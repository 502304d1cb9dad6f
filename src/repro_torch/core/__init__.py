"""Core library of the port: graphs, families, the batched local-fit and
proximal engine, joint ADMM, combiners and consensus helpers."""
from . import combiners, families
from .admm import ADMMResult, admm_mple_family, rho_from_fits
from .asymptotics import free_indices, param_owners
from .batched import (degree_buckets, fit_all_local_batched,
                      prox_update_batched)
from .combiners import get_combiner, registered_combiners
from .consensus import combine, empirical_cross_cov, mse
from .estimators import LocalFit
from .families import get_family, registered_families
from .graphs import (Graph, chain_graph, complete_graph, euclidean_graph,
                     grid_graph, scale_free_graph, star_graph)

__all__ = [
    "combiners", "families", "free_indices", "param_owners",
    "degree_buckets", "fit_all_local_batched", "prox_update_batched",
    "ADMMResult", "admm_mple_family", "rho_from_fits", "get_combiner",
    "registered_combiners", "combine", "empirical_cross_cov", "mse",
    "LocalFit", "get_family", "registered_families", "Graph", "chain_graph",
    "complete_graph", "euclidean_graph", "grid_graph", "scale_free_graph",
    "star_graph",
]
