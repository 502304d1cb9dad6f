"""Core library of the port: graphs, families, the batched local-fit
engine, combiners and consensus helpers."""
from . import combiners, families
from .asymptotics import free_indices, param_owners
from .batched import degree_buckets, fit_all_local_batched
from .combiners import get_combiner, registered_combiners
from .consensus import combine, empirical_cross_cov, mse
from .estimators import LocalFit
from .families import get_family, registered_families
from .graphs import (Graph, chain_graph, complete_graph, euclidean_graph,
                     grid_graph, scale_free_graph, star_graph)

__all__ = [
    "combiners", "families", "free_indices", "param_owners",
    "degree_buckets", "fit_all_local_batched", "get_combiner",
    "registered_combiners", "combine", "empirical_cross_cov", "mse",
    "LocalFit", "get_family", "registered_families", "Graph", "chain_graph",
    "complete_graph", "euclidean_graph", "grid_graph", "scale_free_graph",
    "star_graph",
]
