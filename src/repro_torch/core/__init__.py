"""Core library of the port: graphs, the exponential-family model zoo
(Ising, Gaussian MRF, q-state Potts) with its samplers and exact oracles,
local conditional-likelihood estimators, the degree-bucketed batched
local-fit and proximal engine, one-step consensus, ADMM joint MPLE, the
centralized MPLE and exact-MLE baselines, and the exact asymptotic-variance
machinery behind the paper's theory."""
from . import combiners, families
from .admm import ADMMResult, admm_mple, admm_mple_family, rho_from_fits
from .asymptotics import (ExactLocal, cross_cov, efficiency,
                          exact_consensus_variance, exact_joint_mple_variance,
                          exact_local, exact_locals, exact_mle_variance,
                          free_indices, param_owners)
from .batched import (DegreeBucket, degree_buckets, fit_all_local_batched,
                      prox_update_batched)
from .combiners import (TRUST_RADIUS, Combiner, get_combiner,
                        register_combiner, registered_combiners,
                        streamable_combiners)
from .consensus import SCHEMES, combine, empirical_cross_cov, mse
from .estimators import (LocalFit, fit_all_local, fit_all_local_loop,
                         fit_local_cl, fit_mle_exact, fit_mple,
                         newton_maximize, node_design)
from .families import (GAUSSIAN, ISING, POTTS3, GaussianMRF, IsingFamily,
                       ModelFamily, PottsFamily, fit_mple_family,
                       fit_node_oracle, get_family, random_rows,
                       register_family, registered_families)
from .graphs import (Graph, chain_graph, complete_graph, euclidean_graph,
                     grid_graph, scale_free_graph, star_graph)
from .ising import (IsingModel, all_states, cond_loglik, conditional_logits,
                    exact_moments, exact_probs, log_partition, loglik,
                    pair_matrix, pseudo_loglik, random_model, suff_stats)
from .sampling import (chromatic_gibbs_sample, exact_sample, gibbs_sample,
                       gibbs_sample_family)

__all__ = [
    "combiners", "families",
    # graphs
    "Graph", "chain_graph", "star_graph", "grid_graph", "complete_graph",
    "scale_free_graph", "euclidean_graph",
    # Ising model math and exact enumeration
    "IsingModel", "random_model", "conditional_logits", "cond_loglik",
    "pseudo_loglik", "suff_stats", "log_partition", "exact_probs", "loglik",
    "exact_moments", "all_states", "pair_matrix",
    # families
    "ModelFamily", "IsingFamily", "GaussianMRF", "PottsFamily", "ISING",
    "GAUSSIAN", "POTTS3", "register_family", "get_family",
    "registered_families", "fit_mple_family", "fit_node_oracle",
    "random_rows",
    # samplers
    "exact_sample", "gibbs_sample", "chromatic_gibbs_sample",
    "gibbs_sample_family",
    # estimators
    "LocalFit", "newton_maximize", "fit_local_cl", "fit_all_local",
    "fit_all_local_loop", "fit_mple", "fit_mle_exact", "node_design",
    # batched engine
    "DegreeBucket", "degree_buckets", "fit_all_local_batched",
    "prox_update_batched",
    # exact asymptotics
    "ExactLocal", "exact_local", "exact_locals", "param_owners",
    "free_indices", "exact_consensus_variance", "exact_joint_mple_variance",
    "exact_mle_variance", "efficiency", "cross_cov",
    # combiners and consensus
    "Combiner", "register_combiner", "get_combiner", "registered_combiners",
    "streamable_combiners", "TRUST_RADIUS", "combine", "mse",
    "empirical_cross_cov", "SCHEMES",
    # ADMM
    "admm_mple", "admm_mple_family", "rho_from_fits", "ADMMResult",
]
