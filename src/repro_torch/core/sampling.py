"""Samplers: exact enumeration (small p), sequential Gibbs, chromatic
(graph-colored) Gibbs that updates whole color classes in parallel per sweep
(any p), and a family-generic chromatic chain that draws from any registered
:class:`~repro_torch.core.families.base.ModelFamily` via its conditional-draw
hooks.

Chains run side by side as a batch dimension on the device of the model's
parameters, all drawing from one ``torch.Generator`` that must live on that
device. Each chain keeps the sweeps ``burnin, burnin + thin, ...``; the
rows come out chain-major (``reshape(-1, p)[:n]``) in float32.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .graphs import Graph
from .ising import IsingModel, as_tensor, exact_probs, pair_matrix, \
    states_tensor


def exact_sample(model: IsingModel, n: int,
                 generator: torch.Generator) -> torch.Tensor:
    """Draw n iid samples by enumerating all 2^p states (small p only)."""
    probs = exact_probs(model.graph, model.theta)
    idx = torch.multinomial(probs, n, replacement=True, generator=generator)
    return states_tensor(model.graph.p, probs.device, torch.float32)[idx]


def _run_chains(update, x: torch.Tensor, p: int, n: int, burnin: int,
                thin: int) -> torch.Tensor:
    """Sweep ``update(x)`` (in place on the (chains, >= p) state) and keep
    the states after sweeps ``burnin + k * thin`` for k < n: the
    reference's ``xs[burnin::thin][:n]`` of its ``burnin + n * thin``
    sweeps, whose later sweeps it never keeps. Returns (chains, n, p)."""
    kept = []
    for s in range(burnin + (n - 1) * thin + 1):
        update(x)
        if s >= burnin and (s - burnin) % thin == 0:
            kept.append(x[:, :p].clone())
    return torch.stack(kept, dim=1)


def _gibbs_chains(theta_single, T, n: int, burnin: int, thin: int,
                  n_chains: int, generator) -> torch.Tensor:
    """Sequential single-site Gibbs, ``n_chains`` chains of n samples."""
    p = T.shape[0]
    x = torch.where(torch.rand((n_chains, p), generator=generator,
                               device=T.device) < 0.5, 1.0, -1.0)

    def sweep(x):
        for i in range(p):
            eta = theta_single[i] + x @ T[:, i]
            u = torch.rand(n_chains, generator=generator, device=T.device)
            x[:, i] = torch.where(u < torch.sigmoid(2.0 * eta), 1.0, -1.0)

    return _run_chains(sweep, x, p, n, burnin, thin)


def _chromatic_chains(theta_single, T, class_idx, class_mask, n: int,
                      burnin: int, thin: int, n_chains: int,
                      generator) -> torch.Tensor:
    """Chromatic Gibbs: per sweep, every node of a color class is redrawn
    at once (valid because same-color nodes are mutually non-adjacent, so
    their conditionals don't interact).

    class_idx: (n_colors, pad) node indices, padded with the out-of-range
    index ``p`` which addresses a dummy slot in the extended state;
    class_mask: (n_colors, pad) 1.0 on real entries.
    """
    p, dev = T.shape[0], T.device
    ts_pad = F.pad(theta_single, (0, 1))              # dummy slot p
    T_pad = F.pad(T, (0, 1))
    classes = [(idx, real, ts_pad[idx], T_pad[:, idx])
               for idx, real in _classes(class_idx, class_mask, dev)]
    x = torch.where(torch.rand((n_chains, p + 1), generator=generator,
                               device=dev) < 0.5, 1.0, -1.0)

    def sweep(x):
        for idx, real, ts_c, T_c in classes:
            eta = ts_c + x[:, :p] @ T_c
            u = torch.rand(eta.shape, generator=generator, device=dev)
            xi = torch.where(u < torch.sigmoid(2.0 * eta), 1.0, -1.0)
            x[:, idx] = torch.where(real, xi, x[:, idx])  # pads keep value

    return _run_chains(sweep, x, p, n, burnin, thin)


def color_classes(graph: Graph):
    """(class_idx, class_mask) arrays for chromatic sweeps; padded with p."""
    colors = graph.greedy_coloring()
    n_colors = int(colors.max()) + 1
    groups = [np.flatnonzero(colors == c) for c in range(n_colors)]
    pad = max(len(g) for g in groups)
    class_idx = np.full((n_colors, pad), graph.p, dtype=np.int32)
    class_mask = np.zeros((n_colors, pad), dtype=np.float32)
    for c, g in enumerate(groups):
        class_idx[c, :len(g)] = g
        class_mask[c, :len(g)] = 1.0
    return class_idx, class_mask


def _classes(class_idx, class_mask, device):
    """(node indices, real-entry mask) of each color class, on device."""
    idx = torch.as_tensor(class_idx, device=device).long()
    return list(zip(idx, torch.as_tensor(class_mask, device=device) > 0))


def _ising_inputs(model: IsingModel):
    theta = model.theta.to(torch.float32)
    return theta[: model.graph.p], pair_matrix(model.graph,
                                               theta[model.graph.p:])


def chromatic_gibbs_sample(model: IsingModel, n: int,
                           generator: torch.Generator, burnin: int = 200,
                           thin: int = 5, n_chains: int = 8) -> torch.Tensor:
    """Draw ~n samples via parallel chromatic-Gibbs chains."""
    per = -(-n // n_chains)
    ts, T = _ising_inputs(model)
    class_idx, class_mask = color_classes(model.graph)
    chains = _chromatic_chains(ts, T, class_idx, class_mask, per, burnin,
                               thin, n_chains, generator)
    return chains.reshape(-1, model.graph.p)[:n]


def gibbs_sample(model: IsingModel, n: int, generator: torch.Generator,
                 burnin: int = 200, thin: int = 5, n_chains: int = 8,
                 method: str = "auto") -> torch.Tensor:
    """Draw ~n samples via ``n_chains`` parallel Gibbs chains.

    method="auto" uses chromatic sweeps when the greedy coloring is sparse
    (few color classes relative to p — each sweep then runs a handful of
    vectorized color updates instead of p sequential site updates) and falls
    back to the sequential single-site scan for dense colorings, where the
    color classes are tiny and the chromatic schedule has no parallelism to
    exploit. "sequential" / "chromatic" force a path.
    """
    if method == "auto":
        n_colors = int(model.graph.greedy_coloring().max()) + 1
        method = ("chromatic" if n_colors <= max(2, model.graph.p // 2)
                  else "sequential")
    if method == "chromatic":
        return chromatic_gibbs_sample(model, n, generator, burnin, thin,
                                      n_chains)
    if method != "sequential":
        raise ValueError(f"unknown method {method!r}")
    per = -(-n // n_chains)
    ts, T = _ising_inputs(model)
    chains = _gibbs_chains(ts, T, per, burnin, thin, n_chains, generator)
    return chains.reshape(-1, model.graph.p)[:n]


# ------------------------------------------------------ family-generic Gibbs
def _family_chromatic_chains(family, h, Tc, class_idx, class_mask, n: int,
                             burnin: int, thin: int, n_chains: int,
                             generator) -> torch.Tensor:
    """Chromatic-Gibbs chains for an arbitrary model family.

    The channel logits of every node in a color class are assembled from
    the family's ``edge_features`` and the dense coupling tensor, then the
    class is redrawn in parallel via ``cond_draw``. h: (p, C) node blocks;
    Tc: (p, p, C) symmetric couplings; class_idx/class_mask as in
    :func:`color_classes` (padded with the dummy index ``p``).
    """
    p, dev = Tc.shape[0], Tc.device
    h_pad = F.pad(h, (0, 0, 0, 1))
    Tc_pad = F.pad(Tc, (0, 0, 0, 1))
    classes = [(idx, real, h_pad[idx], Tc_pad[:, idx, :])
               for idx, real in _classes(class_idx, class_mask, dev)]
    x = torch.zeros((n_chains, p + 1), dtype=torch.float32, device=dev)
    x[:, :p] = family.init_draw(generator, n_chains * p, dev).reshape(
        n_chains, p).to(torch.float32)

    def sweep(x):
        for idx, real, h_c, T_c in classes:
            Fx = family.edge_features(x[:, :p])                 # (b, p, C)
            eta = h_c + torch.einsum("bpc,pmc->bmc", Fx, T_c)
            xi = family.cond_draw(generator, eta).to(torch.float32)
            x[:, idx] = torch.where(real, xi, x[:, idx])  # pads keep value

    return _run_chains(sweep, x, p, n, burnin, thin)


def gibbs_sample_family(family, graph: Graph, theta, n: int,
                        generator: torch.Generator, burnin: int = 200,
                        thin: int = 5, n_chains: int = 8) -> torch.Tensor:
    """Draw ~n samples from any registered family via chromatic Gibbs, on
    the device of ``theta`` (a tensor; anything else goes to the card).

    For the Ising family this targets the same law as
    :func:`chromatic_gibbs_sample` (the conformance tests check both
    against exact moments).
    """
    theta = as_tensor(theta)
    per = -(-n // n_chains)
    h = family.node_params(graph, theta).to(torch.float32)
    Tc = family.coupling_tensor(graph, theta).to(torch.float32)
    class_idx, class_mask = color_classes(graph)
    chains = _family_chromatic_chains(family, h, Tc, class_idx, class_mask,
                                      per, burnin, thin, n_chains, generator)
    return chains.reshape(-1, graph.p)[:n]

