"""Adapters from a :class:`ModelFamily` to the channelized kernel inputs,
and the fused flat pseudo-score built on them.

Depends only on the family object's public hooks (``block_dim``,
``edge_features``, ``coupling_tensor``, ``node_params``, ``kernel_kind``),
never on :mod:`repro_torch.core`, so the kernel layer stays free of cycles.
"""
from __future__ import annotations

import numpy as np
import torch

from .ops import score_stats_channels_op


def family_kernel_inputs(family, graph, theta, X):
    """(F, theta_c, mask, bias) channelized kernel inputs.

    theta is the family's flat [node blocks, edge blocks] tensor; X the raw
    (n, p) sample tensor. Returns F (C, n, p) per-channel design features,
    theta_c (C, p, p) symmetric per-channel couplings, the (p, p) adjacency
    mask and bias (C, p) node blocks, all in X's type and on X's device.
    """
    theta = theta.to(dtype=X.dtype, device=X.device)
    F = torch.movedim(family.edge_features(X), -1, 0).contiguous()
    theta_c = torch.movedim(family.coupling_tensor(graph, theta), -1,
                            0).contiguous()
    # the adjacency built where it is used: a dense (p, p) host array would
    # cross to the card on every call
    mask = torch.zeros((graph.p, graph.p), dtype=X.dtype, device=X.device)
    if graph.m:
        e = torch.as_tensor(np.asarray(graph.edges, dtype=np.int64),
                            device=X.device)
        mask[e[:, 0], e[:, 1]] = 1.0
        mask[e[:, 1], e[:, 0]] = 1.0
    bias = family.node_params(graph, theta).T.contiguous()
    return F, theta_c, mask, bias


def fused_pseudo_score(family, graph, theta, x_pad, n_seen: int, *,
                       use_kernel: bool = True) -> np.ndarray:
    """Exact flat gradient of the average pseudo-likelihood at ``theta``
    over the first ``n_seen`` rows of a zero-padded sample buffer, via one
    fused kernel pass.

    Channel-c singleton gradients are live-row means of ``r_c`` and the
    edge-(i, j) channel-c gradient is ``S[c, c][i, j] + S[c, c][j, i]``
    (padded rows have all-zero feature rows, so only the Gram normalizer
    needs rescaling). Everything goes to float32 first, whatever the
    plan's precision, as the reference does.
    """
    p = graph.p
    C = family.block_dim
    x_pad = torch.as_tensor(x_pad).to(torch.float32)
    theta32 = torch.as_tensor(np.asarray(theta, dtype=np.float32),
                              device=x_pad.device)
    F, theta_c, mask, bias = family_kernel_inputs(family, graph, theta32,
                                                  x_pad)
    _, r, S = score_stats_channels_op(F, theta_c, mask, bias,
                                      kind=family.kernel_kind,
                                      use_kernel=use_kernel)
    n_seen = int(n_seen)
    g = np.zeros(family.n_params(graph))
    g[: p * C] = (r[:, :n_seen, :].sum(dim=1, dtype=torch.float64)
                  / max(n_seen, 1)).T.reshape(p * C).cpu().numpy()
    if graph.m:
        e = torch.as_tensor(np.asarray(graph.edges, dtype=np.int64),
                            device=S.device)
        ch = torch.arange(C, device=S.device)
        # (m, C) channel-diagonal couplings of both orientations
        Sij = S[ch[None, :], ch[None, :], e[:, 0:1], e[:, 1:2]]
        Sji = S[ch[None, :], ch[None, :], e[:, 1:2], e[:, 0:1]]
        scale = x_pad.shape[0] / max(n_seen, 1)
        edge = (Sij.to(torch.float64) * scale + Sji.to(torch.float64) * scale)
        g[p * C:] = edge.reshape(graph.m * C).cpu().numpy()
    return g
