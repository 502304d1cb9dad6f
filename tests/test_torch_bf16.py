"""bfloat16 operands of the score, ``cl_logits`` and ``gram`` kernels: the
port's plain versions against the reference's interpret-mode Pallas kernels
on the same bfloat16 inputs, at the reference's own shapes
(tests/kernels/test_kernels.py, tests/kernels/test_score_kernel.py).

Both packages read bfloat16 operands, sum in float32 and return eta and r
in the operands' type (rounded once from float32), S and G in float32. The
inputs are made in float32 by a seeded numpy generator and rounded to
bfloat16 by each package, which give the same values (checked). Gates:
- eta and r bitwise: both round the same float32 values once (Theta * A is
  formed in bfloat16 by both, exactly for a 0/1 mask, and a product of two
  bfloat16 values is exact in float32);
- S normwise within 1e-5 and G within 1e-5 absolute: float32 sums in
  another order;
- ``cl_logits`` within 1e-2 of the largest |eta|: the Pallas kernel rounds
  float32(sum) + bias once, the plain version rounds the bfloat16 product
  and then adds the bias in bfloat16, so the two are a rounding or two
  apart.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as RC  # noqa: E402
import repro.kernels.cl as RK  # noqa: E402
from repro.kernels.cl.kernel import cl_logits as j_logits  # noqa: E402
from repro.kernels.cl.kernel import cl_score_channels as j_score  # noqa: E402
from repro.kernels.gram.kernel import gram as j_gram  # noqa: E402
import repro_torch.core as TC  # noqa: E402
import repro_torch.kernels.cl as TK  # noqa: E402
from repro_torch.kernels.cl import kernel as kmod  # noqa: E402
from repro_torch.kernels.gram import kernel as gmod  # noqa: E402
from repro_torch.kernels.gram.ops import gram_op  # noqa: E402

#: the reference's conformance shapes of the score kernel
SHAPES = [(32, 10), (130, 128), (200, 150), (5, 260)]
#: the reference's Gram shapes (tests/kernels/test_kernels.py)
GRAM_SHAPES = [(100, 7), (512, 128), (1000, 40), (3, 300)]
#: channels of each kind (Potts with q = 4 states)
KINDS = {"ising": 1, "gaussian": 1, "potts": 3}
#: (kind, n, p) of the score kernel: Ising at every conformance shape, the
#: other kinds at the two whose p pads past one 128-wide tile (each case
#: costs the reference an interpret-mode compile, about a second)
SCORE_CASES = ([("ising",) + s for s in SHAPES]
               + [(k,) + s for k in ("gaussian", "potts") for s in SHAPES[2:]])
#: (C, n, p) of cl_logits: one channel at every conformance shape, three at
#: the widest
LOGITS_CASES = [(1,) + s for s in SHAPES] + [(3,) + SHAPES[3]]


def _inputs(kind, n, p, seed):
    """(F, theta, mask, bias) float32 numpy inputs of the kind: F of the
    kind's support, theta symmetric, mask a symmetric 0/1 adjacency."""
    rs = np.random.RandomState(seed)
    C = KINDS[kind]
    if kind == "potts":
        x = rs.randint(0, C + 1, size=(n, p))
        F = np.stack([(x == c) for c in range(1, C + 1)]).astype(np.float64)
    elif kind == "gaussian":
        F = rs.randn(1, n, p)
    else:
        F = np.where(rs.rand(1, n, p) < 0.5, 1.0, -1.0)
    theta = 0.3 * rs.randn(C, p, p)
    theta = (theta + theta.transpose(0, 2, 1)) / 2
    mask = np.triu(rs.rand(p, p) < 0.3, 1).astype(np.float64)
    mask = mask + mask.T
    bias = 0.1 * rs.randn(C, p)
    return tuple(a.astype(np.float32) for a in (F, theta, mask, bias))


def _bf16(arrays):
    """Both packages' bfloat16 roundings of the same float32 arrays, which
    must hold the same values."""
    j = tuple(jnp.asarray(a).astype(jnp.bfloat16) for a in arrays)
    t = tuple(torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    for a, b in zip(j, t):
        assert np.array_equal(np.asarray(a.astype(jnp.float32)),
                              b.float().numpy())
    return j, t


def _np(a):
    """float64 numpy view of a JAX or torch array of any type."""
    if isinstance(a, torch.Tensor):
        return a.double().numpy()
    return np.asarray(a.astype(jnp.float32), np.float64)


def _same_stats(got, want):
    """eta and r bitwise in bfloat16, S in float32 within 1e-5 normwise."""
    eta, r, S = got
    assert [eta.dtype, r.dtype, S.dtype] == [torch.bfloat16, torch.bfloat16,
                                             torch.float32]
    assert [str(w.dtype) for w in want] == ["bfloat16", "bfloat16", "float32"]
    for name, g, w in zip(("eta", "r"), (eta, r), want):
        assert g.shape == tuple(w.shape), name
        assert np.array_equal(_np(g), _np(w)), name
    s, sw = _np(S), _np(want[2])
    assert np.linalg.norm(s - sw) <= 1e-5 * np.linalg.norm(sw)


@pytest.mark.parametrize("kind,n,p", SCORE_CASES)
def test_score_channels_plain_matches_interpret_kernel(kind, n, p):
    (Fj, thj, mj, bj), args = _bf16(_inputs(kind, n, p, seed=n + p))
    want = j_score(Fj, thj, mj, bj, kind=kind, interpret=True)
    before = kmod.cl_score_channels.launches
    _same_stats(kmod.cl_score_channels(*args, kind=kind), want)
    _same_stats(kmod.cl_score_channels_ref(*args, kind), want)
    assert kmod.cl_score_channels.launches == before


@pytest.mark.parametrize("C,n,p", LOGITS_CASES)
def test_logits_plain_matches_interpret_kernel(C, n, p):
    kind = "potts" if C == 3 else "ising"
    (Fj, thj, mj, bj), args = _bf16(_inputs(kind, n, p, seed=n + p + 1))
    want = _np(j_logits(Fj, thj, mj, bj, interpret=True))
    before = kmod.cl_logits.launches
    for got in (kmod.cl_logits(*args), kmod.cl_logits_ref(*args)):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        assert np.max(np.abs(_np(got) - want)) <= 1e-2 * np.max(np.abs(want))
    if C == 1:
        got = TK.conditional_logits_op(args[0][0], args[1][0], args[2],
                                       args[3][0])
        assert got.dtype == torch.bfloat16
        assert np.max(np.abs(_np(got) - want[0])) \
            <= 1e-2 * np.max(np.abs(want))
    assert kmod.cl_logits.launches == before


@pytest.mark.parametrize("n,d", GRAM_SHAPES)
def test_gram_plain_matches_interpret_kernel(n, d):
    s32 = np.random.RandomState(n + d).randn(n, d).astype(np.float32)
    (sj,), (st,) = _bf16((s32,))
    want = np.asarray(j_gram(sj, interpret=True), np.float64)
    assert str(j_gram(sj, interpret=True).dtype) == "float32"
    before = gmod.gram.launches
    for got in (gmod.gram(st), gram_op(st), gmod.gram_ref(st)):
        assert got.dtype == torch.float32 and got.shape == (d, d)
        assert np.max(np.abs(got.double().numpy() - want)) <= 1e-5
    assert gmod.gram.launches == before


@pytest.mark.parametrize("kind", ["ising", "gaussian"])
def test_single_channel_entries_match_interpret_kernel(kind):
    n, p = SHAPES[1]
    F, th, m, b = _inputs(kind, n, p, seed=7)
    live = 100
    F[:, live:] = 0.0       # a zero-padded streaming buffer
    (Fj, thj, mj, bj), (Ft, tht, mt, bt) = _bf16((F, th, m, b))
    args_j = (Fj[0], thj[0], mj, bj[0])
    args_t = (Ft[0], tht[0], mt, bt[0])
    want = RK.cl_score(*args_j, kind=kind, interpret=True)
    before = kmod.cl_score_channels.launches
    for got in (TK.cl_score(*args_t, kind=kind),
                TK.score_stats_op(*args_t, kind=kind),
                TK.score_stats_op(*args_t, kind=kind, use_kernel=False)):
        _same_stats(got, want)
    _same_stats(TK.cl_score_padded(*args_t, live, kind=kind),
                RK.cl_score_padded(*args_j, live, kind=kind, interpret=True))
    assert kmod.cl_score_channels.launches == before


@pytest.mark.parametrize("name", ["ising", "gaussian", "potts"])
def test_family_score_stats_bf16_matches_interpret_kernel(name):
    rs = np.random.RandomState(11)
    g = RC.grid_graph(3, 4)
    rfam, tfam = RC.get_family(name), TC.get_family(name)
    theta = (0.3 * rs.randn(rfam.n_params(g))).astype(np.float32)
    if name == "gaussian":
        X = rs.randn(300, g.p)
    elif name == "ising":
        X = np.where(rs.rand(300, g.p) < 0.5, 1.0, -1.0)
    else:
        X = rs.randint(0, 3, size=(300, g.p)).astype(np.float64)
    (Xj, thj), (Xt, tht) = _bf16((X.astype(np.float32), theta))
    want = RK.family_score_stats(rfam, g, thj, Xj, use_pallas=True,
                                 interpret=True)
    tg = TC.Graph(g.p, g.edges)
    got_in = TK.family_kernel_inputs(tfam, tg, tht, Xt)
    assert all(t.dtype == torch.bfloat16 for t in got_in)
    before = kmod.cl_score_channels.launches
    _same_stats(TK.family_score_stats(tfam, tg, tht, Xt), want)
    assert kmod.cl_score_channels.launches == before


def test_wrappers_on_cpu_hand_bf16_to_the_plain_version():
    # a CPU bfloat16 call is the plain version's, outputs in the reference's
    # types; mixed types reach the plain version too (only CUDA refuses)
    F, th, m, b = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _inputs("ising", 16, 9, seed=3))
    eta, r, S = kmod.cl_score_channels(F, th, m, b, kind="ising")
    assert (eta.dtype, r.dtype, S.dtype) == (torch.bfloat16, torch.bfloat16,
                                             torch.float32)
    assert kmod.cl_logits(F, th, m, b).dtype == torch.bfloat16
    assert gmod.gram(F[0]).dtype == torch.float32
    # copy widths: 16-byte units where rows and base allow, else 4-byte
    # units (a bfloat16 pair), else single elements
    assert [kmod.copy_width(p, F) for p in (8, 6, 7)] == [8, 2, 1]
    assert [kmod.copy_width(p, F.float()) for p in (8, 6)] == [4, 1]
    odd = F.flatten()[1:]
    assert [kmod.copy_width(p, odd) for p in (8, 6)] == [1, 1]
