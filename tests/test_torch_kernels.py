"""The port's plain kernel versions against the JAX reference: epilogues,
bucket Newton statistics, fused score statistics, masked logits and the
Gram product, on the same numpy inputs. On a CPU tensor the kernel wrappers
take the plain version and count no launch."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.cl import epilogues as jep  # noqa: E402
from repro.kernels.cl.kernel import cl_logits as j_logits  # noqa: E402
from repro.kernels.cl.kernel import cl_score_channels as j_score  # noqa: E402
from repro.kernels.cl.kernel import ising_cl_logits as j_ising  # noqa: E402
from repro.kernels.cl.ops import conditional_logits_op as j_logits_op  # noqa: E402,E501
from repro.kernels.cl.newton import (  # noqa: E402
    bucket_newton_stats as j_newton, bucket_newton_stats_ref as j_newton_ref)
from repro.kernels.cl.ref import (  # noqa: E402
    cl_logits_ref as j_logits_ref, cl_score_channels_ref as j_score_ref,
    ising_cl_logits_ref as j_ising_ref)
from repro.kernels.gram.kernel import gram as j_gram  # noqa: E402
from repro.kernels.gram.ref import gram_ref as j_gram_ref  # noqa: E402
from repro_torch.kernels import gram as tgram  # noqa: E402
from repro_torch.kernels.cl import epilogues as tep  # noqa: E402
from repro_torch.kernels.cl import kernel as kmod  # noqa: E402
from repro_torch.kernels.cl import newton as nmod  # noqa: E402
from repro_torch.kernels.cl.ops import conditional_logits_op  # noqa: E402
from repro_torch.kernels.cl.ref import (  # noqa: E402
    cl_logits_ref, cl_score_channels_ref, ising_cl_logits_ref)

KINDS = {"ising": 1, "gaussian": 1, "potts": 2}
N = 300          # not a multiple of the 128-sample tiles


@pytest.fixture(scope="module", autouse=True)
def _x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _rel(got, want):
    """Normwise relative error, max-abs over max-abs of the reference."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)


def _values(kind, shape, rng):
    if kind == "ising":
        return np.where(rng.rand(*shape) < 0.5, 1.0, -1.0)
    if kind == "gaussian":
        return rng.randn(*shape)
    return rng.randint(0, 3, size=shape).astype(np.float64)


def _bucket(kind, k, d, weighted, seed):
    rng = np.random.RandomState(seed)
    C = KINDS[kind]
    xi = _values(kind, (k, N), rng)
    if kind == "potts":
        Zb = (_values(kind, (k, C, d, N), rng) == 1.0).astype(np.float64)
    else:
        Zb = _values(kind, (k, C, d, N), rng)
    base = 0.1 * rng.randn(k, C, N)
    W = 0.2 * rng.randn(k, d * C)
    sw = (rng.rand(k, N) < 0.7).astype(np.float64) if weighted else None
    return Zb, base, xi, W, sw


def _t(a, dtype=torch.float64):
    return None if a is None else torch.as_tensor(a, dtype=dtype)


def _j(a, dtype=jnp.float64):
    return None if a is None else jnp.asarray(a, dtype)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_epilogues_match_reference(kind):
    rng = np.random.RandomState(0)
    C = KINDS[kind]
    x = _values(kind, (7, 11), rng)
    eta = rng.randn(C, 7, 11)
    je, te = jep.require_epilogue(kind), tep.require_epilogue(kind)
    assert je.channels == te.channels
    F_j, F_t = je.features(_j(x), C), te.features(_t(x), C)
    np.testing.assert_allclose(F_t.numpy(), np.asarray(F_j), atol=1e-12)
    for hook in ("residual", "curvature"):
        want = getattr(je, hook)(F_j, _j(eta))
        got = getattr(te, hook)(F_t, _t(eta))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12,
                                   err_msg=hook)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("d", [2, 5, 17])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_newton_stats_ref_matches_reference_float64(kind, d, weighted):
    Zb, base, xi, W, sw = _bucket(kind, 3, d, weighted, seed=d)
    gj, Kj = j_newton_ref(kind, _j(Zb), _j(base), _j(xi), _j(W), _j(sw))
    gt, Kt = nmod.bucket_newton_stats_ref(kind, _t(Zb), _t(base), _t(xi),
                                          _t(W), _t(sw))
    assert gt.dtype == torch.float64 and Kt.shape == (3, d * KINDS[kind],
                                                      d * KINDS[kind])
    assert _rel(gt, gj) <= 1e-10 and _rel(Kt, Kj) <= 1e-10


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("d", [2, 5, 17])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_newton_stats_ref_matches_pallas_interpret_float32(kind, d, weighted):
    Zb, base, xi, W, sw = _bucket(kind, 3, d, weighted, seed=100 + d)
    f32 = jnp.float32
    gj, Kj = j_newton(kind, _j(Zb, f32), _j(base, f32), _j(xi, f32),
                      _j(W, f32), _j(sw, f32), interpret=True)
    t32 = torch.float32
    gt, Kt = nmod.bucket_newton_stats_ref(kind, _t(Zb, t32), _t(base, t32),
                                          _t(xi, t32), _t(W, t32),
                                          _t(sw, t32))
    # float32 sums taken in another order
    assert _rel(gt, gj) <= 1e-5 and _rel(Kt, Kj) <= 1e-5


def _score_inputs(kind, n, p, seed):
    rng = np.random.RandomState(seed)
    C = KINDS[kind]
    x = _values(kind, (n, p), rng)
    F = (np.stack([(x == c).astype(np.float64) for c in range(1, C + 1)])
         if kind == "potts" else x[None])
    th = 0.3 * rng.randn(C, p, p)
    th = th + th.transpose(0, 2, 1)
    A = (rng.rand(p, p) < 0.3).astype(np.float64)
    A = np.triu(A, 1)
    A = A + A.T
    bias = 0.2 * rng.randn(C, p)
    return F, th, A, bias


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_score_ref_matches_pallas_interpret_and_reference(kind):
    F, th, A, bias = _score_inputs(kind, N, 12, seed=3)
    f32, t32 = jnp.float32, torch.float32
    args_j = [_j(a, f32) for a in (F, th, A, bias)]
    got = cl_score_channels_ref(*[_t(a, t32) for a in (F, th, A, bias)],
                                kind)
    for want in (j_score(*args_j, kind=kind, interpret=True),
                 j_score_ref(*args_j, kind)):
        for name, g, w in zip(("eta", "r", "S"), got, want):
            assert g.shape == tuple(w.shape), name
            assert _rel(g, w) <= 1e-5, name


def test_score_ref_computes_in_float32_like_reference():
    # float64 operands are computed in float32 and eta, r handed back in
    # the operands' type, S in float32 (the fit path casts to float32)
    for kind in KINDS:
        F, th, A, bias = _score_inputs(kind, 257, 9, seed=5)
        want = j_score_ref(*[_j(a) for a in (F, th, A, bias)], kind)
        got = cl_score_channels_ref(*[_t(a) for a in (F, th, A, bias)], kind)
        assert [g.dtype for g in got] == [torch.float64, torch.float64,
                                          torch.float32]
        assert [str(w.dtype) for w in want] == ["float64", "float64",
                                                "float32"]
        for g, w in zip(got, want):
            assert _rel(g, w) <= 1e-5


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_wrappers_on_cpu_tensors_take_the_plain_version(kind):
    Zb, base, xi, W, sw = _bucket(kind, 2, 5, True, seed=9)
    n0 = nmod.bucket_newton_stats.launches
    got = nmod.bucket_newton_stats(kind, _t(Zb), _t(base), _t(xi), _t(W),
                                   _t(sw))
    want = nmod.bucket_newton_stats_ref(kind, _t(Zb), _t(base), _t(xi),
                                        _t(W), _t(sw))
    assert nmod.bucket_newton_stats.launches == n0
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    s0 = kmod.cl_score_channels.launches
    args = [_t(a, torch.float32) for a in _score_inputs(kind, 50, 7, 1)]
    got = kmod.cl_score_channels(*args, kind=kind)
    want = cl_score_channels_ref(*args, kind)
    assert kmod.cl_score_channels.launches == s0
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_launch_shapes_cover_the_card_and_divide_nothing_evenly():
    # a bucket of a few nodes still spreads over the card's 132 SMs (four
    # blocks per SM where the samples allow), even one node; a bucket of
    # many nodes needs no splits; a bucket too short to cover the card gets
    # splits of the fewest samples; the regime follows the width: narrow
    # for C = 1 and d <= 8, wide otherwise
    L = nmod.newton_launch_shape(k=3, C=1, d=5, n=4000)
    assert 3 * L.splits >= 132 and L.regime == "narrow"
    field = nmod.newton_launch_shape(k=4096, C=1, d=5, n=16384)
    assert field == ("narrow", 1, 16384)
    sf = nmod.newton_launch_shape(k=1, C=1, d=65, n=4000)
    assert sf.splits >= 132 and sf.regime == "wide"
    assert nmod.newton_launch_shape(k=1, C=2, d=65, n=100) == ("wide", 7, 16)
    assert nmod.newton_launch_shape(k=69, C=2, d=17, n=4000) == ("wide", 9,
                                                                 496)
    assert nmod.newton_launch_shape(k=5, C=1, d=8, n=100).regime == "narrow"
    assert nmod.newton_launch_shape(k=5, C=1, d=9, n=100).regime == "wide"
    assert nmod.newton_launch_shape(k=5, C=2, d=2, n=100).regime == "wide"
    splits, chunk = kmod.score_launch_shape(C=1, n=4000, p=100)
    assert splits > 1 and (splits - 1) * chunk < 4000 <= splits * chunk
    assert kmod.score_launch_shape(C=1, n=16384, p=4096) == (1, 16384)


@pytest.mark.parametrize("k,C,d,n", [(1, 1, 65, 4000), (1, 1, 5, 4001),
                                     (3, 2, 17, 1001), (69, 1, 17, 4000),
                                     (2, 1, 8, 17), (1, 3, 100, 9),
                                     (131, 1, 2, 1000), (133, 1, 2, 1000)])
def test_newton_splits_hold_samples_and_keep_vector_alignment(k, C, d, n):
    # every split holds at least one sample, the splits tile [0, n) in
    # order, and split starts are multiples of 8 samples (16-byte vector
    # loads of every input type) whenever there is more than one
    L = nmod.newton_launch_shape(k=k, C=C, d=d, n=n)
    assert (L.splits - 1) * L.chunk < n <= L.splits * L.chunk
    assert L.splits == 1 or (L.chunk % 8 == 0 and L.chunk >= 16)
    assert k * L.splits >= 4 * 132 or L.chunk == 16 or L.splits == 1
    assert L == nmod.newton_launch_shape(k=k, C=C, d=d, n=n)


@pytest.mark.parametrize("p,triangle,square", [
    (1, 1, 1), (7, 1, 1), (128, 1, 1), (129, 3, 4), (512, 10, 16),
    (513, 15, 25), (4096, 528, 1024)])
def test_gram_tile_count_is_the_upper_triangle(p, triangle, square):
    # symmetric mode (gram) launches the tiles on and above the diagonal
    # of the 128-wide tile grid, full mode (the score kernel's S) all of
    # them; the card tests check the decode (G bitwise symmetric)
    assert kmod.gram_tile_count(p, True) == triangle
    assert kmod.gram_tile_count(p, False) == square


@pytest.mark.parametrize("n,d", [(1, 130), (7, 7), (50, 7), (1001, 130),
                                 (1001, 513), (4000, 100), (16384, 512),
                                 (16384, 4096), (100000, 64)])
def test_gram_splits_tile_the_samples_in_order(n, d):
    # the splits tile [0, n) in order, each a whole number of pipeline
    # slabs and none empty; the triangle's blocks times the splits stay in
    # one wave of the card's target; the same shape gives the same plan
    splits, chunk = tgram.gram_launch_shape(n, d)
    assert (splits - 1) * chunk < n <= splits * chunk
    assert chunk % kmod.GRAM_SLAB == 0
    tiles = kmod.gram_tile_count(d, True)
    assert splits == 1 or splits * tiles <= kmod._TARGET_BLOCKS
    assert splits == 1 or chunk >= kmod._MIN_SPLIT
    assert (splits, chunk) == tgram.gram_launch_shape(n, d)


def test_gram_launch_shape_pinned_at_the_bench_shape():
    # kernels_bench n=16384 d=512: 10 triangle tiles x 26 splits of 640
    # samples (the full square would be 16 tiles)
    assert kmod.gram_tile_count(512, True) == 10
    assert kmod.gram_tile_count(512, False) == 16
    assert tgram.gram_launch_shape(16384, 512) == (26, 640)
    assert tgram.gram_launch_shape(16384, 4096) == (1, 16384)


@pytest.mark.parametrize("C,p", [(1, 37), (1, 130), (2, 37), (3, 130)])
def test_logits_ref_matches_pallas_interpret_and_reference(C, p):
    # n = 300 and p = 37, 130 divide none of the 128 tiles
    rng = np.random.RandomState(C + p)
    F, th = rng.randn(C, N, p), 0.3 * rng.randn(C, p, p)
    A, bias = (rng.rand(p, p) < 0.2).astype(np.float64), rng.randn(C, p)
    f32, t32 = jnp.float32, torch.float32
    args_j = [_j(a, f32) for a in (F, th, A, bias)]
    got = cl_logits_ref(*[_t(a, t32) for a in (F, th, A, bias)])
    assert got.shape == (C, N, p) and got.dtype == t32
    for want in (j_logits(*args_j, interpret=True), j_logits_ref(*args_j)):
        assert _rel(got, want) <= 1e-5     # float32 sums in another order
    x, t, m, b = F[0], th[0], A, bias[0]
    got1 = ising_cl_logits_ref(*[_t(a, t32) for a in (x, t, m, b)])
    args1 = [_j(a, f32) for a in (x, t, m, b)]
    for want in (j_ising(*args1, interpret=True), j_ising_ref(*args1),
                 j_logits_op(*args1, use_pallas=False)):
        assert _rel(got1, want) <= 1e-5
    assert _rel(conditional_logits_op(*[_t(a, t32) for a in (x, t, m, b)]),
                got1) == 0.0


@pytest.mark.parametrize("n,d", [(1001, 130), (300, 37), (513, 128)])
def test_gram_ref_matches_pallas_interpret_and_reference(n, d):
    s = np.random.RandomState(n).randn(n, d)
    got = tgram.gram_ref(_t(s, torch.float32))
    assert got.shape == (d, d) and got.dtype == torch.float32
    for want in (j_gram(_j(s, jnp.float32), interpret=True),
                 j_gram_ref(_j(s, jnp.float32))):
        assert _rel(got, want) <= 1e-5     # float32 sums in another order
    # float64 samples are summed in float32, as the reference casts them
    assert tgram.gram_ref(_t(s)).dtype == torch.float32
    assert _rel(tgram.gram_ref(_t(s)), j_gram_ref(_j(s))) <= 1e-5


def test_logits_and_gram_wrappers_on_cpu_take_the_plain_version():
    rng = np.random.RandomState(0)
    F, th = _t(rng.randn(2, 30, 7)), _t(rng.randn(2, 7, 7))
    A, bias = _t((rng.rand(7, 7) < .5).astype(float)), _t(rng.randn(2, 7))
    l0, g0 = kmod.cl_logits.launches, tgram.gram.launches
    assert torch.equal(kmod.cl_logits(F, th, A, bias),
                       cl_logits_ref(F, th, A, bias))
    assert torch.equal(kmod.ising_cl_logits(F[0], th[0], A, bias[0]),
                       ising_cl_logits_ref(F[0], th[0], A, bias[0]))
    assert torch.equal(tgram.gram(F[0]), tgram.gram_ref(F[0]))
    assert torch.equal(tgram.gram_op(F[0]), tgram.gram_ref(F[0]))
    assert (kmod.cl_logits.launches, tgram.gram.launches) == (l0, g0)


def _poison(F, th, A, seed):
    """Copies of F with NaN and +-inf at random entries and of Theta with
    NaN and +-inf at zeros of A: where such an entry meets a zero of A the
    reference's Theta * A (or F times it) is NaN."""
    rng = np.random.RandomState(seed)
    F, th = F.copy(), th.copy()
    C, n, p = F.shape
    for v in (np.nan, np.inf, -np.inf):
        F[rng.randint(C), rng.randint(n), rng.randint(p)] = v
    zeros = np.argwhere(A == 0.0)
    for v, (j, i) in zip((np.nan, np.inf, -np.inf),
                         zeros[rng.choice(len(zeros), 3, replace=False)]):
        th[rng.randint(C), j, i] = v
    return F, th


def _same_nonfinite(got, want, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.array_equal(np.isnan(got), np.isnan(want)), name
    assert np.array_equal(np.isposinf(got), np.isposinf(want)), name
    assert np.array_equal(np.isneginf(got), np.isneginf(want)), name
    fin = np.isfinite(want)
    assert np.isnan(got).any()
    if fin.any():        # one poisoned sample leaves little of S finite
        assert _rel(got[fin], want[fin]) <= 1e-5, name


@pytest.mark.parametrize("p", [37, 257])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_plain_versions_pin_the_reference_nonfinite_positions(kind, p):
    # eta[c, s, i] is NaN where a zero of A[:, i] meets a non-finite
    # Theta[c, :, i] or F[c, s, :]; r and S follow from that eta
    F, th, A, bias = _score_inputs(kind, N, p, seed=p)
    F, th = _poison(F, th, A, seed=p + 1)
    f32, t32 = jnp.float32, torch.float32
    args_j = [_j(a, f32) for a in (F, th, A, bias)]
    args_t = [_t(a, t32) for a in (F, th, A, bias)]
    wants = [j_score_ref(*args_j, kind)]
    if p < 128:       # the interpret-mode Pallas kernel, at a small p
        wants.append(j_score(*args_j, kind=kind, interpret=True))
    got = cl_score_channels_ref(*args_t, kind)
    for want in wants:
        for name, g, w in zip(("eta", "r", "S"), got, want):
            _same_nonfinite(g.numpy(), w, name)
    logits_wants = [j_logits_ref(*args_j)]
    if p < 128:
        logits_wants.append(j_logits(*args_j, interpret=True))
    for want in logits_wants:
        _same_nonfinite(cl_logits_ref(*args_t).numpy(), want, "eta")
    # whole columns: a non-finite Theta at a zero of A poisons every sample
    C = KINDS[kind]
    bad_cols = np.any(~np.isfinite(th) & (A == 0.0)[None], axis=1)  # (C, p)
    eta = cl_logits_ref(*args_t).numpy()
    assert np.all(np.isnan(eta)[np.broadcast_to(bad_cols[:, None, :],
                                                (C, N, p))])
