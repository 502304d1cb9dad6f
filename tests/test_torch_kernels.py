"""The port's plain kernel versions against the JAX reference: epilogues,
bucket Newton statistics and fused score statistics, on the same numpy
inputs. On a CPU tensor the kernel wrappers take the plain version and
count no launch."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.cl import epilogues as jep  # noqa: E402
from repro.kernels.cl.kernel import cl_score_channels as j_score  # noqa: E402
from repro.kernels.cl.newton import (  # noqa: E402
    bucket_newton_stats as j_newton, bucket_newton_stats_ref as j_newton_ref)
from repro.kernels.cl.ref import (  # noqa: E402
    cl_score_channels_ref as j_score_ref)
from repro_torch.kernels.cl import epilogues as tep  # noqa: E402
from repro_torch.kernels.cl import kernel as kmod  # noqa: E402
from repro_torch.kernels.cl import newton as nmod  # noqa: E402
from repro_torch.kernels.cl.ref import cl_score_channels_ref  # noqa: E402

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
    # a bucket of a few nodes still spreads over the SMs; a wide bucket
    # needs no splits; every shape has at least one sample per split
    tn, splits = nmod.newton_launch_shape(k=3, C=1, d=5, n=4000)
    assert 3 * splits >= 8 and tn == 128
    assert nmod.newton_launch_shape(k=4096, C=1, d=5, n=16384)[1] == 1
    assert nmod.newton_launch_shape(k=1, C=2, d=65, n=100)[1] == 1
    splits, chunk = kmod.score_launch_shape(C=1, n=4000, p=100)
    assert splits > 1 and (splits - 1) * chunk < 4000 <= splits * chunk
    assert kmod.score_launch_shape(C=1, n=16384, p=4096) == (1, 16384)
