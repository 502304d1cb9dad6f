"""The seed score entry points of the port against the reference: the
single-channel and padded-buffer entries, ``score_stats_op``,
``family_score_stats``, the precision table and the ``ising_cl`` shims, on
the same numpy inputs at the reference's own conformance shapes
(tests/kernels/test_score_kernel.py). On CPU tensors every entry takes the
plain version and counts no kernel launch.

Both packages compute the score statistics in float32 whatever the input
type (the reference's ``ref.py`` casts its operands to float32, as the
kernels do), so the outputs are held at ``PRECISION_TOLERANCES["float32"]``
for float32 and float64 inputs alike; the float64 gate holds the kernel
inputs that ``family_kernel_inputs`` builds in float64 under
``jax_enable_x64``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as RC  # noqa: E402
import repro.kernels.cl as RK  # noqa: E402
import repro_torch.core as TC  # noqa: E402
import repro_torch.kernels.cl as TK  # noqa: E402
from repro.kernels.cl import precision as rprec  # noqa: E402
from repro_torch.kernels.cl import kernel as kmod  # noqa: E402

#: the reference's conformance shapes (tests/kernels/test_score_kernel.py)
SHAPES = [(32, 10), (130, 128), (200, 150), (5, 260)]
TOL32 = TK.PRECISION_TOLERANCES["float32"]
TOL64 = TK.PRECISION_TOLERANCES["float64"]
#: reference shim names the port does not export, with the reason: the
#: port's kernels take no tile arguments (launch shapes follow fixed
#: rules), so the Pallas tile sizes have no counterpart
NO_COUNTERPART = {"BM", "BN", "BK"}
#: names this slice adds to ``repro_torch.kernels.cl``
SLICE_NAMES = {
    "cl_score", "cl_score_padded", "cl_score_channels_padded",
    "ising_cl_score", "ising_cl_score_padded", "KERNEL_KINDS",
    "cl_score_ref", "ising_cl_score_ref", "score_stats_op", "KERNEL_PATHS",
    "default_kernel_path", "PRECISION_TOLERANCES", "precision_tolerance",
    "family_score_stats"}


def _inputs(kind, n, p, seed, dtype=np.float32):
    """(x, theta, mask, bias) single-channel inputs: x of the kind's
    support, theta symmetric, mask a symmetric 0/1 adjacency."""
    rs = np.random.RandomState(seed)
    x = (rs.randn(n, p) if kind == "gaussian"
         else np.where(rs.rand(n, p) < 0.5, 1.0, -1.0))
    theta = 0.3 * rs.randn(p, p)
    theta = (theta + theta.T) / 2
    mask = np.triu(rs.rand(p, p) < 0.3, 1).astype(np.float64)
    mask = mask + mask.T
    bias = 0.1 * rs.randn(p)
    return tuple(a.astype(dtype) for a in (x, theta, mask, bias))


def _t(arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _close(got, want, tol):
    for g, w in zip(got, want):
        g = np.asarray(g, np.float64)
        w = np.asarray(w, np.float64)
        assert g.shape == w.shape
        assert np.max(np.abs(g - w)) <= tol, np.max(np.abs(g - w))


def _no_launch():
    return kmod.cl_score_channels.launches


# ---------------------------------------------------------------- names
def test_names_tables_and_shims_match_reference():
    import repro.kernels.ising_cl.kernel as rsk
    import repro.kernels.ising_cl.ops as rso
    import repro.kernels.ising_cl.ref as rsr
    import repro.kernels.ising_cl.score as rss
    import repro_torch.kernels.ising_cl.kernel as tsk
    import repro_torch.kernels.ising_cl.ops as tso
    import repro_torch.kernels.ising_cl.ref as tsr
    import repro_torch.kernels.ising_cl.score as tss

    assert TK.KERNEL_KINDS == RK.KERNEL_KINDS
    assert TK.PRECISION_TOLERANCES == RK.PRECISION_TOLERANCES
    assert TK.precision.__all__ == rprec.__all__
    for prec in RK.PRECISION_TOLERANCES:
        assert TK.precision_tolerance(prec) == RK.precision_tolerance(prec)
    for mod in (TK, RK):
        with pytest.raises(ValueError, match="no documented tolerance for "
                           "precision 'int8'; known: "):
            mod.precision_tolerance("int8")
    assert TK.KERNEL_PATHS == ("cuda", "ref")
    for r, t in ((rsk, tsk), (rso, tso), (rsr, tsr), (rss, tss)):
        assert t.__all__ == [n for n in r.__all__ if n not in NO_COUNTERPART]
        for name in t.__all__:
            assert getattr(t, name) is getattr(TK, name)
    assert SLICE_NAMES <= set(TK.__all__) & set(RK.__all__)


# ------------------------------------------------- single-channel entries
@pytest.mark.parametrize("kind", ["ising", "gaussian"])
@pytest.mark.parametrize("n,p", SHAPES)
def test_single_channel_entries_match_reference(kind, n, p):
    args = _inputs(kind, n, p, seed=n + p)
    want = RK.cl_score_ref(*map(jnp.asarray, args), kind=kind)
    ta = _t(args)
    before = _no_launch()
    _close(TK.cl_score(*ta, kind=kind), want, TOL32)
    _close(TK.score_stats_op(*ta, kind=kind), want, TOL32)
    _close(TK.score_stats_op(*ta, kind=kind, use_kernel=False), want, TOL32)
    _close(TK.cl_score_ref(*ta, kind=kind), want, TOL32)
    if kind == "ising":
        _close(TK.ising_cl_score(*ta), want, TOL32)
        _close(TK.ising_cl_score_ref(*ta), want, TOL32)
    assert _no_launch() == before
    out = TK.cl_score(*ta, kind=kind)
    assert [o.dtype for o in out] == [torch.float32] * 3
    assert out[2].shape == (p, p)


@pytest.mark.parametrize("kind", ["ising", "gaussian", "potts"])
def test_padded_entries_rescale_to_the_live_rows(kind):
    """A zero-padded buffer (capacity 256, 180 live rows) gives the live
    rows' Gram: S of the live rows from the reference's plain version."""
    cap, n_seen, p = 256, 180, 70
    if kind == "potts":
        C = 2
        rs = np.random.RandomState(5)
        x = rs.randint(0, C + 1, size=(n_seen, p)).astype(np.float32)
        F = np.stack([(x == c + 1) for c in range(C)]).astype(np.float32)
        theta = 0.3 * rs.randn(C, p, p)
        theta = ((theta + theta.transpose(0, 2, 1)) / 2).astype(np.float32)
        mask = _inputs("ising", 2, p, seed=6)[2]
        bias = (0.1 * rs.randn(C, p)).astype(np.float32)
        F_pad = np.zeros((C, cap, p), np.float32)
        F_pad[:, :n_seen] = F
        want = RK.cl_score_channels_ref(jnp.asarray(F), jnp.asarray(theta),
                                        jnp.asarray(mask), jnp.asarray(bias),
                                        kind=kind)
        eta, r, S = TK.cl_score_channels_padded(
            *_t((F_pad, theta, mask, bias)), n_seen, kind=kind)
        _close((eta[:, :n_seen], r[:, :n_seen], S), want, TOL32)
        with pytest.raises(ValueError, match="multi-channel"):
            TK.cl_score_padded(*_t((F_pad[0], theta[0], mask, bias[0])),
                               n_seen, kind=kind)
        return
    x, theta, mask, bias = _inputs(kind, n_seen, p, seed=7)
    x_pad = np.zeros((cap, p), np.float32)
    x_pad[:n_seen] = x
    want = RK.cl_score_ref(*map(jnp.asarray, (x, theta, mask, bias)),
                           kind=kind)
    ta = _t((x_pad, theta, mask, bias))
    eta, r, S = TK.cl_score_padded(*ta, n_seen, kind=kind)
    _close((eta[:n_seen], r[:n_seen], S), want, TOL32)
    if kind == "ising":
        assert not torch.any(r[n_seen:])        # x = 0 rows: r = 0
        _close(TK.ising_cl_score_padded(*ta, n_seen), (eta, r, S), 0.0)
    # n_seen = 0 divides by one row, as the reference does
    S0 = TK.cl_score_padded(*ta, 0, kind=kind)[2]
    _close([S0], [TK.cl_score(*ta, kind=kind)[2] * cap], 0.0)


def test_entry_points_refuse_as_the_reference_does():
    args = _t(_inputs("ising", 8, 6, seed=6))
    with pytest.raises(ValueError, match="multi-channel"):
        TK.cl_score(*args, kind="potts")
    with pytest.raises(ValueError, match="multi-channel"):
        TK.cl_score_ref(*args, kind="potts")
    with pytest.raises(ValueError, match="multi-channel"):
        TK.score_stats_op(*args, kind="potts")
    with pytest.raises(ValueError, match="boltzmann"):
        TK.cl_score(*args, kind="boltzmann")


def test_dispatch_paths():
    assert TK.default_kernel_path("cpu") == "ref"
    assert TK.default_kernel_path(torch.device("cuda")) == "cuda"
    assert TK.resolve_kernel_path(torch.device("cuda"), False) == "ref"
    assert TK.resolve_kernel_path(torch.device("cpu")) == "ref"


# ----------------------------------------------------- family adapters
def _family_setup(name, seed=0, n=300):
    """A 2 x 3 grid, the family's random parameters and exact samples,
    drawn by the reference (the RNG streams of the packages differ)."""
    fam = RC.get_family(name)
    g = RC.grid_graph(2, 3)
    theta = np.array(fam.random_params(g, jax.random.PRNGKey(seed)),
                     np.float64)
    X = np.array(fam.exact_sample(g, theta, n, jax.random.PRNGKey(seed + 1)))
    return TC.get_family(name), TC.Graph(g.p, g.edges), theta, X


@pytest.mark.parametrize("name", ["ising", "gaussian", "potts"])
def test_family_score_stats_matches_reference(name):
    fam, g, theta, X = _family_setup(name)
    want = RK.family_score_stats(RC.get_family(name), g,
                                 jnp.asarray(theta, jnp.float32),
                                 jnp.asarray(X, jnp.float32),
                                 use_pallas=False)
    before = _no_launch()
    X32 = torch.from_numpy(X.astype(np.float32))
    got = TK.family_score_stats(fam, g, theta.astype(np.float32), X32)
    _close(got, want, TOL32)
    _close(TK.family_score_stats(fam, g, torch.from_numpy(theta), X32,
                                 use_kernel=False), want, TOL32)
    assert _no_launch() == before
    C = fam.block_dim
    assert got[2].shape == (C, C, g.p, g.p)


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("name", ["ising", "gaussian", "potts"])
def test_float64_inputs_match_reference(name, x64):
    """Under x64 the kernel inputs are float64 in both packages (held at
    the float64 gate); the statistics are float32 computations in both
    (held at the float32 gate)."""
    fam, g, theta, X = _family_setup(name, seed=2)
    rfam = RC.get_family(name)
    Xd, thd = jnp.asarray(X, jnp.float64), jnp.asarray(theta, jnp.float64)
    want_in = RK.family_kernel_inputs(rfam, g, thd, Xd)
    got_in = TK.family_kernel_inputs(fam, g, torch.from_numpy(theta),
                                     torch.from_numpy(X.astype(np.float64)))
    assert all(t.dtype == torch.float64 for t in got_in)
    _close(got_in, want_in, TOL64)
    want = RK.family_score_stats(rfam, g, thd, Xd, use_pallas=False)
    got = TK.family_score_stats(fam, g, theta, X.astype(np.float64))
    _close(got, want, TOL32)
    if fam.block_dim == 1:
        x, th, mask, bias = (np.asarray(a) for a in
                             (want_in[0][0], want_in[1][0], want_in[2],
                              want_in[3][0]))
        want1 = RK.score_stats_op(*map(jnp.asarray, (x, th, mask, bias)),
                                  kind=fam.kernel_kind, use_pallas=False)
        _close(TK.score_stats_op(*_t((x, th, mask, bias)),
                                 kind=fam.kernel_kind), want1, TOL32)
