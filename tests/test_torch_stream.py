"""The port's streaming buffer and online estimator bank against the JAX
reference, at float32 (the reference's stream stack runs in float32): the
fit-weight masks bit for bit, growth, chunked and heterogeneous refits,
windows and discounts, warm starts, the score norm, and a reference state
carried into the port mid-stream."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.api as RA  # noqa: E402
import repro.core as RC  # noqa: E402
import repro.stream as RS  # noqa: E402
import repro_torch.stream as TS  # noqa: E402
from repro_torch.core import Graph  # noqa: E402
from repro_torch.core.batched import fit_all_local_batched  # noqa: E402
from repro_torch.interop import (plan_from_reference,  # noqa: E402
                                 stream_state_from_reference)

#: float32 on both sides, sums in another order
TOL = 1e-5
CPU = "cpu"


@pytest.fixture(scope="module")
def grid_setup():
    g = RC.grid_graph(3, 3)
    m = RC.random_model(g, 0.5, 0.3, jax.random.PRNGKey(0))
    X = np.asarray(RC.exact_sample(m, 1600, jax.random.PRNGKey(1)))
    return g, Graph(g.p, tuple(g.edges)), m, X


def _assert_thetas(tfits, rfits, tol=TOL, all_nodes=True):
    """theta within ``tol`` on every node, or (``all_nodes=False``) on the
    nodes whose reference H is well conditioned: on a short prefix a
    quasi-separated node runs off, and there both packages' iterates
    depend on the last bits (ROADMAP.md queue 3)."""
    assert len(tfits) == len(rfits)
    checked = 0
    for a, b in zip(tfits, rfits):
        assert a.i == b.i and list(a.beta) == list(b.beta)
        if not all_nodes and np.linalg.cond(np.asarray(b.H)) >= 1e6:
            continue
        checked += 1
        np.testing.assert_allclose(a.theta, np.asarray(b.theta), rtol=0,
                                   atol=tol, err_msg=f"node {a.i}")
    return checked


# ---------------------------------------------------------------- buffer
def _filled(p, capacity, n, seed=0):
    rows = np.random.RandomState(seed).randn(n, p).astype(np.float32)
    rb, tb = RS.SampleBuffer(p, capacity=capacity), TS.SampleBuffer(
        p, capacity=capacity, device=CPU)
    rb.append(rows)
    tb.append(rows)
    return rb, tb


def test_window_weights_cases_of_the_reference_bitwise():
    rb, tb = _filled(3, 8, 6)
    counts = np.array([5, 2, 0])
    for kw in ({}, {"window": 3}, {"discount": 0.5},
               {"window": 2, "discount": 0.5}):
        want = rb.window_weights(counts, **kw)
        got = tb.window_weights(counts, **kw)
        assert got.dtype == torch.float32 and got.device.type == CPU
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tb.prefix_masks(counts).numpy(),
                                  rb.prefix_masks(counts))
    np.testing.assert_array_equal(tb.window_weights(counts, window=3)
                                  .numpy()[0], [0, 0, 1, 1, 1, 0, 0, 0])


@pytest.mark.parametrize("discount", [None, 0.5, 0.97, 0.999, 1.0])
@pytest.mark.parametrize("window", [None, 1, 7, 100, 1000])
def test_window_weights_match_reference_bitwise(window, discount):
    rb, tb = _filled(11, 64, 700, seed=1)
    counts = np.random.RandomState(2).randint(0, 701, size=11)
    counts[0], counts[1] = 0, 700
    want = rb.window_weights(counts, window=window, discount=discount)
    got = tb.window_weights(counts, window=window, discount=discount).numpy()
    assert got.shape == want.shape == (11, tb.capacity)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_buffer_growth_and_regrowth_match_reference():
    rb, tb = RS.SampleBuffer(4, capacity=16), TS.SampleBuffer(
        4, capacity=16, device=CPU)
    rng = np.random.RandomState(3)
    for size in (7, 50, 3, 301, 239, 1):
        rows = rng.randn(size, 4)
        rb.append(rows)
        tb.append(torch.as_tensor(rows) if size % 2 else rows)
        assert (tb.n, tb.capacity) == (rb.n, rb.capacity)
        np.testing.assert_array_equal(tb.data, rb.data)
        np.testing.assert_array_equal(tb.rows, rb.rows)
    tb.append(np.ones(4))                       # one row as a vector
    assert tb.n == rb.n + 1
    with pytest.raises(ValueError, match="columns"):
        tb.append(np.ones((2, 5)))
    with pytest.raises(ValueError, match="exceeds"):
        tb.window_weights([tb.n + 1, 0, 0, 0])
    with pytest.raises(ValueError, match="positive"):
        TS.SampleBuffer(4, capacity=0, device=CPU)


# ---------------------------------------------------------------- online
def test_chunked_ingestion_matches_reference(grid_setup):
    g, tg, _, X = grid_setup
    rest = RS.StreamingEstimator(g, capacity=64)
    test = TS.StreamingEstimator(tg, capacity=64, device=CPU)
    for chunk in np.array_split(X[:1200], 5):
        rest.ingest(chunk)
        test.ingest(chunk)
        assert _assert_thetas(test.refit(), rest.refit(), all_nodes=False)
        np.testing.assert_array_equal(test.counts, rest.counts)
        np.testing.assert_array_equal(test.versions, rest.versions)
    assert (test.buffer.capacity, test.n_pool) == (rest.buffer.capacity,
                                                   rest.n_pool)
    # a no-op refit returns the cached fits and bumps no version
    fits, versions = test.fits, test.versions.copy()
    assert test.refit() is fits
    np.testing.assert_array_equal(test.versions, versions)
    # chunked equals one shot (the reference's streaming invariant)
    oneshot = RC.fit_all_local(g, jnp.asarray(X[:1200]))
    _assert_thetas(test.fits, oneshot)


def test_heterogeneous_advance_matches_reference(grid_setup):
    g, tg, _, X = grid_setup
    rest = RS.StreamingEstimator(g, capacity=64)
    test = TS.StreamingEstimator(tg, capacity=64, device=CPU)
    counts = 300 + (np.arange(g.p) * 61) % 600
    for est in (rest, test):
        est.extend_pool(X[:900])
        est.advance(counts)
    _assert_thetas(test.refit(), rest.refit())
    # a second, partial advance: only the moved nodes bump their version
    moved = counts.copy()
    moved[::2] += 40
    for est in (rest, test):
        est.advance(moved)
    _assert_thetas(test.refit(), rest.refit())
    np.testing.assert_array_equal(test.versions, rest.versions)
    np.testing.assert_array_equal(test.versions, 1 + (np.arange(g.p) % 2
                                                      == 0))
    with pytest.raises(ValueError, match="monotone"):
        test.advance(np.zeros(g.p))


@pytest.mark.parametrize("window,discount", [(150, None), (None, 0.98),
                                             (300, 0.99)])
def test_window_and_discount_refits_match_reference(grid_setup, window,
                                                    discount):
    g, tg, _, X = grid_setup
    rest = RS.StreamingEstimator(g, capacity=64, window=window,
                                 discount=discount)
    test = TS.StreamingEstimator(tg, capacity=64, window=window,
                                 discount=discount, device=CPU)
    counts = 400 + (np.arange(g.p) * 37) % 400
    for est in (rest, test):
        est.ingest(X[:300])
        est.refit()
        est.extend_pool(X[300:800])
        est.advance(counts)
    _assert_thetas(test.refit(), rest.refit())
    # the effective counts come from the counts alone on the host: exact
    # for windows, float64 sums of the same float32 weights for discounts
    np.testing.assert_allclose(test.effective_counts, rest.effective_counts,
                               rtol=1e-6)


def test_warm_start_escapes_saturated_point(grid_setup):
    g, tg, _, X = grid_setup
    cold_r = RC.fit_all_local(g, jnp.asarray(X[:800]))
    warm = [None] * g.p
    warm[4] = np.full(len(cold_r[4].theta), 8.0, dtype=np.float32)
    want = RC.fit_all_local(g, jnp.asarray(X[:800]), warm_start=warm)
    got = fit_all_local_batched(tg, torch.tensor(X[:800]),
                                warm_start=warm)
    _assert_thetas(got, want)
    np.testing.assert_allclose(got[4].theta, cold_r[4].theta, atol=1e-4)


def test_score_norm_matches_reference(grid_setup):
    g, tg, m, X = grid_setup
    rest = RS.StreamingEstimator(g, capacity=64)
    test = TS.StreamingEstimator(tg, capacity=64, device=CPU)
    for est in (rest, test):
        est.ingest(X[:700])
    for scale in (0.0, 0.7, 1.0):
        theta = np.asarray(m.theta, dtype=np.float64) * scale
        np.testing.assert_allclose(test.score_norm(theta),
                                   rest.score_norm(theta), rtol=TOL)
    # an empty pool has a zero score
    assert TS.StreamingEstimator(tg, device=CPU).score_norm(
        np.ones(g.n_params)) == 0.0


def test_reference_state_continues_in_the_port(grid_setup):
    g, tg, _, X = grid_setup
    rest = RS.StreamingEstimator(g, capacity=64, window=500)
    for chunk in np.array_split(X[:600], 3):
        rest.ingest(chunk)
        rest.refit()
    test = TS.StreamingEstimator(tg, capacity=64, window=500, device=CPU)
    stream_state_from_reference(*rest.state_dict(), test)
    assert test.refit() is test.fits          # nothing moved: cached
    _assert_thetas(test.fits, rest.fits, tol=0.0)
    for est in (rest, test):
        est.ingest(X[600:900])
    _assert_thetas(test.refit(), rest.refit())
    np.testing.assert_array_equal(test.versions, rest.versions)
    # a state of another shape is refused
    with pytest.raises(ValueError, match="columns"):
        stream_state_from_reference(
            *rest.state_dict(),
            TS.StreamingEstimator(RC.grid_graph(2, 2), device=CPU))
    with pytest.raises(ValueError, match="capacity"):
        stream_state_from_reference(
            *rest.state_dict(),
            TS.StreamingEstimator(tg, capacity=48, device=CPU))


def test_own_state_round_trip_is_exact(grid_setup):
    g, tg, _, X = grid_setup
    a = TS.StreamingEstimator(tg, capacity=64, discount=0.99, device=CPU)
    a.ingest(X[:500])
    a.refit()
    b = TS.StreamingEstimator(tg, capacity=64, discount=0.99, device=CPU)
    b.load_state(*a.state_dict())
    for est in (a, b):
        est.ingest(X[500:700])
    for fa, fb in zip(a.refit(), b.refit()):
        for part in ("theta", "H", "J", "V"):
            np.testing.assert_array_equal(getattr(fa, part),
                                          getattr(fb, part))


def test_session_stream_binds_the_plan(grid_setup):
    g, tg, _, X = grid_setup
    rp = RA.Plan(graph=g, combiners=("max",), stream_window=200,
                 capacity=32, n_iter=25)
    tp = plan_from_reference(rp.to_dict())
    rest, test = rp.session().stream(), tp.session(device=CPU).stream()
    assert (test.window, test.discount, test.n_iter, test.buffer.capacity) \
        == (rest.window, rest.discount, rest.n_iter, rest.buffer.capacity)
    assert test.device.type == CPU and test.want_influence is False
    for est in (rest, test):
        est.ingest(X[:400])
    _assert_thetas(test.refit(), rest.refit())
    assert test.fits[0].s.shape[0] == 0
    with pytest.raises(ValueError, match="window"):
        TS.StreamingEstimator(tg, window=0, device=CPU)
    for bad in (0.0, 1.5):
        with pytest.raises(ValueError, match="discount"):
            TS.StreamingEstimator(tg, discount=bad, device=CPU)
