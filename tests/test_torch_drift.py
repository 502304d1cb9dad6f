"""Parameter drift in the port's streaming simulator, and families without
a fused-kernel epilogue, against the JAX reference.

Drift: the two packages' RNG streams differ, so the reference's jump and
re-drawn pool tail are replayed into the port through
``StreamSimulator._drift_draw``; the trajectory then equals the
reference's within 1e-5 at float32 with exact counters. The port's own
draws are held to its own properties: same-seed runs bitwise equal, a
checkpoint across the change-point exact, the caller's pool untouched.

Families registered with ``kernel_kind = None`` take the engine's
closed-form hooks and the autodiff pseudo-score, as the reference does:
``fit`` (every combiner), ``joint`` and ``select`` equal the reference at
float64 within 1e-8, the stream and the simulator at float32 within 1e-5.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.api as RA  # noqa: E402
import repro.core as RC  # noqa: E402
import repro.stream as RS  # noqa: E402
from repro.core import families as RF  # noqa: E402
import repro_torch.checkpoint as TCK  # noqa: E402
import repro_torch.stream as TS  # noqa: E402
from repro_torch.core import Graph  # noqa: E402
from repro_torch.core import families as TF  # noqa: E402
from repro_torch.interop import (fault_plan_from_reference,  # noqa: E402
                                 plan_from_reference)
from repro_torch.kernels.cl import ops as omod  # noqa: E402

#: float32 on both sides
TOL = 1e-5
#: float64 on both sides
TOL64 = 1e-8
CPU = "cpu"
ROUNDS = 6
LOSSY = dict(drop_prob=0.2, delay=1, jitter=2, link_prob=0.8)
DRIFT = RS.FaultPlan(drift=(RS.DriftSpec(at=3, scale=0.3),))
ALL_COMBINERS = tuple(c.name for c in RC.combiners.registered_combiners())
PLAIN = "ising_plain"


@pytest.fixture(scope="module")
def grid_setup():
    g = RC.grid_graph(4, 4)
    m = RC.random_model(g, 0.4, 0.3, jax.random.PRNGKey(0))
    pool = np.asarray(RC.exact_sample(m, 4000, jax.random.PRNGKey(1)))
    return g, Graph(g.p, tuple(g.edges)), np.asarray(m.theta), pool


@pytest.fixture(scope="module")
def star_setup():
    g = RC.star_graph(6)
    m = RC.random_model(g, 0.5, 0.4, jax.random.PRNGKey(2))
    pool = np.asarray(RC.exact_sample(m, 900, jax.random.PRNGKey(3)))
    return Graph(g.p, tuple(g.edges)), np.asarray(m.theta), pool


def _assert_results(got, want, tol=TOL):
    for col in ("rounds", "samples_seen", "samples_total", "scalars_sent",
                "staleness"):
        np.testing.assert_array_equal(getattr(got, col), getattr(want, col),
                                      err_msg=col)
    np.testing.assert_allclose(got.theta, want.theta, rtol=0, atol=tol)
    np.testing.assert_allclose(got.initial, want.initial, rtol=0, atol=tol)
    if want.err is not None:
        np.testing.assert_allclose(got.err, want.err, rtol=0, atol=tol)
    if want.score_norm is not None:
        np.testing.assert_allclose(got.score_norm, want.score_norm,
                                   rtol=tol)


def _replay_reference_drift(port, ref, theta_before):
    """Make the port's change-point draw the reference's: its jump (the
    truth after minus before, at the free coordinates) and its re-drawn
    pool tail. Returns the list of tails the port asked for."""
    delta = (np.asarray(ref.theta_star) - theta_before)[port.free]
    asked = []

    def draw(spec, tail):
        asked.append(tail)
        theta = port.theta_star.copy()
        theta[port.free] += delta
        return theta, ref.pool[len(ref.pool) - tail:]

    port._drift_draw = draw
    return asked


# ------------------------------------------------------- drift: parity
@pytest.mark.parametrize("entry", ["one_step", "admm", "session"])
def test_drift_replayed_from_reference_matches_it(grid_setup, entry):
    g, tg, ts, pool = grid_setup
    arrivals = {"kind": "poisson", "rate": 150.0}
    if entry == "session":
        rp = RA.Plan(graph=g, faults=DRIFT)
        ref = rp.session().simulate(pool, theta_star=ts, seed=2,
                                    arrivals=RS.ArrivalSpec(**arrivals))
        port = plan_from_reference(rp.to_dict()).session(
            device=CPU).simulate(pool, theta_star=ts, seed=2,
                                 arrivals=TS.ArrivalSpec(**arrivals))
    else:
        kw = dict(estimator=entry, theta_star=ts, capacity=64, seed=5)
        ref = RS.StreamSimulator(
            g, pool, arrivals=RS.ArrivalSpec(**arrivals),
            network=RS.NetworkConfig(**LOSSY), faults=DRIFT, **kw)
        port = TS.StreamSimulator(
            tg, pool, arrivals=TS.ArrivalSpec(**arrivals),
            network=TS.NetworkConfig(**LOSSY),
            faults=fault_plan_from_reference(DRIFT.to_dict()), device=CPU,
            **kw)
    want = ref.run(ROUNDS)
    asked = _replay_reference_drift(port, ref, ts)
    got = port.run(ROUNDS)
    assert len(asked) == 1 and 0 < asked[0] < len(pool)
    _assert_results(got, want)
    assert port.net.counters_dict() == ref.net.counters_dict()
    np.testing.assert_array_equal(port.pool.numpy(), ref.pool)
    np.testing.assert_allclose(port.theta_star, ref.theta_star, rtol=0,
                               atol=1e-15)
    assert not np.array_equal(port.theta_star, ts)


# ---------------------------------------------- drift: its own properties
def _hostile():
    return TS.FaultPlan(
        crashes=(TS.CrashSpec(node=2, at=3, restart_at=8),),
        byzantine=(TS.ByzantineSpec(node=5, kind="scaled_noise",
                                    scale=1.0),),
        replay=TS.ReplaySpec(prob=0.4, delay=2),
        drift=(TS.DriftSpec(at=7, scale=0.3),))


def _hostile_sim(tg, pool, ts, **over):
    kw = dict(scheme="diagonal", theta_star=ts,
              network=TS.NetworkConfig(drop_prob=0.4, delay=1, jitter=1),
              arrivals=TS.ArrivalSpec(kind="poisson", rate=30.0),
              capacity=128, seed=11, faults=_hostile(), window=400,
              device=CPU)
    kw.update(over)
    return TS.StreamSimulator(tg, pool, **kw)


def test_same_seed_drift_runs_are_bitwise_equal(star_setup):
    tg, ts, pool = star_setup
    a, b = _hostile_sim(tg, pool, ts), _hostile_sim(tg, pool, ts)
    a.run(6)
    seen = a.pool[:a._fed].clone()
    ra = a.run(4)
    rb = b.run(10)
    np.testing.assert_array_equal(ra.theta, rb.theta[6:])
    np.testing.assert_array_equal(ra.err, rb.err[6:])
    assert a.net.counters_dict() == b.net.counters_dict()
    assert torch.equal(a.pool, b.pool)
    # rows fed before the change-point keep their draw; the truth moved at
    # the free coordinates only
    assert torch.equal(a.pool[:len(seen)], seen)
    moved = np.flatnonzero(a.theta_star != ts)
    assert len(moved) and set(moved) <= set(a.free.tolist())
    other = _hostile_sim(tg, pool, ts, seed=12).run(10)
    assert not np.array_equal(other.err, rb.err)


@pytest.mark.parametrize("estimator", ["one_step", "admm"])
def test_checkpoint_after_the_change_point_is_exact(star_setup, tmp_path,
                                                    estimator):
    tg, ts, pool = star_setup
    kw = {} if estimator == "one_step" else dict(estimator="admm",
                                                 newton_iters=8)
    full = _hostile_sim(tg, pool, ts, **kw)
    res_full = full.run(11)
    part = _hostile_sim(tg, pool, ts, **kw)
    part.run(9)
    TCK.save_stream(str(tmp_path), 9, part)
    fresh = TCK.restore_stream(str(tmp_path), _hostile_sim(tg, pool, ts,
                                                           **kw))
    np.testing.assert_array_equal(fresh.theta_star, part.theta_star)
    assert torch.equal(fresh.pool, part.pool)
    res = fresh.run(2)
    for t in (10, 11):
        np.testing.assert_allclose(res.estimate_at(t),
                                   res_full.estimate_at(t), rtol=0,
                                   atol=1e-10)
    np.testing.assert_allclose(res.err, res_full.err[9:], rtol=0,
                               atol=1e-10)
    assert fresh.net.counters_dict() == full.net.counters_dict()


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_drift_leaves_the_callers_pool_untouched(star_setup, kind):
    tg, ts, pool = star_setup
    mine = pool.copy() if kind == "numpy" else torch.tensor(pool)
    sim = TS.StreamSimulator(
        tg, mine, theta_star=ts, arrivals=TS.ArrivalSpec(rate=50.0),
        capacity=256, device=CPU,
        faults=TS.FaultPlan(drift=(TS.DriftSpec(at=2, scale=0.5),)))
    sim.run(4)
    assert not np.array_equal(sim.pool.numpy(), pool)      # tail re-drawn
    np.testing.assert_array_equal(np.asarray(mine), pool)


def test_drift_needs_theta_star(star_setup):
    tg, _, pool = star_setup
    for mod, graph in ((RS, RC.star_graph(6)), (TS, tg)):
        fp = mod.FaultPlan(drift=(mod.DriftSpec(at=2),))
        kw = {} if mod is RS else {"device": CPU}
        with pytest.raises(ValueError, match="parameter drift needs "
                                             "theta_star"):
            mod.StreamSimulator(graph, pool, faults=fp, **kw)


# ------------------------------------------ families without an epilogue
@dataclasses.dataclass(frozen=True)
class _RefPlain(RF.IsingFamily):
    name: str = PLAIN

    @property
    def kernel_kind(self):
        return None


@dataclasses.dataclass(frozen=True)
class _PortPlain(TF.IsingFamily):
    name: str = PLAIN

    @property
    def kernel_kind(self):
        return None


@pytest.fixture(scope="module")
def plain_family():
    """An Ising family without a fused-kernel epilogue, registered in both
    packages for this module's tests only."""
    ref, port = RF.register_family(_RefPlain()), TF.register_family(
        _PortPlain())
    yield ref, port
    del RF._REGISTRY[PLAIN], TF._REGISTRY[PLAIN]


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.fixture
def plain_calls(monkeypatch):
    """Counts the Newton statistics' plain version on the fit path."""
    calls = {"n": 0}
    inner = omod.bucket_newton_stats_ref

    def counted(*args, **kwargs):
        calls["n"] += 1
        return inner(*args, **kwargs)

    monkeypatch.setattr(omod, "bucket_newton_stats_ref", counted)
    return calls


def _data64(seed):
    g = RC.grid_graph(3, 3)
    fam = RF.get_family("ising")
    theta = np.asarray(fam.random_params(g, jax.random.PRNGKey(seed)))
    X = fam.exact_sample(g, theta, 257, jax.random.PRNGKey(seed + 1))
    return g, np.asarray(X, dtype=np.float64)


def _plans(g, family, **kw):
    rp = RA.Plan(graph=g, family=family, combiners=ALL_COMBINERS,
                 precision="float64", **kw)
    return rp, plan_from_reference(rp.to_dict())


def test_epilogue_less_fit_matches_reference_float64(plain_family, x64,
                                                     plain_calls):
    g, X = _data64(7)
    rp, tp = _plans(g, PLAIN)
    jr = rp.session().fit(X)
    tr = tp.session(device=CPU).fit(X)
    assert plain_calls["n"] == 0            # the closed-form hooks ran
    for a, b in zip(jr.fits, tr.fits):
        for name in ("theta", "H", "J", "V"):
            np.testing.assert_allclose(getattr(b, name), getattr(a, name),
                                       rtol=0, atol=TOL64,
                                       err_msg=f"node {a.i} {name}")
    for name in ALL_COMBINERS:
        np.testing.assert_allclose(tr.combined[name], jr.combined[name],
                                   rtol=0, atol=TOL64, err_msg=name)
    # the autodiff score and the reference's agree in float32
    np.testing.assert_allclose(tr.score_norm, jr.score_norm, rtol=TOL)
    # the registered Ising family, through the Newton statistics' plain
    # version, gives the same fit
    kr = _plans(g, "ising")[1].session(device=CPU).fit(X)
    assert plain_calls["n"] > 0
    for name in ALL_COMBINERS:
        np.testing.assert_allclose(tr.combined[name], kr.combined[name],
                                   rtol=0, atol=TOL64, err_msg=name)
    np.testing.assert_allclose(tr.score_norm, kr.score_norm, rtol=TOL)


def test_epilogue_less_joint_and_select_match_reference_float64(
        plain_family, x64, plain_calls):
    g, X = _data64(23)
    rp, tp = _plans(g, PLAIN, admm_init="diagonal", admm_iters=6,
                    admm_rho=1.5)
    jr, tr = rp.session().joint(X), tp.session(device=CPU).joint(X)
    np.testing.assert_allclose(tr.trajectory, jr.trajectory, rtol=0,
                               atol=TOL64)
    np.testing.assert_allclose(tr.primal_residual, jr.primal_residual,
                               rtol=0, atol=TOL64)
    spec = RA.StructureSpec(policy="full", n_lambdas=6, admm_rounds=20,
                            vote="weighted")
    rps = rp.replace(structure=spec)
    js = rps.session().select(X)
    ts = plan_from_reference(rps.to_dict()).session(device=CPU).select(X)
    assert ts.support == js.support and ts.support_sizes == js.support_sizes
    assert ts.lambdas.index(ts.lambda_selected) \
        == js.lambdas.index(js.lambda_selected)
    np.testing.assert_allclose(ts.ebic, js.ebic, rtol=TOL64, atol=0)
    for a, b in zip(ts.thetas, js.thetas):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=TOL64)
    assert plain_calls["n"] == 0


def test_epilogue_less_pseudo_score_matches_reference(plain_family,
                                                      grid_setup):
    g, tg, ts, pool = grid_setup
    ref_fam, port_fam = plain_family
    x_pad = np.zeros((512, g.p), dtype=np.float32)
    x_pad[:300] = pool[:300]
    theta = ts + 0.05 * np.random.RandomState(0).randn(ts.size)
    want = RS.pseudo_score(g, theta, x_pad, 300, family=ref_fam)
    got = TS.pseudo_score(tg, theta, torch.tensor(x_pad), 300,
                          family=port_fam)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    fused = TS.pseudo_score(tg, theta, torch.tensor(x_pad), 300,
                            family=TF.ISING)
    np.testing.assert_allclose(got, fused, rtol=0, atol=TOL)


def test_epilogue_less_stream_and_simulate_match_reference(plain_family,
                                                           grid_setup):
    g, tg, ts, pool = grid_setup
    ref_fam, port_fam = plain_family
    ref = RS.StreamSimulator(g, pool, family=ref_fam, theta_star=ts,
                             arrivals=RS.ArrivalSpec(rate=150.0),
                             capacity=64, seed=4)
    port = TS.StreamSimulator(tg, pool, family=port_fam, theta_star=ts,
                              arrivals=TS.ArrivalSpec(rate=150.0),
                              capacity=64, seed=4, device=CPU)
    _assert_results(port.run(3, record_score=True),
                    ref.run(3, record_score=True))
    np.testing.assert_array_equal(port.est.versions, ref.est.versions)
