"""The port's message network, fault plans and streaming simulator against
the JAX reference: identical delivery sequences and counters for the same
seeds, fault-plan schema and validation, and simulator trajectories (every
streamable scheme and streaming ADMM; perfect and lossy networks; crash,
Byzantine, replay; heterogeneous rates; refit cadence; windows) with exact
counters and staleness and theta within 1e-5 at float32. The data keeps
every local H well conditioned (a 4 x 4 grid, at least 150 arrivals per
node and round), where the two packages' fits agree."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.api as RA  # noqa: E402
import repro.core as RC  # noqa: E402
import repro.stream as RS  # noqa: E402
import repro_torch.stream as TS  # noqa: E402
from repro_torch.core import Graph  # noqa: E402
from repro_torch.interop import (fault_plan_from_reference,  # noqa: E402
                                 plan_from_reference,
                                 stream_state_from_reference)

#: float32 on both sides
TOL = 1e-5
CPU = "cpu"
ROUNDS = 6
LOSSY = dict(drop_prob=0.2, delay=1, jitter=2, link_prob=0.8)


@pytest.fixture(scope="module")
def grid_setup():
    g = RC.grid_graph(4, 4)
    m = RC.random_model(g, 0.4, 0.3, jax.random.PRNGKey(0))
    pool = np.asarray(RC.exact_sample(m, 4000, jax.random.PRNGKey(1)))
    return g, Graph(g.p, tuple(g.edges)), np.asarray(m.theta), pool


def _pair(g, tg, pool, network=None, arrivals=None, faults=None, **kw):
    """The same simulator configuration in both packages."""
    arrivals = arrivals or {"kind": "poisson", "rate": 150.0}
    ref = RS.StreamSimulator(
        g, pool, arrivals=RS.ArrivalSpec(**arrivals),
        network=None if network is None else RS.NetworkConfig(**network),
        faults=faults, **kw)
    port = TS.StreamSimulator(
        tg, pool, arrivals=TS.ArrivalSpec(**arrivals),
        network=None if network is None else TS.NetworkConfig(**network),
        faults=(None if faults is None
                else fault_plan_from_reference(faults.to_dict())),
        device=CPU, **kw)
    return ref, port


def _assert_results(got, want, tol=TOL):
    for col in ("rounds", "samples_seen", "samples_total", "scalars_sent",
                "staleness"):
        np.testing.assert_array_equal(getattr(got, col), getattr(want, col),
                                      err_msg=col)
    np.testing.assert_allclose(got.theta, want.theta, rtol=0, atol=tol)
    np.testing.assert_allclose(got.initial, want.initial, rtol=0, atol=tol)
    if want.err is not None:
        np.testing.assert_allclose(got.err, want.err, rtol=0, atol=tol)
    assert got.telemetry is None


# --------------------------------------------------------------- network
@pytest.mark.parametrize("config", [
    dict(drop_prob=0.3, seed=4), dict(delay=2, seed=4),
    dict(jitter=3, seed=4), dict(link_prob=0.5, seed=4),
    dict(drop_prob=0.2, delay=1, jitter=2, link_prob=0.7),
])
def test_network_delivers_the_reference_sequence(config):
    links = [(0, 1), (1, 0), (1, 2), (2, 1), (2, 3), (3, 2)]
    nets = [RS.Network(links, RS.NetworkConfig(**config),
                       rng=np.random.RandomState(9)),
            TS.Network(links, TS.NetworkConfig(**config),
                       rng=np.random.RandomState(9))]
    logs = []
    for net in nets:
        log = []
        for rnd in range(15):
            for (i, j) in links:
                if net.link_active(rnd, i, j):
                    net.send(rnd, i, j, (rnd, i, j), 1 + (i + j) % 3,
                             extra_delay=rnd % 2)
            log += [(rnd, m.src, m.dst, m.payload, m.n_scalars, m.created)
                    for m in net.deliver(rnd)]
        logs.append((log, net.counters_dict(), net.in_flight,
                     net.scalars_in_flight))
    assert logs[0] == logs[1] and logs[0][0]


def test_rng_state_round_trips_through_json():
    rng = np.random.RandomState(3)
    rng.randn(7)
    state = RS.network.rng_state_to_json(rng)
    assert TS.network.rng_state_to_json(rng) == state
    other = np.random.RandomState(0)
    TS.network.rng_state_from_json(other, state)
    assert np.array_equal(other.rand(5), rng.rand(5))


# ---------------------------------------------------------------- faults
def _full_fault_plan(mod):
    return mod.FaultPlan(
        crashes=(mod.CrashSpec(node=2, at=3, restart_at=6),
                 mod.CrashSpec(node=4, at=1)),
        byzantine=(mod.ByzantineSpec(node=5, kind="scaled_noise", scale=2.5),
                   mod.ByzantineSpec(node=1, kind="fixed_value", value=-1.0)),
        replay=mod.ReplaySpec(prob=0.25, delay=4),
        drift=(mod.DriftSpec(at=7, scale=0.4),))


def test_fault_plan_round_trips_with_the_reference():
    ref = _full_fault_plan(RS)
    port = fault_plan_from_reference(ref.to_dict())
    assert port == _full_fault_plan(TS) and hash(port) == hash(
        _full_fault_plan(TS))
    assert port.to_dict() == ref.to_dict()
    assert RS.FaultPlan.from_dict(port.to_dict()) == ref
    assert TS.FaultPlan().empty and not port.empty
    assert port.crashed(2, 4) and not port.crashed(2, 6)
    assert port.byzantine_for(5, 0).kind == "scaled_noise"
    assert port.drift_at(7) == TS.DriftSpec(at=7, scale=0.4)
    assert TS.BYZANTINE_KINDS == RS.BYZANTINE_KINDS


@pytest.mark.parametrize("make,match", [
    (lambda S: S.ByzantineSpec(node=1, kind="gaslight"), "sign_flip"),
    (lambda S: S.ByzantineSpec(node=-1), ">= 0"),
    (lambda S: S.ByzantineSpec(node=1, scale=float("nan")), "finite"),
    (lambda S: S.ByzantineSpec(node=1, value=float("inf")), "finite"),
    (lambda S: S.ByzantineSpec(node=1, start=-1), ">= 0"),
    (lambda S: S.CrashSpec(node=0, at=-1), ">= 0"),
    (lambda S: S.CrashSpec(node=0, at=5, restart_at=5), "strictly after"),
    (lambda S: S.CrashSpec(node=-2, at=0), ">= 0"),
    (lambda S: S.ReplaySpec(prob=1.5), r"\[0, 1\]"),
    (lambda S: S.ReplaySpec(prob=0.5, delay=0), ">= 1"),
    (lambda S: S.DriftSpec(at=-3), ">= 0"),
    (lambda S: S.DriftSpec(at=2, scale=float("inf")), "finite"),
])
def test_fault_validation_mirrors_reference(make, match):
    for mod in (RS, TS):
        with pytest.raises(ValueError, match=match):
            make(mod)


def test_fault_plan_type_checks_and_off_graph_nodes(grid_setup):
    g, tg, _, pool = grid_setup
    with pytest.raises(TypeError, match="CrashSpec"):
        TS.FaultPlan(crashes=(RS.CrashSpec(node=0, at=1),))
    with pytest.raises(TypeError, match="ReplaySpec"):
        TS.FaultPlan(replay=0.5)
    with pytest.raises(TypeError, match="FaultPlan"):
        TS.StreamSimulator(tg, pool, faults={"crashes": []}, device=CPU)
    fp = TS.FaultPlan(crashes=(TS.CrashSpec(node=g.p, at=0),))
    with pytest.raises(ValueError, match="nodes"):
        TS.StreamSimulator(tg, pool, faults=fp, device=CPU)


# ------------------------------------------------------------- simulator
@pytest.mark.parametrize("scheme", RS.ONE_STEP_SCHEMES + ("admm",))
def test_perfect_network_matches_reference(grid_setup, scheme):
    g, tg, ts, pool = grid_setup
    estimator = "admm" if scheme == "admm" else "one_step"
    ref, port = _pair(g, tg, pool, estimator=estimator,
                      scheme="diagonal" if scheme == "admm" else scheme,
                      theta_star=ts, capacity=64, seed=3)
    _assert_results(port.run(ROUNDS), ref.run(ROUNDS))
    assert TS.ONE_STEP_SCHEMES == RS.ONE_STEP_SCHEMES


def test_perfect_network_equals_global_combine(grid_setup):
    g, tg, ts, pool = grid_setup
    _, port = _pair(g, tg, pool, theta_star=ts, capacity=128,
                    arrivals={"rate": 150.0})
    res = port.run(4)
    n = int(res.samples_seen[-1])
    plan = plan_from_reference(RA.Plan(graph=g).to_dict())
    want = plan.session(device=CPU).fit(pool[:n]).theta
    np.testing.assert_allclose(res.theta[-1], want, rtol=0, atol=TOL)
    assert res.err[-1] < res.err[0]


@pytest.mark.parametrize("estimator", ["one_step", "admm"])
def test_lossy_network_matches_reference(grid_setup, estimator):
    g, tg, ts, pool = grid_setup
    ref, port = _pair(g, tg, pool, network=LOSSY, estimator=estimator,
                      theta_star=ts, capacity=64, seed=5)
    got, want = port.run(ROUNDS), ref.run(ROUNDS)
    _assert_results(got, want)
    assert port.net.counters_dict() == ref.net.counters_dict()
    assert np.all(got.staleness >= 0.0) and got.staleness.max() > 0.0


@pytest.mark.parametrize("estimator", ["one_step", "admm"])
@pytest.mark.parametrize("kind", RS.BYZANTINE_KINDS)
def test_faults_match_reference(grid_setup, kind, estimator):
    g, tg, ts, pool = grid_setup
    fp = RS.FaultPlan(
        crashes=(RS.CrashSpec(node=3, at=1, restart_at=4),
                 RS.CrashSpec(node=9, at=3)),
        byzantine=(RS.ByzantineSpec(node=5, kind=kind, start=1),),
        replay=RS.ReplaySpec(prob=0.5, delay=2))
    scheme = "trimmed_mean" if estimator == "one_step" else "diagonal"
    ref, port = _pair(g, tg, pool, network=LOSSY, faults=fp,
                      estimator=estimator, scheme=scheme, theta_star=ts,
                      capacity=64, seed=7)
    _assert_results(port.run(ROUNDS), ref.run(ROUNDS))
    assert port.net.counters_dict() == ref.net.counters_dict()


def test_heterogeneous_rates_and_refit_cadence_match_reference(grid_setup):
    g, tg, ts, pool = grid_setup
    rates = tuple(150.0 + 40.0 * (i % 4) for i in range(g.p))
    ref, port = _pair(g, tg, pool, arrivals={"rate": rates}, theta_star=ts,
                      refit_every=2, capacity=64, seed=2)
    got, want = port.run(ROUNDS, record_every=2), ref.run(ROUNDS,
                                                          record_every=2)
    _assert_results(got, want)
    np.testing.assert_array_equal(port.est.counts, ref.est.counts)
    np.testing.assert_array_equal(port.est.versions, ref.est.versions)


@pytest.mark.parametrize("estimator", ["one_step", "admm"])
def test_window_and_discount_match_reference(grid_setup, estimator):
    g, tg, ts, pool = grid_setup
    ref, port = _pair(g, tg, pool, arrivals={"rate": 160.0},
                      estimator=estimator, window=400, discount=0.995,
                      theta_star=ts, capacity=64, seed=1)
    _assert_results(port.run(ROUNDS), ref.run(ROUNDS))


def test_score_recording_and_any_time_queries(grid_setup):
    g, tg, ts, pool = grid_setup
    ref, port = _pair(g, tg, pool, theta_star=ts, capacity=64, seed=4)
    got = port.run(4, record_score=True)
    want = ref.run(4, record_score=True)
    np.testing.assert_allclose(got.score_norm, want.score_norm, rtol=TOL)
    for metric in ("err", "score_norm", "scalars_sent", "staleness"):
        r, v = got.timeline(metric)
        np.testing.assert_array_equal(r, want.timeline(metric)[0])
    with pytest.raises(KeyError, match="unknown"):
        got.timeline("nope")
    for t in (-1, 0, 2, 3, 10):
        np.testing.assert_allclose(got.estimate_at(t), want.estimate_at(t),
                                   rtol=0, atol=TOL)
    assert np.array_equal(got.estimate_at(-1), port.theta_fixed)


@pytest.mark.parametrize("estimator", ["one_step", "admm"])
def test_reference_state_resumes_in_the_port(grid_setup, estimator):
    """A reference state taken at round 4 and resumed in the port follows
    the reference's uninterrupted trajectory."""
    g, tg, ts, pool = grid_setup
    kw = dict(network=LOSSY, estimator=estimator, theta_star=ts,
              capacity=64, seed=11,
              faults=RS.FaultPlan(replay=RS.ReplaySpec(prob=0.5, delay=2)))
    ref, port = _pair(g, tg, pool, **kw)
    ref.run(4)
    stream_state_from_reference(*ref.state_dict(), port)
    assert port.round == 4
    _assert_results(port.run(3), ref.run(3))
    assert port.net.counters_dict() == ref.net.counters_dict()


@pytest.mark.parametrize("estimator", ["one_step", "admm"])
def test_own_save_load_resume_is_exact(grid_setup, estimator):
    g, tg, ts, pool = grid_setup
    _, a = _pair(g, tg, pool, network=LOSSY, estimator=estimator,
                 theta_star=ts, capacity=64, seed=6)
    _, b = _pair(g, tg, pool, network=LOSSY, estimator=estimator,
                 theta_star=ts, capacity=64, seed=6)
    full = a.run(7)
    b.run(4)
    _, c = _pair(g, tg, pool, network=LOSSY, estimator=estimator,
                 theta_star=ts, capacity=64, seed=6)
    c.load_state(*b.state_dict())
    rest = c.run(3)
    np.testing.assert_array_equal(rest.theta, full.theta[4:])
    np.testing.assert_array_equal(rest.scalars_sent, full.scalars_sent[4:])
    with pytest.raises(ValueError, match="checkpoint"):
        _, d = _pair(g, tg, pool, estimator="one_step", scheme="max",
                     capacity=64)
        d.load_state(*b.state_dict())


def test_session_simulate_carries_the_plan(grid_setup):
    g, tg, ts, pool = grid_setup
    fp = RS.FaultPlan(byzantine=(RS.ByzantineSpec(node=5),),
                      replay=RS.ReplaySpec(prob=0.1, delay=2))
    rp = RA.Plan(graph=g, combiners=("optimal", "trimmed_mean"), faults=fp,
                 stream_window=640, stream_discount=0.999, capacity=128)
    tp = plan_from_reference(rp.to_dict())
    assert tp.to_dict() == rp.to_dict()
    again = type(tp).from_dict(tp.to_dict())
    assert again == tp and hash(again) == hash(tp)
    ref = rp.session().simulate(pool, theta_star=ts, seed=2,
                                arrivals=RS.ArrivalSpec(rate=150.0))
    port = tp.session(device=CPU).simulate(
        pool, theta_star=ts, seed=2, arrivals=TS.ArrivalSpec(rate=150.0))
    assert port.faults == fault_plan_from_reference(fp.to_dict())
    assert (port.scheme, port.est.window, port.est.discount) == (
        "trimmed_mean", 640, 0.999)
    assert port.est.device.type == CPU and port.pool.dtype == torch.float32
    _assert_results(port.run(4), ref.run(4))
    admm = TS.StreamSimulator.from_plan(tp.replace(faults=None), pool,
                                        estimator="admm", device=CPU)
    assert admm.newton_iters == tp.admm_newton_iters
    with pytest.raises(ValueError, match="streamable"):
        TS.StreamSimulator.from_plan(tp.replace(combiners=("optimal",)),
                                     pool, device=CPU)
    with pytest.raises(ValueError, match="streaming scheme"):
        TS.StreamSimulator(tg, pool, scheme="optimal", device=CPU)
    with pytest.raises(ValueError, match="estimator"):
        TS.StreamSimulator(tg, pool, estimator="gossip", device=CPU)

