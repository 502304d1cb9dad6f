"""Durable stream checkpoints of the port (``repro_torch.checkpoint``): a
fleet killed mid-stream and restored in a fresh simulator reproduces the
uninterrupted ``estimate_at(t)`` trajectory and communication counters
within 1e-10 (rtol 0), through a hostile scenario with crash, Byzantine,
replay and drift faults at once; and a directory written by the
reference's ``save_stream`` resumes in the port within 1e-5 at float32."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.checkpoint as RCK  # noqa: E402
import repro.core as RC  # noqa: E402
import repro.stream as RS  # noqa: E402
import repro_torch.checkpoint as CK  # noqa: E402
import repro_torch.stream as S  # noqa: E402
from repro_torch.core import Graph  # noqa: E402
from repro_torch.interop import stream_state_from_reference  # noqa: E402

#: float32 on both sides
TOL = 1e-5
CPU = "cpu"


@pytest.fixture(scope="module")
def setup():
    g = RC.star_graph(6)
    m = RC.random_model(g, 0.5, 0.4, jax.random.PRNGKey(2))
    pool = np.asarray(RC.exact_sample(m, 900, jax.random.PRNGKey(3)))
    return Graph(g.p, tuple(g.edges)), np.asarray(m.theta), pool


def _hostile():
    return S.FaultPlan(
        crashes=(S.CrashSpec(node=2, at=3, restart_at=8),),
        byzantine=(S.ByzantineSpec(node=5, kind="scaled_noise",
                                   scale=1.0),),
        replay=S.ReplaySpec(prob=0.4, delay=2),
        drift=(S.DriftSpec(at=7, scale=0.3),))


def _mk(g, pool, ts, **over):
    kw = dict(scheme="diagonal", theta_star=ts,
              network=S.NetworkConfig(drop_prob=0.4, delay=1, jitter=1),
              arrivals=S.ArrivalSpec(kind="poisson", rate=30.0),
              capacity=128, seed=11, faults=_hostile(), window=400,
              device=CPU)
    kw.update(over)
    return S.StreamSimulator(g, pool, **kw)


def test_kill_restore_reproduces_trajectory_to_1e10(setup, tmp_path):
    """Save at round 6, before the change-point at 7; restore into a fresh
    simulator (state only from disk) and run on: every estimate_at(t),
    error value and counter matches the uninterrupted run to 1e-10."""
    g, ts, pool = setup
    full = _mk(g, pool, ts)
    res_full = full.run(12)

    part = _mk(g, pool, ts)
    part.run(6)
    path = CK.save_stream(str(tmp_path), 6, part)
    assert CK.latest_step(str(tmp_path)) == 6

    fresh = _mk(g, pool, ts)
    CK.restore_stream(str(tmp_path), fresh)
    res2 = fresh.run(6)

    for t in range(7, 13):
        np.testing.assert_allclose(res2.estimate_at(t),
                                   res_full.estimate_at(t),
                                   atol=1e-10, rtol=0)
    np.testing.assert_allclose(res2.err, res_full.err[6:], atol=1e-10,
                               rtol=0)
    assert fresh.net.scalars_sent == full.net.scalars_sent
    assert fresh.net.msgs_delivered == full.net.msgs_delivered
    assert fresh.net.scalars_dropped == full.net.scalars_dropped
    np.testing.assert_array_equal(fresh.theta_star, full.theta_star)
    assert path.endswith("step_6")


def test_restore_continues_replayed_and_inflight_messages(setup, tmp_path):
    """Checkpoint with messages still in flight (delay + jitter): the queue
    survives the round trip and conservation holds after restore."""
    g, ts, pool = setup
    net = S.NetworkConfig(delay=2, jitter=2)
    part = _mk(g, pool, ts, network=net)
    part.run(5)
    assert part.net.in_flight > 0          # the premise: owed messages
    CK.save_stream(str(tmp_path), 5, part)
    fresh = _mk(g, pool, ts, network=net)
    CK.restore_stream(str(tmp_path), fresh)
    assert fresh.net.in_flight == part.net.in_flight
    fresh.run(5)
    net = fresh.net
    assert net.scalars_sent == (net.scalars_delivered + net.scalars_dropped
                                + net.scalars_in_flight)


def test_restore_rejects_mismatched_configuration(setup, tmp_path):
    g, ts, pool = setup
    part = _mk(g, pool, ts)
    part.run(3)
    CK.save_stream(str(tmp_path), 3, part)
    other = _mk(g, pool, ts, scheme="uniform")
    with pytest.raises(ValueError, match="diagonal"):
        CK.restore_stream(str(tmp_path), other)


def test_load_state_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        CK.load_state(str(tmp_path / "nope"))
    assert CK.latest_step(str(tmp_path / "nope")) is None


def test_admm_stream_checkpoint_round_trip(setup, tmp_path):
    """The streaming-ADMM mode checkpoints its primal, dual and consensus
    state too."""
    g, ts, pool = setup

    def mk():
        return S.StreamSimulator(g, pool, estimator="admm", theta_star=ts,
                                 arrivals=S.ArrivalSpec(rate=50.0),
                                 capacity=128, newton_iters=8, seed=5,
                                 device=CPU)
    full = mk()
    res_full = full.run(8)
    part = mk()
    part.run(4)
    CK.save_stream(str(tmp_path), 4, part)
    fresh = CK.restore_stream(str(tmp_path), mk())
    res2 = fresh.run(4)
    np.testing.assert_allclose(res2.theta[-1], res_full.theta[-1],
                               atol=1e-10, rtol=0)


def test_generic_state_round_trip_preserves_json_floats(tmp_path):
    """save_state/load_state: arrays exact, meta floats repr-round-trip,
    and the reference reads what the port wrote."""
    arrays = {"a/x": np.arange(6, dtype=np.float32).reshape(2, 3),
              "b": np.array([1.1e-300, np.pi])}
    meta = {"f": 0.1 + 0.2, "nested": {"k": [1, 2.5]}}
    CK.save_state(str(tmp_path), 0, arrays, meta)
    for load in (CK.load_state, RCK.load_state):
        arrays2, meta2 = load(str(tmp_path), 0)
        for k in arrays:
            np.testing.assert_array_equal(arrays2[k], arrays[k])
            assert arrays2[k].dtype == arrays[k].dtype
        assert meta2["f"] == 0.1 + 0.2
        assert meta2["nested"]["k"][1] == 2.5


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """A directory the reference's save_stream wrote at round 4 loads with
    the port's load_state and resumes in a port simulator through
    stream_state_from_reference, following the reference's uninterrupted
    run (the 4 x 4 grid of the simulator parity tests, where local fits
    are well conditioned)."""
    g = RC.grid_graph(4, 4)
    m = RC.random_model(g, 0.4, 0.3, jax.random.PRNGKey(0))
    pool = np.asarray(RC.exact_sample(m, 4000, jax.random.PRNGKey(1)))
    ts = np.asarray(m.theta)
    kw = dict(theta_star=ts, capacity=64, seed=11,
              faults=RS.FaultPlan(replay=RS.ReplaySpec(prob=0.5, delay=2)))
    lossy = dict(drop_prob=0.2, delay=1, jitter=2, link_prob=0.8)
    ref = RS.StreamSimulator(g, pool, arrivals=RS.ArrivalSpec(rate=150.0),
                             network=RS.NetworkConfig(**lossy), **kw)
    ref.run(4)
    RCK.save_stream(str(tmp_path), 4, ref)
    port = S.StreamSimulator(
        Graph(g.p, tuple(g.edges)), pool,
        arrivals=S.ArrivalSpec(rate=150.0),
        network=S.NetworkConfig(**lossy), device=CPU,
        **dict(kw, faults=S.FaultPlan(replay=S.ReplaySpec(prob=0.5,
                                                          delay=2))))
    stream_state_from_reference(*CK.load_state(str(tmp_path)), port)
    assert port.round == 4
    got, want = port.run(3), ref.run(3)
    np.testing.assert_array_equal(got.scalars_sent, want.scalars_sent)
    np.testing.assert_array_equal(got.staleness, want.staleness)
    np.testing.assert_allclose(got.theta, want.theta, rtol=0, atol=TOL)
    np.testing.assert_allclose(got.err, want.err, rtol=0, atol=TOL)
    assert port.net.counters_dict() == ref.net.counters_dict()
