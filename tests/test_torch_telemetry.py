"""The port's telemetry against the reference's: the recorder contract case
for case with tests/telemetry/test_recorder.py, off equals on bitwise for
every verb, span paths and counts, counter and gauge names on the
reference's chain_graph(6), n = 400 fixture (tests/telemetry/
test_integration.py), JSONL replay of the network ledger on the port's
hostile simulator and on a log the reference wrote, and the spec and plan
round trips through the reference's dicts."""
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.api as RA  # noqa: E402
import repro.telemetry as RT  # noqa: E402
import repro_torch.api as TA  # noqa: E402
import repro_torch.stream as TS  # noqa: E402
import repro_torch.telemetry as TT  # noqa: E402
from repro.core.families import ISING  # noqa: E402
from repro.core.graphs import chain_graph, star_graph  # noqa: E402
from repro.stream import faults as rfaults  # noqa: E402
from repro.stream.network import NetworkConfig as RNetworkConfig  # noqa: E402
from repro.stream.simulator import ArrivalSpec as RArrivalSpec  # noqa: E402
from repro.stream.simulator import StreamSimulator as RSim  # noqa: E402
from repro_torch.core import Graph  # noqa: E402
from repro_torch.interop import plan_from_reference  # noqa: E402
from repro_torch.telemetry.recorder import _ACTIVE, _NULL_SPAN  # noqa: E402


@pytest.fixture(scope="module")
def chain_data():
    g = chain_graph(6)
    theta = np.full(ISING.n_params(g), 0.25)
    X = np.array(ISING.exact_sample(g, theta, 400, jax.random.PRNGKey(1)))
    return g, Graph(g.p, g.edges), X


@pytest.fixture(scope="module")
def star_pool():
    g = star_graph(5)
    theta_star = np.full(ISING.n_params(g), 0.3)
    pool = np.array(ISING.exact_sample(g, theta_star, 400,
                                       jax.random.PRNGKey(2)))
    return g, Graph(g.p, g.edges), theta_star, pool


def _spans(snap):
    return {path: agg["count"] for path, agg in snap.spans.items()}


def _shapes(snap):
    """(kind, name, tag keys) of every event: what a log's reader keys on."""
    return {(e["kind"], e["name"], tuple(sorted((e.get("tags") or {}))))
            for e in snap.events}


# ------------------------------------------------------ recorder contract
def test_null_recorder_is_allocation_free():
    nr = TT.NULL_RECORDER
    assert nr.enabled is False
    s1 = nr.span("fit", tag=1)
    s2 = nr.span("anything")
    assert s1 is s2 is _NULL_SPAN
    with s1:
        pass
    nr.inc("c", 3)
    nr.gauge("g", 1.0)
    nr.observe("h", 2.0)
    nr.point("m", 0, 1.0)
    assert nr.mark() == 0
    assert nr.snapshot() is None


def test_null_span_not_active_for_kernel_trace():
    with TT.NULL_RECORDER.span("fit"):
        assert not _ACTIVE
        TT.record_kernel_trace("kernel.x", shape=(1,))


def test_span_paths_nest_and_aggregate():
    rec = TT.Recorder(TT.TelemetrySpec())
    with rec.span("fit"):
        with rec.span("bucket_solve", deg_pad=3):
            pass
        with rec.span("bucket_solve", deg_pad=5):
            pass
        with rec.span("combine", scheme="uniform"):
            pass
    snap = rec.snapshot()
    assert set(snap.spans) == {"fit", "fit/bucket_solve", "fit/combine"}
    assert snap.spans["fit/bucket_solve"]["count"] == 2
    assert snap.spans["fit"]["count"] == 1
    assert snap.spans["fit"]["total_s"] >= \
        snap.spans["fit/bucket_solve"]["total_s"]
    assert not rec._stack and not _ACTIVE


def test_span_pops_itself_when_its_body_raises():
    rec = TT.Recorder(TT.TelemetrySpec())
    with pytest.raises(RuntimeError, match="body"):
        with rec.span("fit"):
            with rec.span("bucket_solve"):
                raise RuntimeError("body")
    assert not rec._stack and not _ACTIVE
    assert _spans(rec.snapshot()) == {"fit": 1, "fit/bucket_solve": 1}


class _FailingSink:
    def write(self, ev):
        raise OSError("disk full")


def test_span_that_fails_to_open_leaves_no_stack(tmp_path):
    """A span whose start event cannot be written never opens: the stacks
    and the profiler are as before, and later spans still trace."""
    rec = TT.Recorder(TT.TelemetrySpec(profile_dir=str(tmp_path / "prof")))
    rec._sink = _FailingSink()
    with pytest.raises(OSError, match="disk full"):
        rec.span("fit")
    assert not rec._stack and not _ACTIVE and rec._prof is None
    assert not TT.recorder.tracing_active()
    rec._sink = None
    with rec.span("fit"):
        assert TT.recorder.tracing_active()
    assert not rec._stack and not _ACTIVE
    assert len(list((tmp_path / "prof").glob("*.pt.trace.json"))) == 1


def test_open_span_receives_kernel_trace_events():
    rec = TT.Recorder(TT.TelemetrySpec())
    with rec.span("fit"):
        TT.record_kernel_trace("kernel.test", kind="ising", shape=(2, 3))
    ev = [e for e in rec.events if e["kind"] == "event"]
    assert len(ev) == 1
    assert ev[0]["name"] == "kernel.test"
    assert ev[0]["tags"] == {"kind": "ising", "shape": (2, 3)}
    TT.record_kernel_trace("kernel.after")            # no open span: dropped
    assert len([e for e in rec.events if e["kind"] == "event"]) == 1


def test_kernel_tags_keep_the_first_dispatch_per_recorder():
    """The port tags the first dispatch of each (name, tags) under a
    recorder, where the reference tags once per compiled shape."""
    rec, other = TT.Recorder(), TT.Recorder()
    for r in (rec, rec, other):
        with r.span("fit"):
            TT.record_kernel_trace("kernel.k", backend="ref", shape=(2, 3))
            TT.record_kernel_trace("kernel.k", backend="ref", shape=(4, 3))
            TT.record_kernel_trace("kernel.k", backend="ref", shape=(2, 3))
    assert [e["tags"]["shape"] for e in rec.events
            if e["kind"] == "event"] == [(2, 3), (4, 3)]
    assert len([e for e in other.events if e["kind"] == "event"]) == 2


def test_spans_disabled_by_spec():
    rec = TT.Recorder(TT.TelemetrySpec(spans=False))
    assert rec.span("fit") is _NULL_SPAN
    rec.inc("c", 1)
    assert rec.snapshot().counters == {"c": 1}


def test_metrics_disabled_by_spec():
    rec = TT.Recorder(TT.TelemetrySpec(metrics=False))
    rec.inc("c", 1)
    rec.gauge("g", 2.0)
    rec.point("m", 0, 3.0)
    snap = rec.snapshot()
    assert not snap.counters and not snap.gauges and not snap.points
    with rec.span("fit"):
        pass
    assert rec.snapshot().spans["fit"]["count"] == 1


def test_metrics_aggregate():
    rec = TT.Recorder(TT.TelemetrySpec())
    rec.inc("net.send", 5)
    rec.inc("net.send", 7, src=0, dst=1)
    rec.gauge("buf", 3)
    rec.gauge("buf", 9)
    rec.observe("lat", 0.5)
    rec.observe("lat", 1.5)
    rec.point("err", 1, 10.0)
    rec.point("err", 2, 4.0)
    snap = rec.snapshot()
    assert snap.counters["net.send"] == 12
    assert snap.counter("net.send", src=0) == 7
    assert snap.gauges["buf"] == 9
    assert snap.histograms["lat"] == [0.5, 1.5]
    rounds, vals = snap.timeline("err")
    np.testing.assert_array_equal(rounds, [1, 2])
    np.testing.assert_array_equal(vals, [10.0, 4.0])
    with pytest.raises(KeyError, match="err"):
        snap.timeline("nope")


def test_mark_scopes_snapshot():
    rec = TT.Recorder(TT.TelemetrySpec())
    rec.inc("a", 1)
    mark = rec.mark()
    rec.inc("a", 10)
    assert rec.snapshot(mark).counters == {"a": 10}
    assert rec.snapshot().counters == {"a": 11}


def test_jsonl_sink_round_trips_events(tmp_path):
    path = os.path.join(tmp_path, "sub", "trace.jsonl")
    rec = TT.Recorder(TT.TelemetrySpec(jsonl=path))
    with rec.span("fit", n=400):
        rec.inc("net.send", 3, src=0, dst=1)
        rec.gauge("buf", np.int64(7))
    rec.flush()
    logged = TT.read_jsonl(path)
    assert len(logged) == len(rec.events)
    for disk, mem in zip(logged, rec.events):
        assert (disk["seq"], disk["kind"], disk["name"]) == \
            (mem["seq"], mem["kind"], mem["name"])
    assert RT.read_jsonl(path) == logged            # the reference reads it
    with open(path) as f:
        for line in f:
            json.loads(line)


def test_make_recorder_dispatch():
    assert TT.make_recorder(None) is TT.NULL_RECORDER
    assert TT.make_recorder(False) is TT.NULL_RECORDER
    live = TT.Recorder(TT.TelemetrySpec())
    assert TT.make_recorder(live) is live
    assert TT.make_recorder(TT.NULL_RECORDER) is TT.NULL_RECORDER
    assert isinstance(TT.make_recorder(TT.TelemetrySpec()), TT.Recorder)
    from_dict = TT.make_recorder({"spans": False, "metrics": True,
                                  "jsonl": None, "profile_dir": None})
    assert isinstance(from_dict, TT.Recorder)
    assert from_dict.spec.spans is False
    with pytest.raises(TypeError, match="TelemetrySpec"):
        TT.make_recorder(42)


def test_spec_round_trip_and_validation():
    spec = TT.TelemetrySpec(spans=True, metrics=False, jsonl="/tmp/x.jsonl")
    assert TT.TelemetrySpec.from_dict(spec.to_dict()) == spec
    ref = RT.TelemetrySpec(spans=True, metrics=False, jsonl="/tmp/x.jsonl")
    assert spec.to_dict() == ref.to_dict()
    assert TT.TelemetrySpec.from_dict(ref.to_dict()) == spec
    for bad in (dict(jsonl=7), dict(profile_dir=3.5)):
        with pytest.raises(TypeError) as got:
            TT.TelemetrySpec(**bad)
        with pytest.raises(TypeError) as want:
            RT.TelemetrySpec(**bad)
        assert str(got.value) == str(want.value)
    assert TT.__all__ == RT.__all__


def test_null_recorder_span_is_cheap():
    t0 = time.perf_counter()
    for _ in range(100_000):
        with TT.NULL_RECORDER.span("hot"):
            TT.NULL_RECORDER.inc("c")
    assert time.perf_counter() - t0 < 2.0


def test_profile_dir_writes_one_trace_per_outermost_span(tmp_path):
    rec = TT.Recorder(TT.TelemetrySpec(profile_dir=str(tmp_path / "prof")))
    with rec.span("fit"):
        with rec.span("inner"):
            torch.ones(8).sum()
    traces = os.listdir(tmp_path / "prof")
    assert len(traces) == 1 and traces[0].endswith(".pt.trace.json")
    with open(tmp_path / "prof" / traces[0]) as f:
        assert "traceEvents" in json.load(f)


# ------------------------------------------------------- session verbs
def _plan(g, **kw):
    return TA.Plan(graph=g, combiners=("uniform", "diagonal"), **kw)


def test_every_verb_bitwise_equal_with_telemetry_on(chain_data, tmp_path):
    """The recorder only reads: fit, joint, select, stream and simulate
    give bitwise the same outputs with telemetry on and off."""
    _, g, X = chain_data
    spec = TA.TelemetrySpec(jsonl=str(tmp_path / "verbs.jsonl"))
    off = _plan(g).session(device="cpu")
    on = _plan(g, telemetry=spec).session(device="cpu")
    for verb in ("fit", "joint"):
        a, b = getattr(off, verb)(X), getattr(on, verb)(X)
        assert a.telemetry is None and b.telemetry is not None
        assert a.score_norm == b.score_norm
        for k in a.combined:
            np.testing.assert_array_equal(a.combined[k], b.combined[k])
        for fa, fb in zip(a.fits, b.fits):
            np.testing.assert_array_equal(fa.theta, fb.theta)
            np.testing.assert_array_equal(fa.V, fb.V)
    spec_s = {"n_lambdas": 4, "admm_rounds": 10}
    a, b = off.select(X, spec=spec_s), on.select(X, spec=spec_s)
    assert a.support == b.support and a.telemetry is None
    np.testing.assert_array_equal(a.ebic, b.ebic)
    for ta, tb in zip(a.thetas, b.thetas):
        np.testing.assert_array_equal(ta, tb)
    ests = [s.stream(capacity=64) for s in (off, on)]
    for est in ests:
        est.ingest(X[:150])
        est.refit()
        est.ingest(X[150:])
        est.refit()
    for fa, fb in zip(*(e.fits for e in ests)):
        np.testing.assert_array_equal(fa.theta, fb.theta)
    assert "refit/bucket_solve" in _spans(on.recorder.snapshot())
    for estimator in ("one_step", "admm"):
        ra, rb = (s.simulate(np.tile(X, (3, 1)), estimator=estimator,
                             theta_star=np.zeros(g.n_params), seed=4,
                             network=TS.NetworkConfig(drop_prob=0.3,
                                                      delay=1)).run(4)
                  for s in (off, on))
        np.testing.assert_array_equal(ra.theta, rb.theta)
        np.testing.assert_array_equal(ra.err, rb.err)
        np.testing.assert_array_equal(ra.scalars_sent, rb.scalars_sent)
        assert ra.telemetry is None and rb.telemetry is not None


def test_verb_spans_gauges_and_tags_equal_the_reference(chain_data):
    """A fresh session's fit, then joint and select, on the reference's
    fixture: the same span paths and counts, gauges, histogram names and
    event names and tag keys as the reference. Kernel tags carry the
    resolved path (``ref`` on the CPU, ``tiled`` in the reference); the
    reference tags each compiled program once, so its joint and select
    re-tag shapes the port's recorder has already seen."""
    from repro.core.batched import clear_bucket_solver_caches
    from repro_torch.kernels.cl.ops import KERNEL_PATHS
    rg, g, X = chain_data
    clear_bucket_solver_caches()
    rsess = RA.Plan(graph=rg, combiners=("uniform", "diagonal"),
                    telemetry=RT.TelemetrySpec()).session()
    tsess = _plan(g, telemetry=TA.TelemetrySpec()).session(device="cpu")
    for verb in ("fit", "joint", "select"):
        want = getattr(rsess, verb)(X).telemetry
        got = getattr(tsess, verb)(X).telemetry
        assert _spans(got) == _spans(want), verb
        assert got.gauges == want.gauges
        assert sorted(got.histograms) == sorted(want.histograms)
        assert {k: len(v) for k, v in got.histograms.items()
                if k != "engine.newton_iters"} == \
            {k: len(v) for k, v in want.histograms.items()
             if k != "engine.newton_iters"}
        assert _shapes(got) <= _shapes(want)
        kernels = [e for e in got.events if e["kind"] == "event"]
        if verb == "fit":
            assert _shapes(got) == _shapes(want)
            rk = [e for e in want.events if e["kind"] == "event"]
            assert [(e["name"], e["tags"]["shape"]) for e in kernels] == \
                [(e["name"], e["tags"]["shape"]) for e in rk]
        assert all(e["tags"]["backend"] == "ref" in KERNEL_PATHS
                   for e in kernels)
    assert got.spans["select"]["new_compiles"] == 0
    warm = tsess.fit(X[::-1].copy()).telemetry
    assert not [e for e in warm.events if e["kind"] == "event"]


def test_plans_round_trip_the_reference_dicts(chain_data):
    rg, g, _ = chain_data
    for spec in (RT.TelemetrySpec(),
                 RT.TelemetrySpec(metrics=False, jsonl="/tmp/t.jsonl",
                                  profile_dir="/tmp/prof")):
        rplan = RA.Plan(graph=rg, combiners=("uniform",), telemetry=spec)
        d = rplan.to_dict()
        tplan = plan_from_reference(d)
        assert tplan.telemetry == TA.TelemetrySpec.from_dict(spec.to_dict())
        assert tplan.to_dict() == d
        assert TA.Plan.from_dict(tplan.to_dict()) == tplan
        assert hash(tplan) == hash(plan_from_reference(d))
        assert tplan.session(device="cpu") is \
            plan_from_reference(d).session(device="cpu")
    with pytest.raises(TypeError, match="telemetry"):
        TA.Plan(graph=g, combiners=("uniform",), telemetry="yes")


# --------------------------------------------------------------- stream
def _hostile(make, pool, theta_star, g, faults_mod, **kw):
    """tests/telemetry/test_integration.py::_hostile_sim, in either
    package."""
    faults = faults_mod.FaultPlan(
        byzantine=(faults_mod.ByzantineSpec(node=4, kind="sign_flip",
                                            start=1),),
        replay=faults_mod.ReplaySpec(prob=0.4, delay=2))
    return make(g, pool, scheme="trimmed_mean", theta_star=theta_star,
                capacity=64, seed=5, faults=faults, **kw)


def _port_hostile(pool, theta_star, g, **kw):
    return _hostile(TS.StreamSimulator, pool, theta_star, g, TS,
                    arrivals=TS.ArrivalSpec(rate=8.0),
                    network=TS.NetworkConfig(drop_prob=0.25, delay=1),
                    device="cpu", **kw)


def _assert_replay_exact(replayed, net):
    for key, val in net.counters_dict().items():
        assert replayed[key] == val, (key, replayed[key], val)
    assert replayed["in_flight"] == net.in_flight
    assert replayed["scalars_in_flight"] == net.scalars_in_flight
    assert replayed["scalars_sent"] == (replayed["scalars_delivered"]
                                        + replayed["scalars_dropped"]
                                        + replayed["scalars_in_flight"])


def test_hostile_stream_replays_and_matches_the_reference(star_pool,
                                                          tmp_path):
    """The hostile star of the reference's integration test in both
    packages: the port's JSONL replay equals its live counters, the
    timelines equal the recorded columns, the run is bitwise the
    telemetry-off run, and span paths, counter names and the network
    ledger equal the reference's."""
    rg, g, theta_star, pool = star_pool
    path = str(tmp_path / "port.jsonl")
    on = _port_hostile(pool, theta_star, g,
                       telemetry=TT.TelemetrySpec(jsonl=path))
    res = on.run(6, record_every=2)
    off = _port_hostile(pool, theta_star, g).run(6, record_every=2)
    np.testing.assert_array_equal(res.theta, off.theta)
    np.testing.assert_array_equal(res.scalars_sent, off.scalars_sent)
    assert off.telemetry is None
    for port_events in (TT.read_events(path), on.recorder.events):
        _assert_replay_exact(TT.replay_network_counters(port_events), on.net)
    _assert_replay_exact(RT.replay_network_counters(RT.read_events(path)),
                         on.net)
    rounds, err = res.timeline("err")
    np.testing.assert_array_equal(rounds, res.rounds)
    np.testing.assert_array_equal(err, res.err)
    np.testing.assert_array_equal(
        TT.timeline_from_events(TT.read_events(path), "err")[1], res.err)
    np.testing.assert_array_equal(res.timeline("scalars_sent")[1],
                                  res.scalars_sent)
    np.testing.assert_array_equal(res.timeline("staleness")[1],
                                  res.staleness)
    np.testing.assert_array_equal(off.timeline("err")[1], off.err)
    with pytest.raises(KeyError, match="unknown timeline"):
        off.timeline("nonsense")
    assert res.telemetry.counters["fault.injections"] > 0

    rpath = str(tmp_path / "ref.jsonl")
    rsim = _hostile(RSim, pool, theta_star, rg, rfaults,
                    arrivals=RArrivalSpec(rate=8.0),
                    network=RNetworkConfig(drop_prob=0.25, delay=1),
                    telemetry=RT.TelemetrySpec(jsonl=rpath))
    want = rsim.run(6, record_every=2).telemetry
    assert _spans(res.telemetry) == _spans(want)
    assert set(res.telemetry.counters) == set(want.counters)
    for name in ("net.send", "net.drop", "net.deliver", "fault.injections"):
        assert res.telemetry.counters[name] == want.counters[name], name
    assert on.net.counters_dict() == rsim.net.counters_dict()
    # the port replays the reference's log exactly
    _assert_replay_exact(TT.replay_network_counters(TT.read_events(rpath)),
                         rsim.net)


def test_network_replay_matches_live_counters_on_random_schedules():
    """tests/telemetry/test_replay_property.py's network property on 50
    seeded schedules: the replayed ledger is exact at every round."""
    links = [(0, 1), (1, 0), (1, 2), (2, 1), (0, 2)]
    rs = np.random.RandomState(0)
    for case in range(50):
        rec = TT.Recorder(TT.TelemetrySpec())
        delay, jitter = int(rs.randint(4)), int(rs.randint(3))
        net = TS.Network(links, TS.NetworkConfig(
            drop_prob=float(rs.rand()), delay=delay, jitter=jitter,
            seed=case), recorder=rec)
        rnd = 0
        for _ in range(int(rs.randint(41))):
            src, dst = links[int(rs.randint(len(links)))]
            net.send(rnd, src, dst, {"round": rnd}, int(rs.randint(18)))
            net.deliver(rnd)
            _assert_replay_exact(TT.replay_network_counters(rec.events), net)
            rnd += 1
        net.deliver(rnd + delay + jitter + 1)
        _assert_replay_exact(TT.replay_network_counters(rec.events), net)


def test_session_simulate_shares_recorder(star_pool):
    _, g, theta_star, pool = star_pool
    sess = TA.Plan(graph=g, combiners=("diagonal",),
                   telemetry=TA.TelemetrySpec()).session(device="cpu")
    sim = sess.simulate(pool, theta_star=theta_star, seed=3)
    assert sim.recorder is sess.recorder
    assert sim.est.recorder is sim.net.recorder is sess.recorder
    res = sim.run(4)
    assert res.telemetry is not None
    assert "stream/round/refit/bucket_solve" in res.telemetry.spans
    assert sess.stream().recorder is sess.recorder
