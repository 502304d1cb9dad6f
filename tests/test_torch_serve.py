"""The port's multi-tenant session server (``repro_torch.serve``) on the
CPU, against the JAX reference and against its own serial server.

Rows are drawn by the reference's exact samplers from integer seeds and fed
to both packages. "Serial" for the port is the same server with
``coalesce=False``, which dispatches every request alone: the reference's
served stream round fits at the plan's precision while its
``StreamingEstimator.refit`` fits at the pool's float32, so the reference's
own refit is not the serial twin of a served round (ROADMAP.md queue 3).
Coalesced against serial is held at ATOL on theta and the combined
estimates and at V_RTOL (normwise per node) on V: the engine stops a bucket
on its widest step, so a coalesced node may take one more Newton iteration,
which moves V entries of about 50 (Potts) by about 1e-10. Served results
against the reference are held at REF_TOL, all at float64. No Hypothesis:
the mixes below are deterministic.
"""
import collections
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core as RC  # noqa: E402
import repro.serve as RSV  # noqa: E402
from repro.api.plan import Plan as RPlan  # noqa: E402
from repro.core.estimators import LocalFit as RLocalFit  # noqa: E402
from repro.serve import coalesce as RCO  # noqa: E402
from repro.stream import costs as RCOST  # noqa: E402

import repro_torch.api as TA  # noqa: E402
import repro_torch.core as TC  # noqa: E402
import repro_torch.core.batched as bmod  # noqa: E402
import repro_torch.serve as TSV  # noqa: E402
from repro_torch.core.estimators import LocalFit  # noqa: E402
from repro_torch.interop import plan_from_reference  # noqa: E402
from repro_torch.serve import coalesce as TCO  # noqa: E402
from repro_torch.stream import costs as TCOST  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
#: coalesced against the port's serial server: theta and combined
#: estimates (absolute), V (normwise relative per node)
ATOL, V_RTOL = 1e-10, 1e-8
#: served results against the reference, float64
REF_TOL = 1e-8

FAMILY_NAMES = [f.name for f in RC.families.registered_families()]
STREAMABLE_NAMES = [c.name for c in RC.combiners.streamable_combiners()]
GRAPHS = {
    "chain": RC.chain_graph(5),
    "loop": RC.Graph(4, ((0, 1), (1, 2), (2, 3), (0, 3))),
}
#: the reference's admission and concurrency tests' plan (chain_graph(4),
#: n_iter 8); admission dispatches nothing, so its rows are all ones
ADMISSION_PLAN = RPlan(graph=RC.chain_graph(4), family="ising",
                       combiners=("diagonal",), n_iter=8)


@pytest.fixture(scope="module", autouse=True)
def _x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _port(rplan):
    """The port's plan for a reference plan, through the interop path."""
    return plan_from_reference(rplan.to_dict())


def _f64_plan(graph="chain", family="ising", combiners=("diagonal",)):
    return RPlan(graph=GRAPHS[graph], family=family, combiners=combiners,
                 precision="float64", n_iter=40)


def _rows(rplan, n, key):
    """The reference serve tests' draw: random_params then exact_sample."""
    fam = rplan.family_instance
    theta = np.asarray(fam.random_params(rplan.graph,
                                         jax.random.fold_in(key, 0)))
    return np.asarray(fam.exact_sample(rplan.graph, theta, n,
                                       jax.random.fold_in(key, 1)),
                      dtype=np.float64)


def _serve(tenant_plans, rows, coalesce=True, max_coalesce=8):
    """One port server pass over one fit request per tenant, drained: the
    tickets by tenant."""
    srv = TSV.SessionServer(coalesce=coalesce, max_coalesce=max_coalesce,
                            device=CPU)
    for tid, plan in tenant_plans.items():
        srv.register(tid, plan)
    tickets = {tid: srv.submit(tid, rows[tid]) for tid in tenant_plans}
    srv.drain()
    for tid, t in tickets.items():
        assert t.done, (tid, t.status, t.reject_reason)
    return tickets


def _assert_fits_close(got, want, atol=ATOL, v_rtol=V_RTOL):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.i == b.i and list(a.beta) == list(b.beta)
        np.testing.assert_allclose(a.theta, np.asarray(b.theta), atol=atol,
                                   rtol=0, err_msg=f"node {a.i}")
        dV = np.abs(a.V - np.asarray(b.V)).max()
        assert dV <= v_rtol * np.abs(np.asarray(b.V)).max(), (a.i, dV)


def _assert_results_close(got, want, atol=ATOL, v_rtol=V_RTOL):
    """Two served results: fits, every combined estimate, the headline."""
    _assert_fits_close(got.fits, want.fits, atol, v_rtol)
    assert set(got.combined) == set(want.combined)
    for name, value in want.combined.items():
        np.testing.assert_allclose(got.combined[name], np.asarray(value),
                                   atol=atol, rtol=0, err_msg=name)
    np.testing.assert_allclose(got.theta, np.asarray(want.theta), atol=atol,
                               rtol=0)
    assert got.n_samples == want.n_samples
    assert got.comm_scalars == want.comm_scalars


@pytest.fixture(scope="module")
def family_rows():
    """Per family: two tenants' 96 rows on chain_graph(5)."""
    out = {}
    for j, fam in enumerate(FAMILY_NAMES):
        key = jax.random.PRNGKey(100 + j)
        plan = _f64_plan(family=fam)
        out[fam] = {"t0": _rows(plan, 96, jax.random.fold_in(key, 10)),
                    "t1": _rows(plan, 96, jax.random.fold_in(key, 11))}
    return out


def _ising_rows(seed, n):
    """n rows (n <= 96) of a seeded Ising model on chain_graph(5)."""
    return _rows(_f64_plan(), 96, jax.random.PRNGKey(seed))[:n]


# ------------------------------------------------------------ host helpers
def test_serve_exports_the_reference_names():
    assert TSV.__all__ == RSV.__all__
    assert sorted(c.name for c in TC.combiners.streamable_combiners()) \
        == sorted(STREAMABLE_NAMES)


@pytest.mark.parametrize("family", FAMILY_NAMES)
def test_request_scalars_equal_reference(family):
    rfam, tfam = RC.get_family(family), TC.get_family(family)
    names = [c.name for c in RC.combiners.registered_combiners()]
    for gname, rg in GRAPHS.items():
        tg = TC.Graph(rg.p, tuple(rg.edges))
        for inc in (True, False):
            want = RCOST.shared_owner_slot_count(rg, inc, rfam)
            assert TCOST.shared_owner_slot_count(tg, inc, tfam) == want
            for n in (1, 96):
                for combs in [(c,) for c in names] + [tuple(names)]:
                    want = RCOST.plan_request_scalars(rg, combs, n, inc,
                                                      rfam)
                    got = TCOST.plan_request_scalars(tg, combs, n, inc, tfam)
                    assert got == want, (gname, inc, n, combs)


def test_union_helpers_equal_reference():
    for rg in GRAPHS.values():
        tg = TC.Graph(rg.p, tuple(rg.edges))
        for r in range(1, 6):
            ru, tu = RCO.union_graph(rg, r), TCO.union_graph(tg, r)
            assert (tu.p, tuple(tu.edges)) == (ru.p, tuple(ru.edges))
            for fam in FAMILY_NAMES:
                np.testing.assert_array_equal(
                    TCO.tenant_param_slots(fam, tg, r),
                    RCO.tenant_param_slots(fam, rg, r))
    for fam in FAMILY_NAMES:
        rplan = _f64_plan(family=fam)
        n = rplan.family_instance.n_params(rplan.graph)
        tf = tuple(float(v) for v in np.random.RandomState(7).randn(n))
        rplan = rplan.replace(theta_fixed=tf)
        plan = _port(rplan)
        for r in (1, 2, 3, 4):
            ru, tu = RCO.coalesced_plan(rplan, r), TCO.coalesced_plan(plan, r)
            assert tu.theta_fixed == ru.theta_fixed
            assert tu.to_dict() == ru.to_dict()
        assert TCO.coalesced_plan(plan, 1) is plan
    for mc in range(1, 9):
        for r in range(1, 10):
            assert TCO.pad_group_size(r, mc) == RCO.pad_group_size(r, mc)
    with pytest.raises(ValueError, match="empty coalesce group"):
        TCO.pad_group_size(0, 4)
    with pytest.raises(ValueError, match="at least one copy"):
        TCO.union_graph(TC.chain_graph(3), 0)


@pytest.mark.parametrize("family", FAMILY_NAMES)
def test_split_fits_relabels_ids_and_betas_as_reference(family):
    """Node ids and betas equal the reference's; the arrays are the union
    fits' own objects, untouched; phantom slots are dropped."""
    rg, r, r_pad = GRAPHS["chain"], 3, 4
    tg = TC.Graph(rg.p, tuple(rg.edges))
    rfam, tfam = RC.get_family(family), TC.get_family(family)
    ug = TCO.union_graph(tg, r_pad)
    rs = np.random.RandomState(3)
    tfits, rfits = [], []
    for i in range(ug.p):
        beta = tfam.beta(ug, i, True)
        d = len(beta)
        arrs = dict(theta=rs.randn(d), H=rs.randn(d, d), J=rs.randn(d, d),
                    V=rs.randn(d, d), s=rs.randn(4, d))
        tfits.append(LocalFit(i=i, beta=beta, **arrs))
        rfits.append(RLocalFit(i=i, beta=beta, **arrs))
    got = TCO.split_fits(tfits, tg, tfam, True, r)
    want = RCO.split_fits(rfits, rg, rfam, True, r)
    assert len(got) == len(want) == r
    for t in range(r):
        for a, b, u in zip(got[t], want[t], tfits[t * rg.p:]):
            assert (a.i, list(a.beta)) == (b.i, list(b.beta))
            for part in ("theta", "H", "J", "V", "s"):
                assert getattr(a, part) is getattr(u, part)


# --------------------------------------------------------------- admission
def _admission_scenarios(cost):
    """(server kwargs, tenants -> (scalars, replenish_every) or None, ops);
    an op is ("submit", tenant, rows, kind) or ("advance", dt)."""
    sub = lambda tid, kind="fit": ("submit", tid, 16, kind)  # noqa: E731
    return {
        "exact exhaustion": (
            {}, {"a": (3 * cost, None)}, [sub("a", "stream")] * 4),
        "replenishment": (
            {}, {"a": (cost, 60.0)},
            [sub("a"), sub("a"), ("advance", 59.9), sub("a"),
             ("advance", 0.1), sub("a")]),
        "catch-up after an idle gap": (
            {}, {"a": (cost, 5.0)},
            [sub("a"), ("advance", 17.0), sub("a"), ("advance", 2.9),
             sub("a"), ("advance", 0.1), sub("a")]),
        "queue_full charges nothing": (
            {"max_queue": 1, "max_coalesce": 1}, {"a": (2 * cost, None)},
            [sub("a"), sub("a")]),
        "queue_full backpressure": (
            {"max_queue": 3, "max_coalesce": 1}, {"a": None},
            [sub("a")] * 5),
        "independent tenants": (
            {}, {"rich": None, "poor": (0, None)},
            [sub("rich"), sub("poor"), sub("rich", "stream")]),
    }


def _admission_run(pkg, plan, kw, tenants, ops, **server_kw):
    clock = pkg.VirtualClock()
    srv = pkg.SessionServer(clock=clock, **kw, **server_kw)
    for tid, spec in tenants.items():
        srv.register(tid, plan, budget=None if spec is None
                     else pkg.BudgetSpec(*spec))
    out = []
    for op in ops:
        if op[0] == "advance":
            clock.advance(op[1])
            continue
        _, tid, n, kind = op
        t = srv.submit(tid, np.ones((n, plan.graph.p)), kind=kind)
        ledgers = {b: srv.tenant(b).budget.remaining
                   for b, spec in tenants.items() if spec is not None}
        out.append((t.tenant_id, t.kind, t.seq, t.status, t.admitted,
                    t.reject_reason, t.comm_cost, ledgers, srv.queue_depth))
    counters = [(e["name"], sorted((e.get("tags") or {}).items()),
                 e["value"]) for e in srv.metrics().events
                if e["kind"] == "counter"]
    return out, counters


@pytest.mark.parametrize("scenario", list(_admission_scenarios(0)))
def test_admission_decisions_equal_reference(scenario):
    """Ticket status, reason, comm_cost, the ledgers' remaining scalars,
    queue depth and the admission counters equal the reference server's
    for the same submit sequence under a VirtualClock (``submit``
    dispatches nothing in either package)."""
    plan = _port(ADMISSION_PLAN)
    cost = TSV.SessionServer(device=CPU)
    cost.register("a", plan)
    c = cost.request_cost("a", 16)
    rcost = RSV.SessionServer()
    rcost.register("a", ADMISSION_PLAN)
    assert c == rcost.request_cost("a", 16) > 0
    kw, tenants, ops = _admission_scenarios(c)[scenario]
    got = _admission_run(TSV, plan, kw, tenants, ops, device=CPU)
    want = _admission_run(RSV, ADMISSION_PLAN, kw, tenants, ops)
    assert got == want
    if scenario == "exact exhaustion":
        assert [d[4] for d in got[0]] == [True, True, True, False]
        assert got[0][-1][5] == TSV.REJECT_BUDGET
        assert got[0][-1][7] == {"a": 0}


def test_budget_state_and_validation_equal_reference():
    for pkg in (RSV, TSV):
        st = pkg.BudgetState(pkg.BudgetSpec(scalars=10, replenish_every=5.0),
                             now=0.0)
        seq = [st.try_charge(10, 0.0), st.try_charge(10, 17.0),
               st.try_charge(1, 19.9), st.try_charge(10, 20.0)]
        assert seq == [True, True, False, True] and st.remaining == 0
    for make in (lambda pkg: pkg.BudgetSpec(scalars=-1),
                 lambda pkg: pkg.BudgetSpec(scalars=1, replenish_every=0.0),
                 lambda pkg: pkg.VirtualClock().advance(-1.0),
                 lambda pkg: pkg.BudgetState(pkg.BudgetSpec(1), 0.0)
                 .try_charge(-1, 0.0)):
        with pytest.raises(ValueError) as want:
            make(RSV)
        with pytest.raises(ValueError, match=re.escape(str(want.value))):
            make(TSV)


def test_budget_spec_reads_and_writes_the_reference_schema():
    for args in ((5, 2.5), (0, None), (10_000, 60)):
        rspec, tspec = RSV.BudgetSpec(*args), TSV.BudgetSpec(*args)
        assert tspec.to_dict() == rspec.to_dict()
        assert TSV.BudgetSpec.from_dict(rspec.to_dict()) == tspec
        assert RSV.BudgetSpec.from_dict(tspec.to_dict()) == rspec


def test_reference_plan_dict_serves_through_interop(family_rows):
    """A reference plan's dict becomes a port plan that registers and
    serves; its result equals the port plan's own session fit."""
    rplan = _f64_plan(combiners=("diagonal", "max"))
    plan = plan_from_reference(rplan.to_dict())
    assert isinstance(plan, TA.Plan) and plan.to_dict() == rplan.to_dict()
    X = family_rows["ising"]["t0"]
    tickets = _serve({"x": plan}, {"x": X})
    res = plan.session(device=CPU).fit(X)
    for name in ("diagonal", "max"):
        np.testing.assert_array_equal(tickets["x"].result.combined[name],
                                      res.combined[name])


# ------------------------------------------------- coalesced against serial
@pytest.mark.parametrize("combiner", STREAMABLE_NAMES)
@pytest.mark.parametrize("family", FAMILY_NAMES)
def test_every_family_x_streamable_combiner_coalesced_equals_serial(
        family, combiner, family_rows):
    plan = _port(_f64_plan(family=family, combiners=(combiner,)))
    rows = family_rows[family]
    plans = {"t0": plan, "t1": plan}
    co = _serve(plans, rows)
    se = _serve(plans, rows, coalesce=False)
    for tid in rows:
        assert co[tid].result.coalesce_size == 2
        assert se[tid].result.coalesce_size == 1
        _assert_results_close(co[tid].result, se[tid].result)


@pytest.mark.parametrize("family", FAMILY_NAMES)
def test_served_fits_match_reference_serial_session(family, family_rows):
    """Coalesced served fits against the reference's own session fit and
    combiners on the same rows, float64."""
    combs = ("uniform", "diagonal", "max")
    rplan = _f64_plan(family=family, combiners=combs)
    plan = _port(rplan)
    rows = family_rows[family]
    tickets = _serve({"t0": plan, "t1": plan}, rows)
    rsess = rplan.session()
    for tid, X in rows.items():
        ref_fits = rsess.fit_local(X)
        got = tickets[tid].result
        _assert_fits_close(got.fits, ref_fits, REF_TOL, REF_TOL)
        for c in rsess.combiners:
            want = c.combine(rplan.graph, ref_fits,
                             include_singleton=rplan.include_singleton,
                             theta_fixed=rsess.theta_fixed,
                             family=rsess.family)
            np.testing.assert_allclose(got.combined[c.name], want,
                                       atol=REF_TOL, rtol=0,
                                       err_msg=c.name)


def test_heterogeneous_tenant_mix_coalesces_only_equal_plans(monkeypatch):
    """Interleaved tenants of three plans: every dispatched group holds
    one plan, equal-plan tenants do group, and every result equals the
    serial server's."""
    plan_a = _f64_plan(combiners=("diagonal",))
    plan_b = _f64_plan("loop", "gaussian", ("uniform", "max"))
    plan_c = plan_a.replace(combiners=("krum",))
    rplans = [plan_a, plan_b, plan_c, plan_a, plan_b, plan_a, plan_c]
    plans, rows = {}, {}
    key = jax.random.PRNGKey(7)
    for j, rplan in enumerate(rplans):
        plans[f"t{j}"] = _port(rplan)
        rows[f"t{j}"] = _rows(rplan, 64, jax.random.fold_in(key, 100 + j))
    order = list(plans)
    np.random.RandomState(0).shuffle(order)
    plans = {tid: plans[tid] for tid in order}
    groups = []
    orig = TSV.SessionServer._dispatch

    def spy(self, group):
        groups.append([self.tenant(t.tenant_id).plan for t in group])
        return orig(self, group)

    monkeypatch.setattr(TSV.SessionServer, "_dispatch", spy)
    co = _serve(plans, rows, max_coalesce=4)
    assert all(all(p == g[0] for p in g) for g in groups)
    assert max(len(g) for g in groups) >= 2
    se = _serve(plans, rows, coalesce=False)
    for tid in plans:
        _assert_results_close(co[tid].result, se[tid].result)


def test_potts_counterexample_coalesced_equals_serial():
    """The reference's recorded Hypothesis counterexample
    (.hypothesis/patches/2026-10-16--e8621507.patch): one Potts plan on
    chain_graph(5) with ("uniform",) at float64, three tenants, n = 48,
    seed 112947, rows drawn as its test draws them; V held relatively."""
    rplan = _f64_plan(family="potts", combiners=("uniform",))
    plan = _port(rplan)
    key = jax.random.PRNGKey(112947)
    rows = {f"h{j}": _rows(rplan, 48, jax.random.fold_in(key, j))
            for j in range(3)}
    plans = {tid: plan for tid in rows}
    co = _serve(plans, rows, max_coalesce=4)
    se = _serve(plans, rows, coalesce=False)
    for tid in rows:
        assert co[tid].result.coalesce_size == 3
        _assert_results_close(co[tid].result, se[tid].result)


# ----------------------------------------------------------- stream rounds
@pytest.fixture(scope="module")
def stream_runs():
    """Three stream rounds of 32 rows for tenants a and b (max_coalesce 2)
    plus a zero-budget tenant rejected every round, through the reference
    server, the port's coalescing server and its serial server."""
    rplan = _f64_plan()
    plan = _port(rplan)
    key = jax.random.PRNGKey(3)
    rows = {tid: _rows(rplan, 96, jax.random.fold_in(key, j))
            for j, tid in enumerate("ab")}
    servers = {
        "reference": (RSV, rplan, {"max_coalesce": 2}),
        "coalesced": (TSV, plan, {"max_coalesce": 2, "device": CPU}),
        "serial": (TSV, plan, {"coalesce": False, "device": CPU}),
    }
    out = {}
    for name, (pkg, P, kw) in servers.items():
        srv = pkg.SessionServer(clock=pkg.VirtualClock(), **kw)
        for tid in "ab":
            srv.register(tid, P)
        srv.register("poor", P, budget=pkg.BudgetSpec(scalars=0))
        rounds = []
        for rnd in range(3):
            ts = [srv.submit(tid, rows[tid][32 * rnd: 32 * (rnd + 1)],
                             kind="stream") for tid in "ab"]
            ts.append(srv.submit("poor", np.ones((8, 5)), kind="stream"))
            srv.drain()
            rounds.append(ts)
        out[name] = (srv, rounds)
    return out


def test_served_stream_rounds_match_reference_server(stream_runs):
    _, want = stream_runs["reference"]
    _, got = stream_runs["coalesced"]
    for rnd, (g, w) in enumerate(zip(got, want)):
        for a, b in zip(g[:2], w[:2]):
            assert a.done and b.done and a.result.coalesce_size == 2
            assert a.result.n_samples == b.result.n_samples == 32 * (rnd + 1)
            _assert_results_close(a.result, b.result, REF_TOL, REF_TOL)
        assert g[2].reject_reason == w[2].reject_reason == TSV.REJECT_BUDGET


def test_served_stream_rounds_coalesced_equal_serial(stream_runs):
    _, co = stream_runs["coalesced"]
    srv, se = stream_runs["serial"]
    for g, w in zip(co, se):
        for a, b in zip(g[:2], w[:2]):
            assert b.result.coalesce_size == 1
            _assert_results_close(a.result, b.result)
    # the tenant's estimator finished every round: its fits are the last
    assert srv.tenant("a").stream.fits is se[-1][0].result.fits


def test_server_telemetry_equals_reference(stream_runs):
    """Counters (names, tags, values, in order), the coalesce-size
    observations, the queue-depth gauges, one latency observation per
    served request and one serve_dispatch span per group equal the
    reference server's. The reference also counts ``serve.new_compiles``
    (its cold jit compiles); the port's builds are 0 on the CPU."""
    def view(snap):
        ev = snap.events
        return {
            "counters": [(e["name"], sorted((e.get("tags") or {}).items()),
                          e["value"]) for e in ev if e["kind"] == "counter"
                         and e["name"] != "serve.new_compiles"],
            "gauges": [(e["name"], e["value"]) for e in ev
                       if e["kind"] == "gauge"],
            "coalesce": snap.histograms["serve.coalesce_size"],
            "latencies": len(snap.histograms["serve.latency_s"]),
            "dispatch_spans": snap.spans["serve_dispatch"]["count"],
        }
    got = view(stream_runs["coalesced"][0].metrics())
    want = view(stream_runs["reference"][0].metrics())
    assert got == want
    assert got["latencies"] == 6 and got["dispatch_spans"] == 3
    snap = stream_runs["coalesced"][0].metrics()
    assert snap.counter("serve.rejected", tenant="poor",
                        reason=TSV.REJECT_BUDGET) == 3
    assert snap.counter("serve.new_compiles") == 0


# ------------------------------------------------------------- concurrency
@pytest.fixture()
def plan():
    return _port(RPlan(graph=RC.chain_graph(5), family="ising",
                       combiners=("diagonal",), n_iter=8))


def _server(**kw):
    return TSV.SessionServer(device=CPU, **kw)


def test_equal_plan_tenants_share_one_session(plan):
    srv = _server(max_coalesce=4)
    tenants = [srv.register(f"t{i}", plan) for i in range(4)]
    first = tenants[0].session
    assert all(t.session is first for t in tenants[1:])
    assert first is plan.session(device=CPU)


def test_same_tenant_requests_never_share_a_group(plan):
    srv = _server(max_coalesce=4)
    srv.register("a", plan)
    srv.register("b", plan)
    t1 = srv.submit("a", _ising_rows(600, 32))
    t2 = srv.submit("b", _ising_rows(601, 32))
    t3 = srv.submit("a", _ising_rows(602, 32))
    first = srv.pump()
    assert {t.seq for t in first} == {t1.seq, t2.seq}
    assert t3.status == "queued"
    second = srv.pump()
    assert [t.seq for t in second] == [t3.seq]
    assert t3.result.coalesce_size == 1


def test_fifo_preserved_when_stream_keys_mismatch(plan):
    """A cold tenant behind a warm head is considered (and ingested) but
    not grouped, and blocks its later rounds: rows enter each pool in
    submission order, so each round equals the serial server's."""
    srv = _server(max_coalesce=4)
    srv.register("a", plan)
    srv.register("b", plan)
    srv.submit("a", _ising_rows(800, 8), kind="stream")
    srv.drain()
    ta2 = srv.submit("a", _ising_rows(801, 8), kind="stream")
    Xb1, Xb2 = _ising_rows(810, 8), _ising_rows(811, 8)
    tb1 = srv.submit("b", Xb1, kind="stream")
    tb2 = srv.submit("b", Xb2, kind="stream")
    assert [t.seq for t in srv.pump()] == [ta2.seq]
    assert int(srv.tenant("b").stream.buffer.n) == 8
    assert [t.seq for t in srv.pump()] == [tb1.seq]
    assert tb1.result.n_samples == 8
    assert [t.seq for t in srv.pump()] == [tb2.seq]
    assert tb2.result.n_samples == 16
    ref = _server(coalesce=False)
    ref.register("b", plan)
    r1 = ref.submit("b", Xb1, kind="stream")
    ref.drain()
    np.testing.assert_allclose(tb1.result.theta, r1.result.theta,
                               atol=ATOL, rtol=0)


def test_fifo_preserved_across_kinds(plan):
    srv = _server(max_coalesce=4)
    srv.register("a", plan)
    srv.register("b", plan)
    ts_a = srv.submit("a", _ising_rows(820, 8), kind="stream")
    tf_b = srv.submit("b", _ising_rows(821, 8), kind="fit")
    ts_b = srv.submit("b", _ising_rows(822, 8), kind="stream")
    assert [t.seq for t in srv.pump()] == [ts_a.seq]
    assert srv.tenant("b")._stream is None
    assert [t.seq for t in srv.pump()] == [tf_b.seq]
    assert [t.seq for t in srv.pump()] == [ts_b.seq]


def test_stream_group_members_report_own_n_samples(plan):
    srv = _server(max_coalesce=2)
    srv.register("a", plan)
    srv.register("b", plan)
    ta = srv.submit("a", _ising_rows(830, 8), kind="stream")
    tb = srv.submit("b", _ising_rows(831, 16), kind="stream")
    assert {t.seq for t in srv.pump()} == {ta.seq, tb.seq}
    assert ta.result.coalesce_size == 2
    assert (ta.result.n_samples, tb.result.n_samples) == (8, 16)


def test_coalesce_disabled_serves_serially(plan):
    srv = _server(coalesce=False)
    for i in range(3):
        srv.register(f"t{i}", plan)
    tickets = [srv.submit(f"t{i}", _ising_rows(700 + i, 32))
               for i in range(3)]
    srv.drain()
    assert all(t.result.coalesce_size == 1 for t in tickets)
    assert srv.metrics().counter("serve.dispatches") == 3


def test_submit_and_register_validation(plan):
    srv = _server()
    with pytest.raises(KeyError, match="register"):
        srv.submit("ghost", np.zeros((4, 5)))
    srv.register("a", plan)
    with pytest.raises(ValueError, match="kind"):
        srv.submit("a", _ising_rows(70, 8), kind="joint")
    with pytest.raises(ValueError, match="p=5"):
        srv.submit("a", np.zeros((8, 7)))
    with pytest.raises(ValueError, match="no sample rows"):
        srv.submit("a", torch.zeros((0, 5)))
    with pytest.raises(ValueError, match="already registered"):
        srv.register("a", plan)
    with pytest.raises(TypeError, match="Plan"):
        srv.register("b", _f64_plan())
    from repro_torch.stream.faults import CrashSpec, FaultPlan
    faulty = plan.replace(faults=FaultPlan(crashes=(CrashSpec(node=0,
                                                              at=1),)))
    with pytest.raises(ValueError, match="FaultPlan"):
        srv.register("f", faulty)
    assert TCO.coalesced_plan(faulty, 1).faults is None
    assert TCO.coalesced_plan(faulty, 2).faults is None


def test_coalesced_group_takes_fewer_newton_statistics_calls(monkeypatch):
    """A group of four requests calls the engine's Newton statistics (one
    kernel launch each on the card) once per bucket per iteration for the
    whole group: fewer calls than its requests served alone, and per
    bucket at most the largest member's own iteration count plus one."""
    rplan = _f64_plan()
    plan = _port(rplan)
    key = jax.random.PRNGKey(21)
    rows = {f"t{j}": _rows(rplan, 96, jax.random.fold_in(key, j))
            for j in range(4)}
    calls = collections.Counter()
    orig = bmod.bucket_newton_stats_op

    def counting(kind, Zb, *args, **kw):
        calls[Zb.shape[2] - 1] += 1          # d = deg_pad + 1 (singleton)
        return orig(kind, Zb, *args, **kw)

    monkeypatch.setattr(bmod, "bucket_newton_stats_op", counting)
    tickets = _serve({tid: plan for tid in rows}, rows, max_coalesce=4)
    assert tickets["t0"].result.coalesce_size == 4
    coalesced = dict(calls)
    sess = plan.session(device=CPU)
    serial_iters, n_serial = collections.defaultdict(list), 0
    for X in rows.values():
        calls.clear()
        iters = {}
        sess.fit_local(X, iters=iters)
        assert dict(calls) == iters          # one call per iteration
        n_serial += sum(iters.values())
        for deg_pad, it in iters.items():
            serial_iters[deg_pad].append(it)
    assert set(coalesced) == set(serial_iters)
    assert sum(coalesced.values()) < n_serial
    for deg_pad, its in serial_iters.items():
        assert max(its) <= coalesced[deg_pad] <= max(its) + 1, deg_pad


# ----------------------------------------------------------------- loadgen
def _load_plans():
    pa = TA.Plan(graph=TC.chain_graph(4), family="ising",
                 combiners=("diagonal",), n_iter=8)
    return {"a0": pa, "a1": pa, "b0": pa.replace(combiners=("uniform",))}


def test_synthetic_workload_is_a_pure_function_of_its_seed():
    plans = _load_plans()
    s1 = TSV.synthetic_workload(plans, rounds=2, n_rows=12, seed=5,
                                device=CPU)
    s2 = TSV.synthetic_workload(plans, rounds=2, n_rows=12, seed=5,
                                device=CPU)
    s3 = TSV.synthetic_workload(plans, rounds=2, n_rows=12, seed=6,
                                device=CPU)
    assert len(s1) == 2 and len(s1[0]) == 3
    for reqs1, reqs2 in zip(s1, s2):
        for (t1, X1, k1), (t2, X2, k2) in zip(reqs1, reqs2):
            assert (t1, k1) == (t2, k2) and X1.shape == (12, 4)
            assert X1.device.type == CPU and torch.equal(X1, X2)
    assert any(not torch.equal(X1, X3)
               for (_, X1, _), (_, X3, _) in zip(s1[0], s3[0]))
    # past p = 12 the rows come from chromatic Gibbs, as seeded
    big = {"g": TA.Plan(graph=TC.chain_graph(13), family="potts")}
    g1, g2 = (TSV.synthetic_workload(big, rounds=1, n_rows=16, seed=1,
                                     device=CPU) for _ in range(2))
    assert g1[0][0][1].shape == (16, 13)
    assert torch.equal(g1[0][0][1], g2[0][0][1])
    assert TSV.loadgen.fold_seed(0, 1, 2) != TSV.loadgen.fold_seed(0, 2, 1)


def test_coalesced_and_serial_replay_agree_and_report_load():
    plans = _load_plans()
    schedule = TSV.synthetic_workload(plans, rounds=3, n_rows=16, seed=1,
                                      device=CPU)

    def serve(coalesce):
        srv = _server(coalesce=coalesce, max_coalesce=4,
                      clock=TSV.VirtualClock())
        for tid, p in plans.items():
            srv.register(tid, p)
        return srv, TSV.run_load(srv, schedule, round_dt=1.0)

    srv_c, rep_c = serve(True)
    _, rep_s = serve(False)
    for rep in (rep_c, rep_s):
        assert (rep.n_submitted, rep.n_served, rep.n_rejected) == (9, 9, 0)
        assert rep.latencies_s.shape == (9,) and rep.wall_s > 0
        summary = rep.summary()
        assert summary["p99_ms"] >= summary["p50_ms"] >= 0
        assert summary["throughput_rps"] > 0
        assert rep.new_compiles == 0
    assert max(rep_c.coalesce_sizes) == 2
    assert max(rep_s.coalesce_sizes) == 1
    assert srv_c.clock() == 3.0
    for tc, ts in zip(rep_c.tickets, rep_s.tickets):
        assert (tc.tenant_id, tc.kind, tc.seq) == (ts.tenant_id, ts.kind,
                                                   ts.seq)
        # float32 plans: the reference's replay gate
        np.testing.assert_allclose(tc.result.theta, ts.result.theta,
                                   atol=5e-6)
        assert tc.result.comm_scalars == ts.result.comm_scalars


def test_warm_replay_reports_zero_builds():
    plans = _load_plans()
    schedule = TSV.synthetic_workload(plans, rounds=2, n_rows=16, seed=2,
                                      device=CPU)
    srv = _server(max_coalesce=4, clock=TSV.VirtualClock())
    for tid, p in plans.items():
        srv.register(tid, p)
    TSV.run_load(srv, schedule)
    rep = TSV.run_load(srv, schedule)
    assert rep.new_compiles == 0 and rep.n_served == 6
    assert all(t.result.new_compiles == 0 for t in rep.tickets)


# ----------------------------------------------------------------- hygiene
def test_server_and_workload_without_cuda_need_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TSV.SessionServer()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TSV.synthetic_workload(_load_plans(), rounds=1, n_rows=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TCO.stack_columns([np.ones((2, 3))], 1)
    assert TSV.SessionServer(device=CPU).device.type == CPU


def test_serving_runs_without_jax_or_reference():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import repro_torch.api as A
        import repro_torch.serve as S
        from repro_torch.core import chain_graph
        plan = A.Plan(graph=chain_graph(4), n_iter=8)
        srv = S.SessionServer(device="cpu", clock=S.VirtualClock())
        for t in ("a", "b"):
            srv.register(t, plan)
        work = S.synthetic_workload({"a": plan, "b": plan}, rounds=2,
                                    n_rows=16, seed=0, device="cpu")
        rep = S.run_load(srv, work, round_dt=1.0)
        assert rep.n_served == 4 and max(rep.coalesce_sizes) == 2
        loaded = [m for m in sys.modules if m.startswith(("jax.", "repro."))]
        assert not loaded, loaded
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
