"""The PyTorch port stands alone: it imports neither JAX nor the reference
package, its entry points insist on a device, and the parts of the reference
API that belong to later slices refuse loudly."""
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.api as TA  # noqa: E402
import repro_torch.stream as TS  # noqa: E402
from repro_torch.core import Graph, grid_graph  # noqa: E402
from repro_torch.kernels.cl import kernel as kmod  # noqa: E402
from repro_torch.kernels.cl import newton as nmod  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
_FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(jax|repro)(?![\w])",
                        re.MULTILINE)


def _module_names():
    names = []
    for path in sorted(PKG.rglob("*.py")):
        parts = path.relative_to(ROOT / "src").with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return names


def test_every_module_imports_and_fits_without_jax_or_reference():
    code = textwrap.dedent(f"""
        import importlib, sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        for name in {_module_names()!r}:
            importlib.import_module(name)
        import numpy as np
        import repro_torch.api as A
        from repro_torch.core import grid_graph
        X = np.where(np.random.RandomState(0).rand(64, 4) < 0.5, 1.0, -1.0)
        sess = A.Plan(graph=grid_graph(2, 2)).session(device="cpu")
        res = sess.fit(X)
        assert np.all(np.isfinite(res.theta)) and res.theta.shape == (8,)
        est = sess.stream(capacity=16)
        est.ingest(X[:40])
        assert len(est.refit()) == 4 and np.isfinite(est.score_norm(res.theta))
        joint = sess.joint(X)
        assert np.all(np.isfinite(joint.trajectory))
        sim = sess.simulate(np.tile(X, (4, 1)), estimator="admm")
        assert np.all(np.isfinite(sim.run(2).theta))
        sel = sess.select(X, spec=dict(n_lambdas=3, admm_rounds=5))
        assert np.all(np.isfinite(sel.ebic)) and len(sel.thetas) == 4
        import torch
        from repro_torch.core import (exact_locals, fit_mple, gibbs_sample,
                                      random_model)
        gen = torch.Generator()
        gen.manual_seed(0)
        m = random_model(grid_graph(2, 2), 0.4, 0.3, gen, device="cpu")
        Xs = gibbs_sample(m, 64, gen, burnin=10, thin=1)
        assert Xs.shape == (64, 4)
        assert np.all(np.isfinite(fit_mple(m.graph, Xs.double(), n_iter=5)))
        assert len(exact_locals(m)) == 4
        loaded = [m for m in sys.modules if m.startswith(("jax.", "repro."))]
        assert not loaded, loaded
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_drift_checkpoints_and_plain_families_run_without_jax_or_reference(
        tmp_path):
    """A drifting simulate, its save_stream/restore_stream across the
    change-point, and the fit of a family registered without a fused-kernel
    epilogue, in a process where importing jax or repro fails."""
    code = textwrap.dedent(f"""
        import dataclasses, sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import numpy as np
        import repro_torch
        import repro_torch.api as A
        import repro_torch.checkpoint as CK
        import repro_torch.stream as S
        from repro_torch.core import grid_graph
        from repro_torch.core.families import IsingFamily, register_family
        g = grid_graph(2, 2)
        X = np.where(np.random.RandomState(0).rand(256, 4) < 0.5, 1.0, -1.0)
        fp = S.FaultPlan(drift=(S.DriftSpec(at=2, scale=0.3),))
        def mk():
            return A.Plan(graph=g, faults=fp).session(
                device="cpu").simulate(X, theta_star=np.zeros(8),
                                       arrivals=S.ArrivalSpec(rate=16))
        full = mk().run(4)
        part = mk()
        part.run(1)
        CK.save_stream({str(tmp_path)!r}, 1, part)
        rest = CK.restore_stream({str(tmp_path)!r}, mk()).run(3)
        assert np.array_equal(rest.theta, full.theta[1:])

        @dataclasses.dataclass(frozen=True)
        class Plain(IsingFamily):
            name: str = "ising_plain"

            @property
            def kernel_kind(self):
                return None

        register_family(Plain())
        res = A.Plan(graph=g, family="ising_plain").session(
            device="cpu").fit(X)
        assert np.all(np.isfinite(res.theta)) and np.isfinite(res.score_norm)
        loaded = [m for m in sys.modules if m.startswith(("jax.", "repro."))]
        assert not loaded, loaded
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_source_imports_neither_jax_nor_reference(path):
    text = (ROOT / path).read_text()
    assert not _FORBIDDEN.findall(text), path


def test_session_without_cuda_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    plan = TA.Plan(graph=grid_graph(2, 2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        plan.session()
    with pytest.raises(RuntimeError):
        TA.EstimationSession.for_plan(plan)
    assert plan.session(device="cpu").device.type == "cpu"


def test_session_cache_is_keyed_by_plan_and_device():
    plan = TA.Plan(graph=grid_graph(2, 2))
    s1 = plan.session(device="cpu")
    assert TA.Plan(graph=grid_graph(2, 2)).session(device="cpu") is s1
    assert plan.replace(n_iter=7).session(device="cpu") is not s1


@pytest.mark.parametrize("field,value", [
    ("mesh", "host"), ("telemetry", {}), ("structure", {})])
def test_later_slice_plan_options_refuse(field, value):
    """Options of later slices refuse; ``structure``, ported with
    ``select``, and ``telemetry``, ported with the telemetry slice, are
    accepted (a dict becomes a StructureSpec / TelemetrySpec) and
    round-trip through the reference's dict schema; a telemetry plan's fit
    runs and carries its snapshot."""
    if field == "structure":
        plan = TA.Plan(graph=grid_graph(2, 2), **{field: value})
        assert isinstance(plan.structure, TA.StructureSpec)
        assert TA.Plan.from_dict(plan.to_dict()) == plan
        return
    if field == "telemetry":
        plan = TA.Plan(graph=grid_graph(2, 2), **{field: value})
        assert plan.telemetry == TA.TelemetrySpec()
        assert TA.Plan.from_dict(plan.to_dict()) == plan
        X = np.where(np.random.RandomState(1).rand(64, 4) < 0.5, 1.0, -1.0)
        res = plan.session(device="cpu").fit(X)
        assert "fit/bucket_solve" in res.telemetry.spans
        return
    with pytest.raises(NotImplementedError, match=field):
        TA.Plan(graph=grid_graph(2, 2), **{field: value})


@pytest.mark.parametrize("verb", ["select"])
def test_later_slice_verbs_refuse(verb):
    """Every verb of the reference's session is ported now: ``select``
    returns a StructureResult on the CPU."""
    sess = TA.Plan(graph=grid_graph(2, 2)).session(device="cpu")
    X = np.where(np.random.RandomState(2).rand(200, 4) < 0.5, 1.0, -1.0)
    res = getattr(sess, verb)(X, spec={"n_lambdas": 3, "admm_rounds": 5})
    assert isinstance(res, TA.StructureResult)
    assert len(res.thetas) == 4 and len(res.lambdas) == 3


_DRIFT = TS.FaultPlan(drift=(TS.DriftSpec(at=2),))


@pytest.mark.parametrize("case", [
    "drift in simulate", "drift plan in StreamSimulator",
    "telemetry in simulate", "telemetry in StreamSimulator",
    "mesh in StreamSimulator", "mesh in simulate"])
def test_later_slice_stream_options_refuse(case):
    """Mesh waits for its slice: the streaming verbs refuse it. Drift and
    telemetry, ported with their slices, are accepted: a round across the
    change-point runs, and a telemetry run carries its snapshot (a session
    shares its recorder with the simulators it builds)."""
    graph = grid_graph(2, 2)
    pool = np.where(np.random.RandomState(5).rand(64, 4) < 0.5, 1.0, -1.0)
    theta = np.zeros(8)
    sess = TA.Plan(graph=graph).session(device="cpu")
    runs = {
        "drift in simulate": lambda: TA.Plan(
            graph=graph, faults=_DRIFT).session(device="cpu").simulate(
                pool, theta_star=theta, arrivals=TS.ArrivalSpec(rate=8)),
        "drift plan in StreamSimulator": lambda: TS.StreamSimulator(
            graph, pool, faults=_DRIFT, theta_star=theta,
            arrivals=TS.ArrivalSpec(rate=8), device="cpu"),
    }
    if case in runs:
        sim = runs[case]()
        assert sim.faults == _DRIFT
        res = sim.run(3)
        assert np.all(np.isfinite(res.theta)) and res.err.shape == (3,)
        assert not np.array_equal(sim.theta_star, theta)
        return
    telemetry = {
        "telemetry in simulate": lambda: sess.simulate(
            pool, theta_star=theta, telemetry={}),
        "telemetry in StreamSimulator": lambda: TS.StreamSimulator(
            graph, pool, theta_star=theta, telemetry=TA.TelemetrySpec(),
            device="cpu"),
    }
    if case in telemetry:
        res = telemetry[case]().run(3)
        assert np.all(np.isfinite(res.theta)) and res.err.shape == (3,)
        assert res.telemetry.spans["stream/round"]["count"] == 3
        np.testing.assert_array_equal(res.timeline("err")[1], res.err)
        return
    raises = {
        "mesh in StreamSimulator": (
            TypeError, "mesh",
            lambda: TS.StreamSimulator(graph, pool, mesh="host",
                                       device="cpu")),
        "mesh in simulate": (
            TypeError, "mesh", lambda: sess.simulate(pool, mesh="data")),
    }
    exc, match, call = raises[case]
    with pytest.raises(exc, match=match):
        call()


def test_stream_entry_points_insist_on_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.StreamingEstimator(grid_graph(2, 2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.StreamSimulator(grid_graph(2, 2), np.ones((8, 4)))


def test_sampler_and_oracle_entry_points_insist_on_a_device(monkeypatch):
    """What allocates from nothing, or is handed numpy rather than a
    tensor, runs on the card or raises; given tensors, it runs on theirs."""
    import repro_torch.core as TC
    from repro_torch.interop import ising_model_from_numpy
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = grid_graph(2, 2)
    gen = torch.Generator()
    theta, X = np.zeros(8), np.ones((16, 4))
    calls = [
        lambda: TC.random_model(g, 0.5, 0.5, gen),
        lambda: TC.random_rows(TC.ISING, gen, 4, 4),
        lambda: ising_model_from_numpy(4, g.edges, theta),
        lambda: TC.gibbs_sample_family(TC.ISING, g, theta, 8, gen),
        lambda: TC.log_partition(g, theta),
        lambda: TC.fit_mple(g, X),
        lambda: TC.fit_mle_exact(g, X),
        lambda: TC.fit_all_local(g, X),
        lambda: TC.fit_all_local(g, X, method="loop"),
        lambda: TC.admm_mple(g, X, init="zero"),
        lambda: TC.fit_mple_family(TC.POTTS3, g, X),
        lambda: TC.fit_node_oracle(TC.GAUSSIAN, g, X, 0),
    ]
    for fam in TC.registered_families():
        calls += [lambda fam=fam: fam.random_params(g, gen),
                  lambda fam=fam: fam.init_draw(gen, 4),
                  lambda fam=fam: fam.exact_sample(g, theta[: 8], 8, gen)]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    m = TC.random_model(g, 0.5, 0.5, gen, device="cpu")
    assert m.theta.device.type == "cpu"
    assert TC.gibbs_sample(m, 8, gen, burnin=2, thin=1).device.type == "cpu"
    Xt = torch.tensor(np.where(np.random.RandomState(3).rand(64, 4) < 0.5,
                               1.0, -1.0))
    assert np.all(np.isfinite(TC.fit_mple(g, Xt, n_iter=2)))


def test_unknown_names_raise_listing_registries():
    with pytest.raises(KeyError, match="registered"):
        TA.Plan(graph=Graph(2, ((0, 1),)), family="nope")
    with pytest.raises(ValueError, match="registered combiners"):
        TA.Plan(graph=Graph(2, ((0, 1),)), combiners=("nope",))


def test_cpu_fit_launches_no_kernel():
    n0, s0 = nmod.bucket_newton_stats.launches, kmod.cl_score_channels.launches
    X = np.where(np.random.RandomState(1).rand(50, 4) < 0.5, 1.0, -1.0)
    res = TA.Plan(graph=grid_graph(2, 2)).session(device="cpu").fit(X)
    assert res.new_compiles == 0 and res.compile_s == 0.0
    assert nmod.bucket_newton_stats.launches == n0
    assert kmod.cl_score_channels.launches == s0
