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
        res = A.Plan(graph=grid_graph(2, 2)).session(device="cpu").fit(X)
        assert np.all(np.isfinite(res.theta)) and res.theta.shape == (8,)
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
    ("mesh", "host"), ("faults", {"crash": []}), ("telemetry", {}),
    ("structure", {})])
def test_later_slice_plan_options_refuse(field, value):
    with pytest.raises(NotImplementedError, match=field):
        TA.Plan(graph=grid_graph(2, 2), **{field: value})


@pytest.mark.parametrize("verb", ["stream", "joint", "select", "simulate"])
def test_later_slice_verbs_refuse(verb):
    sess = TA.Plan(graph=grid_graph(2, 2)).session(device="cpu")
    args = () if verb == "stream" else (np.zeros((4, 4)),)
    with pytest.raises(NotImplementedError):
        getattr(sess, verb)(*args)


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
