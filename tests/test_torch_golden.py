"""The golden scenario of ``tools/gen_golden.py`` (grid_graph(2, 3), Ising,
n = 400, float32) through the port against a live run of the reference.

The JSON fixture of that tool has drifted under the current JAX, so the
port is held to the reference as it runs now. Gates are float32 gates: the
two packages reduce in another order.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.api as RA  # noqa: E402
import repro.core as RC  # noqa: E402
from repro_torch.interop import plan_from_reference  # noqa: E402

#: the frozen scenario of tools/gen_golden.py
CONFIG = {"model_key": 11, "sample_key": 12, "sigma_pair": 0.5,
          "sigma_single": 0.3, "n": 400,
          "schemes": ("uniform", "diagonal", "optimal", "max")}


@pytest.fixture(scope="module")
def runs():
    g = RC.grid_graph(2, 3)
    m = RC.random_model(g, CONFIG["sigma_pair"], CONFIG["sigma_single"],
                        jax.random.PRNGKey(CONFIG["model_key"]))
    X = np.asarray(RC.exact_sample(m, CONFIG["n"],
                                   jax.random.PRNGKey(CONFIG["sample_key"])))
    assert X.dtype == np.float32
    rp = RA.Plan(graph=g, combiners=CONFIG["schemes"])
    jr = rp.session().fit(X)
    tr = plan_from_reference(rp.to_dict()).session(device="cpu").fit(X)
    return jr, tr, np.asarray(m.theta, dtype=np.float64)


def test_golden_local_fits_match_live_reference(runs):
    jr, tr, _ = runs
    for a, b in zip(jr.fits, tr.fits):
        assert b.theta.dtype == np.float32
        np.testing.assert_allclose(b.theta, a.theta, rtol=0, atol=1e-5)
        np.testing.assert_allclose(np.diag(b.V), np.diag(a.V), rtol=1e-3)


def test_golden_combined_estimates_match_live_reference(runs):
    jr, tr, theta_star = runs
    for name in CONFIG["schemes"]:
        np.testing.assert_allclose(tr.combined[name], jr.combined[name],
                                   rtol=0, atol=1e-5, err_msg=name)
    assert tr.comm_scalars == jr.comm_scalars
    np.testing.assert_allclose(tr.score_norm, jr.score_norm, rtol=1e-4)
    assert tr.mse(theta_star) == pytest.approx(jr.mse(theta_star), rel=1e-3)


def test_golden_bfloat16_plan_matches_live_reference(runs):
    # +-1 spins are exact in bfloat16 and both packages accumulate in
    # float32, so the mixed-precision fit agrees as the float32 one does
    jr, _, _ = runs
    g = RC.grid_graph(2, 3)
    m = RC.random_model(g, CONFIG["sigma_pair"], CONFIG["sigma_single"],
                        jax.random.PRNGKey(CONFIG["model_key"]))
    X = np.asarray(RC.exact_sample(m, CONFIG["n"],
                                   jax.random.PRNGKey(CONFIG["sample_key"])))
    rp = RA.Plan(graph=g, combiners=CONFIG["schemes"], precision="bfloat16")
    jb = rp.session().fit(X)
    tb = plan_from_reference(rp.to_dict()).session(device="cpu").fit(X)
    for a, b in zip(jb.fits, tb.fits):
        assert b.theta.dtype == np.float32
        np.testing.assert_allclose(b.theta, a.theta, rtol=0, atol=1e-5)
    for name in CONFIG["schemes"]:
        np.testing.assert_allclose(tb.combined[name], jb.combined[name],
                                   rtol=0, atol=1e-5, err_msg=name)
