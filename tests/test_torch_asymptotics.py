"""The port's exact asymptotic oracles against the JAX reference at float64
(1e-10): per-node H, V, S and state probabilities, the cross-covariances,
every consensus scheme's exact variance, the joint MPLE's and the MLE's,
and the efficiency ratio, on a star and a grid with and without
singletons; the MLE as the Cramér–Rao floor of every scheme."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core as RC  # noqa: E402
import repro_torch.core as TC  # noqa: E402
from repro_torch.interop import ising_model_from_numpy  # noqa: E402

TOL = 1e-10
SCHEMES = ("uniform", "diagonal", "optimal", "max")


@pytest.fixture(scope="module", autouse=True)
def _x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tests run many tiny tensor ops: one intra-op thread each keeps
    the test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(graph, seed):
    rg = getattr(RC, graph[0])(*graph[1])
    rm = RC.random_model(rg, 0.5, 0.5, jax.random.PRNGKey(seed))
    tm = ising_model_from_numpy(rg.p, rg.edges, np.asarray(rm.theta),
                                device="cpu")
    return rm, tm


def _assert_locals(tl, rl):
    for a, b in zip(tl, rl):
        assert a.i == b.i and a.beta == b.beta
        for name in ("H", "V", "S", "probs"):
            np.testing.assert_allclose(getattr(a, name), getattr(b, name),
                                       rtol=0, atol=TOL,
                                       err_msg=f"node {a.i} {name}")


def _assert_variances(tm, rm, tl, rl, include_singleton):
    """Every scheme's exact variance, the MLE's and the joint MPLE's, the
    port's functions on the port's locals against the reference's on
    ``rl``; the MLE is the floor of all of them."""
    tr_mle, V_mle = TC.exact_mle_variance(tm, include_singleton)
    rtr_mle, rV_mle = RC.exact_mle_variance(rm, include_singleton)
    np.testing.assert_allclose(V_mle, rV_mle, rtol=0, atol=TOL)
    assert abs(tr_mle - rtr_mle) <= TOL
    owners = TC.param_owners(tm.graph, include_singleton)
    for a, own in owners.items():
        np.testing.assert_allclose(TC.cross_cov(tl, a, own),
                                   RC.cross_cov(rl, a, own), rtol=0,
                                   atol=TOL)
    for sch in SCHEMES:
        tr, per = TC.exact_consensus_variance(tm, tl, sch, include_singleton)
        rtr, rper = RC.exact_consensus_variance(rm, rl, sch,
                                                include_singleton)
        assert abs(tr - rtr) <= TOL and per.keys() == rper.keys()
        assert max(abs(per[k] - rper[k]) for k in per) <= TOL
        assert abs(TC.efficiency(tr, tr_mle)
                   - RC.efficiency(rtr, rtr_mle)) <= TOL
        # no consensus scheme beats the exact MLE (Sec. 2.3)
        assert tr >= tr_mle * (1 - 1e-4)
    tr_j, V_j = TC.exact_joint_mple_variance(tm, include_singleton)
    rtr_j, rV_j = RC.exact_joint_mple_variance(rm, include_singleton)
    np.testing.assert_allclose(V_j, rV_j, rtol=0, atol=TOL)
    assert abs(tr_j - rtr_j) <= TOL and tr_j >= tr_mle * (1 - 1e-4)


def test_star_oracles_match_reference():
    """Fig. 2's setting: a star, edges free, singletons known."""
    rm, tm = _models(("star_graph", (6,)), 5)
    rl = RC.exact_locals(rm, include_singleton=False)
    tl = TC.exact_locals(tm, include_singleton=False)
    _assert_locals(tl, rl)
    _assert_variances(tm, rm, tl, rl, False)


def test_grid_oracles_with_singletons_match_reference():
    """Singletons free on a 2 x 3 grid: a corner's locals against the
    reference's (the reference compiles its enumeration anew for every
    node shape, about 10 s each here, so one shape stands for the rest;
    the star test covers two); the variances of the port's functions
    against the reference's functions on the port's locals."""
    rm, tm = _models(("grid_graph", (2, 3)), 3)
    tl = TC.exact_locals(tm, include_singleton=True)
    _assert_locals([tl[0]], [RC.exact_local(rm, 0, True)])
    _assert_variances(tm, rm, tl, tl, True)


def test_unknown_scheme_raises():
    _, tm = _models(("star_graph", (4,)), 0)
    tl = TC.exact_locals(tm, include_singleton=False)
    with pytest.raises(ValueError, match="median"):
        TC.exact_consensus_variance(tm, tl, "median", False)


def test_oracles_run_in_float64_from_a_float32_model():
    """A float32 theta is widened first: the oracles equal those of the
    float64 copy of the same numbers."""
    _, tm = _models(("star_graph", (5,)), 1)
    t32 = TC.IsingModel(tm.graph, tm.theta.float())
    t64 = TC.IsingModel(tm.graph, tm.theta.float().double())
    a, b = TC.exact_local(t32, 0, False), TC.exact_local(t64, 0, False)
    assert a.V.dtype == np.float64
    np.testing.assert_array_equal(a.V, b.V)
    assert TC.exact_mle_variance(t32, False)[0] == \
        TC.exact_mle_variance(t64, False)[0]
