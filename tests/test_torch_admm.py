"""The port's proximal engine and joint ADMM verb against the JAX reference
at float64: ``prox_update_batched`` for every family with per-node
consensus views, sample weights and fixed singletons, and
``session.joint`` for every family and every ``admm_init`` (trajectory,
primal residual, communication scalars)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.api as RA  # noqa: E402
import repro.core as RC  # noqa: E402
from repro.core.batched import prox_update_batched as ref_prox  # noqa: E402
import repro_torch.api as TA  # noqa: E402
from repro_torch.core import Graph  # noqa: E402
from repro_torch.core.admm import admm_mple_family, rho_from_fits  # noqa: E402
from repro_torch.core.batched import prox_update_batched  # noqa: E402
from repro_torch.interop import (local_fits_from_numpy,  # noqa: E402
                                 plan_from_reference)
from repro_torch.stream.costs import comm_costs  # noqa: E402

FAMILIES = ("gaussian", "ising", "potts")
N = 257
TOL = 1e-8


@pytest.fixture(scope="module", autouse=True)
def _x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _data(graph, family, n, seed):
    fam = RC.families.get_family(family)
    theta = np.asarray(fam.random_params(graph, jax.random.PRNGKey(seed)))
    X = fam.exact_sample(graph, theta, n, jax.random.PRNGKey(seed + 1))
    return fam, theta, np.asarray(X, dtype=np.float64)


def _prox_inputs(graph, fam, include_singleton, seed):
    rng = np.random.RandomState(seed)
    betas = [fam.beta(graph, i, include_singleton) for i in range(graph.p)]
    bars = [0.2 * rng.randn(len(b)) for b in betas]
    lams = [0.1 * rng.randn(len(b)) for b in betas]
    rhos = [rng.uniform(0.5, 2.0, len(b)) for b in betas]
    starts = [None if i == 1 else 0.1 * rng.randn(len(b))
              for i, b in enumerate(betas)]
    return bars, lams, rhos, starts


@pytest.mark.parametrize("include_singleton", [True, False])
@pytest.mark.parametrize("family", FAMILIES)
def test_prox_update_matches_reference_float64(family, include_singleton):
    graph = RC.star_graph(5)
    fam, theta, X = _data(graph, family, N, seed=3)
    bars, lams, rhos, starts = _prox_inputs(graph, fam, include_singleton, 4)
    tf = np.zeros(fam.n_params(graph))
    if not include_singleton:
        tf[: graph.p * fam.block_dim] = theta[: graph.p * fam.block_dim]
    counts = np.random.RandomState(5).randint(60, N + 1, size=graph.p)
    sw = (np.arange(N)[None, :] < counts[:, None]).astype(np.float64)
    want = ref_prox(graph, jnp.asarray(X), bars, lams, rhos, thetas0=starts,
                    include_singleton=include_singleton,
                    theta_fixed=jnp.asarray(tf), sample_weight=jnp.asarray(sw),
                    n_iter=15, family=fam)
    tgraph = Graph(graph.p, tuple(graph.edges))
    tfam = TA.Plan(graph=tgraph, family=family).family_instance
    got = prox_update_batched(
        tgraph, torch.tensor(X), bars, lams, rhos, thetas0=starts,
        include_singleton=include_singleton, theta_fixed=torch.as_tensor(tf),
        sample_weight=torch.as_tensor(sw), n_iter=15, family=tfam)
    assert len(got) == graph.p
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == np.float64 and a.shape == np.asarray(b).shape
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=TOL,
                                   err_msg=f"node {i}")


@pytest.mark.parametrize("family", FAMILIES)
def test_prox_update_global_bar_unweighted_matches_reference(family):
    graph = RC.grid_graph(3, 3)
    fam, theta, X = _data(graph, family, N, seed=13)
    _, lams, rhos, _ = _prox_inputs(graph, fam, True, 14)
    bar = 0.5 * theta
    want = ref_prox(graph, jnp.asarray(X), bar, lams, rhos, n_iter=15,
                    family=fam)
    tgraph = Graph(graph.p, tuple(graph.edges))
    got = prox_update_batched(
        tgraph, torch.tensor(X), bar, lams, rhos, n_iter=15,
        family=TA.Plan(graph=tgraph, family=family).family_instance)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=TOL)


@pytest.mark.parametrize("init", ["zero", "uniform", "diagonal"])
@pytest.mark.parametrize("family", FAMILIES)
def test_joint_matches_reference_float64(family, init):
    graph = RC.grid_graph(3, 3)
    _, _, X = _data(graph, family, N, seed=23)
    rp = RA.Plan(graph=graph, family=family, precision="float64",
                 admm_init=init, admm_iters=6, admm_rho=1.5)
    tp = plan_from_reference(rp.to_dict())
    jr = rp.session().joint(X)
    tr = tp.session(device="cpu").joint(X)
    assert tr.mode == "joint" and sorted(tr.combined) == ["admm"]
    assert tr.trajectory.shape == jr.trajectory.shape == (7, jr.theta.size)
    np.testing.assert_allclose(tr.trajectory, jr.trajectory, rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(tr.primal_residual, jr.primal_residual,
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(tr.theta, jr.theta, rtol=0, atol=TOL)
    assert tr.comm_scalars == jr.comm_scalars
    # the score norm runs in float32 in both packages
    np.testing.assert_allclose(tr.score_norm, jr.score_norm, rtol=1e-5,
                               atol=1e-6)
    assert (tr.fits is None) == (jr.fits is None) == (init == "zero")
    assert "admm_iters=6" in repr(tr)


def test_joint_with_sample_weight_and_fixed_singletons():
    graph = RC.grid_graph(3, 3)
    fam, theta, X = _data(graph, "ising", N, seed=33)
    tf = tuple(float(v) for v in np.concatenate(
        [theta[: graph.p], np.zeros(graph.m)]))
    rp = RA.Plan(graph=graph, precision="float64", include_singleton=False,
                 theta_fixed=tf, admm_iters=4)
    tp = plan_from_reference(rp.to_dict())
    sw = (np.arange(N) < 200).astype(np.float64)
    jr = rp.session().joint(X, sample_weight=sw)
    tr = tp.session(device="cpu").joint(X, sample_weight=sw)
    np.testing.assert_allclose(tr.trajectory, jr.trajectory, rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(tr.primal_residual, jr.primal_residual,
                               rtol=0, atol=TOL)


def test_admm_engine_and_penalties_match_reference():
    graph = RC.star_graph(6)
    fam, _, X = _data(graph, "potts", N, seed=43)
    rp = RA.Plan(graph=graph, family="potts", precision="float64")
    jfits = rp.session().fit_local(X)
    tfits = local_fits_from_numpy(jfits)
    tgraph = Graph(graph.p, tuple(graph.edges))
    tfam = plan_from_reference(rp.to_dict()).family_instance
    for scheme in ("uniform", "diagonal"):
        for a, b in zip(rho_from_fits(tgraph, tfits, scheme, family=tfam),
                        RC.rho_from_fits(graph, jfits, scheme, family=fam)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="uniform"):
        rho_from_fits(tgraph, tfits, "max", family=tfam)
    want = RC.admm_mple_family(graph, jnp.asarray(X), n_iters=3,
                               init="diagonal", fits=jfits, family=fam,
                               newton_iters=10)
    got = admm_mple_family(tgraph, torch.tensor(X), n_iters=3,
                           init="diagonal", fits=tfits, family=tfam,
                           newton_iters=10)
    np.testing.assert_allclose(got.trajectory, want.trajectory, rtol=0,
                               atol=TOL)
    with pytest.raises(ValueError, match="fits"):
        admm_mple_family(tgraph, torch.tensor(X), init="diagonal",
                         family=tfam)
    # the combinatorial comm table the joint verb bills with
    from repro.stream.costs import comm_costs as ref_costs
    for n, k in ((100, 30), (4000, 7)):
        assert comm_costs(tgraph, n, k) == ref_costs(graph, n, k)
