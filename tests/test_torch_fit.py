"""``Plan(...).session().fit(X)`` of the PyTorch port against the JAX
reference at float64: every family, every registered combiner, on graphs
with a hub, a grid and an isolated node; warm starts and sample weights;
and one plan dict driving both packages."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.api as RA  # noqa: E402
import repro.core as RC  # noqa: E402
from repro.core.batched import _solve_bucket  # noqa: E402
import repro_torch.api as TA  # noqa: E402
from repro_torch.core import combiners as tcomb  # noqa: E402
from repro_torch.interop import (local_fits_from_numpy,  # noqa: E402
                                 plan_from_reference, theta_from_numpy)

ALL_COMBINERS = tuple(c.name for c in RC.combiners.registered_combiners())
GRAPHS = {
    "star": RC.star_graph(5),
    "grid": RC.grid_graph(3, 3),
    "isolated": RC.Graph(5, ((0, 1), (1, 2), (2, 3))),
}
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
    return theta, np.asarray(X, dtype=np.float64)


def _plans(graph, family, **kw):
    rp = RA.Plan(graph=graph, family=family, combiners=ALL_COMBINERS,
                 precision="float64", **kw)
    return rp, plan_from_reference(rp.to_dict())


def _assert_fits_match(jfits, tfits, tol=TOL):
    assert len(jfits) == len(tfits)
    for a, b in zip(jfits, tfits):
        assert a.i == b.i and list(a.beta) == list(b.beta)
        for name in ("theta", "H", "J", "V", "s"):
            np.testing.assert_allclose(getattr(b, name), getattr(a, name),
                                       rtol=0, atol=tol,
                                       err_msg=f"node {a.i} {name}")


@pytest.mark.parametrize("gname", sorted(GRAPHS))
@pytest.mark.parametrize("family", FAMILIES)
def test_fit_matches_reference_float64(family, gname):
    graph = GRAPHS[gname]
    _, X = _data(graph, family, N, seed=7)
    rp, tp = _plans(graph, family)
    jr = rp.session().fit(X)
    tr = tp.session(device="cpu").fit(X)
    _assert_fits_match(jr.fits, tr.fits)
    assert sorted(tr.combined) == sorted(jr.combined)
    for name in ALL_COMBINERS:
        np.testing.assert_allclose(tr.combined[name], jr.combined[name],
                                   rtol=0, atol=TOL, err_msg=name)
    np.testing.assert_allclose(tr.theta, jr.theta, rtol=0, atol=TOL)
    assert tr.comm_scalars == jr.comm_scalars
    # the score path runs in float32 in both packages
    np.testing.assert_allclose(tr.score_norm, jr.score_norm, rtol=1e-5)
    assert tr.n_samples == jr.n_samples == N


@pytest.mark.parametrize("family", FAMILIES)
def test_newton_iteration_counts_match_reference(family):
    graph = GRAPHS["grid"]
    _, X = _data(graph, family, N, seed=11)
    fam = RC.families.get_family(family)
    C = fam.block_dim
    want = {}
    for b in RC.batched.degree_buckets(graph):
        k = len(b.nodes)
        dC = (b.deg_pad + 1) * C
        *_, I = _solve_bucket(
            jnp.asarray(X), jnp.asarray(b.nodes), jnp.asarray(b.nbrs),
            jnp.asarray(b.mask), jnp.zeros((k, C)), jnp.zeros((k, dC)),
            jnp.ones((1, 1)), True, 40, False, False, fam,
            want_influence=False)
        want[b.deg_pad] = int(np.asarray(I)[0])
    _, tp = _plans(graph, family)
    got = {}
    tp.session(device="cpu").fit_local(X, iters=got)
    assert got == want and all(v >= 1 for v in got.values())


@pytest.mark.parametrize("family", FAMILIES)
def test_warm_start_and_sample_weight_match_reference(family):
    graph = GRAPHS["grid"]
    _, X = _data(graph, family, N, seed=21)
    rp, tp = _plans(graph, family)
    jsess, tsess = rp.session(), tp.session(device="cpu")
    # a first fit on a prefix gives the warm starts, as a stream would
    prior = jsess.fit_local(X[:120])
    warm_j = [f.theta for f in prior]
    warm_t = [f.theta for f in local_fits_from_numpy(prior)]
    rng = np.random.RandomState(3)
    counts = rng.randint(150, N + 1, size=graph.p)
    sw = (np.arange(N)[None, :] < counts[:, None]).astype(np.float64)
    jr = jsess.fit(X, sample_weight=sw, warm_start=warm_j)
    tr = tsess.fit(X, sample_weight=sw, warm_start=warm_t)
    _assert_fits_match(jr.fits, tr.fits)
    for name in ALL_COMBINERS:
        np.testing.assert_allclose(tr.combined[name], jr.combined[name],
                                   rtol=0, atol=TOL, err_msg=name)
    # a shared (n,) weight vector as well
    shared = (np.arange(N) < 200).astype(np.float64)
    _assert_fits_match(jsess.fit_local(X, sample_weight=shared),
                       tsess.fit_local(X, sample_weight=shared))


def test_combiners_match_reference_on_identical_fits():
    graph = GRAPHS["grid"]
    _, X = _data(graph, "potts", N, seed=31)
    rp, tp = _plans(graph, "potts")
    jfits = rp.session().fit_local(X)
    tfits = local_fits_from_numpy(jfits)
    fam_j = rp.family_instance
    fam_t = tp.family_instance
    for name in ALL_COMBINERS:
        want = RC.combiners.get_combiner(name).combine(graph, jfits,
                                                       family=fam_j)
        got = tcomb.get_combiner(name).combine(tp.graph, tfits, family=fam_t)
        np.testing.assert_array_equal(got, want, err_msg=name)
        assert theta_from_numpy(got, tp).shape == (fam_t.n_params(tp.graph),)


def test_plan_dict_round_trips_through_both_packages():
    graph = GRAPHS["isolated"]
    n_params = RC.families.get_family("potts").n_params(graph)
    rp = RA.Plan(graph=graph, family="potts", combiners=("max", "diagonal"),
                 include_singleton=False, theta_fixed=tuple(
                     0.01 * np.arange(n_params)), n_iter=12,
                 precision="float64", capacity=32, admm_iters=5,
                 admm_init="uniform", admm_newton_iters=3, admm_rho=0.5,
                 stream_window=100, stream_discount=0.9)
    d = rp.to_dict()
    tp = plan_from_reference(d)
    assert tp.to_dict() == d
    assert RA.Plan.from_dict(tp.to_dict()) == rp
    # and the fixed-singleton plan fits the same in both packages
    _, X = _data(graph, "potts", N, seed=41)
    jr = rp.session().fit(X)
    tr = tp.session(device="cpu").fit(X)
    _assert_fits_match(jr.fits, tr.fits)
    for name in ("max", "diagonal"):
        np.testing.assert_allclose(tr.combined[name], jr.combined[name],
                                   rtol=0, atol=TOL)


def test_interop_rejects_mismatched_state():
    graph = GRAPHS["star"]
    _, tp = _plans(graph, "ising")
    with pytest.raises(ValueError):
        theta_from_numpy(np.zeros(3), tp)
    rp, _ = _plans(graph, "ising")
    _, X = _data(graph, "ising", 64, seed=51)
    fits = rp.session().fit_local(X)
    with pytest.raises(ValueError, match="node order"):
        local_fits_from_numpy(fits[::-1])


def test_paper_graph_diverged_fits_match_reference():
    """Fig. 4's Euclidean graph at n = 1000: some local MLEs do not exist
    (the fits run off to |theta| > 5), and the reference's fits run off on
    the same nodes. theta agrees everywhere; the sandwich variance V agrees
    only where the curvature H is well conditioned."""
    from repro.core.sampling import chromatic_gibbs_sample

    graph = RC.euclidean_graph(100, radius=0.15, seed=0)
    model = RC.random_model(graph, 0.5, 0.5, jax.random.PRNGKey(1))
    X = np.asarray(chromatic_gibbs_sample(model, 1000,
                                          jax.random.PRNGKey(101)),
                   dtype=np.float64)
    rp = RA.Plan(graph=graph, family="ising", combiners=("diagonal",),
                 precision="float64")
    jfits = rp.session().fit_local(X)
    tfits = plan_from_reference(rp.to_dict()).session(
        device="cpu").fit_local(X)

    def diverged(fits):
        return [f.i for f in fits if np.abs(f.theta).max() > 5.0]

    assert diverged(jfits) == diverged(tfits) != []
    for a, b in zip(jfits, tfits):
        np.testing.assert_allclose(b.theta, a.theta, rtol=0, atol=1e-7,
                                   err_msg=f"node {a.i}")
        if np.linalg.cond(a.H) < 1e6:
            np.testing.assert_allclose(b.V, a.V, rtol=1e-6,
                                       atol=1e-8 * np.abs(a.V).max(),
                                       err_msg=f"node {a.i}")
