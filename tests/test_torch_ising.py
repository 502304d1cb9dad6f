"""The port's Ising model math, exact enumeration and the families' model
and oracle methods against the JAX reference at float64 (1e-10) on the same
theta and X: a grid, a star, a graph with an isolated node and an edgeless
graph; the Gaussian's closed-form oracle, Potts' enumeration, the autodiff
pseudo-score (float32, as the reference) and the reference-model carrier."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as RC  # noqa: E402
import repro_torch.core as TC  # noqa: E402
from repro_torch.interop import ising_model_from_numpy  # noqa: E402

TOL = 1e-10
GRAPHS = {
    "grid": ((3, 3), "grid_graph"),
    "star": ((5,), "star_graph"),
    "isolated": None,
    "edgeless": None,
}


def _graphs(name):
    if name == "isolated":
        edges = ((0, 1), (1, 2), (2, 3))
        return RC.Graph(5, edges), TC.Graph(5, edges)
    if name == "edgeless":
        return RC.Graph(4, ()), TC.Graph(4, ())
    args, fn = GRAPHS[name]
    return getattr(RC, fn)(*args), getattr(TC, fn)(*args)


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


def _theta_x(rg, seed, n=64):
    rs = np.random.RandomState(seed)
    theta = np.concatenate([0.3 * rs.randn(rg.p), 0.5 * rs.randn(rg.m)])
    X = np.where(rs.rand(n, rg.p) < 0.5, 1.0, -1.0)
    return theta, X


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


def _close(got, want, tol=TOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol)


@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_model_math_matches_reference(gname):
    rg, tg = _graphs(gname)
    theta, X = _theta_x(rg, seed=len(gname))
    tj, Xj = jnp.asarray(theta), jnp.asarray(X)
    tt, Xt = _t(theta), _t(X)
    _close(TC.pair_matrix(tg, tt[tg.p:]), RC.pair_matrix(rg, tj[rg.p:]))
    _close(TC.conditional_logits(tg, tt, Xt),
           RC.conditional_logits(rg, tj, Xj))
    _close(TC.cond_loglik(tg, tt, Xt), RC.cond_loglik(rg, tj, Xj))
    _close(TC.pseudo_loglik(tg, tt, Xt), RC.pseudo_loglik(rg, tj, Xj))
    _close(TC.suff_stats(tg, Xt), RC.suff_stats(rg, Xj))
    np.testing.assert_array_equal(TC.all_states(tg.p), RC.all_states(rg.p))
    _close(TC.log_partition(tg, tt), RC.log_partition(rg, tj))
    _close(TC.exact_probs(tg, tt), RC.exact_probs(rg, tj))
    _close(TC.loglik(tg, tt, Xt), RC.loglik(rg, tj, Xj))
    mu, cov = TC.exact_moments(tg, tt)
    rmu, rcov = RC.exact_moments(rg, tj)
    _close(mu, rmu)
    _close(cov, rcov)
    assert mu.dtype == torch.float64


def test_all_states_bit_order():
    S = TC.all_states(3)
    assert S.dtype == np.float32 and S.shape == (8, 3)
    # row s holds the bits of s, lowest first: s = 6 -> (0, 1, 1)
    np.testing.assert_array_equal(S[6], [-1.0, 1.0, 1.0])


def test_enumeration_runs_in_float64_from_float32_theta():
    rg, tg = _graphs("grid")
    theta, _ = _theta_x(rg, seed=3)
    lz = TC.log_partition(tg, _t(theta).float())
    assert lz.dtype == torch.float64
    _close(lz, RC.log_partition(rg, jnp.asarray(theta, jnp.float32)
                                .astype(jnp.float64)))


_FAMILY_GRAPHS = {"ising": "grid", "gaussian": "grid", "potts": "isolated"}


def _family_data(name, rg, seed, n=48):
    fam = RC.get_family(name)
    theta = np.asarray(fam.random_params(rg, jax.random.PRNGKey(seed)))
    rs = np.random.RandomState(seed)
    if name == "ising":
        X = np.where(rs.rand(n, rg.p) < 0.5, 1.0, -1.0)
    elif name == "gaussian":
        X = rs.randn(n, rg.p)
    else:
        X = rs.randint(0, 3, (n, rg.p)).astype(np.float64)
    return theta, X


@pytest.mark.parametrize("name", sorted(_FAMILY_GRAPHS))
def test_family_model_and_oracle_match_reference(name):
    rg, tg = _graphs(_FAMILY_GRAPHS[name])
    rf, tf = RC.get_family(name), TC.get_family(name)
    theta, X = _family_data(name, rg, seed=11)
    tj, Xj = jnp.asarray(theta), jnp.asarray(X)
    tt, Xt = _t(theta), _t(X)
    _close(tf.suff_stats(tg, Xt), rf.suff_stats(rg, Xj))
    _close(tf.cond_logits(tg, tt, Xt), rf.cond_logits(rg, tj, Xj))
    _close(tf.cond_loglik(tg, tt, Xt), rf.cond_loglik(rg, tj, Xj))
    _close(tf.pseudo_loglik(tg, tt, Xt), rf.pseudo_loglik(rg, tj, Xj))
    if name == "potts":
        # the reference enumerates Potts states in float32 (its all_states
        # type); hold the port to the reference's formula at float64 and
        # to the reference's float32 oracle at float32's resolution
        _close(tf.exact_moments(tg, tt), _potts_f64(rg, theta)[2])
        _close(tf.exact_moments(tg, tt), rf.exact_moments(rg, tj), 1e-6)
    else:
        _close(tf.exact_moments(tg, tt), rf.exact_moments(rg, tj))
    # both take the autodiff pseudo-score in float32
    np.testing.assert_allclose(tf.pseudo_score(tg, theta, Xt),
                               rf.pseudo_score(rg, theta, X),
                               rtol=1e-5, atol=1e-6)


def test_gaussian_closed_form_oracle_matches_reference():
    rg, tg = _graphs("star")
    rf, tf = RC.GAUSSIAN, TC.GAUSSIAN
    theta = np.asarray(rf.random_params(rg, jax.random.PRNGKey(4)))
    for t in (theta, _t(theta)):
        np.testing.assert_allclose(tf._precision(tg, t),
                                   rf._precision(rg, theta), rtol=0,
                                   atol=TOL)
        mu, Sigma = tf.moments(tg, t)
        rmu, rSigma = rf.moments(rg, theta)
        _close(mu, rmu)
        _close(Sigma, rSigma)
        assert abs(tf.log_partition(tg, t)
                   - rf.log_partition(rg, theta)) <= TOL
    bad = theta.copy()
    bad[rg.p:] = 2.0
    with pytest.raises(ValueError, match="positive definite"):
        tf.log_partition(tg, bad)


def _potts_f64(rg, theta):
    """(probs, log Z, E[u]) by the reference's own enumeration formula with
    its states and theta in float64."""
    rf = RC.POTTS3
    U = rf.suff_stats(rg, jnp.asarray(rf.all_states(rg.p), jnp.float64))
    s = U @ jnp.asarray(theta, jnp.float64)
    pr = jax.nn.softmax(s)
    return pr, jax.scipy.special.logsumexp(s), pr @ U


def test_potts_enumeration_matches_reference():
    rg, tg = _graphs("isolated")
    rf, tf = RC.POTTS3, TC.POTTS3
    theta = np.asarray(rf.random_params(rg, jax.random.PRNGKey(5)))
    np.testing.assert_array_equal(tf.all_states(tg.p), rf.all_states(rg.p))
    pr, lz, _ = _potts_f64(rg, theta)
    _close(tf.exact_probs(tg, _t(theta)), pr)
    _close(tf.log_partition(tg, _t(theta)), lz)
    # the reference's own oracle enumerates in float32
    _close(tf.exact_probs(tg, _t(theta)), rf.exact_probs(rg, theta), 1e-6)
    _close(tf.log_partition(tg, _t(theta)), rf.log_partition(rg, theta),
           1e-5)


def test_reference_model_carrier():
    rg = RC.grid_graph(2, 3)
    rm = RC.random_model(rg, 0.5, 0.3, jax.random.PRNGKey(0))
    tm = ising_model_from_numpy(rm.graph.p, rm.graph.edges,
                                np.asarray(rm.theta), device="cpu")
    assert tm.graph == TC.grid_graph(2, 3)
    assert tm.theta.dtype == torch.float64
    _close(tm.theta, rm.theta, tol=0)
    _close(tm.theta_single, rm.theta_single, tol=0)
    _close(tm.theta_edges, rm.theta_edges, tol=0)
    with pytest.raises(ValueError, match="params"):
        ising_model_from_numpy(rg.p, rg.edges, np.zeros(3), device="cpu")
