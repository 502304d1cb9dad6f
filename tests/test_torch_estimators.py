"""The port's estimators against the JAX reference at float64 on the same
X: the per-node CL fits and the loop path (theta, H, J, V, s within 1e-8),
the centralized MPLE and exact MLE, the family reference fits and per-node
oracle, and the seed ADMM (3 x 3 grid, 5 rounds); ``fit_all_local``
batched against loop within 1e-5 (the batched shim runs the default plan's
float32 engine, as the reference's does), its ``ValueError``s, and the
degenerate probes: an isolated node and an edgeless graph."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as RC  # noqa: E402
import repro_torch.core as TC  # noqa: E402
from repro_torch.interop import local_fits_from_numpy  # noqa: E402

TOL = 1e-8
BATCHED_TOL = 1e-5


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


def _graph(name):
    if name == "grid":
        return RC.grid_graph(3, 3), TC.grid_graph(3, 3)
    if name == "isolated":
        edges = ((0, 1), (1, 2), (2, 3))
        return RC.Graph(5, edges), TC.Graph(5, edges)
    return RC.Graph(4, ()), TC.Graph(4, ())          # edgeless


def _data(rg, seed, n=1500):
    """Theta and X drawn by the reference at float64: couplings 0.4 keep
    every local Hessian well conditioned at this n."""
    m = RC.random_model(rg, 0.4, 0.3, jax.random.PRNGKey(seed))
    X = RC.exact_sample(m, n, jax.random.PRNGKey(seed + 1))
    return np.asarray(m.theta, np.float64), np.asarray(X, np.float64)


def _assert_fits(tfits, rfits, tol):
    assert len(tfits) == len(rfits)
    for a, b in zip(tfits, rfits):
        assert a.i == b.i and list(a.beta) == list(b.beta)
        for name in ("theta", "H", "J", "V", "s"):
            np.testing.assert_allclose(getattr(a, name), getattr(b, name),
                                       rtol=0, atol=tol,
                                       err_msg=f"node {a.i} {name}")


@pytest.mark.parametrize("gname,include_singleton", [
    ("grid", True), ("grid", False), ("isolated", True), ("edgeless", True)])
def test_loop_fits_match_reference(gname, include_singleton):
    rg, tg = _graph(gname)
    theta, X = _data(rg, seed=1)
    tf = theta if not include_singleton else None
    rfits = RC.fit_all_local(rg, jnp.asarray(X), include_singleton,
                             None if tf is None else jnp.asarray(tf),
                             method="loop")
    tfits = TC.fit_all_local(tg, torch.tensor(X), include_singleton, tf,
                             method="loop")
    _assert_fits(tfits, rfits, TOL)
    # the batched shim on the same data: float32 engine, 1e-5
    bfits = TC.fit_all_local(tg, torch.tensor(X), include_singleton, tf)
    for a, b in zip(bfits, tfits):
        assert list(a.beta) == list(b.beta)
        np.testing.assert_allclose(a.theta, b.theta, rtol=0,
                                   atol=BATCHED_TOL)


def test_node_design_and_cl_fn_match_reference():
    rg, tg = _graph("grid")
    theta, X = _data(rg, seed=2, n=200)
    for i in (0, 4):
        np.testing.assert_array_equal(
            TC.node_design(tg, torch.tensor(X), i).numpy(),
            np.asarray(RC.node_design(rg, jnp.asarray(X), i)))
    from repro.core.estimators import node_cl_fn as rfn
    from repro_torch.core.estimators import node_cl_fn as tfn
    for inc in (True, False):
        fr, dr = rfn(rg, jnp.asarray(X), 4, inc, jnp.asarray(theta))
        ft, dt = tfn(tg, torch.tensor(X), 4, inc, torch.tensor(theta))
        w = np.linspace(-0.5, 0.5, dr)
        assert dt == dr
        assert abs(float(ft(torch.tensor(w))) - float(fr(jnp.asarray(w)))) \
            <= 1e-12


def test_newton_maximize_matches_reference():
    A = np.array([[3.0, 0.5], [0.5, 2.0]])
    b = np.array([1.0, -2.0])
    wr = RC.newton_maximize(
        lambda w: -0.5 * w @ jnp.asarray(A) @ w + jnp.asarray(b) @ w
        - jnp.sum(w ** 4), jnp.zeros(2), n_iter=30)
    wt = TC.newton_maximize(
        lambda w: -0.5 * w @ torch.tensor(A) @ w + torch.tensor(b) @ w
        - torch.sum(w ** 4), torch.zeros(2, dtype=torch.float64), n_iter=30)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wr), rtol=0, atol=1e-12)
    # max_step caps a step's norm: one step from 0 towards a far optimum
    w1 = TC.newton_maximize(lambda w: -torch.sum((w - 100.0) ** 2),
                            torch.zeros(2, dtype=torch.float64), n_iter=1)
    assert abs(float(torch.linalg.norm(w1)) - 5.0) < 1e-12


def test_centralized_fits_match_reference():
    rg, tg = _graph("grid")
    theta, X = _data(rg, seed=3)
    Xj, Xt = jnp.asarray(X), torch.tensor(X)
    np.testing.assert_allclose(TC.fit_mple(tg, Xt), RC.fit_mple(rg, Xj),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(TC.fit_mle_exact(tg, Xt),
                               RC.fit_mle_exact(rg, Xj), rtol=0, atol=TOL)
    # singletons held at the truth, edges free (the paper's Fig. 2 setup)
    free = np.arange(rg.p, rg.p + rg.m)
    got = TC.fit_mple(tg, Xt, free_idx=free, theta_fixed=theta, n_iter=20)
    want = RC.fit_mple(rg, Xj, free_idx=free, theta_fixed=jnp.asarray(theta),
                       n_iter=20)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_array_equal(got[: rg.p], theta[: rg.p])


@pytest.mark.parametrize("name", ["gaussian", "ising", "potts"])
def test_family_reference_fits_match_reference(name):
    rg, tg = (RC.grid_graph(2, 3), TC.grid_graph(2, 3))
    rf, tf = RC.get_family(name), TC.get_family(name)
    theta = np.asarray(rf.random_params(rg, jax.random.PRNGKey(5)))
    X = np.asarray(rf.exact_sample(rg, theta, 1500, jax.random.PRNGKey(6)),
                   np.float64)
    np.testing.assert_allclose(
        TC.fit_mple_family(tf, tg, torch.tensor(X), n_iter=20),
        RC.fit_mple_family(rf, rg, X, n_iter=20), rtol=0, atol=TOL)
    # the hub of the 2 x 3 grid with its singleton free; for Potts also a
    # corner with its singleton block held at theta (C = 2 offsets)
    for i, inc in ((1, True),) + (((3, False),) if name == "potts" else ()):
        np.testing.assert_allclose(
            TC.fit_node_oracle(tf, tg, torch.tensor(X), i, inc, theta,
                               n_iter=20),
            RC.fit_node_oracle(rf, rg, X, i, inc, theta, n_iter=20),
            rtol=0, atol=TOL)


@pytest.mark.parametrize("init,rounds", [("diagonal", 5), ("zero", 2)])
def test_seed_admm_matches_reference(init, rounds):
    rg, tg = _graph("grid")
    _, X = _data(rg, seed=7, n=1000)
    rfits = RC.fit_all_local(rg, jnp.asarray(X), method="loop")
    r = RC.admm_mple(rg, jnp.asarray(X), n_iters=rounds, init=init,
                     fits=rfits)
    t = TC.admm_mple(tg, torch.tensor(X), n_iters=rounds, init=init,
                     fits=local_fits_from_numpy(rfits))
    np.testing.assert_allclose(t.trajectory, r.trajectory, rtol=0, atol=TOL)
    np.testing.assert_allclose(t.primal_residual, r.primal_residual,
                               rtol=0, atol=TOL)
    assert t.primal_residual[-1] < t.primal_residual[0]


def test_fit_all_local_batched_matches_reference_batched():
    """Both shims run their package's float32 engine through a default
    plan; they agree to float32's resolution."""
    rg, tg = _graph("grid")
    _, X = _data(rg, seed=8)
    rfits = RC.fit_all_local(rg, jnp.asarray(X))
    tfits = TC.fit_all_local(tg, torch.tensor(X))
    for a, b in zip(tfits, rfits):
        np.testing.assert_allclose(a.theta, b.theta, rtol=0, atol=1e-5)
        assert a.s.shape == b.s.shape == (1500, len(b.beta))


def test_fit_all_local_rejects_what_the_reference_rejects():
    tg = TC.grid_graph(2, 2)
    X = torch.ones((8, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="unknown method"):
        TC.fit_all_local(tg, X, method="vectorised")
    with pytest.raises(ValueError, match="method='batched'"):
        TC.fit_all_local(tg, X, method="loop", sample_weight=torch.ones(8))
    with pytest.raises(ValueError, match="method='batched'"):
        TC.fit_all_local(tg, X, method="loop", warm_start=[None] * 4)
    with pytest.raises(ValueError, match="only the Ising family"):
        TC.fit_all_local(tg, X, method="loop", family=TC.POTTS3)


def test_fit_all_local_unregistered_family_calls_the_engine():
    """A family instance no plan can name runs the engine directly and
    equals the registered instance's fit."""
    tg = TC.grid_graph(2, 3)
    _, X = _data(RC.grid_graph(2, 3), seed=9, n=800)
    Xt = torch.tensor(X)
    from repro_torch.core.batched import fit_all_local_batched
    mine = TC.IsingFamily(name="ising-copy")
    got = TC.fit_all_local(tg, Xt, family=mine)
    _assert_fits(got, fit_all_local_batched(tg, Xt, family=TC.ISING), 0.0)
    # as in the reference, no plan casts X: the engine runs in float64
    assert got[0].theta.dtype == np.float64
