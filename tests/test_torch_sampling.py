"""The port's samplers against exact moments, on the CPU.

The JAX and PyTorch random streams differ, so a sampler's parity is
agreement with the exact sufficient-statistic moments of the small-p
oracle, at the reference's conformance tolerance: max |mean u - E u| below
``moment_tol / sqrt(n)`` (4.5; 9.0 for the Gaussian, whose statistics are
unbounded). Seeds are fixed. Also: the reference's colour classes and
sweep selection, the "auto" rule, the degenerate graphs, and the scales of
``random_model`` and ``random_params``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core as RC  # noqa: E402
from repro.core.sampling import color_classes as ref_color_classes  # noqa
import repro_torch.core as TC  # noqa: E402
from repro_torch.core import sampling as TS  # noqa: E402

N = 4000
MOMENT_TOL = {"ising": 4.5, "gaussian": 9.0, "potts": 4.5}
#: the conformance cases' graphs (tests/families/test_conformance.py)
FAMILY_GRAPH = {"ising": (3, 3), "gaussian": (3, 3), "potts": (2, 3)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tests run many tiny tensor ops: one intra-op thread each keeps
    the test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _moment_err(fam, graph, theta, X):
    """max |mean u(X) - E u| in units of 1/sqrt(n)."""
    mu = fam.exact_moments(graph, theta)
    emp = fam.suff_stats(graph, X.double()).mean(0).numpy()
    return float(np.max(np.abs(emp - mu)) * np.sqrt(X.shape[0]))


def _model(graph, seed, sigma_pair=0.4, sigma_single=0.3):
    """A random Ising model at the conformance cases' scales (the Ising
    family's ``random_params`` defaults): stronger couplings mix slower, and
    at thin = 3 the chains' autocorrelation then widens the moment error
    past the iid tolerance."""
    return TC.random_model(graph, sigma_pair, sigma_single, _gen(seed),
                           device="cpu")


@pytest.mark.parametrize("method", ["exact", "sequential", "chromatic",
                                    "auto"])
def test_ising_samplers_match_exact_moments(method):
    g = TC.grid_graph(3, 3)
    m = _model(g, seed=0)
    gen = _gen(1)
    if method == "exact":
        X = TC.exact_sample(m, N, gen)
    else:
        X = TC.gibbs_sample(m, N, gen, burnin=300, thin=3, n_chains=16,
                            method=method)
    assert X.shape == (N, g.p) and X.dtype == torch.float32
    assert set(np.unique(X.numpy())) <= {-1.0, 1.0}
    assert _moment_err(TC.ISING, g, m.theta, X) < MOMENT_TOL["ising"]


@pytest.mark.parametrize("name", sorted(MOMENT_TOL))
def test_family_samplers_match_exact_moments(name):
    fam = TC.get_family(name)
    g = TC.grid_graph(*FAMILY_GRAPH[name])
    theta = fam.random_params(g, _gen(50), device="cpu")
    Xg = TC.gibbs_sample_family(fam, g, theta, N, _gen(51), burnin=300,
                                thin=3, n_chains=16)
    Xe = fam.exact_sample(g, theta, N, _gen(52))
    Xs = fam.sample(g, theta, N, _gen(53), burnin=300, thin=3, n_chains=16)
    for X in (Xg, Xe, Xs):
        assert X.shape == (N, g.p) and X.dtype == torch.float32
        assert _moment_err(fam, g, theta, X) < MOMENT_TOL[name]


def test_family_ising_chain_targets_the_seed_law():
    """The family chain on the Ising family and the seed chromatic chain
    draw from one law: both hit the same exact moments."""
    g = TC.grid_graph(3, 3)
    m = _model(g, seed=7)
    Xf = TC.gibbs_sample_family(TC.ISING, g, m.theta, N, _gen(8),
                                burnin=300, thin=3, n_chains=16)
    Xc = TC.chromatic_gibbs_sample(m, N, _gen(9), burnin=300, thin=3,
                                   n_chains=16)
    for X in (Xf, Xc):
        assert _moment_err(TC.ISING, g, m.theta, X) < MOMENT_TOL["ising"]


@pytest.mark.parametrize("graph", ["grid", "star", "scale_free", "complete",
                                   "edgeless"])
def test_color_classes_match_reference(graph):
    make = {"grid": ("grid_graph", (4, 5), {}),
            "star": ("star_graph", (7,), {}),
            "scale_free": ("scale_free_graph", (30,), {"m": 2, "seed": 1}),
            "complete": ("complete_graph", (6,), {}),
            "edgeless": ("Graph", (4, ()), {})}[graph]
    rg = getattr(RC, make[0])(*make[1], **make[2])
    tg = getattr(TC, make[0])(*make[1], **make[2])
    for got, want in zip(TS.color_classes(tg), ref_color_classes(rg)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


@pytest.mark.parametrize("burnin,thin,n", [(0, 1, 5), (7, 3, 4), (200, 5, 2)])
def test_chains_keep_the_reference_sweeps(burnin, thin, n):
    """_run_chains keeps the states the reference's
    ``xs[burnin::thin][:n]`` keeps of its burnin + n * thin sweeps: a
    counting update makes each kept state its sweep's number."""
    x = torch.zeros((2, 3))
    kept = TS._run_chains(lambda s: s.add_(1.0), x, 3, n, burnin, thin)
    sweeps = np.arange(1, burnin + n * thin + 1)[burnin::thin][:n]
    assert kept.shape == (2, n, 3)
    np.testing.assert_array_equal(kept[0, :, 0].numpy(), sweeps)


def test_rows_are_chain_major():
    """gibbs_sample lays each chain's ceil(n / n_chains) rows end to end,
    chain by chain, and cuts the tail to n: the same generator seed gives
    the chains' own draws in that order."""
    m = _model(TC.chain_graph(4), seed=2)
    X = TC.gibbs_sample(m, 10, _gen(3), burnin=5, thin=1, n_chains=3,
                        method="sequential")
    ts, T = TS._ising_inputs(m)
    chains = TS._gibbs_chains(ts, T, 4, 5, 1, 3, _gen(3))
    assert chains.shape == (3, 4, 4)
    assert torch.equal(X, chains.reshape(-1, 4)[:10])


def test_auto_rule_picks_the_reference_path():
    """Same generator seed, same draws: "auto" is the chromatic chain on a
    sparse colouring and the sequential one on complete_graph (colours >
    max(2, p // 2))."""
    for graph, path in ((TC.grid_graph(3, 3), "chromatic"),
                        (TC.complete_graph(5), "sequential"),
                        (TC.Graph(4, ()), "chromatic")):
        m = _model(graph, seed=4)
        auto = TC.gibbs_sample(m, 64, _gen(5), burnin=10, thin=2,
                               n_chains=4)
        forced = TC.gibbs_sample(m, 64, _gen(5), burnin=10, thin=2,
                                 n_chains=4, method=path)
        assert torch.equal(auto, forced), path


def test_complete_graph_sequential_chain_matches_exact_moments():
    g = TC.complete_graph(5)
    m = _model(g, seed=6, sigma_pair=0.3)
    X = TC.gibbs_sample(m, N, _gen(7), burnin=300, thin=3, n_chains=16)
    assert _moment_err(TC.ISING, g, m.theta, X) < MOMENT_TOL["ising"]


@pytest.mark.parametrize("graph", ["isolated", "edgeless"])
def test_degenerate_graphs_sample_their_marginals(graph):
    g = (TC.Graph(5, ((0, 1), (1, 2), (2, 3))) if graph == "isolated"
         else TC.Graph(4, ()))
    m = _model(g, seed=8)
    for X in (TC.gibbs_sample(m, N, _gen(9), burnin=50, thin=2,
                              n_chains=16),
              TC.exact_sample(m, N, _gen(10))):
        assert _moment_err(TC.ISING, g, m.theta, X) < MOMENT_TOL["ising"]


def test_unknown_method_raises():
    m = _model(TC.grid_graph(2, 2), seed=0)
    with pytest.raises(ValueError, match="unknown method"):
        TC.gibbs_sample(m, 8, _gen(0), method="metropolis")


def test_random_model_scales():
    g = TC.grid_graph(30, 30)
    m = TC.random_model(g, 0.5, 0.3, _gen(11), device="cpu")
    assert m.theta.dtype == torch.float64 and m.theta.shape == (g.p + g.m,)
    for block, sigma in ((m.theta_single, 0.3), (m.theta_edges, 0.5)):
        sd = float(block.std())
        # sample sd of k normals: relative error ~ 1/sqrt(2k); 5 of those
        assert abs(sd / sigma - 1) < 5 / np.sqrt(2 * block.numel())
        assert abs(float(block.mean())) < 5 * sigma / np.sqrt(block.numel())


@pytest.mark.parametrize("name", sorted(MOMENT_TOL))
def test_random_params_scales(name):
    fam = TC.get_family(name)
    g = TC.grid_graph(30, 30)
    theta = fam.random_params(g, _gen(12), device="cpu")
    C = fam.block_dim
    assert theta.dtype == torch.float64
    assert theta.shape == ((g.p + g.m) * C,)
    node, edge = theta[: g.p * C], theta[g.p * C:]
    assert abs(float(node.std()) / 0.3 - 1) < 5 / np.sqrt(2 * node.numel())
    if name != "gaussian":
        assert abs(float(edge.std()) / 0.4 - 1) < 5 / np.sqrt(
            2 * edge.numel())


def test_gaussian_random_params_stay_diagonally_dominant():
    """The guard scales the couplings so that no row of |T| sums past 0.9:
    on a grid at scale 0.4 the worst row (four edges) exceeds it."""
    g = TC.grid_graph(6, 6)
    theta = TC.GAUSSIAN.random_params(g, _gen(13), scale_edge=0.4,
                                      device="cpu").numpy()
    T = np.abs(np.eye(g.p) - TC.GAUSSIAN._precision(g, theta))
    assert np.isclose(T.sum(axis=1).max(), 0.9)
    assert np.all(np.linalg.eigvalsh(TC.GAUSSIAN._precision(g, theta)) > 0)
    small = TC.GAUSSIAN.random_params(g, _gen(13), scale_edge=0.01,
                                      device="cpu")
    edge = small[g.p:]
    assert float(edge.abs().max()) < 0.9 / 4


@pytest.mark.parametrize("name", sorted(MOMENT_TOL))
def test_random_rows_are_valid_values(name):
    fam = TC.get_family(name)
    X = TC.random_rows(fam, _gen(14), 500, 6, device="cpu")
    assert X.shape == (500, 6)
    v = X.numpy()
    if name == "ising":
        assert set(np.unique(v)) == {-1.0, 1.0}
    elif name == "potts":
        assert set(np.unique(v)) == {0.0, 1.0, 2.0}
    else:
        assert abs(v.mean()) < 0.1 and abs(v.std() - 1) < 0.1


def test_reference_model_drawn_by_the_port():
    """A reference model carried across (interop) is drawn by the port's
    sampler at its exact moments."""
    from repro_torch.interop import ising_model_from_numpy
    rm = RC.random_model(RC.grid_graph(3, 3), 0.5, 0.3,
                         jax.random.PRNGKey(3))
    tm = ising_model_from_numpy(9, rm.graph.edges, np.asarray(rm.theta),
                                device="cpu")
    X = TC.gibbs_sample(tm, N, _gen(15), burnin=300, thin=3, n_chains=16)
    mu = np.asarray(RC.exact_moments(rm.graph, rm.theta)[0])
    emp = TC.suff_stats(tm.graph, X.double()).mean(0).numpy()
    assert np.max(np.abs(emp - mu)) * np.sqrt(N) < MOMENT_TOL["ising"]
