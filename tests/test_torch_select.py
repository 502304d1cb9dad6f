"""``session.select`` on the port against a live JAX reference run.

Parity at float64 (x64 on in the reference) on small planted grids, for
every family, every vote rule and each candidate policy: the support, the
candidate edges, the per-lambda support sizes, the selected lambda and the
vote bill are equal; the lambda grid agrees within 1e-12 relative, EBIC
within 1e-8 relative, margins and the debiased thetas within 1e-8. Then the
reference's ``tests/structure/test_select.py`` and ``test_lambda0.py`` case
for case (at lambda = 0 the path reproduces the port's own ``fit`` within
1e-8), but for the telemetry and compile-sharing cases, which have no
counterpart yet: the port counts kernel-library builds, none on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.api as RA  # noqa: E402
import repro.core as RC  # noqa: E402
from repro.core.families import random_rows  # noqa: E402
import repro_torch.api as TA  # noqa: E402
from repro_torch.api import Plan, StructureResult, StructureSpec  # noqa: E402
from repro_torch.core import (Graph, chain_graph, complete_graph,  # noqa: E402
                              grid_graph)
from repro_torch.core.batched import fit_all_local_batched  # noqa: E402
from repro_torch.core.families import registered_families  # noqa: E402
from repro_torch.interop import plan_from_reference  # noqa: E402
from repro_torch.kernels.cl import newton as nmod  # noqa: E402
from repro_torch.stream.costs import structure_vote_scalars  # noqa: E402
from repro_torch.structure import candidate_graph  # noqa: E402

FAMILY_NAMES = [f.name for f in registered_families()]
TOL = 1e-8


@pytest.fixture(scope="module", autouse=True)
def _x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: the port's loops launch
    many small ops, and in a suite run in parallel processes each op's
    thread team would contend for the cores with the other workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grid_data(family, n, seed, rows=3, cols=3):
    """Exact samples of a planted grid with random parameters, drawn by the
    reference (the packages' RNG streams differ)."""
    g = RC.grid_graph(rows, cols)
    fam = RA.Plan(graph=g, family=family).family_instance
    theta = np.asarray(fam.random_params(g, jax.random.PRNGKey(seed)))
    X = fam.exact_sample(g, theta, n, jax.random.PRNGKey(seed + 1))
    return g, np.asarray(X, dtype=np.float64)


def _both(rplan, X):
    """(reference result, port result) of one select on the same plan."""
    jr = rplan.session().select(X)
    tr = plan_from_reference(rplan.to_dict()).session(device="cpu").select(X)
    return jr, tr


def _assert_parity(jr, tr):
    assert isinstance(tr, StructureResult)
    assert tr.candidate_edges == jr.candidate_edges
    assert tr.support == jr.support
    assert tr.graph.edges == jr.graph.edges
    assert tr.support_sizes == jr.support_sizes
    assert tr.comm_scalars == jr.comm_scalars
    assert tr.vote_rule == jr.vote_rule and tr.n_samples == jr.n_samples
    np.testing.assert_allclose(tr.lambdas, jr.lambdas, rtol=1e-12, atol=0)
    # the same point of the grid is selected (an auto grid's values agree
    # to 1e-12, not to the bit: both sum the gradient in their own order)
    assert tr.lambdas.index(tr.lambda_selected) \
        == jr.lambdas.index(jr.lambda_selected)
    np.testing.assert_allclose(tr.ebic, jr.ebic, rtol=TOL, atol=0)
    np.testing.assert_allclose(tr.margins, jr.margins, rtol=0, atol=TOL)
    assert len(tr.thetas) == len(jr.thetas)
    for a, b in zip(tr.thetas, jr.thetas):
        assert a.shape == np.asarray(b).shape
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=TOL)


# ------------------------------------------------- parity with the reference
@pytest.mark.parametrize("rule", ["and", "or", "weighted"])
@pytest.mark.parametrize("family", FAMILY_NAMES)
def test_select_full_policy_matches_reference_float64(family, rule):
    g, X = _grid_data(family, 800, seed=5)
    spec = RA.StructureSpec(policy="full", n_lambdas=6, admm_rounds=20,
                            vote=rule)
    jr, tr = _both(RA.Plan(graph=g, family=family, precision="float64",
                           structure=spec), X)
    _assert_parity(jr, tr)
    assert 0 < len(tr.support) < len(tr.candidate_edges)


@pytest.mark.parametrize("policy", ["knn", "given"])
@pytest.mark.parametrize("family", FAMILY_NAMES)
def test_select_screened_policies_match_reference_float64(family, policy):
    g, X = _grid_data(family, 800, seed=15)
    extra = ({"knn_k": 3} if policy == "knn"
             else {"given_edges": tuple(g.edges) + ((0, 4), (2, 6))})
    spec = RA.StructureSpec(policy=policy, n_lambdas=6, admm_rounds=20,
                            vote="weighted", **extra)
    jr, tr = _both(RA.Plan(graph=g, family=family, precision="float64",
                           structure=spec), X)
    _assert_parity(jr, tr)


def test_select_fixed_singletons_and_explicit_grid_match_reference():
    # include_singleton=False: the plan's node blocks are remapped onto the
    # candidate graph as fixed coordinates; an explicit grid ending at 0
    g, X = _grid_data("ising", 800, seed=25)
    fam = RA.Plan(graph=g).family_instance
    theta = np.asarray(fam.random_params(g, jax.random.PRNGKey(25)))
    tf = tuple(float(v) for v in np.concatenate([theta[: g.p],
                                                 np.zeros(g.m)]))
    spec = RA.StructureSpec(policy="full", lambdas=(0.3, 0.1, 0.03, 0.0),
                            admm_rounds=20, vote="and", ebic_gamma=0.25)
    jr, tr = _both(RA.Plan(graph=g, precision="float64",
                           include_singleton=False, theta_fixed=tf,
                           structure=spec), X)
    _assert_parity(jr, tr)
    assert tr.thetas[0].shape == (g.p - 1,)      # edge blocks only


def test_select_planted_grid_f1_float32_equals_reference():
    g, X = _planted_grid()
    spec = RA.StructureSpec(policy="full", n_lambdas=8)
    jr, tr = _both(RA.Plan(graph=g, family="ising", structure=spec), X)
    assert tr.edge_metrics(g.edges) == jr.edge_metrics(g.edges)
    assert tr.edge_metrics(g.edges)["f1"] == 1.0


def test_dense_fit_variances_do_not_need_influence_stacks():
    # the weighted vote's masses read V's diagonal, which the engine computes
    # with or without the per-sample influence stacks
    g, X = _grid_data("potts", 400, seed=35)
    tg = complete_graph(g.p)
    fam = Plan(graph=tg, family="potts").family_instance
    Xt = torch.tensor(X)
    a = fit_all_local_batched(tg, Xt, family=fam, want_influence=True)
    b = fit_all_local_batched(tg, Xt, family=fam, want_influence=False)
    for fa, fb in zip(a, b):
        assert np.array_equal(fa.V, fb.V) and np.array_equal(fa.theta,
                                                             fb.theta)
        assert fb.s.shape[0] == 0 and fa.s.shape[0] == X.shape[0]


# ---------------------------------------- the reference's select cases
def _planted_grid():
    """3x3 Ising grid, couplings +-0.5, recoverable at n = 1500."""
    g = RC.grid_graph(3, 3)
    fam = RA.Plan(graph=g, family="ising").family_instance
    theta = np.zeros(fam.n_params(g))
    signs = np.where(np.random.RandomState(7).rand(g.m) < 0.5, 1.0, -1.0)
    theta[g.p:] = 0.5 * signs
    X = np.asarray(fam.sample(g, theta, 1500, jax.random.PRNGKey(3)))
    return g, X


@pytest.fixture(scope="module")
def planted_grid():
    g, X = _planted_grid()
    return grid_graph(3, 3), Plan(graph=grid_graph(3, 3), family="ising"), X


def test_select_recovers_planted_grid(planted_grid):
    g, plan, X = planted_grid
    spec = StructureSpec(policy="full", n_lambdas=8)
    res = plan.replace(structure=spec).session(device="cpu").select(X)
    m = res.edge_metrics(g.edges)
    assert m["f1"] == 1.0, m
    assert isinstance(res.graph, Graph)
    assert res.graph.edges == res.support
    assert res.margins.shape == (len(res.candidate_edges),)
    kept = {e: mg for e, mg in zip(res.candidate_edges, res.margins)
            if e in set(res.support)}
    assert all(mg >= 0 for mg in kept.values())
    assert res.ebic.shape == (len(res.lambdas),)
    assert res.lambda_selected in res.lambdas
    assert len(res.support_sizes) == len(res.lambdas)


def test_path_builds_no_library_on_the_cpu_warm_equals_cold(planted_grid):
    g, plan, X = planted_grid
    spec = StructureSpec(policy="full", n_lambdas=6, admm_rounds=12)
    sess = plan.replace(structure=spec).session(device="cpu")
    n0 = nmod.bucket_newton_stats.launches
    cold = sess.select(X)
    # the plain versions serve CPU tensors: no kernel library is built or
    # launched, so path_compiles and new_compiles are 0 from the first call
    assert cold.path_compiles == cold.new_compiles == 0
    assert cold.compile_s == 0.0 and cold.wall_s > 0.0
    warm = sess.select(np.ascontiguousarray(X[::-1]))
    assert warm.path_compiles == warm.new_compiles == 0
    assert warm.support == cold.support
    assert nmod.bucket_newton_stats.launches == n0


def test_use_kernel_false_is_the_plain_path_on_the_cpu(planted_grid):
    g, plan, X = planted_grid
    spec = StructureSpec(policy="full", n_lambdas=4, admm_rounds=8)
    sess = plan.replace(structure=spec).session(device="cpu")
    a, b = sess.select(X), sess.select(X, use_kernel=False)
    assert a.support == b.support and np.array_equal(a.ebic, b.ebic)


def test_knn_policy_screens_candidates():
    p, n = 8, 300
    spec = StructureSpec(policy="knn", knn_k=3, n_lambdas=4, admm_rounds=8)
    plan = Plan(graph=chain_graph(p), structure=spec)
    X = np.asarray(random_rows(RA.Plan(graph=RC.chain_graph(p))
                               .family_instance, jax.random.PRNGKey(4), n, p))
    res = plan.session(device="cpu").select(X)
    assert 0 < len(res.candidate_edges) < complete_graph(p).m
    assert set(res.support) <= set(res.candidate_edges)


def test_knn_screen_breaks_ties_by_node_id():
    # duplicated columns tie exactly: the lower node id wins, as the
    # reference's lexsort on (-score, id) decides
    rng = np.random.RandomState(9)
    base = np.where(rng.rand(200, 3) < 0.5, 1.0, -1.0)
    X = base[:, [0, 1, 1, 2, 1, 0]]
    spec = StructureSpec(policy="knn", knn_k=1)
    fam = Plan(graph=chain_graph(6)).family_instance
    got = candidate_graph(spec, 6, X=torch.tensor(X), family=fam)
    from repro.structure import candidate_graph as ref_candidates
    want = ref_candidates(RA.StructureSpec(policy="knn", knn_k=1), 6, X=X,
                          family=RA.Plan(graph=RC.chain_graph(6))
                          .family_instance)
    assert got.edges == want.edges


def test_candidate_graph_knn_requires_data_and_small_k():
    spec = StructureSpec(policy="knn", knn_k=5)
    with pytest.raises(ValueError, match="knn_k must be < p"):
        candidate_graph(spec, p=5)
    with pytest.raises(ValueError, match="knn"):
        candidate_graph(spec, p=8)          # no X / family supplied


def test_per_call_spec_dict_override(planted_grid):
    g, plan, X = planted_grid
    sess = plan.session(device="cpu")       # plan has no structure spec
    res = sess.select(X, spec={"policy": "given",
                               "given_edges": tuple(g.edges),
                               "n_lambdas": 4, "admm_rounds": 8,
                               "vote": "and"})
    assert isinstance(res, StructureResult)
    assert res.vote_rule == "and"
    assert res.candidate_edges == g.edges


def test_select_rejects_wrong_width_X(planted_grid):
    g, plan, X = planted_grid
    with pytest.raises(ValueError, match="columns"):
        plan.session(device="cpu").select(X[:, :-1])


def test_comm_scalars_match_cost_table(planted_grid):
    g, plan, X = planted_grid
    for rule in ("and", "weighted"):
        spec = StructureSpec(policy="full", n_lambdas=4, admm_rounds=8,
                             vote=rule)
        res = plan.replace(structure=spec).session(device="cpu").select(X)
        assert res.comm_scalars == structure_vote_scalars(
            len(res.candidate_edges), rule)


def test_select_without_cuda_needs_a_device(monkeypatch, planted_grid):
    g, plan, X = planted_grid
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        plan.replace(structure=StructureSpec()).session().select(X)


def test_structure_result_exported():
    assert TA.StructureResult is StructureResult


# ------------------------------------------------------------- lambda = 0
def _dense_matches_fit(name, seed, p=5, n=200):
    spec = StructureSpec(policy="given", given_edges=chain_graph(p).edges,
                         lambdas=(0.0,))
    plan = Plan(graph=chain_graph(p), family=name, structure=spec)
    fam = RA.Plan(graph=RC.chain_graph(p), family=name).family_instance
    X = np.asarray(random_rows(fam, jax.random.PRNGKey(seed), n, p))

    sess = plan.session(device="cpu")
    fit = sess.fit(X)
    res = sess.select(X)
    assert res.lambda_selected == 0.0
    assert res.support == chain_graph(p).edges
    for i in range(p):
        np.testing.assert_allclose(res.thetas[i], fit.fits[i].theta,
                                   atol=1e-8, rtol=0)


@pytest.mark.parametrize("name", FAMILY_NAMES)
def test_lambda0_matches_fit_all_families(name):
    _dense_matches_fit(name, seed=11)


@pytest.mark.parametrize("name", FAMILY_NAMES)
def test_lambda0_matches_fit_property(name):
    """Hypothesis variant: same invariant under fuzzed seeds and sizes."""
    hyp = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")

    @hyp.given(seed=st.integers(0, 2**16), p=st.integers(3, 7),
               n=st.integers(64, 256))
    @hyp.settings(max_examples=5, deadline=None)
    def run(seed, p, n):
        _dense_matches_fit(name, seed=seed, p=p, n=n)

    run()
