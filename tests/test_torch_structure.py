"""The port's structure-learning building blocks against the JAX reference:
``StructureSpec`` and ``Plan(structure=)`` validation (the reference's
``tests/structure/test_spec.py`` case for case, with its messages), the
vote-rule registry and reconciliation (``tests/structure/test_voting.py``
case for case), the vote-message bill, and the group soft-threshold (the
flat variant of the lasso path equal to the per-node one bit for bit)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.api as RA  # noqa: E402
import repro.core as RC  # noqa: E402
from repro.core.batched import group_soft_threshold as ref_gst  # noqa: E402
from repro.core.families import random_rows  # noqa: E402
from repro.stream.costs import structure_vote_scalars as ref_bill  # noqa: E402
from repro.structure import reconcile as ref_reconcile  # noqa: E402
import repro_torch.api as TA  # noqa: E402
from repro_torch.api import Plan, StructureSpec  # noqa: E402
from repro_torch.core import chain_graph, grid_graph  # noqa: E402
from repro_torch.core.batched import (group_soft_threshold_flat,  # noqa: E402
                                      local_layout)
from repro_torch.core.families import get_family  # noqa: E402
from repro_torch.interop import plan_from_reference  # noqa: E402
from repro_torch.stream.costs import structure_vote_scalars  # noqa: E402
from repro_torch.structure import (CANDIDATE_POLICIES, VoteRule,  # noqa: E402
                                   get_vote_rule, reconcile,
                                   register_vote_rule, registered_vote_rules)


def _planted_chain(p, n, seed, coupling=0.8):
    """Samples of an Ising chain with equal couplings, drawn by the
    reference's sampler (the two packages' RNG streams differ)."""
    rg = RC.chain_graph(p)
    fam = RA.Plan(graph=rg).family_instance
    theta = np.zeros(fam.n_params(rg))
    theta[rg.p:] = coupling
    return np.asarray(fam.sample(rg, theta, n, jax.random.PRNGKey(seed)))


# ------------------------------------------------------------ lambda grids
def test_negative_lambda_grid_rejected():
    with pytest.raises(ValueError, match="non-negative"):
        StructureSpec(lambdas=(0.5, -0.1))


def test_unsorted_lambda_grid_rejected():
    with pytest.raises(ValueError, match="strictly decreasing"):
        StructureSpec(lambdas=(0.1, 0.5, 0.2))


def test_duplicate_lambda_grid_rejected():
    with pytest.raises(ValueError, match="strictly decreasing"):
        StructureSpec(lambdas=(0.5, 0.5, 0.1))


def test_empty_lambda_grid_rejected():
    with pytest.raises(ValueError, match="non-empty"):
        StructureSpec(lambdas=())


def test_descending_grid_with_zero_tail_accepted():
    spec = StructureSpec(lambdas=(1.0, 0.25, 0.0))
    assert spec.lambdas == (1.0, 0.25, 0.0)


# -------------------------------------------------------------- vote rules
def test_unknown_vote_rule_lists_registered():
    with pytest.raises(ValueError) as exc:
        StructureSpec(vote="majority")
    msg = str(exc.value)
    assert "majority" in msg
    for name in ("and", "or", "weighted"):
        assert name in msg, f"error should list registered rule {name!r}"


# ------------------------------------------------------- candidate policies
def test_unknown_policy_lists_choices():
    with pytest.raises(ValueError) as exc:
        StructureSpec(policy="everything")
    for name in CANDIDATE_POLICIES:
        assert name in str(exc.value)


def test_knn_k_at_least_p_rejected_by_plan():
    with pytest.raises(ValueError, match="knn_k must be < p"):
        Plan(graph=chain_graph(5),
             structure=StructureSpec(policy="knn", knn_k=5))


def test_knn_k_nonpositive_rejected():
    with pytest.raises(ValueError, match="knn_k must be >= 1"):
        StructureSpec(policy="knn", knn_k=0)


def test_given_policy_requires_edges():
    with pytest.raises(ValueError, match="given_edges"):
        StructureSpec(policy="given")


def test_given_edges_require_given_policy():
    with pytest.raises(ValueError, match="policy 'given'"):
        StructureSpec(policy="full", given_edges=((0, 1),))


def test_given_edges_validated_against_plan_graph():
    with pytest.raises(ValueError, match="not a valid"):
        Plan(graph=chain_graph(4),
             structure=StructureSpec(policy="given", given_edges=((0, 9),)))


# ----------------------------------------------------------- scalar bounds
@pytest.mark.parametrize("kw,match", [
    (dict(n_lambdas=0), "n_lambdas"),
    (dict(lambda_min_ratio=0.0), "lambda_min_ratio"),
    (dict(lambda_min_ratio=1.0), "lambda_min_ratio"),
    (dict(ebic_gamma=-0.1), "ebic_gamma"),
    (dict(ebic_gamma=1.5), "ebic_gamma"),
    (dict(admm_rounds=0), "admm_rounds"),
    (dict(admm_rho=0.0), "admm_rho"),
    (dict(admm_tol=0.0), "admm_tol"),
    (dict(newton_iters=0), "newton_iters"),
])
def test_scalar_bounds(kw, match):
    with pytest.raises(ValueError, match=match) as got:
        StructureSpec(**kw)
    with pytest.raises(ValueError) as want:
        RA.StructureSpec(**kw)
    assert str(got.value) == str(want.value)


# ----------------------------------------------------------- serialization
def test_spec_roundtrip():
    spec = StructureSpec(policy="given", given_edges=((0, 2), (1, 3)),
                         lambdas=(0.8, 0.2, 0.0), vote="and",
                         ebic_gamma=0.25, admm_rounds=17)
    assert StructureSpec.from_dict(spec.to_dict()) == spec
    # the reference's dict is the port's dict
    ref = RA.StructureSpec.from_dict(spec.to_dict())
    assert ref.to_dict() == spec.to_dict()


def test_spec_from_dict_rejects_unknown_fields():
    with pytest.raises(ValueError, match="unknown StructureSpec fields"):
        StructureSpec.from_dict({"polciy": "full"})


def test_plan_roundtrip_with_structure():
    plan = Plan(graph=chain_graph(6), family="ising",
                structure=StructureSpec(policy="knn", knn_k=3, vote="or"))
    back = Plan.from_dict(plan.to_dict())
    assert back == plan
    assert hash(back) == hash(plan)          # still a session-cache key


def test_plan_structure_carried_from_reference():
    rp = RA.Plan(graph=RC.chain_graph(6), structure=RA.StructureSpec(
        policy="given", given_edges=((0, 2), (3, 5)), lambdas=(0.4, 0.0),
        vote="and"))
    tp = plan_from_reference(rp.to_dict())
    assert isinstance(tp.structure, StructureSpec)
    assert tp.structure.to_dict() == rp.structure.to_dict()
    assert tp.to_dict() == rp.to_dict()


def test_plan_coerces_structure_dict():
    plan = Plan(graph=chain_graph(6), structure={"policy": "full",
                                                 "vote": "and"})
    assert isinstance(plan.structure, StructureSpec)
    assert plan.structure.vote == "and"


def test_plan_rejects_non_spec_structure():
    with pytest.raises(TypeError, match="StructureSpec"):
        Plan(graph=chain_graph(6), structure="full")


# ---------------------------------------------------------------- registry
def test_unknown_rule_error_lists_registered():
    with pytest.raises(ValueError) as exc:
        get_vote_rule("nope")
    msg = str(exc.value)
    assert "nope" in msg and "and" in msg and "weighted" in msg


def test_registered_rules_sorted_and_complete():
    names = [r.name for r in registered_vote_rules()]
    assert names == sorted(names)
    assert {"and", "or", "weighted"} <= set(names)


def test_custom_rule_registers_and_bills():
    class Unanimous(VoteRule):
        name = "test_unanimous3"
        scalars_per_edge_vote = 3

        def decide(self, in_a, in_b, mass_a, mass_b):
            keep = in_a & in_b
            return keep, np.where(keep, 1.0, -1.0)

    try:
        register_vote_rule(Unanimous())
        assert get_vote_rule("test_unanimous3").scalars_per_edge_vote == 3
        assert structure_vote_scalars(7, "test_unanimous3") == 2 * 7 * 3
    finally:
        from repro_torch.structure.voting import _VOTE_RULES
        _VOTE_RULES.pop("test_unanimous3", None)


def test_vote_scalar_accounting_per_rule():
    for m, rule, want in ((10, "and", 20), (10, "or", 20),
                          (10, "weighted", 40), (0, "weighted", 0)):
        assert structure_vote_scalars(m, rule) == want == ref_bill(m, rule)


# ------------------------------------------------- unanimous disagreement
def test_unanimous_disagreement_and_or():
    in_a = np.array([True, True, False])
    in_b = np.array([False, False, True])
    keep_and, m_and = reconcile(in_a, in_b, "and")
    keep_or, m_or = reconcile(in_a, in_b, "or")
    assert not keep_and.any()
    assert (m_and == -1.0).all()
    assert keep_or.all()
    assert (m_or == 1.0).all()


def test_weighted_disagreement_mass_decides():
    in_a = np.array([True, True, False])
    in_b = np.array([False, False, True])
    keep, margin = reconcile(in_a, in_b, "weighted",
                             mass_a=np.full(3, 4.0), mass_b=np.full(3, 1.0))
    assert list(keep) == [True, True, False]
    assert np.allclose(np.abs(margin), 0.6)   # (4 - 1) / 5


def test_weighted_exact_tie_falls_back_to_union():
    in_a = np.array([True, False])
    in_b = np.array([False, False])
    keep, margin = reconcile(in_a, in_b, "weighted")
    assert (margin == 0.0).all() or margin[1] == -1.0
    assert keep[0]
    assert not keep[1]


def test_weighted_degenerate_masses_are_guarded():
    in_a = np.array([True, True, True])
    in_b = np.array([False, False, False])
    mass_a = np.array([np.inf, np.nan, 0.0])
    mass_b = np.array([1.0, 1.0, 0.0])
    keep, margin = reconcile(in_a, in_b, "weighted",
                             mass_a=mass_a, mass_b=mass_b)
    assert np.isfinite(margin).all()
    assert keep[2]


# --------------------------------------------------- permutation symmetry
@pytest.mark.parametrize("rule", ["and", "or", "weighted"])
def test_endpoint_swap_symmetry(rule):
    rng = np.random.RandomState(0)
    in_a = rng.rand(64) < 0.5
    in_b = rng.rand(64) < 0.5
    mass_a = rng.rand(64) + 0.1
    mass_b = np.where(rng.rand(64) < 0.3, mass_a, rng.rand(64) + 0.1)
    k1, m1 = reconcile(in_a, in_b, rule, mass_a=mass_a, mass_b=mass_b)
    k2, m2 = reconcile(in_b, in_a, rule, mass_a=mass_b, mass_b=mass_a)
    assert (k1 == k2).all()
    assert np.allclose(m1, m2)
    # and the reference's rule decides the same, to the bit
    kr, mr = ref_reconcile(in_a, in_b, rule, mass_a=mass_a, mass_b=mass_b)
    assert (k1 == kr).all() and np.array_equal(m1, mr)


def test_select_deterministic_under_node_permutation():
    """Relabeling nodes permutes the recovered support and nothing else."""
    p, n = 6, 600
    X = _planted_chain(p, n, seed=5)
    plan = Plan(graph=chain_graph(p), family="ising")
    spec = StructureSpec(policy="full", n_lambdas=5, vote="weighted",
                         admm_rounds=15)
    res = plan.replace(structure=spec).session(device="cpu").select(X)
    assert res.support

    perm = np.array([3, 0, 5, 1, 4, 2])       # new id of each old node
    inv = np.argsort(perm)
    res_p = plan.replace(structure=spec).session(device="cpu").select(
        X[:, inv])
    expected = {tuple(sorted((int(perm[i]), int(perm[j]))))
                for (i, j) in res.support}
    assert set(res_p.support) == expected
    assert res_p.lambda_selected == res.lambda_selected


# ---------------------------------------------------------- singleton nodes
def test_candidate_isolated_nodes_survive_voting():
    p, n = 5, 300
    fam = RA.Plan(graph=RC.chain_graph(p)).family_instance
    X = np.asarray(random_rows(fam, jax.random.PRNGKey(6), n, p))
    spec = StructureSpec(policy="given", given_edges=((0, 1), (1, 2)),
                         n_lambdas=4, admm_rounds=10)
    res = Plan(graph=chain_graph(p), structure=spec).session(
        device="cpu").select(X)
    assert set(res.support) <= {(0, 1), (1, 2)}
    assert res.candidate_edges == ((0, 1), (1, 2))
    assert len(res.thetas) == p
    assert res.thetas[3].shape == (1,) and res.thetas[4].shape == (1,)


# -------------------------------------------------------- soft-threshold
@pytest.mark.parametrize("C,lead", [(1, 1), (2, 1), (4, 1), (1, 0), (2, 0)])
def test_group_soft_threshold_matches_reference(C, lead):
    # one node's vector: the flat threshold on a one-node layout
    rng = np.random.RandomState(C + 10 * lead)
    for nblk in (0, 1, 7):
        v = rng.randn(lead * C + nblk * C)
        off = np.array([0, v.size])
        for thr in (0.0, 0.3, 1.2, 50.0):
            got = group_soft_threshold_flat(v, thr, C, off, lead)
            assert np.array_equal(got, ref_gst(v, thr, C, lead))
    bad = np.zeros((lead + 1) * (C + 1) + 1)
    with pytest.raises(ValueError, match="whole"):
        group_soft_threshold_flat(bad, 0.1, C + 1, np.array([0, bad.size]),
                                  lead)


@pytest.mark.parametrize("family,include_singleton", [
    ("ising", True), ("potts", True), ("gaussian", False), ("potts", False)])
def test_flat_soft_threshold_equals_per_node_bitwise(family, include_singleton):
    fam = get_family(family)
    C, lead = fam.block_dim, int(include_singleton)
    graph = grid_graph(4, 5)
    off, _ = local_layout(graph, fam, include_singleton)
    rng = np.random.RandomState(3)
    v = rng.randn(int(off[-1])) * rng.choice([0.01, 1.0, 3.0],
                                             size=int(off[-1]))
    for thr in (0.0, 0.05, 0.7, 2.5):
        got = group_soft_threshold_flat(v, thr, C, off, lead)
        want = np.concatenate([ref_gst(v[off[i]:off[i + 1]], thr, C, lead)
                               for i in range(graph.p)])
        assert np.array_equal(got, want)
        assert np.array_equal(np.signbit(got), np.signbit(want))
    with pytest.raises(ValueError, match="slots"):
        group_soft_threshold_flat(v[:-1], 0.1, C, off, lead)


def test_structure_exports():
    assert TA.StructureSpec is StructureSpec
    import repro_torch.structure as TSt
    import repro.structure as RSt
    assert sorted(TSt.__all__) == sorted(RSt.__all__)
