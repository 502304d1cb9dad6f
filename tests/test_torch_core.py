"""Host-side modules the port keeps its own copy of, against the JAX
package: graph generators and their derived structure, parameter
ownership, and the communication accounting."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as RC  # noqa: E402
from repro.stream import costs as rcosts  # noqa: E402
import repro_torch.core as TC  # noqa: E402
from repro_torch.core.families import get_family  # noqa: E402
from repro_torch.stream import costs as tcosts  # noqa: E402

GENERATORS = [
    ("chain_graph", (7,), {}), ("star_graph", (6,), {}),
    ("grid_graph", (3, 4), {}), ("complete_graph", (5,), {}),
    ("scale_free_graph", (40,), {"m": 1, "seed": 3}),
    ("scale_free_graph", (30,), {"m": 2, "seed": 0}),
    ("euclidean_graph", (40,), {"radius": 0.25, "seed": 1}),
]


@pytest.mark.parametrize("name,args,kw", GENERATORS)
def test_generators_and_derived_structure_match_reference(name, args, kw):
    rg = getattr(RC, name)(*args, **kw)
    tg = getattr(TC, name)(*args, **kw)
    assert tg.p == rg.p and tg.edges == rg.edges
    np.testing.assert_array_equal(tg.adjacency, rg.adjacency)
    np.testing.assert_array_equal(tg.greedy_coloring(), rg.greedy_coloring())
    assert tg.edge_index == rg.edge_index
    for i in range(rg.p):
        assert tg.neighbors(i) == rg.neighbors(i)
        assert tg.degree(i) == rg.degree(i)
        assert tg.incident_edges(i) == rg.incident_edges(i)
        for inc in (True, False):
            assert tg.beta(i, inc) == rg.beta(i, inc)


@pytest.mark.parametrize("family", ["gaussian", "ising", "potts"])
def test_ownership_and_degree_buckets_match_reference(family):
    rg = RC.euclidean_graph(25, radius=0.3, seed=2)
    tg = TC.Graph(rg.p, rg.edges)
    rf, tf = RC.families.get_family(family), get_family(family)
    assert tf.block_dim == rf.block_dim
    assert tf.n_params(tg) == rf.n_params(rg)
    for inc in (True, False):
        assert TC.param_owners(tg, inc, tf) == RC.asymptotics.param_owners(
            rg, inc, rf)
        np.testing.assert_array_equal(
            TC.free_indices(tg, inc, tf),
            RC.asymptotics.free_indices(rg, inc, rf))
        for i in range(rg.p):
            assert tf.beta(tg, i, inc) == rf.beta(rg, i, inc)
    for rb, tb in zip(RC.batched.degree_buckets(rg), TC.degree_buckets(tg),
                      strict=True):
        assert tb.deg_pad == rb.deg_pad
        for field in ("nodes", "nbrs", "mask"):
            np.testing.assert_array_equal(getattr(tb, field),
                                          getattr(rb, field))


def test_comm_accounting_matches_reference():
    names = [c.name for c in RC.combiners.registered_combiners()]
    assert [c.name for c in TC.registered_combiners()] == names
    assert tcosts._registry_scalars() == rcosts._registry_scalars()
    for name in names:
        want = (None if RC.combiners.get_combiner(name)
                .scalars_per_shared_param is None
                else rcosts.one_step_message_scalars(7, name))
        if want is None:
            with pytest.raises(ValueError):
                tcosts.one_step_message_scalars(7, name)
        else:
            assert tcosts.one_step_message_scalars(7, name) == want
    for n in (1, 300):
        assert tcosts.one_step_comm_by_scheme(19, names, n) == \
            rcosts.one_step_comm_by_scheme(19, names, n)


def test_family_without_epilogue_raises_in_local_fits():
    """The Newton statistics always go through the kernel dispatch: a family
    with no registered epilogue raises there instead of taking a plain path."""
    import dataclasses

    from repro_torch.core.batched import fit_all_local_batched
    from repro_torch.core.families.ising import IsingFamily

    @dataclasses.dataclass(frozen=True)
    class NoKernel(IsingFamily):
        name: str = "ising_no_kernel"

        @property
        def kernel_kind(self):
            return None

    graph = TC.star_graph(4)
    X = torch.from_numpy(np.random.RandomState(3).choice(
        [-1.0, 1.0], size=(65, graph.p)))
    with pytest.raises(ValueError, match="no epilogue"):
        fit_all_local_batched(graph, X, family=NoKernel())
