"""Training of the attention families against the JAX package, on the CPU:
the expert layer (qwen2-moe, llama4-scout), multi-head latent attention
(minicpm3), qk-norm (chameleon) and plain GQA at other groupings (phi3,
glm4), each on its reduced config at float32.

The reference's ``init_state`` is carried into the port with
``train_state_from_numpy``, the same numpy tokens and labels (and
llama4-scout's patch embeddings) go into both, and the port's gradients are
held to the reference's ``jax.grad`` (``grads_of``) leaf by leaf. Each
reference entry point is jitted once, with the configs static, and the
batch shapes are shared, so a config compiles once.

Tolerances are those of ``tests/test_torch_train.py`` (float32, sums taken
in another order): gradients normwise per leaf within GRAD_TOL (the port
reads up to 4.5e-6, llama4-scout's router); a step's parameters within
STEP_TOL of the size of that leaf's update, its moments within MOMENT_TOL.
Adam's first step is about lr * g / (|g| + eps), so a coordinate whose
gradient lies below what the gradient gate resolves (|g| at most GRAD_TOL
times its leaf's norm) moves by an amount float32 noise decides, up to
2 lr: such coordinates may lie apart, and STEP_TOL holds over the others
(reduced minicpm3 has 6 of 262144 in ``w_up``, at |g| = 7.8e-8 against a
leaf norm of 1.5, which alone would read 1.1e-3 of the update).
"""
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as JC  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import adamw as JO  # noqa: E402
from repro.train import step as JS  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.interop import train_state_from_numpy  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.optim import adamw as TO  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402

CPU = "cpu"
GRAD_TOL = 1e-5
STEP_TOL = 1e-3
MOMENT_TOL = 1e-4
#: forward logits against the reference's (normwise): float32 sums in
#: another order through two layers
LOGITS_TOL = 1e-4
ARCHS = ("qwen2-moe-a2.7b", "llama4-scout-17b-a16e", "minicpm3-4b",
         "chameleon-34b", "phi3-mini-3.8b", "glm4-9b")
EXPERT = "qwen2-moe-a2.7b"
BSZ, SEQ = 2, 16
#: the capacity path: more than DROPLESS_TOKENS tokens (16 groups of 264),
#: and a capacity factor that certainly drops pairs
CAP_BATCH, CAP_SEQ, CAP_FACTOR = 16, 264, 0.5
J_ADAM = JO.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=100)
T_ADAM = TO.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=100)

_J_GRADS = jax.jit(JS.grads_of, static_argnums=(0, 1))
_J_FORWARD = jax.jit(JT.forward, static_argnums=0)
_MODELS = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: the port's steps launch
    many small ops, and in a suite run in parallel processes each op's
    thread team would contend for the cores with the other workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(arch, **changes):
    """(JAX config, port config, JAX state, port state) of the reduced
    config with ``changes``, the port's state carried from the
    reference's."""
    key = (arch, tuple(sorted(changes.items())))
    if key not in _MODELS:
        jcfg = dataclasses.replace(JC.reduced(JC.get(arch)), **changes)
        tcfg = dataclasses.replace(TC.reduced(TC.get(arch)), **changes)
        jstate = JS.init_state(jcfg, jax.random.PRNGKey(0))
        tstate = train_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                        tcfg, CPU)
        _MODELS[key] = (jcfg, tcfg, jstate, tstate)
    return _MODELS[key]


def _batch(cfg, b=BSZ, s=SEQ, seed=0):
    """numpy tokens and labels (and patch embeddings for a config with
    patch slots)."""
    rng = np.random.RandomState(seed)
    out = {"tokens": rng.randint(0, cfg.vocab_size, (b, s)),
           "labels": rng.randint(0, cfg.vocab_size, (b, s))}
    if cfg.n_patches:
        out["patch_embeds"] = rng.randn(b, cfg.n_patches,
                                        cfg.d_model).astype(np.float32)
    return out


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _flat(tree):
    """'/'-joined path -> float64 numpy, for either package's trees."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in node:
                walk(node[k], path + (str(k),))
        elif isinstance(node, tuple) and hasattr(node, "_fields"):
            for k in node._fields:
                walk(getattr(node, k), path + (k,))
        elif isinstance(node, torch.Tensor):
            out["/".join(path)] = node.detach().double().numpy()
        else:
            out["/".join(path)] = np.asarray(node, np.float64)
    walk(tree, ())
    return out


def _rel(a, b, scale=None):
    scale = np.linalg.norm(b) if scale is None else scale
    return float(np.linalg.norm(a - b) / max(scale, 1e-30))


def _assert_grads_match(jg, jm, tg, tm):
    want, got = _flat(jg), _flat(tg)
    assert set(got) == set(want)
    for key in want:
        assert _rel(got[key], want[key]) <= GRAD_TOL, key
    for key in ("nll", "z_loss", "aux", "n_tokens"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=GRAD_TOL, atol=1e-7)


def _expert_leaves(tree):
    """(path, leaf) of every expert-stacked leaf: (units, E_pad, ...)."""
    return [(k, v) for k, v in _flat(tree).items()
            if k.split("/")[-1] in ("w_gate", "w_up", "w_out")]


@contextlib.contextmanager
def _routes():
    """The port's ``route`` with every call's Routing noted."""
    plain, seen = TM.route, []

    def noting(*args, **kwargs):
        r = plain(*args, **kwargs)
        seen.append(r)
        return r
    TM.route = noting
    try:
        yield seen
    finally:
        TM.route = plain


# ------------------------------------------------------------ the state
@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_carries_across_exactly(arch):
    """The expert, MLA and qk-norm trees with their AdamW moments: every
    parameter equal to the reference's in its spec's type, the moments
    float32 zeros of the same keys, the step an int32 scalar."""
    _, tcfg, jstate, tstate = _model(arch)
    want, got = _flat(jstate), _flat(tstate)
    assert set(got) == set(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    kinds = {k.split("/")[-1] for k in want}
    if tcfg.n_experts:
        assert {"router", "w_gate", "w_up", "w_out"} <= kinds
    if tcfg.attn_kind == "mla":
        assert {"wq_a", "q_a_norm", "wkv_a", "kv_a_norm", "wkv_b"} <= kinds
    if tcfg.qk_norm:
        assert {"q_norm", "k_norm"} <= kinds
    assert all(t.dtype == torch.float32 and not t.any() for tree in
               (tstate.opt.m, tstate.opt.v) for t in TO.tree_leaves(tree))
    assert tstate.opt.step.dtype == torch.int32 and int(tstate.opt.step) == 0


# ------------------------------------------------------------ gradients
@pytest.mark.parametrize("arch", ARCHS)
def test_grads_of_matches_reference(arch):
    jcfg, tcfg, jstate, tstate = _model(arch)
    batch = _batch(tcfg)
    jg, jm = _J_GRADS(jcfg, JS.TrainConfig(), jstate.params, _jax(batch))
    tg, tm = TS.grads_of(tcfg, TS.TrainConfig(), tstate.params,
                         _torch(batch))
    _assert_grads_match(jg, jm, tg, tm)
    if tcfg.n_experts:
        assert float(tm["aux"]) > 0


def test_microbatched_grads_match_reference():
    jcfg, tcfg, jstate, tstate = _model(EXPERT)
    batch = _batch(tcfg, b=4, seed=1)
    jg, jm = _J_GRADS(jcfg, JS.TrainConfig(microbatch=2), jstate.params,
                      _jax(batch))
    tg, tm = TS.grads_of(tcfg, TS.TrainConfig(microbatch=2), tstate.params,
                         _torch(batch))
    _assert_grads_match(jg, jm, tg, tm)
    assert all(g.dtype == torch.float32 for g in TO.tree_leaves(tg))


def test_capacity_path_drops_pairs_and_matches_reference():
    """More than DROPLESS_TOKENS tokens at half the capacity factor: the
    dispatch drops pairs (as the reference's ``mode="drop"``), a dropped
    pair passes no gradient, and the gradients equal the reference's."""
    jcfg, tcfg, jstate, tstate = _model(EXPERT, capacity_factor=CAP_FACTOR)
    batch = _batch(tcfg, b=CAP_BATCH, s=CAP_SEQ, seed=2)
    assert CAP_BATCH * CAP_SEQ > TM.DROPLESS_TOKENS
    jg, jm = _J_GRADS(jcfg, JS.TrainConfig(), jstate.params, _jax(batch))
    with _routes() as seen:
        tg, tm = TS.grads_of(tcfg, TS.TrainConfig(), tstate.params,
                             _torch(batch))
    first = seen[:tcfg.n_layers]     # the forward's (remat replays them)
    assert all(r.cap < r.keep.shape[1] // tcfg.experts_per_tok
               for r in first)
    dropped = sum(int((~r.keep).sum()) for r in first)
    assert dropped > 0
    _assert_grads_match(jg, jm, tg, tm)


def test_padding_experts_get_exactly_zero_gradient():
    """Padding experts (4 -> 16 in the reduced configs) have no router
    column: their expert leaves' gradients are exactly zero in both
    packages, on the dropless and on the capacity path."""
    for changes, b, s in (({}, BSZ, SEQ),
                          ({"capacity_factor": CAP_FACTOR}, CAP_BATCH,
                           CAP_SEQ)):
        jcfg, tcfg, jstate, tstate = _model(EXPERT, **changes)
        batch = _batch(tcfg, b=b, s=s, seed=2 if changes else 0)
        e = tcfg.n_experts
        assert TM.padded_experts(e) > e
        jg, _ = _J_GRADS(jcfg, JS.TrainConfig(), jstate.params, _jax(batch))
        tg, _ = TS.grads_of(tcfg, TS.TrainConfig(), tstate.params,
                            _torch(batch))
        for tree in (jg, tg):
            leaves = _expert_leaves(tree)
            assert len(leaves) == 3
            for key, g in leaves:
                assert not g[:, e:].any(), key
                assert g[:, :e].any(), key


def test_zero_router_routes_ties_as_the_reference():
    """Every router leaf zero: all probabilities tie, the reference's
    ``jax.lax.top_k`` takes experts 0 and 1 for every token, and so must
    the port. Its logits then match the reference's (they read 0.816 apart
    when ties went by ``torch.topk``), its gradients too, and the experts
    that no pair reaches get exactly zero gradient in both."""
    jcfg, tcfg, jstate, _ = _model(EXPERT)
    jparams = jax.tree.map(np.asarray, jstate.params)
    layers = jparams["units"]["b0"]["moe"]
    layers["router"] = np.zeros_like(layers["router"])
    jstate = jstate._replace(params=jax.tree.map(jnp.asarray, jparams))
    tstate = train_state_from_numpy(jax.tree.map(np.asarray, jstate), tcfg,
                                    CPU)
    batch = _batch(tcfg)
    want, _ = _J_FORWARD(jcfg, jstate.params, jnp.asarray(batch["tokens"]))
    with torch.no_grad(), _routes() as seen:
        got, _ = TT.forward(tcfg, tstate.params,
                            torch.as_tensor(batch["tokens"]))
    assert _rel(got.double().numpy(), np.asarray(want, np.float64)) \
        <= LOGITS_TOL
    k = tcfg.experts_per_tok
    assert all(bool((r.gate_idx.reshape(-1, k)
                     == torch.arange(k)).all()) for r in seen)
    jg, jm = _J_GRADS(jcfg, JS.TrainConfig(), jstate.params, _jax(batch))
    tg, tm = TS.grads_of(tcfg, TS.TrainConfig(), tstate.params,
                         _torch(batch))
    _assert_grads_match(jg, jm, tg, tm)
    for tree in (jg, tg):
        for key, g in _expert_leaves(tree):
            assert not g[:, k:].any() and g[:, :k].any(), key


def _route_cfg(e, k):
    return dataclasses.replace(TC.reduced(TC.get(EXPERT)), d_model=e,
                               n_experts=e, experts_per_tok=k)


def test_route_takes_tied_experts_in_the_reference_order():
    """Hand-made tied probabilities (logits through an identity router):
    ``route`` chooses the experts ``jax.lax.top_k`` chooses, in its
    order, with its renormalised gates."""
    for e, k, rows in (
            (4, 2, [[0, 0, 0, 0], [0, 1, 1, 1], [1, 0, 1, 0],
                    [0, 0, 2, 2]]),
            (60, 4, [[0] * 60, [0] * 30 + [1] * 30,
                     [1, 0] * 30, [0] * 57 + [3, 3, 0]]),
            (16, 3, [[2, 1] * 8, [0] * 15 + [5], [1] * 3 + [0] * 13])):
        logits = np.asarray(rows, np.float32)
        probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
        want_v, want_i = jax.lax.top_k(probs, k)
        want_v = want_v / jnp.maximum(want_v.sum(-1, keepdims=True), 1e-9)
        r = TM.route(_route_cfg(e, k), torch.eye(e), torch.tensor(logits))
        np.testing.assert_array_equal(r.gate_idx.reshape(-1, k).numpy(),
                                      np.asarray(want_i))
        np.testing.assert_allclose(r.gate_vals.reshape(-1, k).numpy(),
                                   np.asarray(want_v), rtol=1e-6)


def test_route_on_untied_probabilities_is_topk_bitwise():
    """Where no two probabilities are equal, ``route``'s experts, their
    order and its gates are bitwise those of ``torch.topk``."""
    e, k, t = 60, 4, 4096
    gen = torch.Generator()
    gen.manual_seed(3)
    xt = torch.randn((t, 64), generator=gen)
    router = 0.1 * torch.randn((64, e), generator=gen)
    cfg = dataclasses.replace(_route_cfg(e, k), d_model=64)
    r = TM.route(cfg, router, xt, n_groups=1)
    probs = torch.softmax(xt @ router, dim=-1)
    vals, idx = torch.topk(probs, k, dim=-1)
    assert all(len(set(row.tolist())) == e for row in probs[:64])
    vals = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)
    assert torch.equal(r.gate_idx.reshape(t, k), idx)
    assert torch.equal(r.gate_vals.reshape(t, k), vals)


# ---------------------------------------------------------------- remat
@pytest.mark.parametrize("arch", [EXPERT, "minicpm3-4b"])
def test_remat_on_equals_remat_off_bitwise(arch):
    """The checkpointed units carry the expert layer's aux and MLA's
    padded V through ``checkpoint``: gradients and metrics bitwise."""
    _, tcfg, _, tstate = _model(arch)
    batch = _torch(_batch(tcfg))
    on = TS.grads_of(tcfg, TS.TrainConfig(remat=True), tstate.params, batch)
    off = TS.grads_of(tcfg, TS.TrainConfig(remat=False), tstate.params,
                      batch)
    for a, b in zip(TO.tree_leaves(on[0]), TO.tree_leaves(off[0])):
        assert torch.equal(a, b)
    assert set(on[1]) == set(off[1]) and "aux" in on[1]
    assert all(torch.equal(on[1][k], off[1][k]) for k in on[1])


# ------------------------------------------------------- padded attention
def test_kernel_attention_pads_the_head_width_under_autograd():
    """``_kernel_attention`` at the reduced MLA width 48: zero-padded to
    64 with q scaled by sqrt(64 / 48); on a CPU tensor it runs the plain
    version of the padded problem, whose gradients must be the unpadded
    plain attention's."""
    rng = np.random.RandomState(5)
    b, s, h, d = 2, 40, 4, 48
    q, k, v, g = (torch.tensor(rng.randn(b, s, h, d).astype(np.float32))
                  for _ in range(4))
    for window in (0, 7):
        got_in = [t.clone().requires_grad_(True) for t in (q, k, v)]
        want_in = [t.clone().requires_grad_(True) for t in (q, k, v)]
        got = TA._kernel_attention(*got_in, window=window)
        want = TA._plain_attention(*want_in, window=window)
        assert got.shape == want.shape
        assert _rel(got.detach().numpy(), want.detach().numpy()) <= 1e-6
        for a, w in zip(torch.autograd.grad(got, got_in, g),
                        torch.autograd.grad(want, want_in, g)):
            assert _rel(a.numpy(), w.numpy()) <= 1e-6


# ------------------------------------------------------------ train step
@pytest.mark.parametrize("arch", ["minicpm3-4b", EXPERT])
def test_train_step_matches_reference(arch):
    jcfg, tcfg, jstate, tstate = _model(arch)
    batch = _batch(tcfg)
    j1, jm = jax.jit(JS.make_train_step(jcfg, J_ADAM, JS.TrainConfig()))(
        jstate, _jax(batch))
    t0 = train_state_from_numpy(jax.tree.map(np.asarray, jstate), tcfg, CPU)
    start = _flat(t0)
    t1, tm = TS.make_train_step(tcfg, T_ADAM, TS.TrainConfig())(
        t0, _torch(batch))
    want, got = _flat(j1), _flat(t1)
    grads = _flat(_J_GRADS(jcfg, JS.TrainConfig(), jstate.params,
                           _jax(batch))[0])
    assert set(got) == set(want)
    for key in want:
        if key.startswith("params/"):
            g = grads[key[len("params/"):]]
            resolved = np.abs(g) > GRAD_TOL * np.linalg.norm(g)
            apart = np.abs(got[key] - want[key]) > 1e-2 * T_ADAM.lr
            assert not (apart & resolved).any(), key
            assert _rel(got[key][resolved], want[key][resolved],
                        np.linalg.norm((want[key] - start[key])[resolved])) \
                <= STEP_TOL, key
        elif key.startswith("opt/m/") or key.startswith("opt/v/"):
            assert _rel(got[key], want[key]) <= MOMENT_TOL, key
    assert int(t1.opt.step) == int(j1.opt.step) == 1
    for key in ("nll", "aux"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=GRAD_TOL, atol=1e-7)
