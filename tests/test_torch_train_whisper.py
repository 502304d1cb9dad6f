"""Training of whisper-tiny against the JAX package, on the CPU: the reduced
config (2 encoder and 2 decoder layers, d 256 in 4 heads of 64, 16 frames,
vocab 1024, learned positions) at float32.

The reference's ``init_state`` is carried into the port with
``train_state_from_numpy`` (``consensus_state_from_numpy`` for a round),
the same numpy tokens, labels and frame embeddings go into both, and the
port's gradients are held to the reference's ``jax.grad`` leaf by leaf:
``grads_of`` at b 2 x s 100 with all 16 frames and with 10 (the encoder's
``pos_table`` rows past the frames take no gradient), in microbatches of 2
at b 4 x s 64 (the frames split with the batch), and at b 1 x 4096 tokens,
where every row of the decoder's ``pos_table`` takes a gradient (the
decoder cut to one layer there, the first of the two-layer state: the
attention's 4096 x 4096 scores are most of the test's time). The gradient
with respect to the frames themselves, the one input gradient that
crosses from the checkpointed decoder units into the encoder, is held to
the reference's ``jax.grad`` of its loss in the frames. Each reference
entry point is jitted once with the configs static, each result is
computed once and shared between tests.

Tolerances. Gradients normwise per leaf within GRAD_TOL (the port reads up
to 1.6e-6, at ``units/b0/norm2/scale`` and, at 4096 tokens,
``units/b0/norm1/scale``; the reference's own float32 gradients sit 1.35e-6
from a float64 run of the port there, which both packages round in
float32 only in the layer norms and the attention softmax). A step's or
round's parameters within STEP_TOL of the size of that leaf's update over
the coordinates the gradient gate resolves, the moments within
MOMENT_TOL (ROUND_MOMENT_TOL in a round), as
``tests/test_torch_train_recurrent.py`` holds them: Adam's first step is
about lr * g / (|g| + eps), so a coordinate whose gradient is float32
noise moves by an amount that noise decides, up to 2 lr. The frames'
gradient reads 1.2e-6; a step 2.6e-6 of its update, a round 5.3e-5, with
no resolved coordinate more than lr / 100 apart.

The non-causal attention (``_full_attention``, the encoder's and the
cross-attention's) is held in both types at queries != keys: float32
within ATTN_TOL (reads 2e-7), and bfloat16, where both packages cast the
float32 softmax back to the operands' type before the product with V, so
their backwards run the same casts: the port's bf16 gradients read 0 from
the reference's at this shape, where bf16's own rounding puts either 4e-3
from float64 and a backward through other casts lands that far away.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as JC  # noqa: E402
from repro.data import pipeline as JP  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.optim import adamw as JO  # noqa: E402
from repro.train import consensus as JCT  # noqa: E402
from repro.train import step as JS  # noqa: E402
import repro_torch.checkpoint as TK  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.interop import (consensus_state_from_numpy,  # noqa: E402
                                 train_state_from_numpy)
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.optim import adamw as TO  # noqa: E402
from repro_torch.train import consensus as TCT  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402

CPU = "cpu"
ARCH = "whisper-tiny"
GRAD_TOL = 1e-5
STEP_TOL = 1e-3
MOMENT_TOL = 1e-4
#: a round's resolved coordinates more than lr / 100 apart, at most: phase
#: 15's GATE_TRAIN_FLIPS (``chip_smoke.py``)
FLIPS = 1e-4
#: a round's moments: its second local step's gradient is taken where the
#: first step moved the unresolved coordinates by float32 noise, so they
#: carry that noise (``tests/test_torch_train_recurrent.py``)
ROUND_MOMENT_TOL = 1e-3
#: ``_full_attention``'s gradients, normwise, by type (see the docstring)
ATTN_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
#: (batch, sequence, frames, microbatch) of each gradient case: all the
#: reduced config's 16 frames, fewer, microbatches of 2, and the decoder's
#: whole learned position table (4096 rows) at the depth LONG_LAYERS
CASES = {"frames16": (2, 100, 16, 0), "frames10": (2, 100, 10, 0),
         "micro": (4, 64, 16, 2), "long": (1, TT.POS_ROWS, 16, 0)}
LONG_LAYERS = 1
#: a consensus round: 2 pods, 2 local steps, 2 x 80 tokens a pod and step
N_PODS, H_STEPS, POD_BSZ, POD_SEQ = 2, 2, 2, 80
J_ADAM = JO.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=100)
T_ADAM = TO.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=100)


def _reference_frame_grads(cfg, tcfg, params, batch):
    """The reference's gradients of its loss in the parameters and in
    ``batch["enc_frames"]``, and its metrics."""
    loss_fn = JS.make_loss_fn(cfg, tcfg)

    def loss(p, frames):
        return loss_fn(p, {**batch, "enc_frames": frames})
    (_, metrics), grads = jax.value_and_grad(loss, argnums=(0, 1),
                                             has_aux=True)(
        params, batch["enc_frames"])
    return grads, metrics


_J_GRADS = jax.jit(JS.grads_of, static_argnums=(0, 1))
_J_FRAME_GRADS = jax.jit(_reference_frame_grads, static_argnums=(0, 1))
#: the reference's train step is ``grads_of`` then ``adamw.update``: the
#: step test jits the update alone and reuses the gradients' compile
_J_UPDATE = jax.jit(JO.update, static_argnums=0)
_MODELS = {}
_J_RESULTS = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: the port's steps launch
    many small ops, and in a suite run in parallel processes each op's
    thread team would contend for the cores with the other workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(n_layers=2, dtype="float32"):
    """(JAX config, port config, JAX state, port state) of the reduced
    config at ``n_layers`` decoder layers and ``dtype``, the port's state
    carried from the reference's. A float32 state of fewer layers is the
    two-layer one's first units: one draw for both."""
    key = (n_layers, dtype)
    if key not in _MODELS:
        jcfg, tcfg = (dataclasses.replace(m.reduced(m.get(ARCH)),
                                          n_layers=n_layers, dtype=dtype)
                      for m in (JC, TC))
        if dtype == "float32" and n_layers < 2:
            full = _model()[2].params
            params = {**full, "units": jax.tree.map(
                lambda a: a[:n_layers], full["units"])}
            jstate = JS.TrainState(params, JO.init(params))
        else:
            jstate = JS.init_state(jcfg, jax.random.PRNGKey(0))
        tstate = train_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                        tcfg, CPU)
        _MODELS[key] = (jcfg, tcfg, jstate, tstate)
    return _MODELS[key]


def _batch(cfg, b, s, n_frames, seed=0, lead=()):
    """Tokens, labels and ``n_frames`` frame embeddings of ``cfg``'s width,
    under the leading axes ``lead``."""
    rng = np.random.RandomState(seed)
    return {"tokens": rng.randint(0, cfg.vocab_size, lead + (b, s)),
            "labels": rng.randint(0, cfg.vocab_size, lead + (b, s)),
            "enc_frames": rng.randn(*lead, b, n_frames,
                                    cfg.d_model).astype(np.float32)}


def _case_batch(case):
    b, s, n_frames, _ = CASES[case]
    return _batch(_model()[1], b, s, n_frames)


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch, dtype=torch.float32):
    """The batch as tensors: token ids int64, frames in ``dtype`` (the
    parameters' type)."""
    return {k: torch.as_tensor(np.array(v)).to(
        dtype if k == "enc_frames" else torch.int64)
        for k, v in batch.items()}


def _reference_grads(case):
    """The reference's ``grads_of`` (grads, metrics) for a gradient case,
    once."""
    if case not in _J_RESULTS:
        microbatch = CASES[case][3]
        jcfg, _, jstate, _ = _model(LONG_LAYERS if case == "long" else 2)
        _J_RESULTS[case] = _J_GRADS(
            jcfg, JS.TrainConfig(microbatch=microbatch), jstate.params,
            _jax(_case_batch(case)))
    return _J_RESULTS[case]


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


def _leaves(tree):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k])
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from _leaves(getattr(tree, k))
    else:
        yield tree


def _dtypes(tree):
    """'/'-joined path -> dtype name, for either package's trees."""
    return {k: str(v.dtype).split(".")[-1]
            for k, v in zip(_flat(tree), _leaves(tree))}


def _pod(flat, i):
    """Pod ``i``'s parameters of a flat consensus state."""
    return {k: v[i] for k, v in flat.items() if k.startswith("params/")}


def _zeros_like(tree):
    """A tree of zeros of ``tree``'s structure, shapes and types."""
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_zeros_like(v) for v in tree))
    return torch.zeros_like(tree)


def _rel(a, b, scale=None):
    scale = np.linalg.norm(b) if scale is None else scale
    return float(np.linalg.norm(a - b) / max(scale, 1e-30))


def _resolved(grads):
    """Per leaf, the coordinates whose gradient the gradient gate resolves
    in every one of ``grads`` (flat trees of one structure)."""
    return {k: np.logical_and.reduce(
        [np.abs(g[k]) > GRAD_TOL * np.linalg.norm(g[k]) for g in grads])
        for k in grads[0]}


def _assert_grads_match(jg, jm, tg, tm):
    want, got = _flat(jg), _flat(tg)
    assert set(got) == set(want)
    for key in want:
        assert _rel(got[key], want[key]) <= GRAD_TOL, key
    for key in ("nll", "z_loss", "n_tokens"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=GRAD_TOL, atol=1e-7)


def _rows_with_gradient(g):
    """Rows of a (rows, d) gradient with a non-zero entry."""
    return np.flatnonzero(np.abs(np.asarray(g, np.float64)).sum(-1))


def _flip_share(got, want, resolved, prefixes):
    """The share of the resolved coordinates of the leaves under
    ``prefixes`` that lie more than lr / 100 apart."""
    apart = total = 0
    for key in want:
        head, _, leaf = key.partition("/")
        if head in prefixes:
            far = np.abs(got[key] - want[key]) > 1e-2 * T_ADAM.lr
            apart += int((far & resolved[leaf]).sum())
            total += int(resolved[leaf].sum())
    return apart / total


def _assert_update_matches(got, want, start, resolved, prefixes,
                           moment_tol=MOMENT_TOL):
    """The leaves under ``prefixes`` within STEP_TOL of their update from
    ``start`` over the resolved coordinates; the moments within
    ``moment_tol``."""
    assert set(got) == set(want)
    n_checked = 0
    for key in want:
        head, _, leaf = key.partition("/")
        if head in prefixes:
            ok = resolved[leaf]
            assert _rel(got[key][ok], want[key][ok],
                        np.linalg.norm((want[key] - start[key])[ok])) \
                <= STEP_TOL, key
            n_checked += 1
        elif key.startswith("opt/m/") or key.startswith("opt/v/"):
            assert _rel(got[key], want[key]) <= moment_tol, key
    assert n_checked


# ------------------------------------------------------------ the state
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_state_carries_across_exactly(dtype):
    """The encoder-decoder tree with its AdamW moments: every parameter
    equal to the reference's in its spec's type (the layer norms' scale and
    bias float32 in a bf16 model), both learned position tables and the
    stacked encoder layers among them; the moments float32 zeros of the
    same keys, the step an int32 scalar."""
    jcfg, tcfg, jstate, tstate = _model(dtype=dtype)
    want, got = _flat(jstate), _flat(tstate)
    assert set(got) == set(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    types = _dtypes(tstate)
    assert types == _dtypes(jstate)
    params = {k[len("params/"):]: v for k, v in got.items()
              if k.startswith("params/")}
    assert params["pos_table"].shape == (TT.POS_ROWS, tcfg.d_model)
    assert params["encoder/pos_table"].shape == (tcfg.n_frames,
                                                 tcfg.d_model)
    assert params["encoder/layers/attn/wq"].shape[0] == tcfg.n_enc_layers
    norms = [k for k in params if k.endswith(("/scale", "/bias"))]
    assert {k.split("/")[-2] for k in norms} == {
        "norm1", "norm2", "norm3", "final_norm"}
    assert {k.split("/")[-1] for k in norms} == {"scale", "bias"}
    assert {k for k in norms if k.startswith("encoder/")} == {
        f"encoder/{p}/{w}" for p in ("layers/norm1", "layers/norm2",
                                     "final_norm")
        for w in ("scale", "bias")}
    for key, t in types.items():
        if key.startswith("params/"):
            assert t == ("float32" if key[len("params/"):] in norms
                         else dtype), key
    assert all(t.dtype == torch.float32 and not t.any() for tree in
               (tstate.opt.m, tstate.opt.v) for t in TO.tree_leaves(tree))
    assert set(_flat(tstate.opt.m)) == set(_flat(tstate.params))
    assert tstate.opt.step.dtype == torch.int32 and int(tstate.opt.step) == 0


# ------------------------------------------------------------ gradients
@pytest.mark.parametrize("case", ["frames16", "frames10"])
def test_grads_of_matches_reference(case):
    """Every leaf against the reference's ``grads_of``; the encoder's
    position table takes gradients in exactly its first F rows in both."""
    _, tcfg, _, tstate = _model()
    jg, jm = _reference_grads(case)
    tg, tm = TS.grads_of(tcfg, TS.TrainConfig(), tstate.params,
                         _torch(_case_batch(case)))
    _assert_grads_match(jg, jm, tg, tm)
    n_frames = CASES[case][2]
    for g in (jg["encoder"]["pos_table"], tg["encoder"]["pos_table"]):
        np.testing.assert_array_equal(_rows_with_gradient(g),
                                      np.arange(n_frames))
    assert all(bool(torch.isfinite(g).all()) for g in TO.tree_leaves(tg))


def test_enc_frames_gradient_matches_reference():
    """The loss's gradient in the frame embeddings, through the encoder and
    every checkpointed decoder unit's cross-attention (remat on), against
    the reference's ``jax.grad``; and the parameters' gradients taken with
    it against the reference's."""
    jcfg, tcfg, jstate, tstate = _model()
    batch = _case_batch("frames16")
    if "frames" not in _J_RESULTS:
        _J_RESULTS["frames"] = _J_FRAME_GRADS(
            jcfg, JS.TrainConfig(remat=True), jstate.params, _jax(batch))
    (jg, jframes), jm = _J_RESULTS["frames"]
    tbatch = _torch(batch)
    frames = tbatch["enc_frames"].requires_grad_(True)
    live = TO.tree_map(lambda p: p.detach().requires_grad_(True),
                       tstate.params)
    loss, tm = TS.make_loss_fn(tcfg, TS.TrainConfig(remat=True))(live,
                                                                tbatch)
    grads = torch.autograd.grad(loss, list(TO.tree_leaves(live)) + [frames])
    tm = {k: v.detach() for k, v in tm.items()}
    it = iter(grads[:-1])
    tg = TO.tree_map(lambda _: next(it), live)
    _assert_grads_match(jg, jm, tg, tm)
    got = grads[-1].double().numpy()
    assert got.shape == frames.shape
    assert _rel(got, np.asarray(jframes, np.float64)) <= GRAD_TOL
    assert np.abs(got).sum(-1).all()


def test_decoder_position_table_gradient_at_4096_tokens():
    """b 1 x 4096 tokens: the decoder's ``pos_table[positions % 4096]`` and
    ``embed[tokens]`` gathers' backwards (index-adds) against the
    reference's, every leaf; all 4096 rows of the decoder's table and all
    16 of the encoder's take a gradient in both."""
    _, tcfg, _, tstate = _model(LONG_LAYERS)
    jg, jm = _reference_grads("long")
    tg, tm = TS.grads_of(tcfg, TS.TrainConfig(), tstate.params,
                         _torch(_case_batch("long")))
    _assert_grads_match(jg, jm, tg, tm)
    for g in (jg, tg):
        assert len(_rows_with_gradient(g["pos_table"])) == TT.POS_ROWS
        assert len(_rows_with_gradient(g["encoder"]["pos_table"])) == \
            tcfg.n_frames


def test_microbatched_grads_match_reference():
    """Microbatches of 2 of a batch of 4, the frames split with the
    tokens: float32 accumulators in both."""
    _, tcfg, _, tstate = _model()
    jg, jm = _reference_grads("micro")
    tg, tm = TS.grads_of(tcfg, TS.TrainConfig(microbatch=CASES["micro"][3]),
                         tstate.params, _torch(_case_batch("micro")))
    _assert_grads_match(jg, jm, tg, tm)
    assert all(g.dtype == torch.float32 for g in TO.tree_leaves(tg))


def test_remat_on_equals_remat_off_bitwise():
    """The encoder runs outside remat either way; each decoder unit's
    checkpoint takes the encoder's output as an input, and its gradient
    sums over the units before it reaches the encoder."""
    _, tcfg, _, tstate = _model()
    batch = _torch(_case_batch("frames16"))
    on = TS.grads_of(tcfg, TS.TrainConfig(remat=True), tstate.params, batch)
    off = TS.grads_of(tcfg, TS.TrainConfig(remat=False), tstate.params,
                      batch)
    for a, b in zip(TO.tree_leaves(on[0]), TO.tree_leaves(off[0])):
        assert torch.equal(a, b)
    assert set(on[1]) == set(off[1])
    assert all(torch.equal(on[1][k], off[1][k]) for k in on[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_full_attention_gradients_follow_the_reference(dtype):
    """``_full_attention`` (materialised unmasked scores, the float32
    softmax cast back to the operands' type before the product with V) at
    24 queries over 16 keys: dq, dk, dv in the operands' type against the
    reference's ``jax.vjp`` of its non-causal attention, within
    ATTN_TOL."""
    rng = np.random.RandomState(3)
    b, sq, sk, h, d = 2, 24, 16, 4, 64
    q, k, v, g = (rng.randn(*shape).astype(np.float32) for shape in
                  ((b, sq, h, d), (b, sk, h, d), (b, sk, h, d),
                   (b, sq, h, d)))
    jdt = getattr(jnp, dtype)
    out, vjp = jax.vjp(
        lambda *x: JA._plain_attention(*x, causal=False, window=0),
        *(jnp.asarray(x).astype(jdt) for x in (q, k, v)))
    want = vjp(jnp.asarray(g).astype(jdt))
    tdt = getattr(torch, dtype)
    ins = [torch.tensor(x).to(tdt).requires_grad_(True) for x in (q, k, v)]
    tout = TA._full_attention(*ins)
    got = torch.autograd.grad(tout, ins, torch.tensor(g).to(tdt))
    assert tout.dtype == tdt and all(x.dtype == tdt for x in got)
    assert _rel(tout.detach().double().numpy(),
                np.asarray(out.astype(jnp.float32), np.float64)) \
        <= ATTN_TOL[dtype]
    for x, w in zip(got, want):
        assert _rel(x.double().numpy(),
                    np.asarray(w.astype(jnp.float32), np.float64)) \
            <= ATTN_TOL[dtype]


# ------------------------------------------------------------ train step
def test_train_step_matches_reference():
    jcfg, tcfg, jstate, _ = _model()
    jg, jm = _reference_grads("frames16")
    if "step" not in _J_RESULTS:
        _J_RESULTS["step"] = JS.TrainState(
            *_J_UPDATE(J_ADAM, jg, jstate.opt, jstate.params))
    j1 = _J_RESULTS["step"]
    t0 = train_state_from_numpy(jax.tree.map(np.asarray, jstate), tcfg, CPU)
    start = _flat(t0)
    t1, tm = TS.make_train_step(tcfg, T_ADAM, TS.TrainConfig())(
        t0, _torch(_case_batch("frames16")))
    got, want = _flat(t1), _flat(j1)
    resolved = _resolved([_flat(jg)])
    assert _flip_share(got, want, resolved, ("params",)) == 0
    _assert_update_matches(got, want, start, resolved, ("params",))
    assert int(t1.opt.step) == int(j1.opt.step) == 1
    np.testing.assert_allclose(float(tm["nll"]), float(jm["nll"]),
                               rtol=GRAD_TOL, atol=1e-7)


# -------------------------------------------------------------- consensus
def test_diagonal_round_matches_reference():
    """One diagonal round, 2 pods of 2 local steps, with frame embeddings of
    shape (P, H, b, F, d) beside ``pod_sharded_batches``' tokens and labels
    (the round slices every key of the batch): the pods restart from
    theta_bar. Held over the coordinates resolved in each of the round's
    four local gradients at its start, as phase 15 of ``chip_smoke.py``
    holds a round: at most FLIPS of them more than lr / 100 apart, all of
    them within STEP_TOL of the update; the moments within
    ROUND_MOMENT_TOL."""
    jcfg, tcfg, _, _ = _model()
    jc = JCT.ConsensusConfig(n_pods=N_PODS, scheme="diagonal",
                             h_steps=H_STEPS)
    tc = TCT.ConsensusConfig(n_pods=N_PODS, scheme="diagonal",
                             h_steps=H_STEPS)
    jstate = JCT.init_state(jcfg, jax.random.PRNGKey(0), jc)
    ds = JP.SyntheticLM(JP.DataConfig(vocab_size=jcfg.vocab_size,
                                      seq_len=POD_SEQ,
                                      global_batch=POD_BSZ * N_PODS))
    arrs = jax.tree.map(np.asarray, next(iter(
        JP.pod_sharded_batches(ds, N_PODS, H_STEPS))))
    arrs["enc_frames"] = _batch(tcfg, POD_BSZ, POD_SEQ, tcfg.n_frames,
                                seed=4, lead=(N_PODS, H_STEPS))["enc_frames"]
    batch = _torch(arrs)
    assert batch["tokens"].shape == (N_PODS, H_STEPS, POD_BSZ, POD_SEQ)
    j1, jm = jax.jit(JCT.make_round_step(jcfg, J_ADAM, JS.TrainConfig(),
                                         jc))(jstate, _jax(arrs))
    t0 = consensus_state_from_numpy(jax.tree.map(np.asarray, jstate), tcfg,
                                    N_PODS, CPU)
    start = _flat(t0)
    resolved = _resolved([_flat(TS.grads_of(
        tcfg, TS.TrainConfig(), t0.theta_bar,
        {k: v[i, h] for k, v in batch.items()})[0])
        for i in range(N_PODS) for h in range(H_STEPS)])
    t1, tm = TCT.make_round_step(tcfg, T_ADAM, TS.TrainConfig(), tc)(
        t0, batch)
    got, want = _flat(t1), _flat(j1)
    pods = [[_pod(t, i) for t in (got, want, start)] for i in range(N_PODS)]
    for g, w, s in pods:
        assert _flip_share(g, w, resolved, ("params",)) <= FLIPS
        _assert_update_matches(g, w, s, resolved, ("params",))
    unstacked = [{k: v for k, v in t.items()
                  if not k.startswith(("params/", "lam/"))}
                 for t in (got, want, start)]
    assert _flip_share(*unstacked[:2], resolved, ("theta_bar",)) <= FLIPS
    _assert_update_matches(*unstacked, resolved, ("theta_bar",),
                           moment_tol=ROUND_MOMENT_TOL)
    np.testing.assert_array_equal(t1.opt.step.numpy(),
                                  np.asarray(j1.opt.step))
    np.testing.assert_allclose(float(tm["nll"]), float(jm["nll"]),
                               rtol=GRAD_TOL, atol=1e-7)
    pods, bar = TO.tree_leaves(t1.params), TO.tree_leaves(t1.theta_bar)
    assert all(torch.equal(p[i], tb) for p, tb in zip(pods, bar)
               for i in range(N_PODS))


# ------------------------------------------------------------ checkpoints
def test_bf16_state_round_trips_through_a_checkpoint(tmp_path):
    """``save``/``restore`` of the bf16 reduced state after a step with bf16
    frames: every leaf bitwise, in its own type (bf16 parameters and both
    position tables, float32 layer norms and moments, the int32 step)."""
    _, tcfg, jstate, _ = _model(dtype="bfloat16")
    state = train_state_from_numpy(jax.tree.map(np.asarray, jstate), tcfg,
                                   CPU)
    state, metrics = TS.make_train_step(tcfg, T_ADAM, TS.TrainConfig())(
        state, _torch(_batch(tcfg, 2, 32, tcfg.n_frames),
                      dtype=torch.bfloat16))
    assert np.isfinite(float(metrics["nll"]))
    TK.save(str(tmp_path), 1, state, extra={"arch": ARCH})
    back = TK.restore(str(tmp_path), 1, _zeros_like(state))
    pairs = list(zip(_leaves(back), _leaves(state)))
    assert len(pairs) == len(list(_leaves(state)))
    assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs)
    assert {str(a.dtype) for a, _ in pairs} == {
        "torch.bfloat16", "torch.float32", "torch.int32"}
    assert back.params["pos_table"].dtype == torch.bfloat16
    assert back.params["encoder"]["pos_table"].dtype == torch.bfloat16
    assert back.params["encoder"]["final_norm"]["bias"].dtype == \
        torch.float32
