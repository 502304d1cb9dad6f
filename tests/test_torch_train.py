"""The port's training path against the JAX package, on the CPU.

Shapes are the reference's own consensus tests'
(``tests/distributed/test_consensus.py``): reduced Llama-3.2-3B cut to two
layers of width 64 (2/1 heads of 32), vocab 256, float32; local batch 4,
sequence 16, 2 pods, 2 local steps. The reference's initial states are
carried into the port with ``train_state_from_numpy`` /
``consensus_state_from_numpy``, and the same numpy batches go to both.

Tolerances (float32, sums taken in another order):
- gradients and losses: normwise per leaf within GRAD_TOL. The port reads
  1.2e-6 from the reference; the reference jitted against eager 3.8e-7.
- a step or round's parameters (and theta_bar, lam): normwise per leaf
  within STEP_TOL of the size of that leaf's update. Adam's first step is
  about lr * sign(g), so a gradient coordinate near 0 that float32 noise
  flips moves a parameter by 2 lr: the port reads up to 3.2e-4 of the
  update, the reference jitted against eager 1.1e-4 (its admm lam).
- the optimizer on identical inputs: GATE_ADAM.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as JC  # noqa: E402
from repro.checkpoint import io as JK  # noqa: E402
from repro.data import pipeline as JP  # noqa: E402
from repro.kernels.swa.ops import _swa_bwd  # noqa: E402
from repro.kernels.swa.ref import swa_attention_ref as j_swa_ref  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import adamw as JO  # noqa: E402
from repro.train import consensus as JCT  # noqa: E402
from repro.train import loss as JL  # noqa: E402
from repro.train import step as JS  # noqa: E402
import repro_torch.checkpoint as TK  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.core import grid_graph, random_model  # noqa: E402
from repro_torch.data import pipeline as TP  # noqa: E402
from repro_torch.interop import (consensus_state_from_numpy,  # noqa: E402
                                 params_from_numpy, train_state_from_numpy)
from repro_torch.kernels.swa import kernel as smod  # noqa: E402
from repro_torch.kernels.swa.ops import SwaFunction, swa_op  # noqa: E402
from repro_torch.launch import train as TLAUNCH  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.optim import adamw as TO  # noqa: E402
from repro_torch.train import consensus as TCT  # noqa: E402
from repro_torch.train import loss as TL  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402

CPU = "cpu"
GRAD_TOL = 1e-5
STEP_TOL = 1e-3
#: moments after a step or round, normwise against their own norm (they
#: start at 0): the port reads 4.7e-6
MOMENT_TOL = 1e-4
#: AdamW on identical float32 inputs: a few ulps where the sums fuse
GATE_ADAM = dict(rtol=1e-6, atol=1e-9)
SCHEMES = ("uniform", "diagonal", "max", "admm")
N_PODS, H_STEPS, BSZ, SEQ = 2, 2, 4, 16


def _tiny(mod):
    r = mod.reduced(mod.get("llama3.2-3b"))
    return dataclasses.replace(r, n_layers=2, d_model=64, n_heads=2,
                               n_kv_heads=1, head_dim=32, d_ff=128,
                               vocab_size=256)


JCFG, TCFG = _tiny(JC), _tiny(TC)
J_ADAM = JO.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=100)
T_ADAM = TO.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=100)


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


def _tensors(batch):
    return {k: torch.tensor(np.asarray(v), dtype=torch.int64)
            for k, v in batch.items()}


@pytest.fixture(scope="module")
def ref_state():
    return JS.init_state(JCFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def batch():
    ds = JP.SyntheticLM(JP.DataConfig(vocab_size=JCFG.vocab_size,
                                      seq_len=SEQ, global_batch=BSZ))
    return ds.batch(0)


def _port_state(ref_state):
    return train_state_from_numpy(jax.tree.map(np.asarray, ref_state), TCFG,
                                  CPU)


# ------------------------------------------------------------ swa Function
@pytest.mark.parametrize("window", [0, 5])
def test_swa_function_gradients_equal_reference_vjp(window):
    """The Function's backward is the reference's ``_swa_bwd`` (jax.vjp of
    the oracle), called here directly on CPU tensors; on the CPU swa_op's
    plain autograd gives the Function's gradients bit for bit."""
    rng = np.random.RandomState(window)
    b, s, h, kh, d = 2, 24, 4, 2, 16
    q, k, v = (rng.randn(b, s, n, d).astype(np.float32)
               for n in (h, kh, kh))
    g = rng.randn(b, s, h, d).astype(np.float32)
    launches = smod.swa_attention.launches
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = SwaFunction.apply(tq, tk, tv, window)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.tensor(g))
    want = _swa_bwd(window, tuple(map(jnp.asarray, (q, k, v))),
                    jnp.asarray(g))
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(j_swa_ref(q, k, v, window=window)),
                               rtol=1e-5, atol=1e-6)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    plain = torch.autograd.grad(swa_op(tq, tk, tv, window=window),
                                (tq, tk, tv), torch.tensor(g))
    assert all(torch.equal(a, p) for a, p in zip(got, plain))
    assert smod.swa_attention.launches == launches   # no kernel on the CPU


# -------------------------------------------------------------------- loss
def test_cross_entropy_matches_reference_with_masked_labels():
    rng = np.random.RandomState(3)
    logits = (3 * rng.randn(2, 7, 11)).astype(np.float32)
    labels = rng.randint(0, 11, (2, 7)).astype(np.int32)
    labels[0, :3] = -1
    labels[1, 5] = -1
    jloss, jm = JL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    jgrad = jax.grad(lambda x: JL.cross_entropy(x, jnp.asarray(labels))[0])(
        jnp.asarray(logits))
    tl = torch.tensor(logits, requires_grad=True)
    tloss, tm = TL.cross_entropy(tl, torch.tensor(labels, dtype=torch.int64))
    (tgrad,) = torch.autograd.grad(tloss, tl)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=GRAD_TOL)
    assert set(tm) == set(jm) == {"nll", "z_loss", "n_tokens"}
    for key in jm:
        np.testing.assert_allclose(float(tm[key].detach()), float(jm[key]),
                                   rtol=GRAD_TOL)
    assert float(tm["n_tokens"]) == 10.0
    assert _rel(tgrad.numpy(), np.asarray(jgrad)) <= GRAD_TOL
    assert not tgrad[0, :3].any()                # masked positions


# ------------------------------------------------------------------- AdamW
def test_adamw_schedule_update_and_fisher_match_reference():
    """Identical inputs into both optimizers: the schedule, one update of a
    float32 and a bfloat16 leaf (in place in the port), and the Fisher
    diagonal."""
    cfg_j = JO.AdamWConfig(lr=2e-3, warmup_steps=3, total_steps=10)
    cfg_t = TO.AdamWConfig(lr=2e-3, warmup_steps=3, total_steps=10)
    steps = np.arange(13, dtype=np.int32)
    np.testing.assert_allclose(
        TO.schedule(cfg_t, torch.tensor(steps)).numpy(),
        np.asarray(JO.schedule(cfg_j, jnp.asarray(steps))), rtol=1e-6)
    rng = np.random.RandomState(4)
    shapes = {"a": (3, 5), "b": {"c": (7,)}}

    def tree(make):
        return {"a": make("a", shapes["a"]),
                "b": {"c": make("c", shapes["b"]["c"])}}
    p = tree(lambda n, s: rng.randn(*s).astype(np.float32))
    g = tree(lambda n, s: rng.randn(*s).astype(np.float32))
    m = tree(lambda n, s: 0.1 * rng.randn(*s).astype(np.float32))
    v = tree(lambda n, s: rng.rand(*s).astype(np.float32))
    jp = {"a": jnp.asarray(p["a"]),
          "b": {"c": jnp.asarray(p["b"]["c"], jnp.bfloat16)}}
    jstate = JO.AdamWState(step=jnp.asarray(3, jnp.int32),
                           m=jax.tree.map(jnp.asarray, m),
                           v=jax.tree.map(jnp.asarray, v))
    jnew, jst = JO.update(cfg_j, jax.tree.map(jnp.asarray, g), jstate, jp)
    tp = {"a": torch.tensor(p["a"]),
          "b": {"c": torch.tensor(p["b"]["c"]).to(torch.bfloat16)}}
    tstate = TO.AdamWState(step=torch.tensor(3, dtype=torch.int32),
                           m=TO.tree_map(torch.tensor, m),
                           v=TO.tree_map(torch.tensor, v))
    tnew, tst = TO.update(cfg_t, TO.tree_map(torch.tensor, g), tstate, tp)
    assert tnew is tp and tst.m["a"] is tstate.m["a"]   # in place
    assert int(tst.step) == int(jst.step) == 4
    for key in ("m", "v"):
        for a, b in zip(TO.tree_leaves(getattr(tst, key)),
                        jax.tree_util.tree_leaves(getattr(jst, key))):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **GATE_ADAM)
    np.testing.assert_allclose(tnew["a"].numpy(), np.asarray(jnew["a"]),
                               **GATE_ADAM)
    assert tnew["b"]["c"].dtype == torch.bfloat16
    # bfloat16 leaf: the float32 updates agree to ulps, so the rounded
    # values are equal or one bfloat16 step apart
    np.testing.assert_allclose(
        tnew["b"]["c"].float().numpy(),
        np.asarray(jnew["b"]["c"], np.float32), rtol=2.0 ** -7)
    for a, b in zip(TO.tree_leaves(TO.fisher_diag(tst)),
                    jax.tree_util.tree_leaves(JO.fisher_diag(jst))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GATE_ADAM)


# -------------------------------------------------------------------- data
def test_synthetic_lm_and_pod_batches_equal_reference():
    jcfg = JP.DataConfig(vocab_size=300, seq_len=33, global_batch=6, seed=5)
    tcfg = TP.DataConfig(vocab_size=300, seq_len=33, global_batch=6, seed=5)
    jds, tds = JP.SyntheticLM(jcfg), TP.SyntheticLM(tcfg, device=CPU)
    for index, shard, n_shards in ((0, 0, 1), (7, 1, 3), (2, 2, 3)):
        jb, tb = jds.batch(index, shard, n_shards), tds.batch(
            index, shard, n_shards)
        for key in ("tokens", "labels"):
            assert tb[key].dtype == torch.int64 and tb[key].device.type == CPU
            np.testing.assert_array_equal(tb[key].numpy(), np.asarray(jb[key]))
    jr = JP.pod_sharded_batches(jds, 3, 2, start_round=1)
    tr = TP.pod_sharded_batches(tds, 3, 2, start_round=1)
    for _ in range(2):
        jb, tb = next(jr), next(tr)
        assert tuple(tb["tokens"].shape) == (3, 2, 2, 33)
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(tb[key].numpy(), np.asarray(jb[key]))


def test_ising_batches_draw_from_the_port_samplers():
    def draw(sampler):
        gen = torch.Generator()
        gen.manual_seed(11)
        model = random_model(grid_graph(2, 2), 0.4, 0.3, gen, device=CPU)
        return list(TP.ising_batches(model, 32, 3, gen, sampler=sampler))
    for sampler in ("exact", "gibbs"):
        first, again = draw(sampler), draw(sampler)
        assert len(first) == 3 and all(x.shape == (32, 4) for x in first)
        assert all(torch.equal(a, b) for a, b in zip(first, again))
        assert not torch.equal(first[0], first[1])   # the stream carries on
        assert set(torch.unique(first[0]).tolist()) <= {-1.0, 1.0}


# ------------------------------------------------------------ train step
@pytest.mark.parametrize("microbatch", [0, 2])
def test_grads_of_matches_reference(ref_state, batch, microbatch):
    jg, jm = JS.grads_of(JCFG, JS.TrainConfig(microbatch=microbatch),
                         ref_state.params, batch)
    tg, tm = TS.grads_of(TCFG, TS.TrainConfig(microbatch=microbatch),
                         _port_state(ref_state).params, _tensors(batch))
    want, got = _flat(jg), _flat(tg)
    assert set(got) == set(want)
    for key in want:
        assert _rel(got[key], want[key]) <= GRAD_TOL, key
    for key in ("nll", "z_loss", "aux", "n_tokens"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=GRAD_TOL, atol=1e-7)
    if microbatch:
        assert all(g.dtype == torch.float32 for g in TO.tree_leaves(tg))


def test_remat_on_equals_remat_off_bitwise(ref_state, batch):
    params = _port_state(ref_state).params
    tb = _tensors(batch)
    on = TS.grads_of(TCFG, TS.TrainConfig(remat=True), params, tb)
    off = TS.grads_of(TCFG, TS.TrainConfig(remat=False), params, tb)
    for a, b in zip(TO.tree_leaves(on[0]), TO.tree_leaves(off[0])):
        assert torch.equal(a, b)
    assert all(torch.equal(on[1][k], off[1][k]) for k in on[1])
    with torch.no_grad():
        l1, _ = TT.forward(TCFG, params, tb["tokens"], remat=True)
        l0, _ = TT.forward(TCFG, params, tb["tokens"], remat=False)
    assert torch.equal(l1, l0)


@pytest.mark.parametrize("arch,key", [
    ("chameleon-34b", "patch_embeds"),          # no patch slots: ignored
    ("llama4-scout-17b-a16e", "patch_embeds"),  # early fusion, 4 slots
    ("whisper-tiny", "enc_frames")])
def test_loss_takes_the_batch_inputs_the_reference_takes(arch, key):
    # the reduced config's loss with patch embeddings or encoder frames in
    # the batch, against the reference's make_loss_fn; then the
    # rematerialised backward through the port's loss, which must carry the
    # encoder's output into the checkpointed units
    jcfg, tcfg = JC.reduced(JC.get(arch)), TC.reduced(TC.get(arch))
    jparams = JT.model_init(jcfg, jax.random.PRNGKey(1))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, CPU)
    rng = np.random.RandomState(0)
    n = tcfg.n_frames if key == "enc_frames" else 4
    arrs = {"tokens": rng.randint(0, tcfg.vocab_size, (2, SEQ)),
            "labels": rng.randint(0, tcfg.vocab_size, (2, SEQ)),
            key: rng.randn(2, n, tcfg.d_model).astype(np.float32)}
    jloss, jm = jax.jit(JS.make_loss_fn(jcfg, JS.TrainConfig()))(
        jparams, {k: jnp.asarray(v) for k, v in arrs.items()})
    tbatch = {k: torch.as_tensor(v) for k, v in arrs.items()}
    loss_fn = TS.make_loss_fn(tcfg, TS.TrainConfig())
    tloss, tm = loss_fn(params, tbatch)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=GRAD_TOL)
    np.testing.assert_allclose(float(tm["nll"]), float(jm["nll"]),
                               rtol=GRAD_TOL)
    if key == "enc_frames":
        grads, _ = TS.grads_of(tcfg, TS.TrainConfig(remat=True), params,
                               tbatch)
        assert all(bool(torch.isfinite(g).all())
                   for g in TO.tree_leaves(grads))
        # the loss reaches the encoder only through the cross-attention
        assert float(grads["encoder"]["layers"]["attn"]["wq"].abs().max()) > 0
    elif tcfg.n_patches:
        # the embeddings take the first rows: without them the loss moves
        without = loss_fn(params, {k: v for k, v in tbatch.items()
                                   if k != key})[0]
        assert float(without) != float(tloss)


def test_train_step_matches_reference(ref_state, batch):
    j1, jm = jax.jit(JS.make_train_step(JCFG, J_ADAM, JS.TrainConfig()))(
        ref_state, batch)
    t0 = _port_state(ref_state)
    start = _flat(t0)
    t1, tm = TS.make_train_step(TCFG, T_ADAM, TS.TrainConfig())(
        t0, _tensors(batch))
    want, got = _flat(j1), _flat(t1)
    assert set(got) == set(want)
    for key in want:
        if key.startswith("params/"):
            assert _rel(got[key], want[key],
                        np.linalg.norm(want[key] - start[key])) <= STEP_TOL
        elif key.startswith("opt/m/") or key.startswith("opt/v/"):
            assert _rel(got[key], want[key]) <= MOMENT_TOL, key
    assert int(t1.opt.step) == int(j1.opt.step) == 1
    np.testing.assert_allclose(float(tm["nll"]), float(jm["nll"]),
                               rtol=GRAD_TOL)


# -------------------------------------------------------------- consensus
def _round_inputs(scheme):
    jc = JCT.ConsensusConfig(n_pods=N_PODS, scheme=scheme, h_steps=H_STEPS)
    tc = TCT.ConsensusConfig(n_pods=N_PODS, scheme=scheme, h_steps=H_STEPS)
    state = JCT.init_state(JCFG, jax.random.PRNGKey(0), jc)
    ds = JP.SyntheticLM(JP.DataConfig(vocab_size=JCFG.vocab_size,
                                      seq_len=SEQ,
                                      global_batch=BSZ * N_PODS))
    return jc, tc, state, next(iter(JP.pod_sharded_batches(ds, N_PODS,
                                                           H_STEPS)))


@pytest.mark.parametrize("scheme", SCHEMES)
def test_round_step_matches_reference(scheme):
    jc, tc, jstate, batch = _round_inputs(scheme)
    j1, jm = jax.jit(JCT.make_round_step(JCFG, J_ADAM, JS.TrainConfig(),
                                         jc))(jstate, batch)
    t0 = consensus_state_from_numpy(jax.tree.map(np.asarray, jstate), TCFG,
                                    N_PODS, CPU)
    start = _flat(t0)
    t1, tm = TCT.make_round_step(TCFG, T_ADAM, TS.TrainConfig(), tc)(
        t0, _tensors(batch))
    want, got = _flat(j1), _flat(t1)
    assert set(got) == set(want)
    for key in want:
        if key.split("/")[0] in ("params", "theta_bar", "lam"):
            ref0 = start[key] if key in start else 0.0
            assert _rel(got[key], want[key],
                        np.linalg.norm(want[key] - ref0)) <= STEP_TOL, key
        elif key.startswith("opt/m/") or key.startswith("opt/v/"):
            assert _rel(got[key], want[key]) <= MOMENT_TOL, key
    np.testing.assert_array_equal(t1.opt.step.numpy(),
                                  np.asarray(j1.opt.step))
    jw, tw = (_flat(mod._fisher_weights(state.opt, 1e-8)) for mod, state in
              ((JCT, j1), (TCT, t1)))
    assert all(_rel(tw[k], jw[k]) <= MOMENT_TOL for k in jw)
    np.testing.assert_allclose(float(tm["nll"]), float(jm["nll"]),
                               rtol=GRAD_TOL)
    pods, bar = TO.tree_leaves(t1.params), TO.tree_leaves(t1.theta_bar)
    if scheme == "admm":
        assert any(bool(lam.any()) for lam in TO.tree_leaves(t1.lam))
        assert any(not torch.equal(p[0], p[1]) for p in pods)
    else:   # one-step consensus: every pod restarts from theta_bar
        assert all(torch.equal(p[i], tb) for p, tb in zip(pods, bar)
                   for i in range(N_PODS))


@pytest.mark.parametrize("scheme", SCHEMES)
def test_combine_matches_reference_on_spread_pods(scheme):
    """Stacked parameters with ties in the weights (the max vote averages
    them) through both packages' ``combine``."""
    rng = np.random.RandomState(7)
    p = rng.randn(3, 4, 5).astype(np.float32)
    w = rng.randint(1, 4, (3, 4, 5)).astype(np.float32)
    want = JCT.combine(scheme, {"x": jnp.asarray(p)}, {"x": jnp.asarray(w)})
    got = TCT.combine(scheme, {"x": torch.tensor(p)}, {"x": torch.tensor(w)})
    np.testing.assert_allclose(got["x"].numpy(), np.asarray(want["x"]),
                               rtol=1e-6, atol=1e-7)


def test_configs_refuse_what_the_port_does_not_take():
    with pytest.raises(NotImplementedError, match="item 12"):
        TS.TrainConfig(mesh="pod")
    with pytest.raises(ValueError, match="known"):
        TCT.make_round_step(TCFG, T_ADAM, TS.TrainConfig(),
                            TCT.ConsensusConfig(scheme="median"))
    jstate = JCT.init_state(JCFG, jax.random.PRNGKey(0),
                            JCT.ConsensusConfig(n_pods=2))
    with pytest.raises(ValueError, match="shape"):
        consensus_state_from_numpy(jax.tree.map(np.asarray, jstate), TCFG, 3,
                                   CPU)


# ------------------------------------------------------------- checkpoints
def test_checkpoints_cross_between_packages(ref_state, tmp_path):
    """Keys, dtypes and shapes of both packages' checkpoints of one state
    are equal; each restores the other's exactly; a bfloat16 leaf that the
    reference wrote (raw 2-byte words) reads back in the port, and the
    port's own bfloat16 round trip is exact."""
    tstate = _port_state(ref_state)
    JK.save(str(tmp_path / "ref"), 3, ref_state)
    TK.save(str(tmp_path / "port"), 3, tstate, extra={"arch": "tiny"})
    import json
    mj, mt = (json.load(open(tmp_path / d / "step_3" / "manifest.json"))
              for d in ("ref", "port"))
    assert mj["keys"] == mt["keys"] and "opt/m/units/b0/attn/wq" in mt["keys"]
    assert mj["dtypes"] == mt["dtypes"] and mj["shapes"] == mt["shapes"]
    back = TK.restore(str(tmp_path / "ref"), 3, tstate)
    want = _flat(tstate)
    assert all(np.array_equal(v, want[k]) for k, v in _flat(back).items())
    jback = JK.restore(str(tmp_path / "port"), 3, ref_state)
    jwant = _flat(ref_state)
    assert all(np.array_equal(v, jwant[k]) for k, v in _flat(jback).items())
    assert TK.latest_step(str(tmp_path / "port")) == 3

    bits = np.random.RandomState(8).randn(4, 6).astype(np.float32)
    JK.save(str(tmp_path / "bf16"), 1, {"w": jnp.asarray(bits, jnp.bfloat16),
                                        "b": jnp.asarray(bits[0])})
    like = {"w": torch.zeros((4, 6), dtype=torch.bfloat16),
            "b": torch.zeros(6)}
    got = TK.restore(str(tmp_path / "bf16"), 1, like)
    assert got["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["w"].float().numpy(),
        np.asarray(jnp.asarray(bits, jnp.bfloat16), np.float32))
    TK.save(str(tmp_path / "bf16p"), 1, got)
    again = TK.restore(str(tmp_path / "bf16p"), 1, like)
    assert torch.equal(again["w"], got["w"]) and torch.equal(again["b"],
                                                             got["b"])
    with pytest.raises(ValueError, match="shape"):
        TK.restore(str(tmp_path / "bf16p"), 1, {"w": torch.zeros(3),
                                                "b": torch.zeros(6)})


# ---------------------------------------------------------------- launcher
@pytest.mark.parametrize("scheme", ["sync", "admm"])
def test_launcher_runs_two_steps_on_the_cpu(scheme, tmp_path, capsys):
    TLAUNCH.main(["--reduced", "--device", CPU, "--steps", "2", "--batch",
                  "2", "--seq", "16", "--scheme", scheme, "--h-steps", "1",
                  "--ckpt-dir", str(tmp_path), "--ckpt-every", "1"])
    out = capsys.readouterr().out.splitlines()
    word = "step" if scheme == "sync" else "round"
    lines = [ln for ln in out if ln.startswith(word)]
    assert len(lines) == 2 and out[-1] == "done"
    assert all(np.isfinite(float(ln.split("nll=")[1].split()[0]))
               for ln in lines)
    assert TK.latest_step(str(tmp_path)) == 2
