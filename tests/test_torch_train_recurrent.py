"""Training of the RG-LRU stack (recurrentgemma-2b) against the JAX package,
on the CPU: the reduced config (6 layers rec/rec/attn, d 256, 4/1 heads of
64, window 64, ``rglru_width`` 256) at float32, and at ``n_layers=8`` (two
units and two remainder ``rec`` layers, which run outside remat in both
packages).

The reference's ``init_state`` is carried into the port with
``train_state_from_numpy`` (``consensus_state_from_numpy`` for a round),
the same numpy tokens and labels go into both, and the port's gradients
are held to the reference's ``jax.grad`` (``grads_of``) leaf by leaf. The
batch is 2 x 100 tokens: past the window (64), and not a power of two, so
the doubling scan's last level is partial. Each reference entry point is
jitted once with the configs static, and the batch shapes are shared, so a
config compiles once a shape.

Tolerances are those of ``tests/test_torch_train_families.py``: gradients
normwise per leaf within GRAD_TOL (the port reads up to 3.6e-6, at
``units/b2/attn/wk``; 4.4e-6 with the remainder layers, at
``rem/r1/rec/w_a``); a step's or round's parameters within
STEP_TOL of the size of that leaf's update over the coordinates the
gradient gate resolves (|g| above GRAD_TOL times the leaf's norm), the
moments within MOMENT_TOL. Adam's first step is about lr * g / (|g| +
eps), so an unresolved coordinate moves by an amount float32 noise
decides, up to 2 lr. In a diagonal consensus round that noise also enters
the Fisher weights: over all coordinates the port reads 4.6e-3 of the
update on ``params/embed`` against the reference, and 3.6e-3 against
itself between one and four intra-op threads, so the round is gated over
the coordinates resolved in every pod's local gradients.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as JC  # noqa: E402
from repro.data import pipeline as JP  # noqa: E402
from repro.optim import adamw as JO  # noqa: E402
from repro.train import consensus as JCT  # noqa: E402
from repro.train import step as JS  # noqa: E402
import repro_torch.checkpoint as TK  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.interop import (consensus_state_from_numpy,  # noqa: E402
                                 train_state_from_numpy)
from repro_torch.models import ssm as TSSM  # noqa: E402
from repro_torch.optim import adamw as TO  # noqa: E402
from repro_torch.train import consensus as TCT  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402

CPU = "cpu"
ARCH = "recurrentgemma-2b"
GRAD_TOL = 1e-5
STEP_TOL = 1e-3
MOMENT_TOL = 1e-4
#: a round's resolved coordinates more than lr / 100 apart, at most: phase
#: 15's GATE_TRAIN_FLIPS (``chip_smoke.py``)
FLIPS = 1e-4
#: a round's moments: the second local step's gradient is taken at
#: parameters that the first step's unresolved coordinates moved by float32
#: noise (up to 2 lr each), so the moments carry that noise, linearly in
#: lr: against the reference 3.2e-4 at lr 1e-3 (2.5e-5 at 1e-4), the port
#: against itself between 1 and 4 intra-op threads 1.2e-4. One step's
#: moments are held to MOMENT_TOL
ROUND_MOMENT_TOL = 1e-3
#: the doubling scan's gradients against a sequential loop, both float64
SCAN_TOL = 1e-12
#: past the reduced window (64), not a power of two
BSZ, SEQ = 2, 100
#: a consensus round: 2 pods, 2 local steps, 2 x 80 tokens a pod and step
N_PODS, H_STEPS, POD_BSZ, POD_SEQ = 2, 2, 2, 80
J_ADAM = JO.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=100)
T_ADAM = TO.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=100)

_J_GRADS = jax.jit(JS.grads_of, static_argnums=(0, 1))
#: the reference's train step is ``grads_of`` then ``adamw.update``: the
#: step test jits the update alone and reuses the gradients' compile
_J_UPDATE = jax.jit(JO.update, static_argnums=0)
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


def _model(n_layers=6, dtype="float32"):
    """(JAX config, port config, JAX state, port state) of the reduced
    config at ``n_layers`` and ``dtype``, the port's state carried from the
    reference's. The float32 depth-6 state is the depth-8 one without its
    remainder layers: one draw for both."""
    key = (n_layers, dtype)
    if key not in _MODELS:
        jcfg, tcfg = (dataclasses.replace(m.reduced(m.get(ARCH)),
                                          n_layers=n_layers, dtype=dtype)
                      for m in (JC, TC))
        if key == (6, "float32"):
            deep = _model(8)[2].params
            params = {k: v for k, v in deep.items() if k != "rem"}
            jstate = JS.TrainState(params, JO.init(params))
        else:
            jstate = JS.init_state(jcfg, jax.random.PRNGKey(0))
        tstate = train_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                        tcfg, CPU)
        _MODELS[key] = (jcfg, tcfg, jstate, tstate)
    return _MODELS[key]


def _batch(cfg, b=BSZ, s=SEQ, seed=0):
    rng = np.random.RandomState(seed)
    return {"tokens": rng.randint(0, cfg.vocab_size, (b, s)),
            "labels": rng.randint(0, cfg.vocab_size, (b, s))}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.as_tensor(np.array(v), dtype=torch.int64)
            for k, v in batch.items()}


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


def _dtypes(tree):
    """'/'-joined path -> dtype name, for either package's trees."""
    return {k: str(v.dtype).split(".")[-1]
            for k, v in zip(_flat(tree), _leaves(tree))}


def _leaves(tree):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k])
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from _leaves(getattr(tree, k))
    else:
        yield tree


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
    """The hybrid tree with its AdamW moments: every parameter equal to the
    reference's in its spec's type (``lamb`` float32 in a bf16 model), the
    moments float32 zeros of the same keys, the step an int32 scalar."""
    _, tcfg, jstate, tstate = _model(dtype=dtype)
    want, got = _flat(jstate), _flat(tstate)
    assert set(got) == set(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    types = _dtypes(tstate)
    assert types == _dtypes(jstate)
    kinds = {k.split("/")[-1] for k in want if k.startswith("params/")}
    assert {"w_x", "w_gate", "conv_k", "w_a", "w_i", "lamb", "w_out",
            "wq", "wk", "wv", "wo"} <= kinds
    rec = {k: t for k, t in types.items() if "/rec/" in k
           and k.startswith("params/")}
    assert len(rec) == 2 * 7
    for key, t in rec.items():
        assert t == ("float32" if key.endswith("/lamb") else dtype), key
    assert all(t.dtype == torch.float32 and not t.any() for tree in
               (tstate.opt.m, tstate.opt.v) for t in TO.tree_leaves(tree))
    assert tstate.opt.step.dtype == torch.int32 and int(tstate.opt.step) == 0


# ------------------------------------------------------------ gradients
@pytest.mark.parametrize("n_layers", [6, 8])
def test_grads_of_matches_reference(n_layers):
    """At depth 6 the two rec/rec/attn units run under remat; at depth 8
    the two remainder ``rec`` layers run outside it."""
    jcfg, tcfg, jstate, tstate = _model(n_layers=n_layers)
    assert tcfg.n_rem_layers == n_layers - 6
    batch = _batch(tcfg)
    jg, jm = _J_GRADS(jcfg, JS.TrainConfig(), jstate.params, _jax(batch))
    tg, tm = TS.grads_of(tcfg, TS.TrainConfig(), tstate.params,
                         _torch(batch))
    _assert_grads_match(jg, jm, tg, tm)
    lamb = [g for k, g in _flat(tg).items() if k.endswith("/lamb")]
    assert len(lamb) == 2 + tcfg.n_rem_layers and all(
        np.isfinite(g).all() and g.any() for g in lamb)


def test_microbatched_grads_match_reference():
    """Microbatch 1 of a batch of 2: float32 accumulators in both."""
    jcfg, tcfg, jstate, tstate = _model(n_layers=6)
    batch = _batch(tcfg, seed=1)
    jg, jm = _J_GRADS(jcfg, JS.TrainConfig(microbatch=1), jstate.params,
                      _jax(batch))
    tg, tm = TS.grads_of(tcfg, TS.TrainConfig(microbatch=1), tstate.params,
                         _torch(batch))
    _assert_grads_match(jg, jm, tg, tm)
    assert all(g.dtype == torch.float32 for g in TO.tree_leaves(tg))


def test_remat_on_equals_remat_off_bitwise():
    _, tcfg, _, tstate = _model(n_layers=8)
    batch = _torch(_batch(tcfg))
    on = TS.grads_of(tcfg, TS.TrainConfig(remat=True), tstate.params, batch)
    off = TS.grads_of(tcfg, TS.TrainConfig(remat=False), tstate.params,
                      batch)
    for a, b in zip(TO.tree_leaves(on[0]), TO.tree_leaves(off[0])):
        assert torch.equal(a, b)
    assert set(on[1]) == set(off[1])
    assert all(torch.equal(on[1][k], off[1][k]) for k in on[1])


@pytest.mark.parametrize("s", [1, 2, 3, 64, 100])
def test_linear_scan_gradients_equal_a_sequential_loop(s):
    """The doubling scan's gradients for ``a`` and ``b`` (float64) against
    autograd of h_t = a_t h_{t-1} + b_t run position by position."""
    rng = np.random.RandomState(s)
    a0 = torch.tensor(rng.uniform(0.05, 1.0, (2, s, 5)))
    b0 = torch.tensor(rng.randn(2, s, 5))
    g = torch.tensor(rng.randn(2, s, 5))

    def loop(a, b):
        h, out = torch.zeros_like(b[:, 0]), []
        for t in range(s):
            h = a[:, t] * h + b[:, t]
            out.append(h)
        return torch.stack(out, 1)
    grads = []
    for fn in (TSSM.linear_scan, loop):
        a, b = (t.clone().requires_grad_(True) for t in (a0, b0))
        # at s = 1 the scan is b itself: a's gradient is zero
        grads.append(torch.autograd.grad(fn(a, b), (a, b), g,
                                         allow_unused=True,
                                         materialize_grads=True))
    for got, want in zip(*grads):
        assert got.dtype == torch.float64
        assert _rel(got.numpy(), want.numpy()) <= SCAN_TOL


# ------------------------------------------------------------ train step
def test_train_step_matches_reference():
    jcfg, tcfg, jstate, _ = _model()
    batch = _batch(tcfg)
    jg, jm = _J_GRADS(jcfg, JS.TrainConfig(), jstate.params, _jax(batch))
    j1 = JS.TrainState(*_J_UPDATE(J_ADAM, jg, jstate.opt, jstate.params))
    t0 = train_state_from_numpy(jax.tree.map(np.asarray, jstate), tcfg, CPU)
    start = _flat(t0)
    t1, tm = TS.make_train_step(tcfg, T_ADAM, TS.TrainConfig())(
        t0, _torch(batch))
    got, want = _flat(t1), _flat(j1)
    assert _flip_share(got, want, _resolved([_flat(jg)]), ("params",)) == 0
    _assert_update_matches(got, want, start, _resolved([_flat(jg)]),
                           ("params",))
    assert int(t1.opt.step) == int(j1.opt.step) == 1
    np.testing.assert_allclose(float(tm["nll"]), float(jm["nll"]),
                               rtol=GRAD_TOL, atol=1e-7)
    assert t1.params["units"]["b0"]["rec"]["lamb"].dtype == torch.float32


# -------------------------------------------------------------- consensus
def test_diagonal_round_matches_reference():
    """One diagonal round, 2 pods of 2 local steps: the pods restart from
    theta_bar. Held over the coordinates resolved in each of the round's
    four local gradients at its start (the port's: they match the
    reference's within GRAD_TOL), as phase 15 of ``chip_smoke.py`` holds a
    round: at most FLIPS of them more than lr / 100 apart (the port reads
    4.4e-6 of them), all of them within STEP_TOL of the update (2.9e-4, at
    ``units/b2/attn/wk``); the moments within ROUND_MOMENT_TOL."""
    jcfg, tcfg, _, _ = _model()
    jc = JCT.ConsensusConfig(n_pods=N_PODS, scheme="diagonal",
                             h_steps=H_STEPS)
    tc = TCT.ConsensusConfig(n_pods=N_PODS, scheme="diagonal",
                             h_steps=H_STEPS)
    jstate = JCT.init_state(jcfg, jax.random.PRNGKey(0), jc)
    ds = JP.SyntheticLM(JP.DataConfig(vocab_size=jcfg.vocab_size,
                                      seq_len=POD_SEQ,
                                      global_batch=POD_BSZ * N_PODS))
    batch = _torch(jax.tree.map(np.asarray, next(iter(
        JP.pod_sharded_batches(ds, N_PODS, H_STEPS)))))
    assert batch["tokens"].shape == (N_PODS, H_STEPS, POD_BSZ, POD_SEQ)
    j1, jm = jax.jit(JCT.make_round_step(jcfg, J_ADAM, JS.TrainConfig(),
                                         jc))(jstate, _jax(batch))
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
    """``save``/``restore`` of the bf16 reduced state after a step: every
    leaf bitwise, in its own type (bf16 parameters, float32 ``lamb`` and
    moments, the int32 step)."""
    _, tcfg, jstate, _ = _model(dtype="bfloat16")
    state = train_state_from_numpy(jax.tree.map(np.asarray, jstate), tcfg,
                                   CPU)
    state, _ = TS.make_train_step(tcfg, T_ADAM, TS.TrainConfig())(
        state, _torch(_batch(tcfg, s=32)))
    TK.save(str(tmp_path), 1, state, extra={"arch": ARCH})
    back = TK.restore(str(tmp_path), 1, _zeros_like(state))
    pairs = list(zip(_leaves(back), _leaves(state)))
    assert len(pairs) == len(list(_leaves(state)))
    assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs)
    assert {str(a.dtype) for a, _ in pairs} == {
        "torch.bfloat16", "torch.float32", "torch.int32"}
    assert back.params["units"]["b1"]["rec"]["lamb"].dtype == torch.float32
