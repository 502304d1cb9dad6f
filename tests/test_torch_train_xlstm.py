"""Training of the xLSTM stack (xlstm-1.3b) against the JAX package, on the
CPU: the reduced config (d 256, mLSTM width 512 in 2 heads of 256) cut to
one unit of seven mLSTM and one sLSTM layer (``n_layers=8``) and to that
unit plus two remainder mLSTM layers, which run outside remat in both
packages (``n_layers=10``), at float32.

The reference's state is carried into the port with
``train_state_from_numpy`` (``consensus_state_from_numpy`` for a round),
the same numpy tokens and labels go into both, and the port's gradients
are held to the reference's ``jax.grad`` (``grads_of``) leaf by leaf
(CASES): at b 2 x s 100 (one chunk), at b 1 x s 512 (two chunks of 256),
at b 2 x s 64 with the chunk set to 4 in both packages (sixteen chunks,
so the carried (C, n, m) takes gradients that count: at the initial
forget gates a chunk of 256 leaves it none), and at depth 10 in
microbatches of 1. Each reference entry point is jitted once with the
configs static, and the batch shapes are shared, so a config compiles
once a shape.

Gradients are gated normwise per leaf at GRAD_TOL, set from measurement.
Both packages run the recurrences in float32, and the normaliser
max(|q.n|, exp(-m)) magnifies float32 rounding at a few positions (the
forward's story, ``tests/test_torch_xlstm.py``), most on the leaves that
feed q and k. Against a run of the port with the xLSTM recurrences in
float64 (its norms and loss still float32), the reference's own float32
gradients read up to 3.0e-5 at depth 8, s 100 (``units/b0/norm1/scale``),
6.0e-5 at s 512 (``units/b1/mix/w_q``), 3.9e-5 at chunk 4
(``units/b0/mix/conv_k``) and 5.8e-5 at depth 10 (``rem/r1/mix/w_q``); the
port's 3.0e-5, 5.6e-5, 2.3e-5 and 3.9e-5. The port against the reference
reads up to 3.8e-5 (``units/b1/norm1/scale``), 8.2e-5
(``units/b1/mix/w_q``), 4.4e-5 (``units/b0/mix/conv_k``) and 6.8e-5
(``units/b0/mix/w_q``). Each case's gate is three times the reference's
own distance there, rounded down: the two packages are two float32
roundings of one float64 result.

A step's or round's parameters are held within STEP_TOL of the size of
that leaf's update over the coordinates the gradient gate resolves (|g|
above the gate times the leaf's norm), the moments within MOMENT_TOL, as
``tests/test_torch_train_recurrent.py`` holds them: Adam's first step is
about lr * g / (|g| + eps), so an unresolved coordinate moves by an amount
float32 noise decides, up to 2 lr.
"""
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as JC  # noqa: E402
from repro.data import pipeline as JP  # noqa: E402
from repro.models import xlstm as JX  # noqa: E402
from repro.optim import adamw as JO  # noqa: E402
from repro.train import consensus as JCT  # noqa: E402
from repro.train import step as JS  # noqa: E402
import repro_torch.checkpoint as TK  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.interop import (consensus_state_from_numpy,  # noqa: E402
                                 train_state_from_numpy)
from repro_torch.models import xlstm as TX  # noqa: E402
from repro_torch.optim import adamw as TO  # noqa: E402
from repro_torch.train import consensus as TCT  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402

CPU = "cpu"
ARCH = "xlstm-1.3b"
#: the gradient cases: name -> (depth, (batch, sequence), microbatch,
#: MLSTM_CHUNK in both packages). One chunk of 100; two chunks of 256;
#: sixteen chunks of 4, where the carried (C, n, m) weighs in (at the
#: model's initial forget gates, about 0.5, a chunk of 256 decays the
#: carried state by about exp(-177), zero in float32); remainder layers in
#: microbatches of 1
CASES = {"depth8-s100": (8, (2, 100), 0, 256),
         "depth8-s512": (8, (1, 512), 0, 256),
         "depth8-s64-chunk4": (8, (2, 64), 0, 4),
         "depth10-s100-microbatch1": (10, (2, 100), 1, 256)}
#: gradients normwise per leaf, by case: three times the reference's own
#: float32 distance from float64 there, rounded down (module docstring)
GRAD_TOL = {"depth8-s100": 9e-5, "depth8-s512": 1.8e-4,
            "depth8-s64-chunk4": 1.1e-4, "depth10-s100-microbatch1": 1.7e-4}
#: the batch of the train step and the round's gradient gate
SHORT = CASES["depth8-s100"][1]
#: nll, z_loss and n_tokens, relative
METRIC_TOL = 1e-5
STEP_TOL = 1e-3
MOMENT_TOL = 1e-4
#: a round's resolved coordinates more than lr / 100 apart, at most: phase
#: 15's GATE_TRAIN_FLIPS (``chip_smoke.py``)
FLIPS = 1e-4
#: a round's moments carry the first local step's float32 noise (see
#: ``tests/test_torch_train_recurrent.py``)
ROUND_MOMENT_TOL = 1e-3
#: the scans alone on O(1) inputs, normwise per input: float32 sums in
#: another order
SCAN_GRAD_TOL = 1e-5
#: a consensus round: 2 pods, 2 local steps, 2 x 32 tokens a pod and step
N_PODS, H_STEPS, POD_BSZ, POD_SEQ = 2, 2, 2, 32
J_ADAM = JO.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=100)
T_ADAM = TO.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=100)


@contextlib.contextmanager
def _chunk(size):
    """Both packages' MLSTM_CHUNK set to ``size``."""
    orig = JX.MLSTM_CHUNK, TX.MLSTM_CHUNK
    JX.MLSTM_CHUNK = TX.MLSTM_CHUNK = size
    try:
        yield
    finally:
        JX.MLSTM_CHUNK, TX.MLSTM_CHUNK = orig


def _grads_at_chunk(chunk, cfg, tcfg, params, batch):
    """The reference's ``grads_of``, traced with both packages'
    MLSTM_CHUNK at ``chunk``."""
    with _chunk(chunk):
        return JS.grads_of(cfg, tcfg, params, batch)


#: compiled without LLVM's expensive passes: bitwise the default
#: compile's gradients at every input here, in about 60 % of its compile
#: time
_J_GRADS = jax.jit(_grads_at_chunk, static_argnums=(0, 1, 2),
                   compiler_options={"xla_llvm_disable_expensive_passes":
                                     True})
_J_UPDATE = jax.jit(JO.update, static_argnums=0)
_MODELS = {}
_J_RESULTS = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: the port's loops launch
    many small ops, and in a suite run in parallel processes each op's
    thread team would contend for the cores with the other workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(n_layers=8, dtype="float32"):
    """(JAX config, port config, JAX state, port state) of the reduced
    config at ``n_layers`` and ``dtype``, the port's state carried from the
    reference's. The float32 depth-8 state is the depth-10 one without its
    remainder layers: one draw for both."""
    key = (n_layers, dtype)
    if key not in _MODELS:
        jcfg, tcfg = (dataclasses.replace(m.reduced(m.get(ARCH)),
                                          n_layers=n_layers, dtype=dtype)
                      for m in (JC, TC))
        if key == (8, "float32"):
            deep = _model(10)[2].params
            params = {k: v for k, v in deep.items() if k != "rem"}
            jstate = JS.TrainState(params, JO.init(params))
        else:
            jstate = JS.init_state(jcfg, jax.random.PRNGKey(0))
        tstate = train_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                        tcfg, CPU)
        _MODELS[key] = (jcfg, tcfg, jstate, tstate)
    return _MODELS[key]


def _batch(cfg, shape=SHORT, seed=0):
    rng = np.random.RandomState(seed)
    return {"tokens": rng.randint(0, cfg.vocab_size, shape),
            "labels": rng.randint(0, cfg.vocab_size, shape)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.as_tensor(np.array(v), dtype=torch.int64)
            for k, v in batch.items()}


def _reference_grads(case):
    """The reference's (grads, metrics) at float32 for a gradient case,
    once."""
    if case not in _J_RESULTS:
        n_layers, shape, microbatch, chunk = CASES[case]
        jcfg, tcfg, jstate, _ = _model(n_layers)
        _J_RESULTS[case] = _J_GRADS(
            chunk, jcfg, JS.TrainConfig(microbatch=microbatch),
            jstate.params, _jax(_batch(tcfg, shape)))
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


def _resolved(grads, tol):
    """Per leaf, the coordinates whose gradient a gate of ``tol``
    resolves in every one of ``grads`` (flat trees of one structure)."""
    return {k: np.logical_and.reduce(
        [np.abs(g[k]) > tol * np.linalg.norm(g[k]) for g in grads])
        for k in grads[0]}


def _assert_grads_match(jg, jm, tg, tm, tol):
    want, got = _flat(jg), _flat(tg)
    assert set(got) == set(want)
    for key in want:
        assert _rel(got[key], want[key]) <= tol, key
    for key in ("nll", "z_loss", "n_tokens"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=METRIC_TOL, atol=1e-7)


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
    """The xLSTM tree with its AdamW moments: every parameter equal to the
    reference's in its spec's type (the mLSTM's ``w_if``, ``skip`` and
    ``out_norm``, the sLSTM's ``out_norm`` and every norm float32 in a bf16
    model), the moments float32 zeros of the same keys, the step an int32
    scalar."""
    _, tcfg, jstate, tstate = _model(dtype=dtype)
    want, got = _flat(jstate), _flat(tstate)
    assert set(got) == set(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    types = _dtypes(tstate)
    assert types == _dtypes(jstate)
    mix = {k: t for k, t in types.items()
           if k.startswith("params/units/") and "/mix/" in k}
    m_keys = {k.split("/")[-1] for k in mix if "/b0/" in k}
    s_keys = {k.split("/")[-1] for k in mix if "/b7/" in k}
    assert m_keys == {"w_up", "conv_k", "w_q", "w_k", "w_v", "w_if", "skip",
                      "out_norm", "w_down"}
    assert s_keys == {"w_gates", "r_gates", "out_norm", "ff_gate", "ff_up",
                      "ff_out"}
    assert len(mix) == 7 * 9 + 6
    f32 = {"w_if", "skip", "out_norm"}
    for key, t in mix.items():
        assert t == ("float32" if key.split("/")[-1] in f32 else dtype), key
    assert all(t.dtype == torch.float32 and not t.any() for tree in
               (tstate.opt.m, tstate.opt.v) for t in TO.tree_leaves(tree))
    assert tstate.opt.step.dtype == torch.int32 and int(tstate.opt.step) == 0


# ------------------------------------------------------------ gradients
@pytest.mark.parametrize("case", list(CASES))
def test_grads_of_matches_reference(case):
    """Depth 8 is one m x 7, s unit under remat; at depth 10 two remainder
    mLSTM layers run outside it. Every layer's float32 ``w_if``, ``skip``
    and ``out_norm`` take a finite, non-zero gradient, and microbatches
    accumulate in float32."""
    n_layers, shape, microbatch, chunk = CASES[case]
    _, tcfg, _, tstate = _model(n_layers=n_layers)
    assert tcfg.n_rem_layers == n_layers - 8
    jg, jm = _reference_grads(case)
    with _chunk(chunk):
        tg, tm = TS.grads_of(tcfg, TS.TrainConfig(microbatch=microbatch),
                             tstate.params, _torch(_batch(tcfg, shape)))
    _assert_grads_match(jg, jm, tg, tm, GRAD_TOL[case])
    if microbatch:
        assert all(g.dtype == torch.float32 for g in TO.tree_leaves(tg))
    kept = [g for k, g in _flat(tg).items()
            if k.endswith(("/w_if", "/skip", "/out_norm"))]
    assert len(kept) == 3 * 7 + 1 + 3 * tcfg.n_rem_layers
    assert all(np.isfinite(g).all() and g.any() for g in kept)


def test_remat_on_equals_remat_off_bitwise():
    _, tcfg, _, tstate = _model(n_layers=10)
    batch = _torch(_batch(tcfg))
    on = TS.grads_of(tcfg, TS.TrainConfig(remat=True), tstate.params, batch)
    off = TS.grads_of(tcfg, TS.TrainConfig(remat=False), tstate.params,
                      batch)
    for a, b in zip(TO.tree_leaves(on[0]), TO.tree_leaves(off[0])):
        assert torch.equal(a, b)
    assert set(on[1]) == set(off[1])
    assert all(torch.equal(on[1][k], off[1][k]) for k in on[1])


def test_training_length_not_a_multiple_of_the_chunk_raises():
    """Above one chunk (256) the length must be a multiple of it: nothing
    pads, as the reference asserts."""
    _, tcfg, _, tstate = _model()
    with pytest.raises(ValueError, match="multiple of the chunk 256"):
        TS.grads_of(tcfg, TS.TrainConfig(), tstate.params,
                    _torch(_batch(tcfg, (1, 300))))


def _scan_inputs(s, seed, tied, b=2, h=2, d=16):
    """q, k, v (B, H, S, D) and the log gates (B, H, S) as the block makes
    them: li a pre-activation, lf a log-sigmoid. ``tied``: every li equal
    and lf zero, so the stabiliser's maxima tie, within a chunk (every
    D_jk of a row) and across chunks (the carried m against the chunk's
    own maximum)."""
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, h, s, d).astype(np.float32) for _ in range(3))
    if tied:
        return q, k, v, np.full((b, h, s), 0.5, np.float32), \
            np.zeros((b, h, s), np.float32)
    li = rng.randn(b, h, s).astype(np.float32)
    lf = -np.log1p(np.exp(-(rng.randn(b, h, s) + 1.0))).astype(np.float32)
    return q, k, v, li, lf


def _reference_input_grads(fn, chunk, inputs, upstream):
    """``jax.grad`` of <upstream, fn(inputs)> with respect to every input,
    traced with both packages' MLSTM_CHUNK at ``chunk``."""
    with _chunk(chunk):
        return jax.grad(lambda a: sum(jnp.vdot(u, o) for u, o in zip(
            upstream, jax.tree.leaves(fn(*a)))))(inputs)


#: compiled once a function, chunk and shape (the tied and untied inputs
#: share a compile)
_J_INPUT_GRADS = jax.jit(_reference_input_grads, static_argnums=(0, 1))


def _assert_input_grads_match(tfn, jfn, inputs, upstream, chunk=256):
    """Gradients of <upstream, f(inputs)> with respect to every input,
    port against ``jax.grad`` of the reference, normwise per input."""
    want = _J_INPUT_GRADS(jfn, chunk, tuple(map(jnp.asarray, inputs)),
                          tuple(map(jnp.asarray, upstream)))
    live = [torch.tensor(x, requires_grad=True) for x in inputs]
    with _chunk(chunk):
        outs = jax.tree.leaves(tfn(*live))
    got = torch.autograd.grad(
        sum((torch.as_tensor(u) * o).sum() for u, o in zip(upstream, outs)),
        live)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.float32
        assert np.isfinite(g.numpy()).all(), i
        assert _rel(g.numpy().astype(np.float64),
                    np.asarray(w, np.float64)) <= SCAN_GRAD_TOL, i


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("s,chunk", [(48, 256), (48, 16)])
def test_chunk_scan_gradients_match_the_reference(s, chunk, tied):
    """``_mlstm_chunk_scan``'s gradients for q, k, v and both gates, under
    an upstream gradient on h and on the final (C, n, m), against the
    reference's ``jax.grad`` of its ``lax.scan``: one chunk, and three
    carried through (C, n, m). The tied inputs reach the ``amax`` and
    ``maximum`` ties, whose gradient both packages split evenly."""
    inputs = _scan_inputs(s, seed=s + chunk, tied=tied)
    rng = np.random.RandomState(7)
    b, h, _, d = inputs[0].shape
    upstream = [rng.randn(*shape).astype(np.float32) for shape in
                ((b, h, s, d), (b, h, d, d), (b, h, d), (b, h))]
    _assert_input_grads_match(TX._mlstm_chunk_scan, JX._mlstm_chunk_scan,
                              inputs, upstream, chunk)


def _port_slstm_scan(zx, r_gates):
    return TX._slstm_scan({"r_gates": r_gates}, zx)


def _reference_slstm_scan(zx, r_gates):
    """The reference's sLSTM position loop: ``slstm_apply``'s ``lax.scan``
    of ``_slstm_cell`` from the zero state (m at -1e30), on zx (B, S, 4d)
    -> (h (B, S, d), the last (c, n, m, h))."""
    p = {"r_gates": r_gates}
    b, d = zx.shape[0], zx.shape[2] // 4
    z0 = jnp.zeros((b, d), jnp.float32)
    m0 = jnp.full((b, d), -1e30, jnp.float32)

    def step(state, zx_t):
        new = JX._slstm_cell(p, zx_t, state)
        return new, new[3]
    carry, hs = jax.lax.scan(step, (z0, z0, m0, z0), zx.transpose(1, 0, 2))
    return hs.transpose(1, 0, 2), carry


@pytest.mark.parametrize("s", [1, 48])
def test_slstm_scan_gradients_match_the_reference(s):
    """``_slstm_scan``'s gradients for the input gates zx and ``r_gates``
    (which takes a gradient summed over every position) under an upstream
    gradient on h and on the last state, against the reference's
    ``jax.grad`` of its ``lax.scan``."""
    d = 16
    rng = np.random.RandomState(s)
    zx = rng.randn(2, s, 4 * d).astype(np.float32)
    r = (0.5 * rng.randn(d, 4 * d) / np.sqrt(d)).astype(np.float32)
    upstream = [rng.randn(*shape).astype(np.float32) for shape in
                [(2, s, d)] + [(2, d)] * 4]
    _assert_input_grads_match(_port_slstm_scan, _reference_slstm_scan,
                              (zx, r), upstream)


# ------------------------------------------------------------ train step
def _reference_step():
    """The reference's gradients and its one AdamW step from the depth-8
    state, at the short batch: its train step is ``grads_of`` then
    ``adamw.update``, so the update alone is jitted and the gradients'
    compile is reused."""
    if "step" not in _J_RESULTS:
        _, _, jstate, _ = _model()
        jg, _ = _reference_grads("depth8-s100")
        _J_RESULTS["step"] = JS.TrainState(
            *_J_UPDATE(J_ADAM, jg, jstate.opt, jstate.params))
    return _J_RESULTS["step"]


def test_train_step_matches_reference():
    jcfg, tcfg, jstate, _ = _model()
    jg, jm = _reference_grads("depth8-s100")
    j1 = _reference_step()
    t0 = train_state_from_numpy(jax.tree.map(np.asarray, jstate), tcfg, CPU)
    start = _flat(t0)
    t1, tm = TS.make_train_step(tcfg, T_ADAM, TS.TrainConfig())(
        t0, _torch(_batch(tcfg)))
    got, want = _flat(t1), _flat(j1)
    resolved = _resolved([_flat(jg)], GRAD_TOL["depth8-s100"])
    assert _flip_share(got, want, resolved, ("params",)) == 0
    _assert_update_matches(got, want, start, resolved, ("params",))
    assert int(t1.opt.step) == int(j1.opt.step) == 1
    np.testing.assert_allclose(float(tm["nll"]), float(jm["nll"]),
                               rtol=METRIC_TOL, atol=1e-7)
    for key in ("w_if", "skip", "out_norm"):
        assert t1.params["units"]["b0"]["mix"][key].dtype == torch.float32


# -------------------------------------------------------------- consensus
def _reference_consensus_state(state):
    """A consensus state of the reference's layout (its ``init_state``'s)
    whose pods all hold the train state ``state``: its parameters and
    moments stacked per pod, per-pod step counters at its step, zero
    duals, theta_bar its parameters."""
    def stack(tree):
        return jax.tree.map(
            lambda p: jnp.broadcast_to(p[None], (N_PODS,) + p.shape), tree)
    params = stack(state.params)
    opt = JO.AdamWState(step=jnp.full((N_PODS,), state.opt.step, jnp.int32),
                        m=stack(state.opt.m), v=stack(state.opt.v))
    lam = jax.tree.map(lambda p: jnp.zeros_like(p, dtype=jnp.float32),
                       params)
    return JCT.ConsensusState(params=params, opt=opt, lam=lam,
                              theta_bar=state.params)


def test_diagonal_round_matches_reference():
    """One diagonal round, 2 pods of 2 local steps: the pods restart from
    theta_bar. It starts from the reference's state after one AdamW step
    (``_reference_step``): from zero moments the first local step moves
    each coordinate by about lr * sign(g), and the sign of the ~1e-4 share
    of coordinates whose gradient is at float32 noise (|g| ~ 1e-7) is
    noise. The xLSTM's second gradient follows those moves: 677 of them
    (up to 2 lr) change it by 2.7e-2 normwise, where at equal parameters
    the two packages' second gradients agree within 3.5e-5. So a round
    from a fresh state reads 0.29 of the resolved coordinates more than
    lr / 100 from the reference, and the port against itself between one
    and four intra-op threads 1.2e-3 of them, 1.4e-3 of the update and
    moments 2.7e-3 apart. With one step's moments held, a noise-level
    gradient barely moves its coordinate's moment, and the round reads
    none apart. Held, as phase 15 of ``chip_smoke.py`` holds a round, over
    the coordinates resolved in each of the round's four local gradients
    at its start (the port's: they match the reference's within
    GRAD_TOL): at most FLIPS of them more than lr / 100 apart, all of
    them within STEP_TOL of the update; the moments within
    ROUND_MOMENT_TOL."""
    jcfg, tcfg, _, _ = _model()
    jc = JCT.ConsensusConfig(n_pods=N_PODS, scheme="diagonal",
                             h_steps=H_STEPS)
    tc = TCT.ConsensusConfig(n_pods=N_PODS, scheme="diagonal",
                             h_steps=H_STEPS)
    jstate = _reference_consensus_state(_reference_step())
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
        for i in range(N_PODS) for h in range(H_STEPS)],
        GRAD_TOL["depth8-s100"])
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
    assert t1.opt.step.tolist() == [1 + H_STEPS] * N_PODS
    np.testing.assert_allclose(float(tm["nll"]), float(jm["nll"]),
                               rtol=METRIC_TOL, atol=1e-7)
    pods, bar = TO.tree_leaves(t1.params), TO.tree_leaves(t1.theta_bar)
    assert all(torch.equal(p[i], tb) for p, tb in zip(pods, bar)
               for i in range(N_PODS))


# ------------------------------------------------------------ checkpoints
def test_bf16_state_round_trips_through_a_checkpoint(tmp_path):
    """``save``/``restore`` of the bf16 depth-8 state after a step: every
    leaf bitwise, in its own type (bf16 parameters, float32 ``w_if``,
    ``skip``, ``out_norm``, norms and moments, the int32 step)."""
    _, tcfg, jstate, _ = _model(dtype="bfloat16")
    state = train_state_from_numpy(jax.tree.map(np.asarray, jstate), tcfg,
                                   CPU)
    state, _ = TS.make_train_step(tcfg, T_ADAM, TS.TrainConfig())(
        state, _torch(_batch(tcfg, (2, 32))))
    TK.save(str(tmp_path), 1, state, extra={"arch": ARCH})
    back = TK.restore(str(tmp_path), 1, _zeros_like(state))
    pairs = list(zip(_leaves(back), _leaves(state)))
    assert len(pairs) == len(list(_leaves(state)))
    assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs)
    assert {str(a.dtype) for a, _ in pairs} == {
        "torch.bfloat16", "torch.float32", "torch.int32"}
    for slot, key in (("b0", "w_if"), ("b0", "skip"), ("b7", "out_norm")):
        assert back.params["units"][slot]["mix"][key].dtype == torch.float32
