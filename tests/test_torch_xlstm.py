"""The port's xLSTM blocks (``repro_torch.models.xlstm``: the chunkwise
mLSTM and the sequential sLSTM) and the xlstm-1.3b stack against the JAX
package, on the reduced config (16 layers, two units of seven mLSTM and
one sLSTM; d 256, mLSTM width 512 in 2 heads of 256) at float32, and the
blocks alone at float32 and float64. The JAX package's ``model_init``
parameters are carried across with ``params_from_numpy`` and the same
numpy inputs go into both. Covers the configs, the parameter tree, the
blocks' full-sequence, cache and decode paths, the chunk scan against the
reference's and against the chunk-1 recurrence over one and three chunks,
a length the chunk does not divide, the stack's forward, prefill, decode
continuation and in-place caches at one chunk (s = 80) and two (s = 512),
greedy tokens, and a run with JAX blocked."""
import contextlib
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as JC  # noqa: E402
from repro.models import decoding as JD  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models import xlstm as JX  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import decoding as TD  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models import xlstm as TX  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "xlstm-1.3b"
#: one chunk, then decode steps; two chunks of the reduced config's 256
S, S_LONG, EXTRA = 80, 512, 4
#: the stack, normwise relative per tensor (logits O(1)): float32 sums
#: taken in another order through 16 layers, each a float32 recurrence
#: whose normaliser max(|q.n|, exp(-m)) magnifies rounding at a few
#: positions, so elementwise the logits differ by up to 2.6e-4 already at
#: s = 80. At s = 512 (chunks of 256 and 512 sLSTM steps) the reference's
#: own float32 rounding is 8.7e-5 normwise against the port computing in
#: float64 outside its float32 recurrences (the port's 3.8e-5), and three
#: token draws put the two packages 6.7e-5 to 1.35e-4 apart: the long
#: case holds three times the short one's 1e-4.
STACK_TOL = {S: 1e-4, S_LONG: 3e-4}
#: one block: a few products and a float32 recurrence, sums in another
#: order. Both packages run the recurrences (the mLSTM's chunk scan and
#: decode step, the sLSTM's cell) in float32 whatever the input's type
#: (the reference casts q, k, v, the gates and the carried state to
#: float32), so a float64 input leaves their float32 rounding in place and
#: holds the float32 tolerance; it checks the types around them.
BLOCK_TOL = dict(rtol=1e-5, atol=1e-5)
#: the chunk scan alone, on O(1) inputs
SCAN_TOL = dict(rtol=1e-5, atol=1e-5)

#: the reference's entry points compiled once per shape (eager, each call
#: of their scans compiles anew)
_J_PREFILL = jax.jit(JD.prefill, static_argnums=(0, 3))
_J_DECODE = jax.jit(JT.decode_step, static_argnums=0)
_J_APPLY = {k: jax.jit(f, static_argnums=0, static_argnames="return_cache")
            for k, f in (("m", JX.mlstm_apply), ("s", JX.slstm_apply))}
_J_STEP = {k: jax.jit(f, static_argnums=0)
           for k, f in (("m", JX.mlstm_decode), ("s", JX.slstm_decode))}
_T_BLOCK = {"m": (TX.mlstm_spec, TX.mlstm_apply, TX.mlstm_decode),
            "s": (TX.slstm_spec, TX.slstm_apply, TX.slstm_decode)}

_MODEL = []


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: the port's loops launch
    many small ops, and in a suite run in parallel processes each op's
    thread team would contend for the cores with the other workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model():
    """(JAX config, port config, JAX params, port params), reduced."""
    if not _MODEL:
        jcfg, tcfg = JC.reduced(JC.get(ARCH)), TC.reduced(TC.get(ARCH))
        jparams = JT.model_init(jcfg, jax.random.PRNGKey(0))
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                    "cpu")
        _MODEL.extend((jcfg, tcfg, jparams, tparams))
    return _MODEL


def _tokens(cfg, b, s, seed):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, (b, s))


def _leaves(tree, path=()):
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _leaves(tree[key], path + (key,))
        else:
            yield path + (key,), tree[key]


def _assert_trees_close(got, want, **tol):
    """Every leaf of the port's tree against the reference's, key for key,
    in the reference's type."""
    want = dict(_leaves(jax.tree.map(np.asarray, want)))
    got = dict(_leaves(got))
    assert sorted(got) == sorted(want)
    for path, arr in want.items():
        assert tuple(got[path].shape) == arr.shape, path
        assert str(got[path].dtype) == f"torch.{arr.dtype}", path
        np.testing.assert_allclose(got[path].numpy(), arr, err_msg=str(path),
                                   **tol)


def _assert_normwise(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert err <= tol, f"{what}: normwise {err:.3e} > {tol:.0e}"


def _assert_trees_normwise(got, want, tol):
    """The port's tree against the reference's, key for key and type for
    type, each leaf normwise."""
    want = dict(_leaves(jax.tree.map(np.asarray, want)))
    got = dict(_leaves(got))
    assert sorted(got) == sorted(want)
    for path, arr in want.items():
        assert str(got[path].dtype) == f"torch.{arr.dtype}", path
        _assert_normwise(got[path].numpy(), arr, tol, str(path))


@contextlib.contextmanager
def _jax_dtype(dtype):
    """JAX in 64-bit mode for a float64 case, restored after it."""
    if dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def test_configs_and_reduced_equal_the_reference():
    for make in (lambda m: m.get(ARCH), lambda m: m.reduced(m.get(ARCH))):
        assert dataclasses.asdict(make(TC)) == dataclasses.asdict(make(JC))
    assert TC.get("xlstm_1_3b") == TC.get(ARCH)
    red = TC.reduced(TC.get(ARCH))
    assert (red.n_layers, red.d_model, red.mlstm_heads) == (16, 256, 2)


def test_parameter_tree_equals_the_reference_at_full_size():
    # keys, shapes and the float32 leaves of the uncut config, unmaterialised
    cfg = TC.get(ARCH)
    want = dict(_leaves(JT.abstract_params(JC.get(ARCH))))
    got = dict(_leaves(TT.abstract_params(cfg)))
    assert sorted(got) == sorted(want)
    for path, ps in want.items():
        assert got[path].shape == ps.shape, path
        assert (got[path].dtype == torch.float32) == \
            (ps.dtype == jnp.float32), path
    # the xLSTM blocks hold norm1 and their mix, no norm2 or MLP
    assert sorted(p[2] for p in got if p[:2] == ("units", "b0")) == \
        ["mix"] * 9 + ["norm1"]
    n = sum(int(np.prod(ps.shape)) for ps in got.values())
    assert n == 3_681_949_696


def test_parameters_carry_across_one_to_one():
    jcfg, tcfg, jparams, tparams = _model()
    want = dict(_leaves(jax.tree.map(np.asarray, jparams)))
    got = dict(_leaves(tparams))
    assert sorted(got) == sorted(want)
    for path, arr in want.items():
        assert torch.equal(got[path], torch.as_tensor(np.array(arr))), path
    # in the full config's bf16 the reference's float32 leaves (the norms,
    # the mLSTM's w_if, skip and out_norm, the sLSTM's out_norm) stay
    # float32 and the rest take bf16
    f32 = {path for path, ps in _leaves(JT.abstract_params(jcfg))
           if ps.dtype == jnp.float32}
    assert ("units", "b6", "mix", "w_if") in f32
    assert ("units", "b7", "mix", "out_norm") in f32
    bf16 = dataclasses.replace(tcfg, dtype=TC.get(ARCH).dtype)
    carried = params_from_numpy(jax.tree.map(np.asarray, jparams), bf16,
                                "cpu")
    for path, t in _leaves(carried):
        assert t.dtype == (torch.float32 if path in f32
                           else torch.bfloat16), path


def _block_inputs(kind, dtype):
    """Layer 0 of the reduced model's first ``kind`` slot in ``dtype`` (its
    float32 leaves stay float32, as params_from_numpy keeps them) and the
    numpy inputs of a full sequence and a decode step."""
    jcfg, tcfg, jparams, _ = _model()
    slot = f"b{tcfg.pattern.index(kind)}"
    spec = _T_BLOCK[kind][0](tcfg)
    layer = {k: np.asarray(v[0]).astype(
        dtype if spec[k].dtype is None else "float32")
        for k, v in jparams["units"][slot]["mix"].items()}
    rng = np.random.RandomState(3)
    x = rng.randn(2, S, tcfg.d_model).astype(dtype)
    x1 = rng.randn(2, 1, tcfg.d_model).astype(dtype)
    return jcfg, tcfg, layer, x, x1


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kind", ["m", "s"])
def test_block_matches_the_reference(kind, dtype):
    jcfg, tcfg, layer, x, x1 = _block_inputs(kind, dtype)
    tlayer = {k: torch.tensor(v) for k, v in layer.items()}
    with _jax_dtype(dtype):
        jlayer = {k: jnp.asarray(v) for k, v in layer.items()}
        want, jcache = _J_APPLY[kind](jcfg, jlayer, jnp.asarray(x),
                                      return_cache=True)
        plain = _J_APPLY[kind](jcfg, jlayer, jnp.asarray(x))
        jdec, jcache1 = _J_STEP[kind](jcfg, jlayer, jnp.asarray(x1), jcache,
                                      S)
        want, plain, jcache, jdec, jcache1 = jax.tree.map(
            np.asarray, (want, plain, jcache, jdec, jcache1))
    _, apply, decode = _T_BLOCK[kind]
    got, cache = apply(tcfg, tlayer, torch.as_tensor(x), return_cache=True)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.numpy(), want, **BLOCK_TOL)
    np.testing.assert_allclose(
        apply(tcfg, tlayer, torch.as_tensor(x)).numpy(), plain, **BLOCK_TOL)
    # the states are float32 and the conv history takes the config's type
    _assert_trees_close(cache, jcache, **BLOCK_TOL)
    held = dict(cache)
    dec, cache1 = decode(tcfg, tlayer, torch.as_tensor(x1), cache)
    # in place: the same tensors, holding the reference's new cache
    assert cache1 is cache and all(cache1[k] is v for k, v in held.items())
    assert dec.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(dec.numpy(), jdec, **BLOCK_TOL)
    _assert_trees_close(cache1, jcache1, **BLOCK_TOL)


def _scan_inputs(s, seed, b=2, h=2, d=16):
    """q, k, v (B, H, S, D) and the log gates (B, H, S) as the block makes
    them: li a pre-activation, lf a log-sigmoid."""
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, h, s, d).astype(np.float32) for _ in range(3))
    li = rng.randn(b, h, s).astype(np.float32)
    lf = -np.log1p(np.exp(-(rng.randn(b, h, s) + 1.0))).astype(np.float32)
    return q, k, v, li, lf


@contextlib.contextmanager
def _chunk(size):
    """Both packages' MLSTM_CHUNK set to ``size`` for the block."""
    orig = JX.MLSTM_CHUNK, TX.MLSTM_CHUNK
    JX.MLSTM_CHUNK = TX.MLSTM_CHUNK = size
    try:
        yield
    finally:
        JX.MLSTM_CHUNK, TX.MLSTM_CHUNK = orig


@pytest.mark.parametrize("s,chunk", [(17, 256), (64, 64), (48, 16),
                                     (96, 32)])
def test_chunk_scan_matches_the_reference_and_the_recurrence(s, chunk):
    # one chunk (the default chunk over a shorter sequence, or equal to
    # it) and three chunks carried through (C, n, m)
    inputs = _scan_inputs(s, seed=s)
    with _chunk(chunk):
        want, jstate = JX._mlstm_chunk_scan(*map(jnp.asarray, inputs))
        got, state = TX._mlstm_chunk_scan(*map(torch.as_tensor, inputs))
    with _chunk(1):
        step, step_state = TX._mlstm_chunk_scan(*map(torch.as_tensor,
                                                     inputs))
    assert got.dtype == torch.float32 and got.shape == (2, 2, s, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN_TOL)
    for a, b, c in zip(state, jstate, step_state):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **SCAN_TOL)
        np.testing.assert_allclose(a.numpy(), c.numpy(), **SCAN_TOL)
    np.testing.assert_allclose(got.numpy(), step.numpy(), **SCAN_TOL)


def test_chunk_scan_equals_the_decode_recurrence():
    # the block over a sequence against its decode step run position by
    # position from a zero cache (the stabiliser m starts at -1e30 there
    # too), over two chunks of 16
    jcfg, tcfg, layer, x, _ = _block_inputs("m", "float32")
    p = {k: torch.tensor(v) for k, v in layer.items()}
    x = torch.as_tensor(x[:, :32])
    with _chunk(16):
        want, cache = TX.mlstm_apply(tcfg, p, x, return_cache=True)
    step = {k: torch.zeros(s.shape, dtype=s.dtype) for k, s in
            TX.mlstm_cache_spec(tcfg, 2).items()}
    step["m"].fill_(-1e30)
    got = torch.cat([TX.mlstm_decode(tcfg, p, x[:, t:t + 1], step)[0]
                     for t in range(x.shape[1])], dim=1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **BLOCK_TOL)
    for k in cache:
        np.testing.assert_allclose(step[k].numpy(), cache[k].numpy(),
                                   **BLOCK_TOL)


def test_length_not_a_multiple_of_the_chunk_raises():
    inputs = _scan_inputs(40, seed=0)
    with _chunk(16):
        with pytest.raises(AssertionError):
            JX._mlstm_chunk_scan(*map(jnp.asarray, inputs))
        with pytest.raises(ValueError, match="multiple of the chunk 16"):
            TX._mlstm_chunk_scan(*map(torch.as_tensor, inputs))
    _, tcfg, _, tparams = _model()
    with pytest.raises(ValueError, match="multiple"):
        TT.forward(tcfg, tparams, torch.as_tensor(_tokens(tcfg, 1, 257, 0)))


_SERVED = {}


def _reference_serve(tok, s, extra):
    """The reference's prefill of ``tok[:, :s]`` (its logits are its
    forward's) and ``extra`` teacher-forced decode steps (numpy): prefill
    logits, its cache, each step's logits and the final cache."""
    key = (tok.tobytes(), s, extra)
    if key not in _SERVED:
        jcfg, _, jparams, _ = _model()
        jtok = jnp.asarray(tok, jnp.int32)
        jlog, jcache = _J_PREFILL(jcfg, jparams, jtok[:, :s], s + extra)
        pre = jax.tree.map(np.asarray, (jlog, jcache))
        steps = []
        for t in range(extra):
            jlg, jcache = _J_DECODE(jcfg, jparams, jcache,
                                    jtok[:, s + t:s + t + 1], s + t)
            steps.append(np.asarray(jlg))
        _SERVED[key] = (*pre, steps, jax.tree.map(np.asarray, jcache))
    return _SERVED[key]


@pytest.mark.parametrize("s", [S, S_LONG])
def test_forward_and_prefill_match_the_reference(s):
    _, tcfg, _, tparams = _model()
    tok = _tokens(tcfg, 2, s + EXTRA, seed=2)
    jlog, jcache, _, _ = _reference_serve(tok, s, EXTRA)
    ttok = torch.as_tensor(tok[:, :s])
    logits, aux = TT.forward(tcfg, tparams, ttok)
    _assert_normwise(logits.numpy(), jlog, STACK_TOL[s], "forward")
    assert float(aux) == 0.0
    tlog, tcache = TD.prefill(tcfg, tparams, ttok, s + EXTRA)
    _assert_normwise(tlog.numpy(), jlog, STACK_TOL[s], "prefill")
    _assert_trees_normwise(tcache, jcache, STACK_TOL[s])
    m, sl = tcache["units"]["b0"], tcache["units"]["b7"]
    assert m["C"].shape == (tcfg.n_units, 2, 2, 256, 256)
    assert sl["h"].shape == (tcfg.n_units, 2, tcfg.d_model)


@pytest.mark.parametrize("s", [S, S_LONG])
def test_decode_continues_the_prefill_in_place(s):
    # teacher-forced decode against the reference's decode steps and, at
    # s = 80, against the port's own forward over s + 4 tokens (516 is not
    # a multiple of the chunk, so the long case has no such forward); the
    # cache after it is the tensors the prefill returned, holding the
    # reference's final cache
    _, tcfg, _, tparams = _model()
    tok = _tokens(tcfg, 2, s + EXTRA, seed=2)
    _, _, jsteps, jfinal = _reference_serve(tok, s, EXTRA)
    ttok = torch.as_tensor(tok)
    full = TT.forward(tcfg, tparams, ttok)[0] if s == S else None
    _, tcache = TD.prefill(tcfg, tparams, ttok[:, :s], s + EXTRA)
    held = dict(_leaves(tcache))
    for t in range(EXTRA):
        tlg, out = TT.decode_step(tcfg, tparams, tcache,
                                  ttok[:, s + t:s + t + 1], s + t)
        assert out is tcache
        _assert_normwise(tlg.numpy(), jsteps[t], STACK_TOL[s], f"step {t}")
        if full is not None:
            _assert_normwise(tlg[:, 0].numpy(), full[:, s + t].numpy(),
                             STACK_TOL[s], f"step {t} against the forward")
    assert all(v is held[k] for k, v in _leaves(tcache))
    _assert_trees_normwise(tcache, jfinal, STACK_TOL[s])


def test_greedy_generation_gives_the_reference_tokens():
    # the reference's generate is its prefill, an argmax, and decode steps
    # with an argmax each; run here through the compiled prefill and step
    jcfg, tcfg, jparams, tparams = _model()
    prompt = _tokens(tcfg, 2, S, seed=3)
    jtok = jnp.asarray(prompt, jnp.int32)
    logits, cache = _J_PREFILL(jcfg, jparams, jtok, S + EXTRA)
    want = [jnp.argmax(logits[:, -1, :jcfg.vocab_size], -1)[:, None]]
    for t in range(EXTRA - 1):
        logits, cache = _J_DECODE(jcfg, jparams, cache,
                                  want[-1].astype(jnp.int32), S + t)
        want.append(jnp.argmax(logits[:, -1, :jcfg.vocab_size], -1)[:, None])
    got = TD.generate(tcfg, tparams, torch.as_tensor(prompt), EXTRA)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jnp.concatenate(want, 1)))


def test_reduced_xlstm_runs_without_jax_or_reference():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import torch
        import repro_torch
        import repro_torch.configs as C
        from repro_torch.models import decoding as D, transformer as T
        cfg = C.reduced(C.get("xlstm-1.3b"))
        gen = torch.Generator()
        gen.manual_seed(0)
        params = T.model_init(cfg, gen, "cpu")
        tok = torch.randint(0, cfg.vocab_size, (2, 40), generator=gen)
        logits, aux = T.forward(cfg, params, tok)
        assert logits.shape == (2, 40, cfg.padded_vocab)
        assert bool(torch.isfinite(logits).all())
        assert D.generate(cfg, params, tok, 3).shape == (2, 3)
        loaded = [m for m in sys.modules if m.startswith(("jax.", "repro."))]
        assert not loaded, loaded
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
