"""The port's whisper-tiny (``repro_torch.models``: the encoder over frame
embeddings, non-causal cross-attention, learned positions and the
``"xattn"`` decoder block) against the JAX package, on the reduced config
(2 encoder and 2 decoder layers, d 256 in 4 heads of 64, 16 frames, vocab
1024) at float32, and the encoder and cross-attention alone at float32
and float64. The JAX package's ``model_init`` parameters are carried
across with ``params_from_numpy`` and the same numpy frames and tokens go
into both. Covers the configs, the parameter tree, the encoder,
cross-attention with fewer queries than frames, the block's full-sequence
and decode paths, the forward with all and with fewer frames, prefill and
decode continuation, greedy tokens, a decode step past the learned
position table, the refusals, and a run with JAX blocked."""
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
from repro.models import attention as JA  # noqa: E402
from repro.models import decoding as JD  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import decoding as TD  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "whisper-tiny"
#: batch, prompt, teacher-forced steps after it
B, S, EXTRA = 2, 12, 4
#: the stack's logits, normwise (the port reads about 8e-7): float32 sums
#: in another order through 2 + 2 layers
STACK_TOL = 1e-4
#: one module (the encoder, cross-attention, a block) elementwise. Both
#: packages take the attention scores' softmax and the layer norms in
#: float32 whatever the input's type (the reference casts scores and norm
#: inputs to float32), so a float64 input keeps that float32 rounding (the
#: port reads 8.5e-8 from the reference on float64 cross-attention) and
#: holds the float32 tolerance; it checks the types around them
TOL = dict(rtol=1e-5, atol=1e-5)

#: the reference's entry points, compiled once per shape with the config
#: static (eager, each call of their scans compiles anew)
_J_PREFILL = jax.jit(JD.prefill, static_argnums=(0, 3))
_J_DECODE = jax.jit(JT.decode_step, static_argnums=0,
                    static_argnames="window_override")
_J_ENCODE = jax.jit(JT.encode, static_argnums=0)
_J_CROSS = jax.jit(JA.cross_apply, static_argnums=0)
_J_BLOCK = jax.jit(JT._block_apply, static_argnums=(0, 1),
                   static_argnames=("return_cache", "cache_len"))
_J_BLOCK_DECODE = jax.jit(JT._block_decode, static_argnums=(0, 1))

_MODEL = []


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: the reduced model's ops
    are small, and in a suite run in parallel processes each op's thread
    team would contend for the cores with the other workers'."""
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


def _frames(cfg, b, n, seed, dtype="float32"):
    return np.random.RandomState(seed).randn(b, n, cfg.d_model).astype(dtype)


def _leaves(tree, path=()):
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _leaves(tree[key], path + (key,))
        else:
            yield path + (key,), tree[key]


def _assert_normwise(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert err <= tol, f"{what}: normwise {err:.3e} > {tol:.0e}"


def _assert_trees_close(got, want, **tol):
    """Every leaf of the port's tree against the reference's, key for key,
    in the reference's type."""
    want = dict(_leaves(jax.tree.map(np.asarray, want)))
    got = dict(_leaves(got))
    assert sorted(got) == sorted(want)
    for path, arr in want.items():
        assert str(got[path].dtype) == f"torch.{arr.dtype}", path
        np.testing.assert_allclose(got[path].numpy(), arr, err_msg=str(path),
                                   **tol)


@contextlib.contextmanager
def _jax_dtype(dtype):
    """JAX in 64-bit mode for a float64 case, restored after it."""
    if dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _subtree(tree, dtype):
    """A numpy subtree of the reference's parameters in ``dtype``, as
    (JAX, torch) trees."""
    arrs = jax.tree.map(lambda a: np.asarray(a).astype(dtype), tree)
    return (jax.tree.map(jnp.asarray, arrs),
            jax.tree.map(torch.as_tensor, arrs))


def test_configs_and_reduced_equal_the_reference():
    for make in (lambda m: m.get(ARCH), lambda m: m.reduced(m.get(ARCH))):
        assert dataclasses.asdict(make(TC)) == dataclasses.asdict(make(JC))
    assert TC.get("whisper_tiny") == TC.get(ARCH)
    # every architecture of the reference is got now; unknown names raise
    assert all(TC.get(a).arch_id == JC.get(a).arch_id for a in TC.ARCH_IDS)
    with pytest.raises(ValueError, match="unknown architecture"):
        TC.get("whisper-large")
    red = TC.reduced(TC.get(ARCH))
    assert (red.n_layers, red.n_enc_layers, red.n_frames, red.hd) == \
        (2, 2, 16, 64)


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
    # the decoder's table has the reference's 4096 rows, the encoder's one
    # a frame; the xattn block holds three norms and two attentions
    assert got[("pos_table",)].shape == (4096, 384)
    assert got[("encoder", "pos_table")].shape == (1500, 384)
    assert got[("encoder", "layers", "attn", "wq")].shape == (4, 384, 384)
    assert sorted({p[2] for p in got if p[:2] == ("units", "b0")}) == \
        ["attn", "cross", "mlp", "norm1", "norm2", "norm3"]
    n = sum(int(np.prod(ps.shape)) for ps in got.values())
    assert n == 58_592_256


def test_parameters_carry_across_one_to_one():
    jcfg, tcfg, jparams, tparams = _model()
    want = dict(_leaves(jax.tree.map(np.asarray, jparams)))
    got = dict(_leaves(tparams))
    assert sorted(got) == sorted(want)
    assert ("encoder", "layers", "mlp", "w_in") in got
    assert ("encoder", "final_norm", "bias") in got
    for path, arr in want.items():
        assert torch.equal(got[path], torch.as_tensor(np.array(arr))), path
    bad = jax.tree.map(np.asarray, jparams)
    bad["encoder"]["pos_table"] = bad["encoder"]["pos_table"][:8]
    with pytest.raises(ValueError, match="encoder/pos_table"):
        params_from_numpy(bad, tcfg, "cpu")
    del bad["pos_table"]
    with pytest.raises(ValueError, match="keys"):
        params_from_numpy(bad, tcfg, "cpu")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_encode_matches_the_reference(dtype):
    jcfg, tcfg, jparams, _ = _model()
    frames = _frames(tcfg, B, tcfg.n_frames, seed=1, dtype=dtype)
    with _jax_dtype(dtype):
        jenc, tenc = _subtree(jparams["encoder"], dtype)
        want = np.asarray(_J_ENCODE(jcfg, {"encoder": jenc},
                                    jnp.asarray(frames)))
    got = TT.encode(tcfg, {"encoder": tenc}, torch.as_tensor(frames))
    assert got.dtype == getattr(torch, dtype) and want.dtype == dtype
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cross_apply_matches_the_reference(dtype):
    # five decoder queries on sixteen frames, every query on every frame
    jcfg, tcfg, jparams, _ = _model()
    layer = jax.tree.map(lambda a: a[0], jparams["units"]["b0"]["cross"])
    rng = np.random.RandomState(2)
    x = rng.randn(B, 5, tcfg.d_model).astype(dtype)
    enc = rng.randn(B, tcfg.n_frames, tcfg.d_model).astype(dtype)
    with _jax_dtype(dtype):
        jlayer, tlayer = _subtree(layer, dtype)
        want = np.asarray(_J_CROSS(jcfg, jlayer, jnp.asarray(x),
                                   jnp.asarray(enc)))
    got = TA.cross_apply(tcfg, tlayer, torch.as_tensor(x),
                         torch.as_tensor(enc))
    assert got.dtype == getattr(torch, dtype) and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # non-causal: the last frame moves the first query's output
    moved = enc.copy()
    moved[:, -1] += 1.0
    again = TA.cross_apply(tcfg, tlayer, torch.as_tensor(x),
                           torch.as_tensor(moved))
    assert not torch.allclose(again[:, 0], got[:, 0])


def test_non_causal_sdpa_is_unmasked_and_takes_no_window():
    q = torch.randn(1, 3, 2, 64)
    k = v = torch.randn(1, 7, 2, 64)
    out = TA.sdpa(q, k, v, causal=False)
    want = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) / 8.0, -1)
    torch.testing.assert_close(out, torch.einsum("bhqk,bkhd->bqhd", want, v))
    for kw in ({"window": 4}, {"force_blocked": True}):
        with pytest.raises(ValueError, match="no window"):
            TA.sdpa(q, k, v, causal=False, **kw)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_xattn_block_matches_the_reference(dtype):
    # the full sequence with its cache, then one decode step from it
    jcfg, tcfg, jparams, _ = _model()
    layer = jax.tree.map(lambda a: a[0], jparams["units"]["b0"])
    rng = np.random.RandomState(3)
    x = rng.randn(B, S, tcfg.d_model).astype(dtype)
    x1 = rng.randn(B, 1, tcfg.d_model).astype(dtype)
    enc = rng.randn(B, tcfg.n_frames, tcfg.d_model).astype(dtype)
    with _jax_dtype(dtype):
        jlayer, tlayer = _subtree(layer, dtype)
        want, _, jcache = _J_BLOCK(jcfg, "xattn", jlayer, jnp.asarray(x),
                                   jnp.arange(S), jnp.asarray(enc),
                                   return_cache=True, cache_len=S + 1)
        jdec, jcache1 = _J_BLOCK_DECODE(jcfg, "xattn", jlayer,
                                        jnp.asarray(x1), jcache, S,
                                        jnp.asarray(enc))
        want, jcache, jdec, jcache1 = jax.tree.map(
            np.asarray, (want, jcache, jdec, jcache1))
    got, aux, cache = TT._block_apply(
        tcfg, "xattn", tlayer, torch.as_tensor(x), torch.arange(S),
        window=0, return_cache=True, cache_len=S + 1,
        enc_out=torch.as_tensor(enc))
    assert got.dtype == getattr(torch, dtype) and aux == 0.0
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    _assert_trees_close(cache, jcache, **TOL)
    dec = TT._block_decode(tcfg, "xattn", tlayer, torch.as_tensor(x1), cache,
                           S, window=0, enc_out=torch.as_tensor(enc))
    np.testing.assert_allclose(dec.numpy(), jdec, **TOL)
    _assert_trees_close(cache, jcache1, **TOL)


_SERVED = {}


def _reference_serve(tok, frames, s, extra):
    """The reference's prefill of ``tok[:, :s]`` over ``frames`` (its logits
    are its forward's) and ``extra`` teacher-forced decode steps attending
    to its encoding of them (numpy): prefill logits, its cache, each step's
    logits and the final cache."""
    key = (tok.tobytes(), frames.tobytes(), s, extra)
    if key not in _SERVED:
        jcfg, _, jparams, _ = _model()
        jtok, jfr = jnp.asarray(tok, jnp.int32), jnp.asarray(frames)
        jlog, jcache = _J_PREFILL(jcfg, jparams, jtok[:, :s], s + extra,
                                  enc_frames=jfr)
        pre = jax.tree.map(np.asarray, (jlog, jcache))
        enc = _J_ENCODE(jcfg, jparams, jfr)
        steps = []
        for t in range(extra):
            jlg, jcache = _J_DECODE(jcfg, jparams, jcache,
                                    jtok[:, s + t:s + t + 1], s + t,
                                    enc_out=enc)
            steps.append(np.asarray(jlg))
        _SERVED[key] = (*pre, steps, jax.tree.map(np.asarray, jcache))
    return _SERVED[key]


@pytest.mark.parametrize("n_frames", [16, 10])
def test_forward_and_prefill_match_the_reference(n_frames):
    # all the config's frames, and fewer (the encoder's table is sliced)
    _, tcfg, _, tparams = _model()
    tok = _tokens(tcfg, B, S + EXTRA, seed=4)
    frames = _frames(tcfg, B, n_frames, seed=5)
    jlog, jcache, _, _ = _reference_serve(tok, frames, S, EXTRA)
    ttok, tfr = torch.as_tensor(tok[:, :S]), torch.as_tensor(frames)
    logits, aux = TT.forward(tcfg, tparams, ttok, enc_frames=tfr)
    _assert_normwise(logits.numpy(), jlog, STACK_TOL, "forward")
    assert float(aux) == 0.0
    tlog, tcache = TD.prefill(tcfg, tparams, ttok, S + EXTRA,
                              enc_frames=tfr)
    _assert_normwise(tlog.numpy(), jlog, STACK_TOL, "prefill")
    want = dict(_leaves(jcache))
    got = dict(_leaves(tcache))
    assert sorted(got) == sorted(want)
    for path, arr in want.items():
        _assert_normwise(got[path].numpy(), arr, STACK_TOL, str(path))
    # the self-attention cache is the GQA cache: all heads, no cross K/V
    assert tcache["units"]["b0"]["k"].shape == (tcfg.n_units, B, S + EXTRA,
                                                tcfg.n_kv_heads, tcfg.hd)


def test_decode_continues_the_prefill_in_place():
    # teacher-forced decode against the reference's decode steps and the
    # port's own forward over S + EXTRA tokens
    _, tcfg, _, tparams = _model()
    tok = _tokens(tcfg, B, S + EXTRA, seed=4)
    frames = _frames(tcfg, B, tcfg.n_frames, seed=5)
    _, _, jsteps, jfinal = _reference_serve(tok, frames, S, EXTRA)
    ttok, tfr = torch.as_tensor(tok), torch.as_tensor(frames)
    full = TT.forward(tcfg, tparams, ttok, enc_frames=tfr)[0]
    _, tcache = TD.prefill(tcfg, tparams, ttok[:, :S], S + EXTRA,
                           enc_frames=tfr)
    enc = TT.encode(tcfg, tparams, tfr)
    held = dict(_leaves(tcache))
    for t in range(EXTRA):
        tlg, out = TT.decode_step(tcfg, tparams, tcache,
                                  ttok[:, S + t:S + t + 1], S + t,
                                  enc_out=enc)
        assert out is tcache
        _assert_normwise(tlg.numpy(), jsteps[t], STACK_TOL, f"step {t}")
        _assert_normwise(tlg[:, 0].numpy(), full[:, S + t].numpy(),
                         STACK_TOL, f"step {t} against the forward")
    assert all(v is held[k] for k, v in _leaves(tcache))
    for path, arr in _leaves(jfinal):
        _assert_normwise(held[path].numpy(), arr, STACK_TOL, str(path))


def test_greedy_generation_gives_the_reference_tokens():
    # the reference's generate is its prefill, an argmax, and decode steps
    # on one encoding with an argmax each; run here through the compiled
    # prefill, encoder and step, from a 4-token prompt
    jcfg, tcfg, jparams, tparams = _model()
    prompt = _tokens(tcfg, B, 4, seed=6)
    frames = _frames(tcfg, B, tcfg.n_frames, seed=7)
    jfr = jnp.asarray(frames)
    logits, cache = _J_PREFILL(jcfg, jparams, jnp.asarray(prompt, jnp.int32),
                               4 + EXTRA, enc_frames=jfr)
    enc = _J_ENCODE(jcfg, jparams, jfr)
    want = [jnp.argmax(logits[:, -1, :jcfg.vocab_size], -1)[:, None]]
    for t in range(EXTRA - 1):
        logits, cache = _J_DECODE(jcfg, jparams, cache,
                                  want[-1].astype(jnp.int32), 4 + t,
                                  enc_out=enc)
        want.append(jnp.argmax(logits[:, -1, :jcfg.vocab_size], -1)[:, None])
    got = TD.generate(tcfg, tparams, torch.as_tensor(prompt), EXTRA,
                      enc_frames=torch.as_tensor(frames))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jnp.concatenate(want, 1)))


def test_decode_past_the_position_table_wraps():
    # one step at position 4100 (row 4100 % 4096 = 4 of the learned table)
    # with an 8-slot window cache, the same random cache in both packages
    jcfg, tcfg, jparams, tparams = _model()
    spec = TT.init_cache(tcfg, B, 16, window_override=8)
    rng = np.random.RandomState(8)
    cache = {"units": {"b0": {k: rng.randn(*s.shape).astype(np.float32)
                              for k, s in spec["units"]["b0"].items()}}}
    assert cache["units"]["b0"]["k"].shape[2] == 8
    enc = rng.randn(B, tcfg.n_frames, tcfg.d_model).astype(np.float32)
    tok = _tokens(tcfg, B, 1, seed=9)
    jlg, jcache = _J_DECODE(jcfg, jparams,
                            jax.tree.map(jnp.asarray, cache),
                            jnp.asarray(tok, jnp.int32), 4100,
                            enc_out=jnp.asarray(enc), window_override=8)
    tcache = jax.tree.map(torch.tensor, cache)
    tlg, _ = TT.decode_step(tcfg, tparams, tcache, torch.as_tensor(tok), 4100,
                            enc_out=torch.as_tensor(enc), window_override=8)
    _assert_normwise(tlg.numpy(), np.asarray(jlg), STACK_TOL, "logits")
    _assert_trees_close(tcache, jcache, **TOL)


def test_encoder_decoder_inputs_are_required():
    _, tcfg, _, tparams = _model()
    tok = torch.as_tensor(_tokens(tcfg, 1, 4, seed=0))
    with pytest.raises(ValueError, match="enc_frames"):
        TT.forward(tcfg, tparams, tok)
    cache = TT.materialize_cache(tcfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="enc_out"):
        TT.decode_step(tcfg, tparams, cache, tok[:, :1], 0)


def test_reduced_whisper_runs_without_jax_or_reference():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import torch
        import repro_torch
        import repro_torch.configs as C
        from repro_torch.models import decoding as D, transformer as T
        cfg = C.reduced(C.get("whisper-tiny"))
        gen = torch.Generator()
        gen.manual_seed(0)
        params = T.model_init(cfg, gen, "cpu")
        frames = torch.randn((2, cfg.n_frames, cfg.d_model), generator=gen)
        tok = torch.randint(0, cfg.vocab_size, (2, 12), generator=gen)
        logits, aux = T.forward(cfg, params, tok, enc_frames=frames)
        assert logits.shape == (2, 12, cfg.padded_vocab)
        assert bool(torch.isfinite(logits).all())
        out = D.generate(cfg, params, tok[:, :4], 3, enc_frames=frames)
        assert out.shape == (2, 3)
        loaded = [m for m in sys.modules if m.startswith(("jax.", "repro."))]
        assert not loaded, loaded
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
