"""The port's RG-LRU block (``repro_torch.models.ssm``) and the hybrid
recurrentgemma-2b stack against the JAX package, on the reduced config
(6 layers rec/rec/attn, d 256, 4/1 heads of width 64, window 64) at
float32, and the block alone at float64. The JAX package's ``model_init``
parameters are carried across with ``params_from_numpy`` and the same
numpy inputs go into both. Covers the block's full-sequence and decode
paths, the doubling scan against a sequential loop, prefill shorter than
the conv history, prefill past the attention window with decode wrapping
the ring buffer, a depth with remainder ``rec`` layers, the cache after
in-place decode, greedy tokens, and a run with JAX blocked."""
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
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import decoding as TD  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "recurrentgemma-2b"
# the stack, as tests/test_torch_archs.py: float32 sums taken in another
# order through the layers and the vocab projection, logits O(1)
TOL = dict(rtol=1e-4, atol=1e-4)
#: one RG-LRU block: a few products and a scan, float32 sums in another
#: order; at float64 the same arithmetic to rounding
BLOCK_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
             "float64": dict(rtol=1e-10, atol=1e-10)}
#: prompt past the reduced window (64), then decode steps
S, EXTRA = 80, 4

#: the reference's entry points compiled once per shape (eager, each call
#: of their unit scans compiles anew)
_J_FORWARD = jax.jit(JT.forward, static_argnums=0, static_argnames="remat")
_J_PREFILL = jax.jit(JD.prefill, static_argnums=(0, 3))
_J_DECODE = jax.jit(JT.decode_step, static_argnums=0)
_J_APPLY = jax.jit(JS.rglru_apply, static_argnums=0,
                   static_argnames="return_cache")
_J_STEP = jax.jit(JS.rglru_decode, static_argnums=0)

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: the port's loops launch
    many small ops, and in a suite run in parallel processes each op's
    thread team would contend for the cores with the other workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_MODELS = {}


def _model(n_layers=None):
    """(JAX config, port config, JAX params, port params) of the reduced
    config, or of it at depth 8 (``n_layers=8``): two rec/rec/attn units
    and two remainder rec layers. Both share one draw: the reduced model's
    parameters are the deep one's without its remainder layers."""
    if not _MODELS:
        jcfg, tcfg = JC.reduced(JC.get(ARCH)), TC.reduced(TC.get(ARCH))
        deep = [dataclasses.replace(c, n_layers=8) for c in (jcfg, tcfg)]
        jparams = JT.model_init(deep[0], jax.random.PRNGKey(0))
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                    deep[1], "cpu")
        _MODELS[8] = (*deep, jparams, tparams)
        _MODELS[None] = (jcfg, tcfg,
                         {k: v for k, v in jparams.items() if k != "rem"},
                         {k: v for k, v in tparams.items() if k != "rem"})
    return _MODELS[n_layers]


def _tokens(cfg, b, s, seed):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, (b, s))


def _leaves(tree, path=()):
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _leaves(tree[key], path + (key,))
        else:
            yield path + (key,), tree[key]


def _assert_trees_close(got, want, **tol):
    """Every leaf of the port's tree against the reference's, key for key."""
    want = dict(_leaves(jax.tree.map(np.asarray, want)))
    got = dict(_leaves(got))
    assert sorted(got) == sorted(want)
    for path, arr in want.items():
        assert tuple(got[path].shape) == arr.shape, path
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


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_rglru_block_matches_the_reference(dtype):
    jcfg, tcfg, jparams, _ = _model()
    layer = {k: np.asarray(v[0]).astype(dtype) for k, v in
             jparams["units"]["b0"]["rec"].items()}
    rng = np.random.RandomState(3)
    x = rng.randn(2, S, tcfg.d_model).astype(dtype)
    x1 = rng.randn(2, 1, tcfg.d_model).astype(dtype)
    tlayer = {k: torch.tensor(v) for k, v in layer.items()}
    with _jax_dtype(dtype):
        jlayer = {k: jnp.asarray(v) for k, v in layer.items()}
        want, jcache = _J_APPLY(jcfg, jlayer, jnp.asarray(x),
                                return_cache=True)
        jdec, jcache1 = _J_STEP(jcfg, jlayer, jnp.asarray(x1), jcache, S)
        want, jcache, jdec, jcache1 = jax.tree.map(
            np.asarray, (want, jcache, jdec, jcache1))
    got, cache = TS.rglru_apply(tcfg, tlayer, torch.as_tensor(x),
                                return_cache=True)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.numpy(), want, **BLOCK_TOL[dtype])
    _assert_trees_close(cache, jcache, **BLOCK_TOL[dtype])
    # the conv history takes the config's type (float32), h the scan's
    assert cache["conv"].dtype == torch.float32
    h, conv = cache["h"], cache["conv"]
    dec, cache1 = TS.rglru_decode(tcfg, tlayer, torch.as_tensor(x1), cache)
    # in place: the same tensors, holding the reference's new cache
    assert cache1["h"] is h and cache1["conv"] is conv
    np.testing.assert_allclose(dec.numpy(), jdec, **BLOCK_TOL[dtype])
    _assert_trees_close(cache1, jcache1, **BLOCK_TOL[dtype])


def _sequential_scan(a, b):
    """The plain oracle: h_t = a_t h_{t-1} + b_t, one position at a time."""
    h = torch.zeros_like(b[:, 0])
    out = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out.append(h)
    return torch.stack(out, 1)


@pytest.mark.parametrize("s", [1, 2, 37, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_doubling_scan_matches_the_sequential_loop(dtype, s):
    # decays as the block makes them: exp(-8 softplus(1) r), r in (0, 1),
    # down to about 3e-5 a step, so a running product from position 0
    # would underflow float32 within tens of steps
    rng = np.random.RandomState(s)
    r = rng.rand(2, s, 64)
    a = torch.tensor(np.exp(-8.0 * np.log1p(np.e) * r), dtype=dtype)
    b = torch.tensor(rng.randn(2, s, 64), dtype=dtype)
    got = TS.linear_scan(a, b)
    want = _sequential_scan(a, b)
    assert got.dtype == dtype and got.shape == b.shape
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=tol, atol=tol)


_SERVED = {}


def _reference_serve(n_layers, tok, s, extra):
    """The reference's prefill of ``tok[:, :s]`` and ``extra``
    teacher-forced decode steps (numpy): prefill logits, its cache, each
    step's logits and the final cache. Kept per case: tests share it."""
    key = (n_layers, tok.tobytes(), s, extra)
    if key not in _SERVED:
        jcfg, _, jparams, _ = _model(n_layers)
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


def _serve_both(n_layers, tok, s, extra):
    """Prefill of ``tok[:, :s]`` then ``extra`` teacher-forced decode steps
    in the port, each checked against the reference and the port's full
    forward; returns the port's cache after them (updated in place)."""
    _, tcfg, _, tparams = _model(n_layers)
    jlog, jcache, jsteps, _ = _reference_serve(n_layers, tok, s, extra)
    ttok = torch.as_tensor(tok)
    full, _ = TT.forward(tcfg, tparams, ttok)
    tlog, tcache = TD.prefill(tcfg, tparams, ttok[:, :s], s + extra)
    np.testing.assert_allclose(tlog.numpy(), jlog, **TOL)
    np.testing.assert_allclose(tlog.numpy(), full[:, :s].numpy(), **TOL)
    _assert_trees_close(tcache, jcache, **TOL)
    for t in range(extra):
        tlg, tcache = TT.decode_step(tcfg, tparams, tcache,
                                     ttok[:, s + t:s + t + 1], s + t)
        np.testing.assert_allclose(tlg.numpy(), jsteps[t], **TOL)
        np.testing.assert_allclose(tlg[:, 0].numpy(), full[:, s + t].numpy(),
                                   **TOL)
    return tcache


def test_prefill_shorter_than_the_conv_history_pads_it():
    _, tcfg, _, tparams = _model()
    tok = _tokens(tcfg, 2, 4, seed=5)
    tcache = _serve_both(None, tok, 2, 2)
    # after two prompt tokens and two decode steps the history has shifted
    # the left pad out; straight after the prefill it held one zero row
    _, pre = TD.prefill(tcfg, tparams, torch.as_tensor(tok[:, :2]), 4)
    conv = pre["units"]["b0"]["conv"]
    assert conv.shape == (tcfg.n_units, 2, tcfg.conv_width - 1,
                          tcfg.rglru_width)
    assert not conv[:, :, 0].any() and conv[:, :, 1:].abs().min() > 0
    assert tcache["units"]["b0"]["conv"].abs().min() > 0


def test_prefill_past_the_window_then_decode_wraps_the_ring():
    _, tcfg, _, _ = _model()
    tok = _tokens(tcfg, 2, S + EXTRA, seed=2)
    tcache = _serve_both(None, tok, S, EXTRA)
    assert tcache["units"]["b2"]["k"].shape[2] == tcfg.window < S


def test_cache_after_in_place_decode_equals_the_reference():
    _, tcfg, _, tparams = _model()
    tok = _tokens(tcfg, 2, S + EXTRA, seed=2)
    jcache = _reference_serve(None, tok, S, EXTRA)[3]
    ttok = torch.as_tensor(tok)
    _, tcache = TD.prefill(tcfg, tparams, ttok[:, :S], S + EXTRA)
    held = dict(_leaves(tcache))
    for t in range(EXTRA):
        _, out = TT.decode_step(tcfg, tparams, tcache,
                                ttok[:, S + t:S + t + 1], S + t)
        assert out is tcache
    # every leaf is the tensor the prefill returned, updated in place
    assert all(v is held[k] for k, v in _leaves(tcache))
    _assert_trees_close(tcache, jcache, **TOL)


def test_remainder_rec_layers_match_the_reference():
    # depth 8: two rec/rec/attn units and two remainder rec layers, r0 and
    # r1, as the full config's 26 layers have
    jcfg, tcfg, jparams, tparams = _model(n_layers=8)
    assert (tcfg.n_units, tcfg.n_rem_layers) == (2, 2)
    assert sorted(tparams["rem"]) == ["r0", "r1"]
    assert sorted(tparams["rem"]["r1"]) == ["mlp", "norm1", "norm2", "rec"]
    tok = _tokens(tcfg, 2, S + EXTRA, seed=2)
    want, _ = _J_FORWARD(jcfg, jparams, jnp.asarray(tok, jnp.int32),
                         remat=False)
    got, aux = TT.forward(tcfg, tparams, torch.as_tensor(tok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(aux) == 0.0
    tcache = _serve_both(8, tok, S, EXTRA)
    assert tcache["rem"]["r1"]["h"].shape == (2, tcfg.rglru_width)


def test_greedy_generation_gives_the_reference_tokens():
    jcfg, tcfg, jparams, tparams = _model()
    prompt = _tokens(tcfg, 2, S, seed=3)
    want = JD.generate(jcfg, jparams, jnp.asarray(prompt, jnp.int32), 6)
    got = TD.generate(tcfg, tparams, torch.as_tensor(prompt), 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_reduced_recurrentgemma_runs_without_jax_or_reference():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import torch
        import repro_torch
        import repro_torch.configs as C
        from repro_torch.models import decoding as D, transformer as T
        cfg = C.reduced(C.get("recurrentgemma-2b"))
        gen = torch.Generator()
        gen.manual_seed(0)
        params = T.model_init(cfg, gen, "cpu")
        tok = torch.randint(0, cfg.vocab_size, (2, 70), generator=gen)
        logits, aux = T.forward(cfg, params, tok)
        assert logits.shape == (2, 70, cfg.padded_vocab)
        assert bool(torch.isfinite(logits).all())
        assert D.generate(cfg, params, tok, 3).shape == (2, 3)
        loaded = [m for m in sys.modules if m.startswith(("jax.", "repro."))]
        assert not loaded, loaded
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
