"""The port's dense GQA transformer against the JAX package, on the reduced
Llama-3.2-3B config at float32: the JAX package's ``model_init`` parameters
carried across with ``params_from_numpy``, the same numpy tokens into both.
Covers forward logits, prefill and decode continuation, greedy generation
with full attention and with a sliding window (the two requests of
``examples/serve_batched.py``), cache shapes, and the attention dispatch."""
import dataclasses

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

ARCH = "llama3.2-3b"
# float32 sums taken in another order through two layers and the vocab
# projection: logits are O(1), agreement is ~1e-5
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def model():
    jcfg = JC.reduced(JC.get(ARCH))
    tcfg = TC.reduced(TC.get(ARCH))
    jparams = JT.model_init(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                "cpu")
    return jcfg, tcfg, jparams, tparams


def _tokens(cfg, b, s, seed):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, (b, s))


def test_configs_match_the_reference():
    for make in (lambda m: m.get(ARCH), lambda m: m.reduced(m.get(ARCH))):
        assert dataclasses.asdict(make(TC)) == dataclasses.asdict(make(JC))
    assert TC.ARCH_IDS == JC.ARCH_IDS and TC.ALIASES == JC.ALIASES
    with pytest.raises(ValueError):
        TC.get("no-such-model")
    # cross-attention blocks need an encoder, which the reference cannot
    # run without either
    xattn = dataclasses.replace(TC.reduced(TC.get(ARCH)), pattern=("xattn",))
    with pytest.raises(ValueError, match="enc_dec"):
        TT.abstract_params(xattn)


def test_parameters_carry_across_one_to_one(model):
    jcfg, tcfg, jparams, tparams = model
    jleaves = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(jleaves) == 12
    for path, arr in jleaves:
        node = tparams
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == arr.shape
        assert torch.equal(node, torch.as_tensor(np.array(arr)))
    bad = jax.tree.map(np.asarray, jparams)
    bad["head"] = bad["head"][:, :7]
    with pytest.raises(ValueError, match="head"):
        params_from_numpy(bad, tcfg, "cpu")
    del bad["head"]
    with pytest.raises(ValueError, match="keys"):
        params_from_numpy(bad, tcfg, "cpu")


def test_model_init_follows_the_reference_init_law():
    cfg = TC.reduced(TC.get(ARCH))
    gen = torch.Generator()
    gen.manual_seed(0)
    p = TT.model_init(cfg, gen, "cpu")
    wq = p["units"]["b0"]["attn"]["wq"]
    assert wq.shape == (cfg.n_units, cfg.d_model, cfg.n_heads * cfg.hd)
    assert abs(float(wq.std()) * cfg.d_model ** 0.5 - 1.0) < 0.02
    assert float(p["embed"].std()) * cfg.padded_vocab ** 0.5 == \
        pytest.approx(1.0, abs=0.02)
    assert torch.equal(p["final_norm"]["scale"],
                       torch.ones(cfg.d_model, dtype=torch.float32))
    gen.manual_seed(0)
    again = TT.model_init(cfg, gen, "cpu")
    assert torch.equal(again["head"], p["head"])


def test_model_entry_points_without_cuda_need_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TC.reduced(TC.get(ARCH))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.model_init(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.materialize_cache(cfg, 1, 8)


def test_forward_logits_match(model):
    jcfg, tcfg, jparams, tparams = model
    tok = _tokens(tcfg, 2, 37, seed=1)
    want, _ = JT.forward(jcfg, jparams, jnp.asarray(tok, jnp.int32),
                         remat=False)
    got, aux = TT.forward(tcfg, tparams, torch.as_tensor(tok))
    assert got.shape == (2, 37, tcfg.padded_vocab) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("window", [None, 6])
def test_prefill_and_decode_continuation_match(model, window):
    jcfg, tcfg, jparams, tparams = model
    S, EXTRA = 10, 3
    tok = _tokens(tcfg, 2, S + EXTRA, seed=2)
    jtok, ttok = jnp.asarray(tok, jnp.int32), torch.as_tensor(tok)
    full, _ = TT.forward(tcfg, tparams, ttok, window_override=window)
    jlog, jcache = JD.prefill(jcfg, jparams, jtok[:, :S], S + EXTRA,
                              window_override=window)
    tlog, tcache = TD.prefill(tcfg, tparams, ttok[:, :S], S + EXTRA,
                              window_override=window)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    np.testing.assert_allclose(tlog.numpy(), full[:, :S].numpy(), **TOL)
    for t in range(EXTRA):
        jlg, jcache = JT.decode_step(jcfg, jparams, jcache,
                                     jtok[:, S + t:S + t + 1], S + t,
                                     window_override=window)
        tlg, tcache = TT.decode_step(tcfg, tparams, tcache,
                                     ttok[:, S + t:S + t + 1], S + t,
                                     window_override=window)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), **TOL)
        np.testing.assert_allclose(tlg[:, 0].numpy(), full[:, S + t].numpy(),
                                   **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache["units"]["b0"][key].numpy(),
                                   np.asarray(jcache["units"]["b0"][key]),
                                   **TOL)


@pytest.mark.parametrize("window", [None, 16])
def test_greedy_generation_gives_the_reference_tokens(model, window):
    # examples/serve_batched.py: batch 4, prompt 24, 12 new tokens
    jcfg, tcfg, jparams, tparams = model
    prompt = _tokens(tcfg, 4, 24, seed=3)
    want = JD.generate(jcfg, jparams, jnp.asarray(prompt, jnp.int32), 12,
                       window_override=window)
    got = TD.generate(tcfg, tparams, torch.as_tensor(prompt), 12,
                      window_override=window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_temperature_sampling_is_seeded(model):
    _, tcfg, _, tparams = model
    prompt = torch.as_tensor(_tokens(tcfg, 2, 8, seed=4))
    a = TD.generate(tcfg, tparams, prompt, 5, temperature=0.7, seed=11)
    b = TD.generate(tcfg, tparams, prompt, 5, temperature=0.7, seed=11)
    assert torch.equal(a, b) and a.shape == (2, 5)
    assert int(a.max()) < tcfg.vocab_size


@pytest.mark.parametrize("window", [None, 64])
def test_cache_shapes_match_the_reference(window):
    tcfg = TC.reduced(TC.get(ARCH))
    jcfg = JC.reduced(JC.get(ARCH))
    want = JT.init_cache(jcfg, 3, 500, window_override=window)
    got = TT.init_cache(tcfg, 3, 500, window_override=window)
    for key in ("k", "v"):
        assert got["units"]["b0"][key].shape == \
            want["units"]["b0"][key].shape
    cache = TT.materialize_cache(tcfg, 3, 500, window_override=window,
                                 device="cpu")
    assert cache["units"]["b0"]["k"].shape[2] == (window or 500)
    assert cache["units"]["b0"]["k"].dtype == torch.float32


@pytest.mark.parametrize("force_blocked", [False, True])
@pytest.mark.parametrize("window", [0, 5])
def test_sdpa_takes_unrepeated_kv_and_matches_the_reference(window,
                                                            force_blocked):
    rng = np.random.RandomState(window)
    q = rng.randn(2, 21, 4, 16).astype(np.float32)
    k, v = (rng.randn(2, 21, 2, 16).astype(np.float32) for _ in range(2))
    kr, vr = (np.repeat(a, 2, axis=2) for a in (k, v))
    tq, tk, tv, tkr, tvr = map(torch.as_tensor, (q, k, v, kr, vr))
    grouped = TA.sdpa(tq, tk, tv, window=window, force_blocked=force_blocked)
    repeated = TA.sdpa(tq, tkr, tvr, window=window,
                       force_blocked=force_blocked)
    assert torch.equal(grouped, repeated)
    want = JA.sdpa(q, kr, vr, window=window, force_blocked=force_blocked)
    np.testing.assert_allclose(grouped.numpy(), np.asarray(want), rtol=0,
                               atol=2e-6)


@pytest.mark.parametrize("window", [0, 300])
def test_blocked_attention_spans_several_kv_blocks(window):
    # 1100 keys: one full 1024-key block and a ragged one
    rng = np.random.RandomState(7)
    q = rng.randn(1, 1100, 2, 8).astype(np.float32)
    k, v = (rng.randn(1, 1100, 1, 8).astype(np.float32) for _ in range(2))
    tq, tk, tv = map(torch.as_tensor, (q, k, v))
    got = TA.sdpa(tq, tk, tv, window=window, force_blocked=True)
    plain = TA.sdpa(tq, tk, tv, window=window, force_blocked=False)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=2e-6)
    want = JA.sdpa(q, np.repeat(k, 2, 2), np.repeat(v, 2, 2), window=window,
                   force_blocked=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-6)
