"""The port's attention families against the JAX package, on the reduced
configs at float32: sparse experts (qwen2-moe, llama4-scout with patch
embeddings), latent attention (minicpm3), qk-norm (chameleon), the dense
configs (phi3, glm4) and the hybrid recurrent stack (recurrentgemma; its
RG-LRU block alone in tests/test_torch_recurrent.py). The JAX package's
``model_init`` parameters are carried across with ``params_from_numpy``
and the same numpy tokens go into both. Covers configs, parameters,
forward logits and aux, prefill caches and decode continuation, greedy
tokens, the expert layer's capacity path, a mixed block pattern with a
remainder layer, and the attention kernel's head-width padding."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as JC  # noqa: E402
from repro.models import decoding as JD  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import decoding as TD  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

ARCHS = ("qwen2-moe-a2.7b", "llama4-scout-17b-a16e", "minicpm3-4b",
         "chameleon-34b", "phi3-mini-3.8b", "glm4-9b", "recurrentgemma-2b")
# float32 sums taken in another order through two layers and the vocab
# projection: logits are O(1), agreement is ~1e-5
TOL = dict(rtol=1e-4, atol=1e-4)
#: one expert layer alone: a few float32 products
MOE_TOL = dict(rtol=1e-5, atol=1e-5)
#: the leaves the reference keeps in float32 whatever the config's type
F32_LEAVES = {"router", "q_a_norm", "kv_a_norm", "q_norm", "k_norm",
              "scale", "lamb"}

_MODELS = {}


def _model(arch):
    if arch not in _MODELS:
        jcfg = JC.reduced(JC.get(arch))
        tcfg = TC.reduced(TC.get(arch))
        jparams = JT.model_init(jcfg, jax.random.PRNGKey(0))
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                    "cpu")
        _MODELS[arch] = (jcfg, tcfg, jparams, tparams)
    return _MODELS[arch]


def _tokens(cfg, b, s, seed):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, (b, s))


def _patches(cfg, b, seed):
    """Random patch embeddings (numpy) for an early-fusion config, else
    None."""
    if not cfg.n_patches:
        return None
    return np.random.RandomState(seed).randn(
        b, cfg.n_patches, cfg.d_model).astype(np.float32)


def _both(arr):
    """(JAX, torch) views of an optional numpy array."""
    if arr is None:
        return None, None
    return jnp.asarray(arr), torch.as_tensor(arr)


def _leaves(tree, path=()):
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _leaves(tree[key], path + (key,))
        else:
            yield path + (key,), tree[key]


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_reduced_equal_the_reference(arch):
    for make in (lambda m: m.get(arch), lambda m: m.reduced(m.get(arch))):
        assert dataclasses.asdict(make(TC)) == dataclasses.asdict(make(JC))
    assert TC.get(arch.replace("-", "_").replace(".", "_")) == TC.get(arch)


@pytest.mark.parametrize("arch", ["whisper-tiny"])
def test_unported_architectures_still_refuse(arch):
    # the last architecture that refused is got now (tests/
    # test_torch_whisper.py holds it against the reference): its config is
    # the reference's and the reduced reference config builds the
    # reference's parameter tree, encoder and position tables included
    assert dataclasses.asdict(TC.get(arch)) == \
        dataclasses.asdict(JC.get(arch))
    jcfg = JC.reduced(JC.get(arch))
    got = dict(_leaves(TT.abstract_params(jcfg)))
    want = dict(_leaves(JT.abstract_params(jcfg)))
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    assert ("encoder", "pos_table") in got and ("pos_table",) in got


@pytest.mark.parametrize("arch", ARCHS)
def test_parameters_carry_across_one_to_one(arch):
    jcfg, tcfg, jparams, tparams = _model(arch)
    jleaves = {tuple(k.key for k in path): np.asarray(a) for path, a in
               jax.tree_util.tree_leaves_with_path(jparams)}
    tleaves = dict(_leaves(tparams))
    assert set(tleaves) == set(jleaves)
    for path, arr in jleaves.items():
        got = tleaves[path]
        assert tuple(got.shape) == arr.shape, path
        assert torch.equal(got, torch.as_tensor(np.array(arr))), path
        if path[-1] in F32_LEAVES:
            assert got.dtype == torch.float32, path
    # at full size every other leaf takes the config's bfloat16
    for path, ps in _leaves(TT.abstract_params(TC.get(arch))):
        want = torch.float32 if path[-1] in F32_LEAVES else None
        assert ps.dtype == want, path


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_aux_match(arch):
    jcfg, tcfg, jparams, tparams = _model(arch)
    tok = _tokens(tcfg, 2, 37, seed=1)
    jpe, tpe = _both(_patches(tcfg, 2, seed=5))
    want, want_aux = JT.forward(jcfg, jparams, jnp.asarray(tok, jnp.int32),
                                patch_embeds=jpe, remat=False)
    got, aux = TT.forward(tcfg, tparams, torch.as_tensor(tok),
                          patch_embeds=tpe)
    assert got.shape == (2, 37, tcfg.padded_vocab)
    assert aux.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    if tcfg.n_experts:
        assert float(aux) > 0.0
    if tpe is not None:
        plain, _ = TT.forward(tcfg, tparams, torch.as_tensor(tok))
        assert not torch.allclose(plain, got, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_continuation_match(arch):
    jcfg, tcfg, jparams, tparams = _model(arch)
    S, EXTRA = 10, 3
    tok = _tokens(tcfg, 2, S + EXTRA, seed=2)
    jtok, ttok = jnp.asarray(tok, jnp.int32), torch.as_tensor(tok)
    jpe, tpe = _both(_patches(tcfg, 2, seed=6))
    full, _ = TT.forward(tcfg, tparams, ttok, patch_embeds=tpe)
    jlog, jcache = JD.prefill(jcfg, jparams, jtok[:, :S], S + EXTRA,
                              patch_embeds=jpe)
    tlog, tcache = TD.prefill(tcfg, tparams, ttok[:, :S], S + EXTRA,
                              patch_embeds=tpe)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    np.testing.assert_allclose(tlog.numpy(), full[:, :S].numpy(), **TOL)
    keys = ("h", "conv") if tcfg.pattern[0] == "rec" else \
        ("ckv",) if tcfg.attn_kind == "mla" else ("k", "v")
    assert sorted(tcache["units"]["b0"]) == sorted(keys)
    if tcfg.attn_kind == "mla":
        assert tcache["units"]["b0"]["ckv"].shape == (
            tcfg.n_layers, 2, S + EXTRA,
            tcfg.kv_lora_rank + tcfg.qk_rope_dim)
    for key in keys:
        np.testing.assert_allclose(tcache["units"]["b0"][key].numpy(),
                                   np.asarray(jcache["units"]["b0"][key]),
                                   **TOL)
    for t in range(EXTRA):
        jlg, jcache = JT.decode_step(jcfg, jparams, jcache,
                                     jtok[:, S + t:S + t + 1], S + t)
        tlg, tcache = TT.decode_step(tcfg, tparams, tcache,
                                     ttok[:, S + t:S + t + 1], S + t)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), **TOL)
        np.testing.assert_allclose(tlg[:, 0].numpy(), full[:, S + t].numpy(),
                                   **TOL)
    for key in keys:
        np.testing.assert_allclose(tcache["units"]["b0"][key].numpy(),
                                   np.asarray(jcache["units"]["b0"][key]),
                                   **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shapes_match_the_reference(arch):
    tcfg, jcfg = TC.reduced(TC.get(arch)), JC.reduced(JC.get(arch))
    want = JT.init_cache(jcfg, 3, 500)
    got = TT.init_cache(tcfg, 3, 500)
    assert {k: v.shape for k, v in got["units"]["b0"].items()} == \
        {k: v.shape for k, v in want["units"]["b0"].items()}
    cache = TT.materialize_cache(tcfg, 3, 500, device="cpu")
    assert all(v.dtype == torch.float32 and not v.any()
               for v in cache["units"]["b0"].values())


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "minicpm3-4b"])
def test_greedy_generation_gives_the_reference_tokens(arch):
    jcfg, tcfg, jparams, tparams = _model(arch)
    prompt = _tokens(tcfg, 4, 24, seed=3)
    want = JD.generate(jcfg, jparams, jnp.asarray(prompt, jnp.int32), 8)
    got = TD.generate(tcfg, tparams, torch.as_tensor(prompt), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _moe_inputs(case):
    """The reduced qwen2-moe config, its first expert layer (numpy) and
    inputs (b, s, d) for ``case``. The capacity cases shift every token
    toward expert 0's router column so that expert overflows."""
    jcfg, tcfg, jparams, _ = _model("qwen2-moe-a2.7b")
    layer = {k: np.asarray(v[0]) for k, v in
             jparams["units"]["b0"]["moe"].items()}
    b, s = {"capacity": (2, 2080), "capacity, one group": (1, 4100),
            "dropless": (2, 64), "one group": (2, 37)}[case]
    x = np.random.RandomState(len(case)).randn(b, s, tcfg.d_model)
    if case.startswith("capacity"):
        col = layer["router"][:, 0]
        x = x + 0.3 * col / float(col @ col)
    return jcfg, tcfg, layer, x.astype(np.float32)


@pytest.mark.parametrize("case", ["capacity", "capacity, one group",
                                  "dropless", "one group"])
def test_moe_apply_matches_the_reference(case):
    jcfg, tcfg, layer, x = _moe_inputs(case)
    want, want_aux = JM.moe_apply(jcfg, {k: jnp.asarray(v) for k, v in
                                         layer.items()}, jnp.asarray(x))
    tlayer = {k: torch.tensor(v) for k, v in layer.items()}
    got, aux = TM.moe_apply(tcfg, tlayer, torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOE_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **MOE_TOL)

    b, s, d = x.shape
    t, k = b * s, tcfg.experts_per_tok
    r = TM.route(tcfg, tlayer["router"], torch.as_tensor(x).reshape(t, d))
    g = 16 if t % 16 == 0 else 1
    assert r.keep.shape == (g, t // g * k)
    if not case.startswith("capacity"):
        assert r.cap == t // g and bool(r.keep.all())
        return
    assert r.cap < t // g
    dropped = (~r.keep).reshape(t, k).any(-1)
    assert 0 < int(dropped.sum()) < t
    print(f"{case}: {int(dropped.sum())} of {t} tokens lose a slot")
    # the reference's dropped tokens: those whose output a capacity that
    # cannot overflow (at least Tg slots an expert) changes
    roomy = dataclasses.replace(
        jcfg, capacity_factor=(jcfg.n_experts + 0.5) / k)
    all_in, _ = JM.moe_apply(roomy, {k: jnp.asarray(v) for k, v in
                                     layer.items()}, jnp.asarray(x))
    moved = np.abs(np.asarray(all_in) - np.asarray(want)).reshape(t, d)
    np.testing.assert_array_equal(moved.max(-1) > 1e-4, dropped.numpy())


def test_a_mixed_pattern_with_a_remainder_layer_matches():
    base = dataclasses.replace(JC.reduced(JC.get("qwen2-moe-a2.7b")),
                               pattern=("attn", "attn_moe"), n_layers=3)
    tcfg = dataclasses.replace(TC.reduced(TC.get("qwen2-moe-a2.7b")),
                               pattern=("attn", "attn_moe"), n_layers=3)
    gen = torch.Generator()
    gen.manual_seed(1)
    tparams = TT.model_init(tcfg, gen, "cpu")
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tparams)
    assert sorted(tparams["units"]) == ["b0", "b1"]
    assert sorted(tparams["rem"]) == ["r0"]
    tok = _tokens(tcfg, 2, 12, seed=4)
    jtok, ttok = jnp.asarray(tok, jnp.int32), torch.as_tensor(tok)
    jlog, want_aux, jcache = JT.forward(base, jparams, jtok[:, :11],
                                        remat=False, return_cache=True,
                                        cache_len=12)
    tlog, aux, tcache = TT.forward(tcfg, tparams, ttok[:, :11],
                                   return_cache=True, cache_len=12)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    assert sorted(tcache) == ["rem", "units"]
    jlg, _ = JT.decode_step(base, jparams, jcache, jtok[:, 11:], 11)
    tlg, _ = TT.decode_step(tcfg, tparams, tcache, ttok[:, 11:], 11)
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), **TOL)
    full, _ = TT.forward(tcfg, tparams, ttok)
    np.testing.assert_allclose(tlg[:, 0].numpy(), full[:, 11].numpy(), **TOL)


def test_kernel_attention_pads_a_narrow_head_width():
    # the reduced MLA config attends at width 32 + 16 = 48, which the kernel
    # is not instantiated for: padded to 64 with q rescaled, through the
    # kernel's plain version here, it equals attention at width 48
    rng = np.random.RandomState(8)
    q, k, v = (torch.as_tensor(rng.randn(2, 19, 4, 48).astype(np.float32))
               for _ in range(3))
    for window in (0, 5):
        got = TA._kernel_attention(q, k, v, window=window)
        want = TA._plain_attention(q, k, v, window=window)
        assert got.shape == q.shape
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=2e-6)
