"""The port's int8 paths against the JAX package: int8 GPT weights
(quantize_gpt_weights, QuantDense), the int8 KV cache (write, read, decode
attention with scales), K2's int8 branches (plain version against the JAX
kernel in interpret mode) and greedy int8 decodes, plus the batch picker's
int8 tier."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tortoise_tpu import weights as jax_weights
from tortoise_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from tortoise_tpu.models.gpt2 import GPT2Stack as JaxGPT2Stack
from tortoise_tpu.models.gpt2 import QuantDense as JaxQuantDense
from tortoise_tpu.models.gpt2 import init_kv_cache as jax_init_cache
from tortoise_tpu_torch import weights as port_weights
from tortoise_tpu_torch.convert.from_jax import from_jax
from tortoise_tpu_torch.models import gpt2 as port_gpt2
from tortoise_tpu_torch.models.layers import QuantDense

torch.set_num_threads(2)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a), tree)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(np.asarray(a, np.float32) if dtype else np.asarray(a)))
    return t.to(dtype) if dtype else t


def _jax_stack_params(cfg, seed=0, t=3):
    stack = JaxGPT2Stack(cfg, dtype=jnp.float32)
    return _np(stack.init(jax.random.PRNGKey(seed), jnp.zeros((1, t, cfg.n_embd)))["params"])


# --- int8 weights -------------------------------------------------------------

def test_quantize_gpt_weights_matches_jax():
    """Same int8 kernels and scales as the JAX package, bit for bit; the
    dequantized kernel is within half a step of the original; int8 kernels
    pass through."""
    params = {"gpt": _jax_stack_params(JaxGPT2Config(n_layer=2, n_embd=64, n_head=2))}
    want = jax_weights.quantize_gpt_weights(params)["gpt"]
    got = port_weights.quantize_gpt_weights(params)["gpt"]
    for name in ("c_attn", "c_proj"):
        w, g = want["h_scan"]["block"]["attn"][name], got["h_scan"]["block"]["attn"][name]
        assert g["kernel"].dtype == np.int8 and g["qscale"].dtype == np.float32
        np.testing.assert_array_equal(g["kernel"], np.asarray(w["kernel"]))
        np.testing.assert_array_equal(g["qscale"], np.asarray(w["qscale"]))
    sub = got["h_scan"]["block"]["mlp_fc"]
    assert sub["qscale"].shape == (2, 4 * 64)                     # (L, out)
    orig = params["gpt"]["h_scan"]["block"]["mlp_fc"]["kernel"]
    recon = sub["kernel"].astype(np.float32) * sub["qscale"][:, None, :]
    step = np.abs(orig).max(axis=1, keepdims=True) / 127.0
    assert np.abs(recon - orig).max() <= (step * 0.51).max()
    again = port_weights.quantize_gpt_weights({"gpt": got})["gpt"]
    assert again["h_scan"]["block"]["mlp_fc"]["kernel"] is sub["kernel"]
    assert got["ln_f"]["scale"] is params["gpt"]["ln_f"]["scale"]  # norms untouched


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_quant_dense_matches_jax(dtype):
    """QuantDense: f32 accumulate, acc * qscale + bias, one rounding to the
    compute dtype. f32 exact to 1e-5; bf16 to one output ulp (the two
    frameworks' f32 sums differ in order)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    jm = JaxQuantDense(96, dtype=dtype)
    params = _np(jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    params["bias"] = rng.standard_normal(96).astype(np.float32) * 0.1
    assert params["kernel"].dtype == np.int8
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x).astype(dtype)), np.float32)
    port = QuantDense(64, 96)
    port.load_state_dict(from_jax(port, params))
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    with torch.no_grad():
        got = port(_t(x, tdt)).float().numpy()
    tol = 1e-5 if dtype == jnp.float32 else 2 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_resolve_gpt_quant_matches_jax():
    from tortoise_tpu.models.autoregressive import UnifiedVoiceConfig as JaxConfig
    from tortoise_tpu_torch.models.autoregressive import UnifiedVoiceConfig

    for opt in ("bf16", "int8", "int8_decode"):
        want = jax_weights.resolve_gpt_quant(JaxConfig(), opt).quant_weights
        got = port_weights.resolve_gpt_quant(UnifiedVoiceConfig(), opt)
        assert got.quant_weights == want and got.gpt_config.quant_weights == want
    with pytest.raises(ValueError, match="gpt_weights"):
        port_weights.resolve_gpt_quant(UnifiedVoiceConfig(), "fp8")


# --- int8 KV cache --------------------------------------------------------------

def test_int8_cache_structure_matches_jax():
    jcfg = JaxGPT2Config(n_layer=3, n_embd=64, n_head=2)
    want = jax_init_cache(jcfg, 4, 512, dtype=jnp.int8)
    got = port_gpt2.init_kv_cache(port_gpt2.GPT2Config(n_layer=3, n_embd=64, n_head=2), 4, 512,
                                  dtype=torch.int8)
    assert set(got) == set(want) == {"k", "v", "k_scale", "v_scale"}
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
    assert tuple(got["k_scale"].shape) == (3, 4, 2, 512)         # (L, B, H, T) T-minor
    assert set(port_gpt2.init_kv_cache(port_gpt2.GPT2Config(), 1, 256)) == {"k", "v"}


@pytest.fixture(scope="module")
def stack_pair():
    cfg = JaxGPT2Config(n_layer=2, n_embd=128, n_head=4)
    params = _jax_stack_params(cfg, seed=1, t=7)
    port = port_gpt2.GPT2Stack(port_gpt2.GPT2Config(n_layer=2, n_embd=128, n_head=4))
    port.load_state_dict(from_jax(port, params))
    return cfg, params, port.eval()


def test_int8_cache_write_read_and_decode_match_jax(stack_pair):
    """f32 stack, int8 cache: a 7-row prefill (rows quantized on write, read
    back dequantized) and two decode steps (attention with the scales over
    the chunked path) against the JAX stack. Quantized values agree to one
    int8 step (an f32 difference can cross a rounding boundary), scales and
    hidden states to 1e-4."""
    cfg, params, port = stack_pair
    rng = np.random.default_rng(2)
    emb = rng.standard_normal((2, 7, 128)).astype(np.float32)
    steps = rng.standard_normal((2, 2, 1, 128)).astype(np.float32)
    stack = JaxGPT2Stack(cfg, dtype=jnp.float32)
    jcache = jax_init_cache(cfg, 2, 256, dtype=jnp.int8)
    pcache = port_gpt2.init_kv_cache(port.config, 2, 256, dtype=torch.int8)
    jy, jcache = stack.apply({"params": params}, jnp.asarray(emb), cache=jcache, cache_index=0)
    with torch.no_grad():
        py, _ = port(_t(emb), cache=pcache, cache_index=0)
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), rtol=1e-4, atol=1e-4)
    for i in range(2):
        jy, jcache = stack.apply({"params": params}, jnp.asarray(steps[i]), cache=jcache,
                                 cache_index=7 + i)
        with torch.no_grad():
            py, _ = port(_t(steps[i]), cache=pcache, cache_index=7 + i)
        np.testing.assert_allclose(py.numpy(), np.asarray(jy), rtol=1e-4, atol=1e-4)
    for k in ("k", "v"):
        diff = np.abs(pcache[k].numpy().astype(np.int32) - np.asarray(jcache[k], np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
        np.testing.assert_allclose(pcache[f"{k}_scale"].numpy(), np.asarray(jcache[f"{k}_scale"]),
                                   rtol=1e-5, atol=1e-8)
    assert not pcache["k"][:, :, 9:].any()


@pytest.mark.parametrize("cache_index", [0, 50, 200])
def test_chunked_decode_attention_with_scales_matches_jax(cache_index):
    """Scales factored out of the dot products: k scales on the logits, v
    scales on the weights, the sum over the unscaled weights (f32, 1e-5)."""
    from tortoise_tpu.ops.attention import chunked_decode_attention_merged as jax_attn
    from tortoise_tpu_torch.ops.attention import chunked_decode_attention_merged as port_attn

    rng = np.random.default_rng(cache_index)
    q = rng.standard_normal((3, 128)).astype(np.float32)
    ck, cv = (rng.integers(-127, 128, (2, 3, 256, 128)).astype(np.int8) for _ in range(2))
    ks, vs = (rng.uniform(0.001, 0.02, (2, 3, 4, 256)).astype(np.float32) for _ in range(2))
    want = jax_attn(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), 1, cache_index, heads=4,
                    k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    got = port_attn(_t(q), _t(ck), _t(cv), 1, cache_index, heads=4, k_scale=_t(ks),
                    v_scale=_t(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# --- K2's int8 branches -------------------------------------------------------------

K2_CFG = JaxGPT2Config(n_layer=3, n_embd=256, n_head=4)
K2_B, K2_T, K2_HIST = 4, 256, 160


def _bf16_leaves(params):
    """JAX cast_for_inference: float leaves to bf16, norms and qscales kept f32."""
    return jax_weights.cast_for_inference(params, jnp.bfloat16)


@pytest.fixture(scope="module")
def k2_setup():
    """bf16 JAX stacks (bf16 and int8 weights, the int8 ones quantized from
    the same f32 weights) with bf16 and int8 caches whose first K2_HIST rows
    the XLA path wrote; the same in the port."""
    from tortoise_tpu.ops.decode_step_pallas import prepare_stacked_params as jax_prepare
    from tortoise_tpu_torch.ops.decode_step import prepare_stacked_params

    f32 = _jax_stack_params(K2_CFG, seed=0)
    trees = {"bf16": {"gpt": f32}, "int8": jax_weights.quantize_gpt_weights({"gpt": f32})}
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((K2_B, 1, K2_CFG.n_embd)).astype(np.float32)
    hist = rng.standard_normal((K2_B, K2_HIST, K2_CFG.n_embd)).astype(np.float32)
    out = {"emb": emb}
    for w, tree in trees.items():
        cfg = dataclasses.replace(K2_CFG, quant_weights=w == "int8")
        params = _bf16_leaves(tree)["gpt"]
        model = JaxGPT2Stack(cfg, dtype=jnp.bfloat16)
        port = port_gpt2.GPT2Stack(port_gpt2.GPT2Config(n_layer=3, n_embd=256, n_head=4,
                                                        quant_weights=w == "int8"))
        port.load_state_dict(from_jax(port, _np(jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32) if a.dtype != np.int8 else a, params))))
        port_weights.cast_for_inference(port, torch.bfloat16)
        out[w] = (model, params, jax_prepare(params), prepare_stacked_params(port))
        for c, dt in (("bf16", jnp.bfloat16), ("int8", jnp.int8)):
            cache = jax_init_cache(cfg, K2_B, K2_T, dtype=dt)
            _, cache = model.apply({"params": params}, jnp.asarray(hist, jnp.bfloat16),
                                   cache=cache, cache_index=0)
            out[(w, c)] = cache
    return out


def _port_cache(cache, pos):
    """The JAX cache as port tensors, rows at and past pos zeroed (never read)."""
    out = {}
    for k, v in cache.items():
        a = np.array(v if v.dtype != jnp.bfloat16 else np.asarray(v, np.float32))
        if k.endswith("scale"):
            a[..., pos:] = 0
        else:
            a[:, :, pos:] = 0
        t = torch.from_numpy(a)
        out[k] = t.to(torch.bfloat16) if v.dtype == jnp.bfloat16 else t
    return out


@pytest.mark.parametrize("pos", [0, 20, 150], ids=["empty", "inside_chunk", "across_chunks"])
@pytest.mark.parametrize("weights,cache", [("int8", "bf16"), ("bf16", "int8"), ("int8", "int8")])
def test_plain_int8_variants_match_jax_kernel(k2_setup, weights, cache, pos):
    """The plain K2 of each int8 variant against the JAX fused kernel in
    interpret mode on the same stack and cache: hidden within 0.03 x max
    and the new rows within 0.02 x max (the bounds of
    tests/test_fused_decode_step.py); with the int8 cache also against the
    JAX layer stack after ln_f within 0.08 x max (the step attends to its
    row unquantized, the stack to the quantized row, that test's bound)."""
    from tortoise_tpu.ops.decode_step_pallas import fused_decode_step as jax_step
    from tortoise_tpu_torch.ops.decode_step import fused_decode_step, variant

    model, params, jstack, pstack = k2_setup[weights]
    jcache = {k: v.at[..., pos:].set(0) if k.endswith("scale") else v.at[:, :, pos:].set(0)
              for k, v in k2_setup[(weights, cache)].items()}   # rows >= pos are never read
    emb = k2_setup["emb"]
    pcache = _port_cache(k2_setup[(weights, cache)], pos)
    assert variant(pstack, pcache) == {("int8", "bf16"): "int8_weights",
                                       ("bf16", "int8"): "int8_cache",
                                       ("int8", "int8"): "int8_weights_int8_cache"}[
                                           (weights, cache)]
    y_ref, k_ref, v_ref = jax_step(jstack, jnp.asarray(emb[:, 0], jnp.bfloat16), jcache, pos,
                                   heads=4, ck=32, interpret=True)
    y, k_rows, v_rows = fused_decode_step(pstack, _t(emb[:, 0], torch.bfloat16), pcache, pos, 4)
    ref = np.asarray(y_ref, np.float32)
    np.testing.assert_allclose(y.float().numpy(), ref, atol=0.03 * np.abs(ref).max())
    for got, want in ((k_rows, k_ref), (v_rows, v_ref)):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.float().numpy(), want,
                                   atol=2e-2 * max(np.abs(want).max(), 1))
    if cache == "int8":
        hidden_ref, _ = model.apply({"params": params}, jnp.asarray(emb, jnp.bfloat16),
                                    cache=jcache, cache_index=pos)
        ref = np.asarray(hidden_ref[:, 0], np.float32)
        w, b = (np.asarray(params["ln_f"][n], np.float32) for n in ("scale", "bias"))
        y32 = y.float().numpy()
        mu, var = y32.mean(-1, keepdims=True), y32.var(-1, keepdims=True)
        got = (y32 - mu) / np.sqrt(var + 1e-5) * w + b
        np.testing.assert_allclose(got, ref, atol=0.08 * np.abs(ref).max())


def test_int8_decode_stack_matches_jax():
    """gpt_weights="int8_decode": the stack of a bf16 model quantized from
    its f32 weights before the cast equals the JAX package's (quantize the
    f32 host tree, cast, stack)."""
    from tortoise_tpu.ops.decode_step_pallas import prepare_stacked_params as jax_prepare
    from tortoise_tpu_torch.ops.decode_step import prepare_stacked_params, quantize_gpt_denses

    cfg = JaxGPT2Config(n_layer=2, n_embd=64, n_head=2)
    f32 = _jax_stack_params(cfg)
    f32["h_scan"]["block"]["attn"]["c_attn"]["bias"] = \
        np.random.default_rng(0).standard_normal((2, 192)).astype(np.float32)
    want = jax_prepare(_bf16_leaves(jax_weights.quantize_gpt_weights({"gpt": f32}))["gpt"])
    port = port_gpt2.GPT2Stack(port_gpt2.GPT2Config(n_layer=2, n_embd=64, n_head=2))
    port.load_state_dict(from_jax(port, f32))
    quantized = quantize_gpt_denses(port)
    port_weights.cast_for_inference(port, torch.bfloat16)
    got = prepare_stacked_params(port, quantized)
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        w = w[:, 0] if w.ndim == 3 and w.shape[1] == 1 else w   # JAX keeps (L, 1, X) rows
        g = got[k].float().numpy() if got[k].dtype == torch.bfloat16 else got[k].numpy()
        if k.startswith("w"):
            w = np.swapaxes(w, -1, -2)                           # (in, out) -> (out, in)
        assert g.dtype == (np.float32 if w.dtype != np.int8 else np.int8), k
        np.testing.assert_array_equal(g, np.asarray(w, g.dtype), err_msg=k)


# --- greedy decodes ---------------------------------------------------------------

GREEDY_KW = dict(layers=2, model_dim=128, heads=4, max_text_tokens=40, max_mel_tokens=80,
                 number_mel_codes=64, start_mel_token=60, stop_mel_token=61)


@pytest.mark.parametrize("gpt_weights,cache", [("f32", "int8"), ("int8", "f32"),
                                               ("int8", "int8")])
def test_greedy_int8_decode_matches_jax(gpt_weights, cache):
    """f32 model, greedy: the port's sampler over int8 weights and/or an int8
    cache emits the JAX sampler's tokens exactly."""
    from tortoise_tpu.models.ar_sampler import SamplerSettings as JaxSettings
    from tortoise_tpu.models.ar_sampler import sample_speech as jax_sample
    from tortoise_tpu.models.autoregressive import UnifiedVoice as JaxVoice
    from tortoise_tpu.models.autoregressive import UnifiedVoiceConfig as JaxConfig
    from tortoise_tpu.models.autoregressive import init_unified_voice
    from tortoise_tpu_torch.models.ar_sampler import SamplerSettings, sample_speech
    from tortoise_tpu_torch.models.autoregressive import UnifiedVoice, UnifiedVoiceConfig

    quant = gpt_weights == "int8"
    jcfg = JaxConfig(**GREEDY_KW)
    params = init_unified_voice(JaxVoice(jcfg), 0)["params"]
    if quant:
        params = jax_weights.quantize_gpt_weights(_np(params))
    jmodel = JaxVoice(dataclasses.replace(jcfg, quant_weights=quant))
    cond = np.random.default_rng(3).standard_normal((1, 128)).astype(np.float32)
    text = np.random.RandomState(0).randint(1, 30, (1, 12))
    jdt, pdt = {"f32": (jnp.float32, torch.float32), "int8": (jnp.int8, torch.int8)}[cache]
    want, _ = jax_sample(jmodel, {"params": params}, jnp.asarray(cond), jnp.asarray(text),
                         jax.random.PRNGKey(4), 2,
                         settings=JaxSettings(do_sample=False, max_generate=24,
                                              emit_latents=False), cache_dtype=jdt)
    port = UnifiedVoice(UnifiedVoiceConfig(**GREEDY_KW, quant_weights=quant))
    port.load_state_dict(from_jax(port, _np(params)))
    with torch.no_grad():
        got, _ = sample_speech(port, _t(cond), torch.from_numpy(text).long(),
                               torch.Generator().manual_seed(0), 2,
                               SamplerSettings(do_sample=False, max_generate=24,
                                               emit_latents=False), cache_dtype=pdt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fused_int8_sampler_agrees_with_jax_stack():
    """bf16 model, int8 weights and cache, greedy: the port's sampler on K2's
    plain version (rows quantized into the cache after each step) against
    the JAX XLA sampler; K2 attends to its own row unquantized, so, as the
    JAX package's own int8 tests, agreement over a prefix >= 0.9."""
    from tortoise_tpu.models.ar_sampler import SamplerSettings as JaxSettings
    from tortoise_tpu.models.ar_sampler import sample_speech as jax_sample
    from tortoise_tpu.models.autoregressive import UnifiedVoice as JaxVoice
    from tortoise_tpu.models.autoregressive import UnifiedVoiceConfig as JaxConfig
    from tortoise_tpu.models.autoregressive import init_unified_voice
    from tortoise_tpu_torch.models.ar_sampler import SamplerSettings, sample_speech
    from tortoise_tpu_torch.models.autoregressive import UnifiedVoice, UnifiedVoiceConfig
    from tortoise_tpu_torch.ops.decode_step import prepare_stacked_params

    jcfg = JaxConfig(**GREEDY_KW, quant_weights=True)
    params = jax_weights.quantize_gpt_weights(_np(init_unified_voice(
        JaxVoice(dataclasses.replace(jcfg, quant_weights=False)), 0)["params"]))
    cond = np.random.default_rng(3).standard_normal((1, 128)).astype(np.float32)
    text = np.random.RandomState(0).randint(1, 30, (1, 12))
    want, _ = jax_sample(JaxVoice(jcfg, dtype=jnp.bfloat16),
                         {"params": _bf16_leaves(params)}, jnp.asarray(cond), jnp.asarray(text),
                         jax.random.PRNGKey(4), 2,
                         settings=JaxSettings(do_sample=False, max_generate=24,
                                              emit_latents=False), cache_dtype=jnp.int8)
    model = UnifiedVoice(UnifiedVoiceConfig(**GREEDY_KW, quant_weights=True))
    model.load_state_dict(from_jax(model, _np(params)))
    port_weights.cast_for_inference(model, torch.bfloat16)
    stacked = prepare_stacked_params(model.gpt)
    with torch.no_grad():
        got, _ = sample_speech(model, _t(cond), torch.from_numpy(text).long(),
                               torch.Generator().manual_seed(0), 2,
                               SamplerSettings(do_sample=False, max_generate=24, fused_step=True,
                                               emit_latents=False),
                               cache_dtype=torch.int8, stacked=stacked)
    agree = (got.numpy()[:, :12] == np.asarray(want)[:, :12]).mean()
    assert agree >= 0.9, agree


# --- the batch picker --------------------------------------------------------------

@pytest.mark.parametrize("free_gib,bf16,int8", [(16, 64, 128), (75, 128, 256)])
def test_batch_picker_doubles_for_int8_cache(monkeypatch, free_gib, bf16, int8):
    """Half the free memory over one candidate's cache bytes (the int8 cache
    counted with its f32 scale slabs, about 0.53x bf16), a power of two,
    capped at 128 (bf16) or 256 (int8) as the JAX package's tiers."""
    from tortoise_tpu_torch.api import (kv_cache_bytes_per_candidate,
                                        pick_best_batch_size_for_device)
    from tortoise_tpu_torch.models.autoregressive import UnifiedVoiceConfig

    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (free_gib << 30, 80 << 30))
    cfg = UnifiedVoiceConfig()
    assert pick_best_batch_size_for_device("cuda", cfg, torch.bfloat16) == bf16
    assert pick_best_batch_size_for_device("cuda", cfg, torch.int8) == int8
    ratio = (kv_cache_bytes_per_candidate(cfg, 1024, torch.int8)
             / kv_cache_bytes_per_candidate(cfg, 1024, torch.bfloat16))
    assert 0.5 < ratio < 0.56
    cache = port_gpt2.init_kv_cache(port_gpt2.GPT2Config(n_layer=2, n_embd=128, n_head=2), 1,
                                    256, dtype=torch.int8)
    assert sum(t.numel() * t.element_size() for t in cache.values()) == \
        kv_cache_bytes_per_candidate(UnifiedVoiceConfig(layers=2, model_dim=128, heads=2), 256,
                                     torch.int8)
