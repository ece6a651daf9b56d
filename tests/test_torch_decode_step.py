"""K2 (ops/decode_step.py) against the JAX fused decode kernel and layer stack,
and the port's greedy AR decode against the JAX sampler."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tortoise_tpu.models.gpt2 import GPT2Config, GPT2Stack, init_kv_cache
from tortoise_tpu.ops.decode_step_pallas import fused_decode_step as jax_fused_step
from tortoise_tpu.ops.decode_step_pallas import prepare_stacked_params as jax_stack
from tortoise_tpu_torch.convert.from_jax import from_jax
from tortoise_tpu_torch.models import gpt2 as port_gpt2
from tortoise_tpu_torch.ops.decode_step import (fused_decode_step, fused_decode_step_plain,
                                                prepare_stacked_params)

torch.set_num_threads(2)

CFG = GPT2Config(n_layer=3, n_embd=256, n_head=4)
B, T_MAX, HIST = 4, 128, 70


def _bf16_torch(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


@pytest.fixture(scope="module")
def setup():
    """bf16 JAX stack with a cache whose rows 0..HIST-1 the XLA path wrote,
    and the same weights and cache in the port."""
    model = GPT2Stack(CFG, dtype=jnp.bfloat16)
    rng = np.random.default_rng(0)
    emb = jnp.asarray(rng.standard_normal((B, 1, CFG.n_embd)), jnp.bfloat16)
    variables = model.init(jax.random.PRNGKey(0), emb)
    variables = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.bfloat16) if a.dtype == jnp.float32 else a, variables)
    cache = init_kv_cache(CFG, B, T_MAX, dtype=jnp.bfloat16)
    hist = jnp.asarray(rng.standard_normal((B, HIST, CFG.n_embd)), jnp.bfloat16)
    _, cache = model.apply(variables, hist, cache=cache, cache_index=0)

    port = port_gpt2.GPT2Stack(port_gpt2.GPT2Config(n_layer=3, n_embd=256, n_head=4))
    port.load_state_dict(from_jax(port, jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), variables["params"])))
    stacked = prepare_stacked_params(port)
    port_cache = {k: _bf16_torch(cache[k]) for k in ("k", "v")}
    return model, variables, cache, emb, port, stacked, port_cache


@torch.no_grad()
def _ln_f(port, y):
    w, b = port.ln_f.params()
    return torch.nn.functional.layer_norm(y.float(), (y.shape[-1],), w, b, 1e-5)


@pytest.mark.parametrize("pos", [0, 20, HIST], ids=["empty", "inside_chunk", "across_chunks"])
def test_plain_matches_jax_kernel_and_stack(setup, pos):
    model, variables, cache, emb, port, stacked, port_cache = setup
    if pos < HIST:  # rows >= pos are never read
        cache = {k: v.at[:, :, pos:].set(0) for k, v in cache.items()}
    y_ref, k_ref, v_ref = jax_fused_step(jax_stack(variables["params"]), emb[:, 0], cache, pos,
                                         heads=CFG.n_head, ck=32, interpret=True)
    y, k_rows, v_rows = fused_decode_step(stacked, _bf16_torch(emb[:, 0]), port_cache, pos,
                                          CFG.n_head)
    ref = np.asarray(y_ref, np.float32)
    # tolerances of tests/test_fused_decode_step.py
    np.testing.assert_allclose(y.float().numpy(), ref, atol=0.03 * np.abs(ref).max())
    for got, want in ((k_rows, k_ref), (v_rows, v_ref)):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.float().numpy(), want,
                                   atol=2e-2 * max(np.abs(want).max(), 1))

    hidden_ref, _ = model.apply(variables, emb, cache=cache, cache_index=pos)
    ref = np.asarray(hidden_ref[:, 0], np.float32)
    np.testing.assert_allclose(_ln_f(port, y).numpy(), ref, atol=0.03 * np.abs(ref).max())


def test_wrapper_takes_plain_version_on_cpu(setup):
    _, _, _, emb, _, stacked, port_cache = setup
    x = _bf16_torch(emb[:, 0])
    before = fused_decode_step.launches
    got = fused_decode_step(stacked, x, port_cache, 5, CFG.n_head)
    want = fused_decode_step_plain(stacked, x, port_cache, 5, CFG.n_head)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert fused_decode_step.launches == before


def test_greedy_decode_token_exact_f32():
    """f32 greedy decode: the port's sampler (prefill + Python loop, plain
    decode attention) emits exactly the JAX sampler's tokens."""
    from tortoise_tpu.models.ar_sampler import SamplerSettings as JaxSettings
    from tortoise_tpu.models.ar_sampler import sample_speech as jax_sample
    from tortoise_tpu.models.autoregressive import UnifiedVoice as JaxVoice
    from tortoise_tpu.models.autoregressive import UnifiedVoiceConfig as JaxConfig
    from tortoise_tpu.models.autoregressive import init_unified_voice
    from tortoise_tpu_torch.models.ar_sampler import SamplerSettings, sample_speech
    from tortoise_tpu_torch.models.autoregressive import UnifiedVoice, UnifiedVoiceConfig

    kw = dict(layers=2, model_dim=64, heads=2, max_text_tokens=40, max_mel_tokens=48)
    jmodel = JaxVoice(JaxConfig(**kw))
    params = init_unified_voice(jmodel, 0)
    rng = np.random.default_rng(3)
    cond = rng.standard_normal((1, 64)).astype(np.float32)
    text = np.asarray([[10, 20, 30, 7, 0]], np.int32)
    want, _ = jax_sample(jmodel, params, jnp.asarray(cond), jnp.asarray(text),
                         jax.random.PRNGKey(0), 3,
                         settings=JaxSettings(do_sample=False, max_generate=24),
                         cache_dtype=jnp.float32)

    port = UnifiedVoice(UnifiedVoiceConfig(**kw))
    port.load_state_dict(from_jax(port, params["params"]))
    with torch.no_grad():
        got, lats = sample_speech(port, torch.from_numpy(cond), torch.from_numpy(text).long(),
                                  torch.Generator().manual_seed(0), 3,
                                  SamplerSettings(do_sample=False, max_generate=24),
                                  cache_dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert lats.shape == (3, 24, 64)

