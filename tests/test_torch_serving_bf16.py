"""The served bf16 models (``dtype=None``, weights cast by
``weights.cast_for_inference``) against the JAX package's bf16 models on the
CPU: the two type promotions that JAX applies on every backend, bit for bit,
and the served UnifiedVoice's conditioning latent and prefill logits.

JAX promotes a bf16 array to float32 when it meets a numpy scalar: in
``gelu_new`` (``tortoise_tpu/models/gpt2.py:50-52``) the tanh and the
result are float32, and in the attention block (``blocks.py:253-255``) q and
k are float32 before the logits product. The JAX side is compiled with XLA's
``xla_allow_excess_precision`` off, so that it rounds to bf16 wherever its
program says (tests/test_torch_training_bf16.py)."""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from tortoise_tpu import weights as jax_weights
from tortoise_tpu_torch.convert.from_jax import from_jax

torch.set_num_threads(2)
EXACT_BF16 = {"xla_allow_excess_precision": False}
# gelu_new's float32 result, absolute: XLA and torch each approximate the
# float32 tanh, and part by an ulp or two of it (2^-24 near 1), which
# 0.5 x (|x| < 16 here) scales; a bf16 result misses by up to 2^-9 of it
GELU_ATOL = 2.0 ** -19
UV = dict(layers=2, model_dim=128, heads=4, max_text_tokens=40, max_mel_tokens=48)
# The served UnifiedVoice against the JAX bf16 model, relative to the
# output's max: the served path keeps the fused Dense bias (one rounding
# where flax rounds twice), so a bf16 ulp flips here and there and carries
# through the layers. Read 0.0052 (latent) and 0.0059 (logits) with both
# promotions, 0.0103 and 0.0065 without them: the bound is 2^-6, the bf16
# training tests' gradient bound
SERVED_REL_BOUND = 2.0 ** -6


def _bf16_inputs(seed, *shape, scale=3.0):
    """numpy float32 values that are exact bf16 numbers, and the torch bf16 tensor."""
    x = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)
    t = torch.as_tensor(x).to(torch.bfloat16)
    return t.float().numpy(), t


def test_gelu_new_promotes_to_float32_as_jax_does():
    from tortoise_tpu.models.gpt2 import gelu_new as jax_gelu_new
    from tortoise_tpu_torch.models.gpt2 import gelu_new

    x, xt = _bf16_inputs(0, 4096)
    want = jax.jit(jax_gelu_new, compiler_options=EXACT_BF16)(jnp.asarray(x, jnp.bfloat16))
    got = gelu_new(xt)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    # bit for bit but for the float32 tanh
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=GELU_ATOL)


def test_attention_logits_promote_q_and_k_as_jax_does():
    from tortoise_tpu_torch.models.blocks import attention_logits

    ch = 32
    q, qt = _bf16_inputs(1, 2, 24, 4, ch)
    k, kt = _bf16_inputs(2, 2, 24, 4, ch)

    def jax_logits(q, k):   # tortoise_tpu/models/blocks.py:253-255
        scale = 1.0 / np.sqrt(np.sqrt(ch))
        return jnp.einsum("bthd,bshd->bhts", q * scale, k * scale,
                          preferred_element_type=jnp.float32)

    want = jax.jit(jax_logits, compiler_options=EXACT_BF16)(jnp.asarray(q, jnp.bfloat16),
                                                            jnp.asarray(k, jnp.bfloat16))
    got = attention_logits(qt, kt)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _rel_err(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max() / np.abs(want).max())


def test_served_bf16_unified_voice_against_jax():
    """Conditioning latent of two clips and the mel logits of a prompt's
    last position after a prefill into a bf16 cache."""
    from tortoise_tpu.models.autoregressive import (UnifiedVoice, UnifiedVoiceConfig,
                                                    init_unified_voice)
    from tortoise_tpu.models.gpt2 import init_kv_cache
    from tortoise_tpu_torch import weights as port_weights
    from tortoise_tpu_torch.models.autoregressive import UnifiedVoice as PV
    from tortoise_tpu_torch.models.autoregressive import UnifiedVoiceConfig as PC
    from tortoise_tpu_torch.models.gpt2 import init_kv_cache as port_cache

    params = jax_weights.host_init(
        lambda: init_unified_voice(UnifiedVoice(UnifiedVoiceConfig(**UV)), 0), seed=2)["params"]
    port = PV(PC(**UV))
    port.load_state_dict(from_jax(port, params))
    port = port_weights.cast_for_inference(port, torch.bfloat16).eval()
    jm = UnifiedVoice(UnifiedVoiceConfig(**UV), dtype=jnp.bfloat16)
    v = {"params": jax_weights.cast_for_inference(params, jnp.bfloat16)}

    rng = np.random.default_rng(4)
    mels = rng.standard_normal((1, 2, 40, 80)).astype(np.float32)
    text = rng.integers(1, 255, (1, 9))

    def jax_served(mels, text):
        cond = jm.apply(v, mels, method=UnifiedVoice.get_conditioning)
        prompt = jm.apply(v, cond, text, method=UnifiedVoice.compute_prompt)
        cache = init_kv_cache(jm.config.gpt_config, 1, 256, dtype=jnp.bfloat16)
        hidden, _ = jm.apply(v, prompt, cache, 0, method=UnifiedVoice.gpt_with_cache)
        return cond, jm.apply(v, hidden[:, -1:], method=UnifiedVoice.hidden_to_mel_logits)

    jcond, jlogits = jax.jit(jax_served, compiler_options=EXACT_BF16)(
        jnp.asarray(mels), jnp.asarray(text))
    with torch.no_grad():
        cond = port.get_conditioning(torch.as_tensor(mels))
        prompt = port.compute_prompt(cond, torch.as_tensor(text))
        cache = port_cache(port.config.gpt_config, 1, 256, dtype=torch.bfloat16)
        hidden, _ = port.gpt(prompt, cache=cache, cache_index=0)
        logits = port.hidden_to_mel_logits(hidden[:, -1:])
    assert cond.dtype == logits.dtype == torch.bfloat16
    assert _rel_err(cond, jcond) <= SERVED_REL_BOUND
    assert _rel_err(logits, jlogits) <= SERVED_REL_BOUND
