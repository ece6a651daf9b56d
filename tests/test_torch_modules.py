"""Each module of the port against its JAX counterpart: same numpy inputs,
JAX weights carried over by convert/from_jax.py, float32 throughout."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tortoise_tpu import weights as jax_weights
from tortoise_tpu_torch.convert.from_jax import from_jax

torch.set_num_threads(2)
RTOL = ATOL = 1e-4  # f32 against f32 (jax_default_matmul_precision=highest)


def _random_params(init_fn, seed):
    """Every parameter random (kernels N(0, 1/fan_in); no zero-initialized
    output projections), host-side."""
    return jax_weights.host_init(init_fn, seed=seed)["params"]


def _load(port, params):
    port.load_state_dict(from_jax(port, params))
    return port.eval()


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a)).to(dtype)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(want), rtol=rtol, atol=atol)


def test_mel_front_ends():
    from tortoise_tpu.ops import mel as jmel
    from tortoise_tpu_torch.ops import mel as pmel

    rng = np.random.default_rng(0)
    t = np.arange(11025) / 22050
    wav = (0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(t.shape))
    wav = wav[None].astype(np.float32)
    norms = jmel.load_mel_norms(jmel.DEFAULT_MEL_NORMS_FILE)
    # log-mels: the two FFTs differ by float32 rounding only
    _close(pmel.tacotron_mel(_t(wav), pmel.load_mel_norms()),
           jmel.tacotron_mel(jnp.asarray(wav), norms), rtol=1e-3, atol=1e-3)
    _close(pmel.univnet_mel(_t(wav)), jmel.univnet_mel(jnp.asarray(wav)), rtol=1e-3, atol=1e-3)
    _close(pmel.denormalize_tacotron_mel(pmel.normalize_tacotron_mel(_t(wav))), wav)


def test_conditioning_encoder():
    from tortoise_tpu.models.blocks import ConditioningEncoder as J
    from tortoise_tpu_torch.models.blocks import ConditioningEncoder as P

    jm = J(80, 128, attn_blocks=2, num_attn_heads=4)
    x = np.random.default_rng(1).standard_normal((2, 50, 80)).astype(np.float32)
    params = _random_params(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    port = _load(P(80, 128, attn_blocks=2, num_attn_heads=4), params)
    with torch.no_grad():
        _close(port(_t(x)), jm.apply({"params": params}, jnp.asarray(x)))


@pytest.fixture(scope="module")
def voice():
    from tortoise_tpu.models.autoregressive import UnifiedVoice, UnifiedVoiceConfig
    from tortoise_tpu.models.autoregressive import init_unified_voice
    from tortoise_tpu_torch.models.autoregressive import UnifiedVoice as PV
    from tortoise_tpu_torch.models.autoregressive import UnifiedVoiceConfig as PC

    kw = dict(layers=2, model_dim=128, heads=4, max_text_tokens=40, max_mel_tokens=48)
    jm = UnifiedVoice(UnifiedVoiceConfig(**kw))
    params = _random_params(lambda: init_unified_voice(jm, 0), 2)
    return jm, params, _load(PV(PC(**kw)), params)


def test_unified_voice_teacher_forced_logits_and_latents(voice):
    jm, params, port = voice
    rng = np.random.default_rng(3)
    cond = rng.standard_normal((2, 128)).astype(np.float32)
    text = rng.integers(0, 255, (2, 9))
    codes = rng.integers(0, 8192, (2, 14))
    lens = np.full((2,), 14 * 1024)
    j_args = (jnp.asarray(cond), jnp.asarray(text), jnp.asarray(codes), jnp.asarray(lens))
    p_args = (_t(cond), _t(text, torch.long), _t(codes, torch.long), _t(lens, torch.long))
    jt, jmel = jm.apply({"params": params}, *j_args, return_logits=True)
    jlat = jm.apply({"params": params}, *j_args, return_latent=True)
    with torch.no_grad():
        pt, pmel = port(*p_args, return_logits=True)
        plat = port(*p_args, return_latent=True)
    _close(pt, jt)
    _close(pmel, jmel)
    _close(plat, jlat)


def test_unified_voice_conditioning_and_cached_prefill(voice):
    from tortoise_tpu.models.autoregressive import UnifiedVoice
    from tortoise_tpu.models.gpt2 import init_kv_cache
    from tortoise_tpu_torch.models.gpt2 import init_kv_cache as port_cache

    jm, params, port = voice
    rng = np.random.default_rng(4)
    mels = rng.standard_normal((1, 2, 40, 80)).astype(np.float32)
    cond = rng.standard_normal((1, 128)).astype(np.float32)
    text = rng.integers(0, 255, (1, 7))
    v = {"params": params}
    jcond = jm.apply(v, jnp.asarray(mels), method=UnifiedVoice.get_conditioning)
    prompt = jm.apply(v, jnp.asarray(cond), jnp.asarray(text),
                      method=UnifiedVoice.compute_prompt)
    cache = init_kv_cache(jm.config.gpt_config, 1, 256, dtype=jnp.float32)
    hidden, cache = jm.apply(v, prompt, cache, 0, method=UnifiedVoice.gpt_with_cache)
    logits = jm.apply(v, hidden[:, -1:], method=UnifiedVoice.hidden_to_mel_logits)
    with torch.no_grad():
        _close(port.get_conditioning(_t(mels)), jcond)
        pprompt = port.compute_prompt(_t(cond), _t(text, torch.long))
        _close(pprompt, prompt)
        pc = port_cache(port.config.gpt_config, 1, 256, dtype=torch.float32)
        phidden, _ = port.gpt(pprompt, cache=pc, cache_index=0)
        _close(phidden, hidden)
        _close(port.hidden_to_mel_logits(phidden[:, -1:]), logits)
        _close(pc["k"], cache["k"])


def test_sampling_warpers():
    from tortoise_tpu.ops import sampling as js
    from tortoise_tpu_torch.ops import sampling as ps

    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((6, 300)) * 3).astype(np.float32)
    seen = rng.random((6, 300)) < 0.1
    for kw in (dict(), dict(typical_mass=0.9), dict(temperature=1.0, top_k=0, top_p=1.0),
               dict(repetition_penalty=1.0, top_k=20, top_p=0.5)):
        want = np.asarray(js.process_logits(jnp.asarray(logits), jnp.asarray(seen), **kw))
        got = ps.process_logits(_t(logits), _t(seen, torch.bool), **kw).numpy()
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        _close(got[np.isfinite(got)], want[np.isfinite(want)])

    # the fused top-k/top-p sampler draws from softmax(process_logits(...))
    n = 4000
    row = np.repeat(logits[:1], n, axis=0)
    row_seen = np.repeat(seen[:1], n, axis=0)
    probs = np.asarray(jax.nn.softmax(js.process_logits(jnp.asarray(logits[:1]),
                                                        jnp.asarray(seen[:1]))))[0]
    draws = ps.sample_topk_topp(torch.Generator().manual_seed(0), _t(row),
                                _t(row_seen, torch.bool)).numpy()
    assert set(draws) <= set(np.nonzero(probs)[0])
    freq = np.bincount(draws, minlength=300) / n
    assert np.abs(freq - probs).max() < 0.03


def test_clvp_scores():
    from tortoise_tpu.models.clvp import CLVP, CLVPConfig
    from tortoise_tpu_torch.models.clvp import CLVP as PClvp
    from tortoise_tpu_torch.models.clvp import CLVPConfig as PConfig

    kw = dict(dim_text=128, dim_speech=128, dim_latent=128, text_enc_depth=2, text_heads=2,
              speech_enc_depth=2, speech_heads=2)
    jm = CLVP(CLVPConfig(**kw))
    params = _random_params(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 4), jnp.int32),
                                            jnp.zeros((1, 4), jnp.int32)), 6)
    port = _load(PClvp(PConfig(**kw)), params)
    rng = np.random.default_rng(7)
    text = rng.integers(0, 256, (1, 12))
    cands = rng.integers(0, 8192, (3, 20))
    want = jm.apply({"params": params}, jnp.asarray(text), jnp.asarray(cands),
                    method=CLVP.score_candidates)
    with torch.no_grad():
        got = port.score_candidates(_t(text, torch.long), _t(cands, torch.long))
        _close(got, want)
        cands[1, 5] = 8192  # the AR start token is outside CLVP's vocabulary
        got = port.score_candidates(_t(text, torch.long), _t(cands, torch.long))
    assert np.isneginf(got[1].item()) and np.isfinite(got[[0, 2]].numpy()).all()


@pytest.fixture(scope="module")
def diffusion():
    from tortoise_tpu.models.diffusion_decoder import (DiffusionTts, DiffusionTtsConfig,
                                                       init_diffusion_tts)
    from tortoise_tpu_torch.models.diffusion_decoder import DiffusionTts as PD
    from tortoise_tpu_torch.models.diffusion_decoder import DiffusionTtsConfig as PC

    kw = dict(model_channels=64, num_layers=2, in_latent_channels=32, num_heads=2)
    jm = DiffusionTts(DiffusionTtsConfig(**kw))
    params = _random_params(lambda: init_diffusion_tts(jm, jax.random.PRNGKey(0)), 8)
    return jm, params, _load(PD(PC(**kw)), params)


def test_diffusion_conditioning_and_forward(diffusion):
    from tortoise_tpu.models.diffusion_decoder import DiffusionTts, compute_rel_biases

    jm, params, port = diffusion
    v = {"params": params}
    rng = np.random.default_rng(9)
    mels = rng.standard_normal((1, 2, 24, 100)).astype(np.float32)
    lat = rng.standard_normal((1, 16, 32)).astype(np.float32)
    jcond = jm.apply(v, jnp.asarray(mels), method=DiffusionTts.get_conditioning)
    t, n_lat, out_len = 48, 9, 9 * 4 * 24000 // 22050
    jpre = jm.apply(v, jnp.asarray(lat), jnp.asarray(n_lat), jcond, jnp.asarray(out_len), t,
                    method=DiffusionTts.timestep_independent_bucketed)
    x = rng.standard_normal((2, t, 100)).astype(np.float32)
    pre2 = jnp.concatenate([jpre, jpre * 0.5])
    steps = np.array([10, 900])
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(steps), precomputed_aligned_embeddings=pre2,
                    valid_len=jnp.asarray(out_len),
                    rel_biases=compute_rel_biases(params, jm.config, t, dtype=jnp.float32))
    with torch.no_grad():
        pcond = port.get_conditioning(_t(mels))
        _close(pcond, jcond)
        ppre = port.timestep_independent_bucketed(
            _t(lat), torch.tensor([n_lat]), pcond, torch.tensor([out_len]), t)
        _close(ppre, jpre)
        for flash in (False, True):
            got = port(_t(x), _t(steps, torch.long), torch.cat([ppre, ppre * 0.5]),
                       valid_len=torch.tensor([out_len, out_len]),
                       rel_biases=port.rel_bias_vectors(t), flash=flash)
            _close(got[:, :out_len], np.asarray(want)[:, :out_len], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("sampler", ["p", "ddim"])
def test_diffusion_sampling_steps(diffusion, sampler):
    """Two steps of each loop with classifier-free guidance; the ancestral
    loop runs its mean trajectory (noise_scale=0), DDIM at eta=0 draws none."""
    from tortoise_tpu.diffusion.sampler import SamplerConfig as JCfg
    from tortoise_tpu.diffusion.sampler import make_ddim_sample_loop, make_p_sample_loop
    from tortoise_tpu.diffusion.schedule import spaced_schedule
    from tortoise_tpu.models.diffusion_decoder import compute_rel_biases
    from tortoise_tpu_torch.diffusion.sampler import (SamplerConfig, ddim_sample_loop,
                                                      p_sample_loop)

    jm, params, port = diffusion
    rng = np.random.default_rng(10)
    t, out_len = 32, 29
    noise = rng.standard_normal((1, t, 100)).astype(np.float32)
    pre = rng.standard_normal((2, t, 64)).astype(np.float32)
    schedule = spaced_schedule("linear", 4000, 2)
    rel = compute_rel_biases(params, jm.config, t, dtype=jnp.float32)

    def jfn(v, x, ts, pre_pack, doubled, valid_len=None):
        return jm.apply(v, x, ts, precomputed_aligned_embeddings=pre_pack,
                        rel_biases=rel, valid_len=valid_len)

    make = {"p": make_p_sample_loop, "ddim": make_ddim_sample_loop}[sampler]
    want = make(jfn, schedule, JCfg(noise_scale=0.0))(
        {"params": params}, jnp.asarray(pre), jnp.asarray(noise), jax.random.PRNGKey(0),
        jnp.asarray(out_len))
    rel_p = port.rel_bias_vectors(t)
    loop = {"p": p_sample_loop, "ddim": ddim_sample_loop}[sampler]
    with torch.no_grad():
        got = loop(lambda x, ts: port(x, ts, _t(pre), valid_len=torch.full((2,), out_len),
                                      rel_biases=rel_p),
                   schedule, _t(noise), torch.Generator().manual_seed(0),
                   SamplerConfig(noise_scale=0.0))
    _close(got[:, :out_len], np.asarray(want)[:, :out_len], rtol=2e-4, atol=2e-4)


def test_univnet_forward():
    from tortoise_tpu.models.vocoder import UnivNetConfig, UnivNetGenerator
    from tortoise_tpu_torch.models.vocoder import UnivNetGenerator as PU

    jm = UnivNetGenerator(UnivNetConfig())
    params = _random_params(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 12, 100)),
                                            jnp.zeros((1, 12, 64))), 11)
    # the random gated LVC stack is chaotic; scaled weights make it
    # contractive, as in tests/test_api_quality.py
    params = jax.tree_util.tree_map(lambda a: a * 0.15, params)
    port = _load(PU(), params)
    rng = np.random.default_rng(12)
    mel = rng.standard_normal((1, 6, 100)).astype(np.float32)
    z = rng.standard_normal((1, 16, 64)).astype(np.float32)
    want = jm.apply({"params": params}, jnp.asarray(mel), jnp.asarray(z),
                    method=UnivNetGenerator.inference)
    with torch.no_grad():
        got = port.inference(_t(mel), _t(z))
    assert got.shape == (1, 6 * 256, 1)
    _close(got, want)
