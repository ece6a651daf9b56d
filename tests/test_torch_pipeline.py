"""The quality pipeline of the port against the JAX TextToSpeech at tiny
configs, stage by stage on shared inputs (float32, f32 KV cache), then the
port's tts_with_preset end to end."""
import glob
import os
import random
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tortoise_tpu import api as japi
from tortoise_tpu.api_fast import deterministic_state as jax_deterministic_state
from tortoise_tpu.models.ar_sampler import SamplerSettings as JaxSettings
from tortoise_tpu.models.ar_sampler import sample_speech as jax_sample
from tortoise_tpu.models.autoregressive import UnifiedVoiceConfig as JaxARConfig
from tortoise_tpu.models.clvp import CLVPConfig as JaxCLVPConfig
from tortoise_tpu.models.diffusion_decoder import DiffusionTtsConfig as JaxDiffConfig
from tortoise_tpu.ops.mel import denormalize_tacotron_mel
from tortoise_tpu.utils.audio import BUILTIN_VOICES_DIR, load_audio
from tortoise_tpu_torch import api as papi
from tortoise_tpu_torch.convert.from_jax import from_jax
from tortoise_tpu_torch.models.ar_sampler import SamplerSettings, sample_speech
from tortoise_tpu_torch.models.autoregressive import UnifiedVoiceConfig
from tortoise_tpu_torch.models.clvp import CLVPConfig
from tortoise_tpu_torch.models.diffusion_decoder import DiffusionTtsConfig
from tortoise_tpu_torch.utils.audio import load_voice

torch.set_num_threads(2)

TEXT = "Hello there, a short test."
SEED = 7
AR = dict(layers=2, model_dim=128, heads=4, max_text_tokens=60, max_mel_tokens=80)
DIFF = dict(model_channels=128, num_layers=2, in_latent_channels=128, num_heads=4)
CLVP = dict(dim_text=128, dim_speech=128, dim_latent=128, text_enc_depth=2, text_heads=4,
            speech_enc_depth=2, speech_heads=4)
CVVP_KW = dict(model_dim=64, transformer_heads=4, conditioning_enc_depth=2, speech_enc_depth=2)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a)).to(dtype)


@pytest.fixture(scope="module")
def pair():
    """A JAX and a port TextToSpeech holding the same weights (the UnivNet
    weights scaled to make the random gated stack contractive, as
    tests/test_api_quality.py does)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jtts = japi.TextToSpeech(
            autoregressive_batch_size=2, half=False, kv_cache_dtype="f32",
            enable_redaction=False, ar_config=JaxARConfig(**AR),
            diffusion_config=JaxDiffConfig(**DIFF), clvp_config=JaxCLVPConfig(**CLVP))
        ptts = papi.TextToSpeech(
            device="cpu", autoregressive_batch_size=2, half=False, kv_cache_dtype="f32",
            enable_redaction=False, ar_config=UnifiedVoiceConfig(**AR),
            diffusion_config=DiffusionTtsConfig(**DIFF), clvp_config=CLVPConfig(**CLVP))
    jtts.vocoder_vars = jax.tree_util.tree_map(lambda a: a * 0.15, jtts.vocoder_vars)
    for model, variables in ((ptts.autoregressive, jtts.ar_vars),
                             (ptts.diffusion, jtts.diffusion_vars),
                             (ptts.clvp, jtts.clvp_vars), (ptts.vocoder, jtts.vocoder_vars)):
        model.load_state_dict(from_jax(model, variables["params"]))
    return jtts, ptts


@pytest.fixture(scope="module")
def stages(pair):
    """Every stage of tts() on both sides; each port stage gets the JAX
    stage's input, so a fault shows where it starts."""
    jtts, ptts = pair
    out = {}
    # the JAX side reads the wavs directly: its load_voice also writes a clip
    # cache into the voice folder, which tests in other workers may read
    wavs = sorted(glob.glob(os.path.join(BUILTIN_VOICES_DIR, "train_dotrice", "*.wav")))
    clips = [load_audio(p, 22050) for p in wavs]
    pclips, _ = load_voice("train_dotrice")
    out["clips"] = (clips, pclips)

    out["tokens"] = (jtts.tokenizer.encode(TEXT), ptts.tokenizer.encode(TEXT))
    ids = np.pad(np.asarray(out["tokens"][0], np.int32)[None], ((0, 0), (0, 1)))
    text = np.pad(ids, ((0, 0), (0, 32 - ids.shape[1])))  # the text bucket

    jax_deterministic_state(SEED)
    ja, jd = jtts.get_conditioning_latents(clips)
    pa, pd = ptts.get_conditioning_latents(pclips, crop_rng=random.Random(SEED))
    out["latents"] = ((ja, jd), (pa, pd))

    settings = dict(do_sample=False, max_generate=20)
    jcodes, _ = jax_sample(jtts.autoregressive, jtts.ar_vars, jnp.asarray(ja), jnp.asarray(text),
                           jax.random.PRNGKey(0), 2, settings=JaxSettings(**settings),
                           cache_dtype=jnp.float32)
    with torch.no_grad():
        pcodes, _ = sample_speech(ptts.autoregressive, _t(ja), _t(text, torch.long),
                                  torch.Generator().manual_seed(0), 2,
                                  SamplerSettings(**settings), cache_dtype=torch.float32)
    out["codes"] = (np.asarray(jcodes), pcodes.numpy())

    # three distinct candidates for the re-ranking: the greedy decode and
    # two random ones (codes within CLVP's vocabulary)
    rng = np.random.default_rng(0)
    greedy = np.where(out["codes"][0][0] >= 8192, 8193, out["codes"][0][0])
    cands = np.stack([greedy, rng.integers(0, 8192, 20), rng.integers(0, 8192, 20)])
    jfixed = np.stack([japi.fix_autoregressive_output(c, 8193, complain=False) for c in cands])
    pfixed = np.stack([papi.fix_autoregressive_output(c, 8193, complain=False) for c in cands])
    out["fixed"] = (jfixed, pfixed)
    jscores = np.asarray(jtts._clvp_scores(jnp.asarray(ids), jnp.asarray(jfixed)))
    with torch.no_grad():
        pscores = ptts.clvp.score_candidates(_t(ids, torch.long), _t(jfixed, torch.long))
    out["scores"] = (jscores, pscores.numpy())

    best = jfixed[np.argsort(jscores)[::-1][:1]]
    jlat = np.asarray(jtts._relatent(jnp.asarray(ja), jnp.asarray(text), jnp.asarray(best)))
    with torch.no_grad():
        plat = ptts.autoregressive(_t(ja), _t(text, torch.long), _t(best, torch.long),
                                   wav_lengths=torch.full((1,), best.shape[1] * 1024),
                                   return_latent=True)
    out["relatent"] = (jlat, plat.numpy())

    # DDIM diffusion from one initial noise, the JAX side spelled out as in
    # tortoise_tpu/api.py::do_spectrogram_diffusion
    n = papi.calm_token_trim_length(best[0])
    lat = jlat[:, :n]
    n_bucket = -(-n // 64) * 64
    out_bucket, out_len = n_bucket * 4 * 24000 // 22050, n * 4 * 24000 // 22050
    # the port draws its initial noise first from the generator it is given
    noise = torch.randn((1, out_bucket, 100), generator=torch.Generator().manual_seed(1)).numpy()
    pre = jtts._timestep_independent_bucketed(
        jnp.pad(jnp.asarray(lat), ((0, 0), (0, n_bucket - n), (0, 0))), jnp.asarray(n),
        jnp.asarray(jd), jnp.asarray(out_len), out_bucket)
    uncond = jnp.broadcast_to(jtts.diffusion_vars["params"]["unconditioned_embedding"],
                              pre.shape)
    mask = (jnp.arange(out_bucket)[None, :, None] < out_len).astype(pre.dtype)
    loop = jtts._diffusion_loop(4, True, 2.0, "ddim")
    jmel = loop(jtts.diffusion_vars,
                (jnp.concatenate([pre, uncond * mask]), jtts._rel_biases(jtts.diffusion_vars,
                                                                         out_bucket)),
                jnp.asarray(noise), jax.random.PRNGKey(0), jnp.asarray(out_len))
    jmel = np.asarray(jnp.swapaxes(denormalize_tacotron_mel(jmel), 1, 2))[:, :, :out_len]
    with torch.no_grad():
        pmel = ptts.do_spectrogram_diffusion(
            _t(lat), _t(jd), diffusion_iterations=4, cond_free=True, cond_free_k=2.0,
            temperature=1.0, generator=torch.Generator().manual_seed(1), sampler="ddim")
    out["mel"] = (jmel, pmel.numpy())

    mel_btc = np.swapaxes(jmel, 1, 2)
    z = np.random.default_rng(2).standard_normal((1, out_len + 10, 64)).astype(np.float32)
    jwav = np.asarray(jtts._vocode(jnp.asarray(mel_btc), jnp.asarray(z)))
    with torch.no_grad():
        pwav = ptts.vocoder.inference(_t(mel_btc), _t(z))
    out["wav"] = (jwav, pwav.numpy())
    return out


def test_same_tokens_and_clips(stages):
    jt, pt = stages["tokens"]
    assert jt == pt and len(jt) > 5
    for a, b in zip(*stages["clips"]):
        np.testing.assert_array_equal(a, b)


def test_same_conditioning_latents(stages):
    (ja, jd), (pa, pd) = stages["latents"]
    np.testing.assert_allclose(pa.numpy(), ja, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(pd.numpy(), jd, rtol=1e-4, atol=1e-4)


def test_greedy_codes_token_exact(stages):
    jc, pc = stages["codes"]
    np.testing.assert_array_equal(pc, jc)


def test_same_clvp_winner(stages):
    jf, pf = stages["fixed"]
    np.testing.assert_array_equal(pf, jf)
    js, ps = stages["scores"]
    np.testing.assert_allclose(ps, js, rtol=1e-4, atol=1e-4)
    assert np.argmax(ps) == np.argmax(js)


def test_reextracted_latents(stages):
    jl, pl = stages["relatent"]
    np.testing.assert_allclose(pl, jl, rtol=1e-4, atol=1e-4)


def test_ddim_diffusion_from_same_noise(stages):
    jm, pm = stages["mel"]
    assert pm.shape == jm.shape
    # denormalized log-mel (range ~14): four DDIM steps of float32 drift
    np.testing.assert_allclose(pm, jm, rtol=1e-3, atol=1e-3)


def test_vocoder_same_z(stages):
    jw, pw = stages["wav"]
    assert pw.shape == jw.shape
    np.testing.assert_allclose(pw, jw, rtol=1e-4, atol=1e-4)


def test_tts_with_preset_end_to_end(pair):
    _, ptts = pair
    clips, _ = load_voice("train_dotrice")
    wav = ptts.tts_with_preset(TEXT, preset="ultra_fast", voice_samples=clips,
                               num_autoregressive_samples=2, diffusion_iterations=3,
                               max_mel_tokens=24, use_deterministic_seed=3, verbose=False)
    assert isinstance(wav, torch.Tensor) and wav.dtype == torch.float32
    assert wav.ndim == 3 and wav.shape[:2] == (1, 1) and wav.shape[2] % 256 == 0
    assert torch.isfinite(wav).all() and wav.abs().max() <= 1.0
    assert set(ptts.last_stage_timings) >= {"conditioning", "autoregressive", "clvp_rerank",
                                            "latent_reextraction", "diffusion", "vocoder"}


def test_unported_options_raise(pair):
    """The one refusal left of the options that once raised: cvvp_amount=1
    with no conditioning mels (latents given, not voice clips) raises the
    JAX package's ValueError, as tests/test_api_quality.py holds it to."""
    jtts, ptts = pair
    kw = dict(conditioning_latents=(np.zeros((1, 128)), np.zeros((1, 256))), cvvp_amount=1.0,
              num_autoregressive_samples=2, diffusion_iterations=2, max_mel_tokens=16,
              use_deterministic_seed=5, verbose=False)
    with pytest.raises(ValueError, match="cvvp_amount=1") as got:
        ptts.tts(TEXT, **kw)
    with pytest.raises(ValueError, match="cvvp_amount=1") as want:
        jtts.tts(TEXT, **kw)
    assert str(got.value) == str(want.value)


def test_redaction_defaults_on_and_degrades_without_weights(tmp_path):
    """enable_redaction defaults to True (reference api.py:196); with no
    wav2vec2 checkpoint the first bracketed request warns, returns finite
    unredacted audio and drops the aligner, as the JAX package does
    (tests/test_api_quality.py)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tts = papi.TextToSpeech(
            device="cpu", autoregressive_batch_size=2, half=False, models_dir=str(tmp_path),
            ar_config=UnifiedVoiceConfig(**AR), diffusion_config=DiffusionTtsConfig(**DIFF),
            clvp_config=CLVPConfig(**CLVP))
    assert tts.enable_redaction is True and tts.aligner is not None
    assert tts.aligner.device == torch.device("cpu")
    kw = dict(num_autoregressive_samples=2, diffusion_iterations=2, cond_free=False,
              max_mel_tokens=16, use_deterministic_seed=13, verbose=False)
    with pytest.warns(UserWarning, match="redaction disabled"):
        wav = tts.tts("[I am sad,] Hello there.", **kw)
    assert tts.aligner is None  # no retry on every call
    assert wav.shape[:2] == (1, 1) and wav.shape[2] % 256 == 0 and torch.isfinite(wav).all()
    assert "redact_finalize" in tts.last_stage_timings
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert torch.equal(tts.tts("[I am sad,] Hello there.", **kw), wav)


@pytest.fixture(scope="module")
def with_cvvp(pair, monkeypatch_module):
    """The pair with CVVP at 64 wide, depth 2: the JAX side's load_cvvp (its
    random weights, seed 4) at that config, the port's carrying them."""
    from tortoise_tpu.models.cvvp import CVVPConfig as JaxCVVPConfig
    from tortoise_tpu_torch.models.cvvp import CVVP, CVVPConfig

    jtts, ptts = pair
    monkeypatch_module.setattr(japi, "CVVPConfig", lambda: JaxCVVPConfig(**CVVP_KW))
    jtts.load_cvvp()
    ptts.cvvp = CVVP(CVVPConfig(**CVVP_KW))
    ptts.cvvp.load_state_dict(from_jax(ptts.cvvp, jtts.cvvp_vars["params"]))
    ptts.cvvp.eval()
    return jtts, ptts


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.mark.parametrize("amount", [0.5, 1.0])
def test_cvvp_mix_matches_jax(with_cvvp, amount, monkeypatch):
    """tts with voice clips and cvvp_amount in {0.5, 1}: the port's CVVP
    scores of each candidate against each clip equal the JAX _cvvp_scores on
    the same mels and codes, and the candidate that goes on to the diffusion
    is the best of the JAX package's mix of CVVP (mean over the clips) and
    CLVP scores."""
    jtts, ptts = with_cvvp
    seen = {"cvvp": [], "clvp": [], "best": []}

    def spy(fn, key):
        def wrapped(*args):
            out = fn(*args)
            seen[key].append([a.detach().clone() for a in args] + [out.detach().clone()])
            return out
        return wrapped

    monkeypatch.setattr(ptts.cvvp, "score_candidates", spy(ptts.cvvp.score_candidates, "cvvp"))
    monkeypatch.setattr(ptts.clvp, "score_candidates", spy(ptts.clvp.score_candidates, "clvp"))
    trim = papi.calm_token_trim_length
    monkeypatch.setattr(papi, "calm_token_trim_length",
                        lambda codes: seen["best"].append(codes.copy()) or trim(codes))
    clips, _ = load_voice("train_dotrice")
    wav = ptts.tts(TEXT, voice_samples=clips, cvvp_amount=amount, num_autoregressive_samples=2,
                   diffusion_iterations=2, max_mel_tokens=16, use_deterministic_seed=21,
                   verbose=False)
    assert torch.isfinite(wav).all() and "cvvp_rerank" in ptts.last_stage_timings
    assert len(seen["cvvp"]) == len(clips) and len(seen["clvp"]) == (amount != 1)
    assert ("clvp_rerank" in ptts.last_stage_timings) == (amount != 1)
    codes = seen["cvvp"][0][1].numpy()
    ok = (codes < 8192).all(axis=1)  # out-of-vocabulary candidates score -inf in the port
    jcvvp = []
    for mel, c, got in seen["cvvp"]:
        assert np.array_equal(c.numpy(), codes)
        want = np.asarray(jtts._cvvp_scores(jnp.asarray(np.repeat(mel.numpy(), len(codes), 0)),
                                            jnp.asarray(np.minimum(codes, 8191))))
        np.testing.assert_allclose(got.numpy()[ok], want[ok], rtol=1e-4, atol=1e-4)
        assert np.isneginf(got.numpy()[~ok]).all()
        jcvvp.append(want)
    mix = np.mean(jcvvp, axis=0)
    if amount != 1:
        text, c, _ = seen["clvp"][0]
        jclvp = np.asarray(jtts._clvp_scores(jnp.asarray(text.numpy()),
                                             jnp.asarray(np.minimum(c.numpy(), 8191))))
        mix = mix * amount + jclvp * (1 - amount)
    mix = np.where(ok, mix, -np.inf)
    np.testing.assert_array_equal(seen["best"][0], codes[np.argmax(mix)])


def test_tts_without_voice_uses_random_latents(pair):
    """No voice and no latents: random voice latents from the two random-latent
    generators, seeded by the request's seed."""
    _, ptts = pair
    kw = dict(num_autoregressive_samples=2, diffusion_iterations=2, max_mel_tokens=16,
              use_deterministic_seed=4, verbose=False)
    wav = ptts.tts(TEXT, **kw)
    assert wav.shape[:2] == (1, 1) and wav.shape[2] % 256 == 0 and torch.isfinite(wav).all()
    auto, diff = ptts.get_random_conditioning_latents(4)
    assert auto.shape == (1, 128) and diff.shape == (1, 256)
    assert torch.equal(ptts.get_random_conditioning_latents(4)[0], auto)


@pytest.mark.parametrize("kv_cache_dtype,gpt_weights", [("int8", "bf16"), ("int8", "int8"),
                                                        ("bf16", "int8_decode")])
def test_int8_options_run_end_to_end(kv_cache_dtype, gpt_weights):
    """The int8 cache and int8 GPT weights through tts_with_preset (bf16 model,
    K2's plain version on the CPU): a finite clip of the usual shape, K2's
    stack int8 where the weights are."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tts = papi.TextToSpeech(
            device="cpu", autoregressive_batch_size=2, enable_redaction=False,
            kv_cache_dtype=kv_cache_dtype, gpt_weights=gpt_weights, gpt_fused_step=True,
            ar_config=UnifiedVoiceConfig(**AR), diffusion_config=DiffusionTtsConfig(**DIFF),
            clvp_config=CLVPConfig(**CLVP))
    assert tts.kv_cache_dtype == {"int8": torch.int8, "bf16": torch.bfloat16}[kv_cache_dtype]
    assert (tts._ar_stacked["wqkv"].dtype == torch.int8) == (gpt_weights != "bf16")
    clips, _ = load_voice("train_dotrice")
    wav = tts.tts_with_preset(TEXT, preset="ultra_fast", voice_samples=clips,
                              num_autoregressive_samples=2, diffusion_iterations=2,
                              max_mel_tokens=16, use_deterministic_seed=3, verbose=False)
    assert wav.shape[:2] == (1, 1) and torch.isfinite(wav).all() and wav.abs().max() <= 1.0
