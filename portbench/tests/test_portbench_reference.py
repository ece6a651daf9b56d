"""The frozen reference held to the port at a tiny width on the CPU, with
the benchmark's weights on both sides; and the same run with the reference
a step lower in precision fails the comparison."""
import random

import numpy as np
import torch

from portbench import control
from portbench import weights as bench_weights
from portbench.reference import clvp as ref_clvp
from portbench.reference import diffusion as ref_diffusion
from portbench.reference import sampler as ref_sampler
from portbench.reference import hifigan as ref_hifigan
from portbench.reference import unified_voice as ref_uv
from portbench.reference import univnet as ref_univnet
from portbench.reference.text import Tokenizer, conditioning_mels
from portbench.system import load_clips

SEED = 2 ** 31 + 99


def both(program, reference, name, suppressed=None):
    bench_weights.fill(program, name, SEED, suppressed)
    bench_weights.fill(reference, name, SEED, suppressed)
    return program.eval(), reference.eval()


def test_tokenizer_and_conditioning_mels_match_the_port():
    from tortoise_tpu_torch.ops import mel as mel_ops
    from tortoise_tpu_torch.utils.audio import format_conditioning
    from tortoise_tpu_torch.utils.tokenizer import VoiceBpeTokenizer
    text = "Mrs. Smith paid $5.20 for 3 books, the 2nd time today."
    assert Tokenizer().encode(text) == VoiceBpeTokenizer().encode(text)
    clips = load_clips("train_grace")
    rng = random.Random(7)
    port = torch.stack([format_conditioning(c, mel_ops.load_mel_norms(), "cpu", rng)
                        for c in clips], dim=1)
    assert torch.equal(port, conditioning_mels(clips, 7, "cpu"))


def test_unified_voice_served_and_reextracted():
    from tortoise_tpu_torch.models.ar_sampler import SamplerSettings, sample_speech
    from tortoise_tpu_torch.models.autoregressive import UnifiedVoice, UnifiedVoiceConfig
    prog, ref = both(UnifiedVoice(UnifiedVoiceConfig(layers=2, model_dim=128, heads=4)),
                     ref_uv.UnifiedVoice(ref_uv.Config(layers=2, model_dim=128, heads=4)),
                     "UnifiedVoice", ref_uv.SUPPRESSED)
    mels = conditioning_mels(load_clips("lj"), 3, "cpu")
    with torch.no_grad():
        cond = prog.get_conditioning(mels)
        assert torch.allclose(cond, ref.conditioning(mels), atol=1e-5)
        text = torch.tensor([[5, 6, 7, 8, 9, 0, 0, 0]])
        greedy = SamplerSettings(max_generate=20, top_p=1e-9, repetition_penalty=1.0)
        codes, _ = sample_speech(prog, cond, text, torch.Generator().manual_seed(1), 2, greedy,
                                 cache_dtype=torch.float32)
        logits, _ = ref.teacher_forced(cond.expand(2, -1), text.expand(2, -1), codes, True)
        assert torch.equal(logits.argmax(-1), codes)
        lat = prog(cond, text, codes[:1], wav_lengths=torch.tensor([20 * 1024]),
                   return_latent=True)
        _, ref_lat = ref.teacher_forced(cond, text, codes[:1], False)
        assert torch.allclose(lat, ref_lat, atol=1e-4)


def test_hifigan_diffusion_and_univnet():
    from tortoise_tpu_torch.models.diffusion_decoder import DiffusionTts, DiffusionTtsConfig
    from tortoise_tpu_torch.models.hifigan import HifiganConfig, HifiganGenerator
    from tortoise_tpu_torch.models.vocoder import UnivNetGenerator
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        prog, ref = both(HifiganGenerator(HifiganConfig(in_channels=64, cond_channels=64)),
                         ref_hifigan.Hifigan(64), "HifiganGenerator")
        lat, spk = torch.randn(1, 9, 64, generator=g), torch.randn(1, 64, generator=g)
        assert torch.allclose(prog.inference(lat, spk)[..., 0], ref(lat, spk), atol=1e-5)
        prog, ref = both(DiffusionTts(DiffusionTtsConfig(model_channels=64, num_layers=2,
                                                         num_heads=4, in_latent_channels=32)),
                         ref_diffusion.DiffusionTts(64, 2, 4, 32), "DiffusionTts")
        x, aligned = torch.randn(2, 40, 100, generator=g), torch.randn(2, 40, 64, generator=g)
        t, valid = torch.tensor([300, 300]), torch.tensor([40, 29])
        out = prog(x, t, aligned, valid_len=valid, rel_biases=prog.rel_bias_vectors(40))
        want = ref.step(x, t, aligned, valid)
        assert torch.allclose(out[0], want[0], atol=1e-4)
        assert torch.allclose(out[1, :29], want[1, :29], atol=1e-4)
        prog, ref = both(UnivNetGenerator(), ref_univnet.UnivNet(), "UnivNetGenerator")
        mel, z = torch.randn(1, 6, 100, generator=g), torch.randn(1, 6, 64, generator=g)
        assert torch.allclose(prog(mel, z)[..., 0], ref(mel, z), atol=1e-5)


def test_diffusion_conditioning():
    from tortoise_tpu_torch.models.diffusion_decoder import DiffusionTts, DiffusionTtsConfig
    prog, ref = both(DiffusionTts(DiffusionTtsConfig(model_channels=64, num_layers=1,
                                                     num_heads=4, in_latent_channels=32)),
                     ref_diffusion.DiffusionTts(64, 1, 4, 32), "DiffusionTts")
    g = torch.Generator().manual_seed(5)
    mels = torch.randn(1, 3, 40, 100, generator=g)
    lat = torch.randn(1, 64, 32, generator=g)           # 23 valid of a 64-frame bucket
    lat[:, 23:] = 0
    with torch.no_grad():
        voice = prog.get_conditioning(mels)
        assert torch.allclose(voice, ref.voice_latent(mels), atol=1e-4)
        out = prog.timestep_independent_bucketed(lat, torch.tensor([23]), voice,
                                                 torch.tensor([100]), 128)
        assert torch.allclose(out[:, :100], ref.aligned(lat[:, :23], voice, 100), atol=1e-4)


def test_clvp_scores():
    from tortoise_tpu_torch.models.clvp import CLVP, CLVPConfig
    cfg = CLVPConfig(dim_text=128, dim_speech=128, dim_latent=128, text_enc_depth=2,
                     speech_enc_depth=2, text_heads=2, speech_heads=2)
    prog, ref = both(CLVP(cfg), ref_clvp.CLVP(128, 2, 2), "CLVP")
    g = torch.Generator().manual_seed(2)
    text = torch.randint(0, 256, (1, 17), generator=g)
    cands = torch.randint(0, 8192, (5, 30), generator=g)
    cands[3, 7] = 8192                        # out of the speech vocabulary: -inf
    with torch.no_grad():
        got, want = prog.score_candidates(text, cands), ref.scores(text, cands, rows=2)
    assert torch.equal(torch.isinf(got), torch.isinf(want)) and bool(torch.isinf(want[3]))
    keep = torch.isfinite(want)
    assert torch.allclose(got[keep], want[keep], atol=1e-5)


def test_sampler_arithmetic():
    from tortoise_tpu_torch import api
    from tortoise_tpu_torch.diffusion.sampler import SamplerConfig, p_sample_loop
    from tortoise_tpu_torch.diffusion.schedule import spaced_schedule
    from tortoise_tpu_torch.ops import mel as mel_ops
    for n in (3, 30, 80, 200, 400):
        sched = spaced_schedule("linear", 4000, n)
        assert list(sched.timestep_map) == ref_sampler.spaced_timesteps(n)
        assert np.allclose(np.cumprod(1 - sched.betas), ref_sampler.alphas_cumprod(n),
                           rtol=1e-12)
    assert ref_sampler.settings({"preset": "fast"})["diffusion_iterations"] == 80
    g = torch.Generator().manual_seed(3)
    x, out = torch.randn(1, 20, 100, generator=g), torch.randn(2, 20, 200, generator=g)
    inputs = []

    def model_fn(xx, t):
        inputs.append(xx)
        return out

    got = p_sample_loop(model_fn, spaced_schedule("linear", 4000, 2), x,
                        torch.Generator().manual_seed(4),
                        SamplerConfig(cond_free=True, cond_free_k=2.0))
    assert torch.allclose(got, ref_sampler.last_step(inputs[-1], out, True, 2.0, 2, 1),
                          atol=1e-6)
    assert torch.allclose(mel_ops.denormalize_tacotron_mel(got), ref_sampler.denormalize(got))
    for codes in (np.array([5, 8193, 9, 8193, 7, 7]), np.array([83] * 12 + [5]),
                  np.arange(10)):
        fixed = api.fix_autoregressive_output(codes, 8193, complain=False)
        assert np.array_equal(fixed, ref_sampler.fix_codes(codes, 8193))
        assert api.calm_token_trim_length(fixed) == ref_sampler.calm_trim(fixed)


def test_a_lower_precision_fails_the_comparison():
    """The tiny quality pipeline in bf16 (its configuration) against the
    reference, and the reference in fp8 in its place: the control's numbers
    lie well above the program's, past the limits the sound run meets."""
    import os
    here = os.path.dirname(os.path.abspath(__file__))
    bench = {"configs": [{"name": "t", "file": os.path.join(here, "tiny-quality.json")}]}
    cell = {"name": "t", "config": "t", "chips": 1,
            "traffic": os.path.join(here, "tiny-preset.json")}
    limits = {"ar_gap": 0.05, "latent_err": 0.05, "clvp_err": 0.05, "diffusion_err": 0.05,
              "sampler_err": 1e-4, "vocoder_err": 1e-4, "structure_off": 0}
    r = control.readings(bench, cell, SEED, 0.5, device="cpu",
                         options={"gpt_fused_step": True, "autoregressive_batch_size": 2},
                         limits=limits)
    assert r["judged"] >= 1
    for name in ("latent_err", "diffusion_err"):
        assert r["control"][name] > 3 * r["program"][name], r
        assert r["program"][name] < 0.05 < r["control"][name], r
    assert r["program_correct"] and not r["control_correct"], r


def test_fp8_rounding_keeps_scale_and_loses_bits():
    from portbench.reference.layers import fp8_round
    x = torch.randn(1000, generator=torch.Generator().manual_seed(1)) * 1e-3
    err = float((fp8_round(x) - x).norm() / x.norm())
    assert 0.005 < err < 0.1
    assert np.isclose(float(fp8_round(x).abs().max()), float(x.abs().max()), rtol=0.07)
