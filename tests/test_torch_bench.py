"""The port's benchmark program (tortoise_tpu_torch/bench.py) on the CPU:
the JAX bench's line, constants and key names, each section on tiny
instances, the candidate count it reports, and its refusal to fall back to
the CPU. The models are tiny (2 layers, 128 wide; a 32-channel HiFi-GAN),
the quality presets cut to 2 diffusion steps and, for high_quality, 4
candidates: the keys and counts are what is held, not the numbers."""
import importlib.util
import json
import math
import os
import warnings

import pytest
import torch

from tortoise_tpu_torch import bench
from tortoise_tpu_torch import weights as weights_lib
from tortoise_tpu_torch.api import TextToSpeech
from tortoise_tpu_torch.api_fast import TextToSpeechFast
from tortoise_tpu_torch.models.autoregressive import UnifiedVoiceConfig
from tortoise_tpu_torch.models.clvp import CLVPConfig
from tortoise_tpu_torch.models.diffusion_decoder import DiffusionTtsConfig
from tortoise_tpu_torch.models.hifigan import HifiganConfig, HifiganGenerator
from tortoise_tpu_torch.presets import QUALITY_PRESETS

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# max_mel_tokens 24: the long-form chunks (500 tokens asked) decode 21;
# max_text_tokens 160: the first chunk is 122 tokens
AR = dict(layers=2, model_dim=128, heads=4, max_text_tokens=160, max_mel_tokens=24)
DIFF = dict(model_channels=128, num_layers=1, in_latent_channels=128, num_heads=4)
CLVP = dict(dim_text=64, dim_speech=64, dim_latent=64, text_enc_depth=1, text_heads=2,
            speech_enc_depth=1, speech_heads=2)
TOKENS = 8
# the JAX headline's detail keys (root bench.py:278-285, 290)
HEADLINE_KEYS = {"p50_latency_s", "audio_s_per_run", "runs", "ar_tokens", "weights", "device",
                 "sections_skipped", "elapsed_s"}
QUALITY_ROW_KEYS = {"rtf", "p50_latency_s", "audio_s_per_run", "candidates", "vs_k80_baseline"}
SERVING_KEYS = {"utterances", "throughput_audio_s_per_s", "p50_wall_s", "audio_s_per_run"}


def _jax_bench():
    """The root bench.py, whose top level imports only the standard library."""
    spec = importlib.util.spec_from_file_location("jax_bench", os.path.join(ROOT, "bench.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _lines(out: str) -> list[dict]:
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


@pytest.fixture
def short_presets(monkeypatch):
    """Every quality preset at 2 diffusion steps; high_quality at 4 candidates."""
    for preset in QUALITY_PRESETS.values():
        monkeypatch.setitem(preset, "diffusion_iterations", 2)
    monkeypatch.setitem(QUALITY_PRESETS["high_quality"], "num_autoregressive_samples", 4)


def _quality(**kwargs) -> TextToSpeech:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return TextToSpeech(device="cpu", half=False, enable_redaction=False,
                            ar_config=UnifiedVoiceConfig(**AR),
                            diffusion_config=DiffusionTtsConfig(**DIFF),
                            clvp_config=CLVPConfig(**CLVP), **kwargs)


def _fast(**kwargs) -> TextToSpeechFast:
    """K2's plain version by default (gpt_fused_step=True), a 32-channel HiFi-GAN."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tts = TextToSpeechFast(device="cpu", dtype=torch.float32, gpt_fused_step=True,
                               ar_config=UnifiedVoiceConfig(**AR), **kwargs)
        tts.hifi_decoder = HifiganGenerator(HifiganConfig(
            in_channels=128, cond_channels=128, upsample_initial_channel=32))
        weights_lib.load_weights("hifidecoder", tts.hifi_decoder, None, True, 1)
    tts.hifi_decoder.eval()
    return tts


@pytest.fixture(scope="module")
def ctx():
    tts = _fast()
    c = bench.Context(tts, "cpu", TOKENS, bench.Runs(*[1] * 8))
    c.headline_rtf, c.headline_p50_s, _ = bench._measure(bench.fast_runner(tts, TOKENS), 1)
    return c


def test_constants_are_the_jax_bench_s():
    jb = _jax_bench()
    for name in ("SENTENCE", "PARAGRAPH", "LADDER", "REFERENCE_RTF", "REFERENCE_QUALITY_RTF"):
        assert getattr(bench, name) == getattr(jb, name), name


def test_paragraph_chunks_are_the_jax_package_s():
    from tortoise_tpu.utils.text import split_and_recombine_text as jax_split
    from tortoise_tpu_torch.utils.text import split_and_recombine_text

    chunks = split_and_recombine_text(bench.PARAGRAPH, 200, 300)
    assert chunks == jax_split(bench.PARAGRAPH, 200, 300) and len(chunks) == 2


def test_smoke_prints_the_jax_headline(capsys, monkeypatch):
    """The line's value and vs_baseline are the bench's roundings of the
    unrounded RTF it measured (recorded from ``bench._line``), exactly."""
    rtfs = []
    line = bench._line

    def record(metric, value, baseline, detail):
        rtfs.append(value)
        return line(metric, value, baseline, detail)

    monkeypatch.setattr(bench, "_line", record)
    detail = bench.main(["--smoke", "--device", "cpu", "--runs", "1"])
    lines = _lines(capsys.readouterr().out)
    last, rtf = lines[-1], rtfs[-1]
    assert last["metric"] == "fast_preset_rtf" and last["unit"] == "wall_sec_per_audio_sec"
    assert rtf > 0 and math.isfinite(rtf) and last["value"] > 0
    assert last["value"] == round(rtf, 4)
    assert last["vs_baseline"] == round(bench.REFERENCE_RTF / rtf, 3)
    assert HEADLINE_KEYS <= set(last["detail"]) and last["detail"] == detail
    assert detail["ar_tokens"] == 32 and detail["runs"] == 1 and detail["device"] == "cpu"
    assert detail["sections_skipped"] == []


def test_without_cuda_the_bench_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--smoke"])


@pytest.mark.parametrize("batch", [64, 128, 256])
def test_effective_candidates_are_the_candidates_sampled(batch, short_presets):
    qtts = _quality(autoregressive_batch_size=batch)
    for preset in ("ultra_fast", "fast", "standard"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            qtts.tts_with_preset(bench.SENTENCE, preset=preset, max_mel_tokens=2,
                                 use_deterministic_seed=0, verbose=False)
        assert len(qtts.last_candidates) == bench.effective_candidates(qtts, preset), preset


def test_quality_sections_fill_the_jax_keys(ctx, short_presets):
    detail = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        bench.section_quality_ladder(detail, ctx, _quality())
        bench.section_fast_int8_decode(detail, ctx, _quality(gpt_weights="int8_decode",
                                                             gpt_fused_step=True))
        bench.section_long_form(detail, ctx, _quality(kv_cache_dtype="int8"))
    ladder = detail["quality_ladder"]
    assert set(ladder) == {"ultra_fast", "fast", "standard", "fast_int8_decode",
                           "high_quality_int8kv"}
    for name, row in ladder.items():
        assert QUALITY_ROW_KEYS <= set(row) and row["rtf"] > 0, name
        assert {"autoregressive", "clvp_rerank", "diffusion", "vocoder"} <= set(row["stages_s"])
    assert ladder["fast_int8_decode"]["gpt_weights"] == "int8_decode"
    assert ladder["standard"]["candidates"] == 256 and ladder["fast"]["candidates"] == 96
    assert ladder["standard"]["ar_batch"] == 32     # the CPU's pick
    assert detail["quality_ladder_runs"] == 1
    long_form = detail["long_form_high_quality"]
    assert {"rtf", "rtf_min", "rtf_max", "runs", "p50_wall_s", "audio_s_per_run", "chunks",
            "preset", "kv_cache", "vs_k80_baseline"} <= set(long_form)
    assert long_form["chunks"] == 2 and long_form["kv_cache"] == "int8"


def test_fast_sections_fill_the_jax_keys(ctx):
    detail = {}
    bench.section_first_audio(detail, ctx, _fast(gpt_weights="int8_decode"))
    bench.section_serving_64(detail, ctx)
    bench.section_fused_ab(detail, ctx)
    bench.section_serving_8(detail, ctx)
    for kind in ("bf16_weights", "int8_decode"):
        assert {"median_ms", "min_ms", "first_chunk_audio_s", "first_chunk_tokens",
                "runs"} <= set(detail["first_audio_ms"][kind])
    assert {"rtf", "p50_latency_s"} <= set(detail["fast_int8_decode"])
    assert SERVING_KEYS <= set(detail["batched_serving"])
    assert detail["batched_serving"]["utterances"] == 64
    assert SERVING_KEYS <= set(detail["batched_serving_8"])
    # the instance decodes with K2 (its plain version here): "on" is the default
    assert set(detail["fused_ab"]) == {"fast_b1", "batch64"}
    for row in detail["fused_ab"].values():
        assert row["on"]["default"] is True and "default" not in row["off"]
    assert detail["fused_ab"]["fast_b1"]["on"]["rtf"] == round(ctx.headline_rtf, 4)


def test_run_sections_records_an_error_and_goes_on(ctx):
    """A section that raises leaves ``<name>_error``; the next still runs,
    and one over the budget is skipped."""
    def broken(detail, ctx):
        raise ValueError("boom")

    sections = (("broken", 1, lambda c: (), broken),
                ("serving_8", 1, lambda c: (), bench.section_serving_8),
                ("too_long", 1e9, lambda c: (), broken))
    detail = {}
    bench.run_sections(detail, ctx, remaining=lambda: 1e6, sections=sections)
    assert detail["broken_error"] == "ValueError: boom"
    assert "batched_serving_8" in detail and set(detail["section_times_s"]) == {
        "broken", "serving_8"}
    assert [s["section"] for s in detail["sections_skipped"]] == ["too_long"]
