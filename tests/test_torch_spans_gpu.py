"""The program's spans on the GPU: a tiny traced request of the quality and
the streaming pipeline, each span a host range of the profiler's (on its
clock), none on the device's timeline as a kernel, and no synchronisation
added by tracing.

This file imports neither jax nor the JAX package, so it also runs on a
machine with a GPU and no jax (tests/conftest.py imports jax; skip it there):

    python3 -m pytest --noconftest -m gpu tests/test_torch_spans_gpu.py

Without a CUDA device the cases skip.
"""
import warnings

import numpy as np
import pytest
import torch

from portbench import trace as bench_trace
from tortoise_tpu_torch.models.autoregressive import UnifiedVoiceConfig
from tortoise_tpu_torch.utils import profiling

torch.set_num_threads(2)

# heads 64 wide, the kernels' head dim
AR = dict(layers=2, model_dim=128, heads=2, max_text_tokens=60, max_mel_tokens=80)
TEXT = "Hello there, a short test."


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the spans are checked against the card's trace")
    return torch.device("cuda")


def _request(entry: str):
    """The entry point's tiny pipeline and one call of it."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if entry == "quality":
            from tortoise_tpu_torch.api import TextToSpeech
            from tortoise_tpu_torch.models.clvp import CLVPConfig
            from tortoise_tpu_torch.models.diffusion_decoder import DiffusionTtsConfig
            tts = TextToSpeech(
                device="cuda", enable_redaction=False, autoregressive_batch_size=2,
                ar_config=UnifiedVoiceConfig(**AR),
                diffusion_config=DiffusionTtsConfig(model_channels=128, num_layers=2,
                                                    in_latent_channels=128, num_heads=2),
                clvp_config=CLVPConfig(dim_text=128, dim_speech=128, dim_latent=128,
                                       text_enc_depth=2, text_heads=2, speech_enc_depth=2,
                                       speech_heads=2))
            rng = np.random.default_rng(0)
            latents = (rng.standard_normal((1, 128)), rng.standard_normal((1, 256)))
            return lambda: [tts.tts_with_preset(
                TEXT, preset="ultra_fast", conditioning_latents=latents,
                num_autoregressive_samples=2, diffusion_iterations=4, max_mel_tokens=24,
                use_deterministic_seed=3, verbose=False)]
        from tortoise_tpu_torch.api_fast import TextToSpeechFast
        tts = TextToSpeechFast(device="cuda", ar_config=UnifiedVoiceConfig(**AR))
        cond = np.random.default_rng(1).standard_normal((1, 128)).astype(np.float32)
        return lambda: list(tts.tts_stream(TEXT, conditioning_latents=cond, max_mel_tokens=24,
                                           first_chunk_size=8, stream_chunk_size=8,
                                           use_deterministic_seed=3, verbose=False))


def _syncs(call) -> int:
    """The synchronising CUDA calls ``call`` makes, by torch's sync debug mode."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ["quality", "stream"])
def test_spans_are_host_ranges_on_the_profilers_clock(cuda, entry):
    from torch.profiler import ProfilerActivity, profile

    call = _request(entry)
    call()                                   # kernels built, shapes met
    torch.cuda.synchronize()
    off = _syncs(call)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiling.spans().clear()
        on = _syncs(call)
        torch.cuda.synchronize()
    spans = list(profiling.spans())
    assert on == off > 0
    assert sum(s.name == "tts.request" for s in spans) == 1
    assert any(s.name == "tts.ar.step" for s in spans)
    assert any(s.name == ("tts.diffusion.step" if entry == "quality" else "tts.hifigan")
               for s in spans)
    device, host = bench_trace.events(prof)
    assert not [n for n, _, _ in device if n.startswith("tts.")]
    ranges = {}
    for name, start, end in host:
        ranges.setdefault(name, []).append((start, end))
    for s in spans:
        assert any(abs(s.start_ns - a) < 1_000_000 and abs(s.end_ns - b) < 1_000_000
                   for a, b in ranges.get(s.name, [])), s.name
