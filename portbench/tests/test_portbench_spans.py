"""The readers of the program's spans (``portbench/spans.py`` and the five
``metrics/`` files that use it) on synthetic spans, and on a program
without the span recorder."""
from types import SimpleNamespace

import pytest

from portbench import run
from tortoise_tpu_torch.utils import profiling

MS = 1_000_000   # ns


def _span(name, start_ms, length_ms, closed=True):
    return SimpleNamespace(name=name, start_ns=start_ms * MS,
                           end_ns=(start_ms + length_ms) * MS if closed else None)


def _ctx(audio_s):
    return SimpleNamespace(served=[SimpleNamespace(audio_s=a) for a in audio_s])


# two requests of 1.5 and 0.5 audio seconds: AR steps of 2, 4 and 6 ms,
# diffusion steps of 10 and 30 ms, HiFi-GAN decodes of 3 and 5 ms
SPANS = [_span("tts.request", 0, 100), _span("tts.ar.step", 1, 2), _span("tts.ar.step", 4, 4),
         _span("tts.diffusion.step", 10, 10), _span("tts.hifigan", 40, 3),
         _span("tts.request", 200, 100), _span("tts.ar.step", 201, 6),
         _span("tts.diffusion.step", 210, 30), _span("tts.hifigan", 250, 5)]
WANT = {"ar_host_ms_per_step": 4.0, "ar_host_ms_per_step.batch": 4.0,
        "diffusion_host_ms_per_step": 20.0, "stage_ms_per_audio_s.hifigan": 4.0,
        "stage_ms_per_audio_s.hifigan.batch": 4.0}


@pytest.mark.parametrize("metric", sorted(WANT))
def test_each_reader_on_synthetic_spans(metric, monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: SPANS)
    assert run.read_metric(metric, _ctx([1.5, 0.5])) == pytest.approx(WANT[metric])


@pytest.mark.parametrize("case", ["requests_miscounted", "no_such_span", "no_recorder",
                                  "open_request"])
def test_readers_give_none_when_there_is_nothing_to_read(case, monkeypatch):
    spans, served = SPANS, [1.5, 0.5]
    if case == "requests_miscounted":
        served = [1.5, 0.5, 1.0]
    elif case == "no_such_span":
        spans = [s for s in SPANS if s.name == "tts.request"]
    elif case == "open_request":
        spans = SPANS[:-4] + [_span("tts.request", 200, 0, closed=False)]
    if case == "no_recorder":   # the program before it had spans
        monkeypatch.delattr(profiling, "spans")
    else:
        monkeypatch.setattr(profiling, "spans", lambda: spans)
    for metric in WANT:
        assert run.read_metric(metric, _ctx(served)) is None, metric


def test_hifigan_reader_needs_audio(monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: SPANS)
    assert run.read_metric("stage_ms_per_audio_s.hifigan", _ctx([0.0, 0.0])) is None


@pytest.mark.parametrize("entry,metrics", [
    ("stream", ("ar_host_ms_per_step", "stage_ms_per_audio_s.hifigan")),
    ("batch", ("ar_host_ms_per_step.batch", "stage_ms_per_audio_s.hifigan.batch")),
    ("preset", ("ar_host_ms_per_step", "diffusion_host_ms_per_step"))])
def test_readers_on_a_tiny_traced_window(entry, metrics):
    """The program's own spans of two tiny requests served under the
    profiler (the CPU's: the harness's traced window takes the card's too)
    give every reader of the cell a positive number."""
    import os

    from torch.profiler import ProfilerActivity, profile

    from portbench import traffic
    from portbench.system import Driver, load_config

    here = os.path.dirname(os.path.abspath(__file__))
    config = load_config(os.path.join(here, "tiny-quality.json" if entry == "preset"
                                      else "tiny-fast.json"))
    mix = traffic.load_mix(os.path.join(here, f"tiny-{entry}.json"))
    options = {"gpt_fused_step": True}
    if entry == "preset":
        options["autoregressive_batch_size"] = 2
    driver = Driver(config, mix, 7, "cpu", options)
    gen = traffic.requests(mix, 7)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            profiling.spans().clear()
            served = [driver.serve(next(gen)) for _ in range(2)]
    finally:
        driver.close()
    ctx = SimpleNamespace(served=served)
    for metric in metrics:
        value = run.read_metric(metric, ctx)
        assert value is not None and value > 0, metric
