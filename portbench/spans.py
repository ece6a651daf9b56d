"""The program's own spans of a traced window: ``tortoise_tpu_torch.utils.
profiling.spans()``, which the program fills while a profiler runs (each
span a ``record_function`` range as well, on the profiler's clock). A
program without that recorder, or a window whose ``tts.request`` spans do
not number its requests, gives None: nothing to read."""
from __future__ import annotations

REQUEST = "tts.request"


def window_spans(ctx) -> list | None:
    """The closed spans of the window, or None (see the module's text)."""
    from tortoise_tpu_torch.utils import profiling

    read = getattr(profiling, "spans", None)
    if read is None:
        return None
    closed = [s for s in read() if s.end_ns is not None]
    if sum(s.name == REQUEST for s in closed) != len(ctx.served):
        return None
    return closed


def durations_ms(ctx, name: str) -> list[float] | None:
    """Milliseconds of each span of the window named ``name``; None where
    there is no window to read or no such span."""
    spans = window_spans(ctx)
    if spans is None:
        return None
    got = [(s.end_ns - s.start_ns) / 1e6 for s in spans if s.name == name]
    return got or None


def mean_ms(ctx, name: str) -> float | None:
    got = durations_ms(ctx, name)
    return None if got is None else sum(got) / len(got)


def ms_per_audio_s(ctx, name: str) -> float | None:
    """The spans' milliseconds summed over the window, a second of audio served."""
    got = durations_ms(ctx, name)
    audio = sum(s.audio_s for s in ctx.served)
    if got is None or audio <= 0:
        return None
    return sum(got) / audio
