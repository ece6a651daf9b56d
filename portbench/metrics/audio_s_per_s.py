"""Seconds of 24 kHz audio delivered by the requests completed in the
window, over the window's seconds (from its start to the last completion:
every request sent is completed)."""
from portbench.stats import rate


def read(ctx):
    return rate(sum(s.audio_s for s in ctx.served), ctx.window[0], ctx.window[1])
