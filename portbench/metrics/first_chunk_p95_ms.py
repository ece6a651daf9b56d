"""The 95th percentile, over every stream of the window, of the time from
the ``tts_stream`` call to its first yielded chunk (a CPU tensor), on the
host clock; closed loop, so measured from the send."""
from portbench.stats import percentile


def read(ctx):
    if ctx.mix["entry"] != "tts_stream" or not ctx.served:
        return None
    return 1000.0 * percentile([s.first - s.sent for s in ctx.served], 95)
