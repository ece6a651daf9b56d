"""The mean host milliseconds of an AR prefill: the program's
``tts.ar.prefill`` spans (``models/ar_sampler._prefill``: the prompt through
the prior into a fresh decode cache, and for a recurrent prior the fan-out
of its states to every candidate row, span ``tts.ar.fanout``, and the first
token's draw) over the traced window."""
from portbench.spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "tts.ar.prefill")
