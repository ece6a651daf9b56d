"""The mean host milliseconds of one AR decode step: the program's
``tts.ar.step`` spans (``models/ar_sampler._step``: the step's launches and
its host work, no sync) over the traced window."""
from portbench.spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "tts.ar.step")
