"""The mean host milliseconds of one diffusion sampler step (a guided
model call and the step's arithmetic): the program's ``tts.diffusion.step``
spans (``diffusion/sampler._loop``, no sync) over the traced window."""
from portbench.spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "tts.diffusion.step")
