"""The fast API's HiFi-GAN: the program's ``tts.hifigan`` spans (one a
decode or a stream chunk, each ending in its copy to the host), summed over
the traced window, in milliseconds a second of audio served."""
from portbench.spans import ms_per_audio_s


def read(ctx):
    return ms_per_audio_s(ctx, "tts.hifigan")
