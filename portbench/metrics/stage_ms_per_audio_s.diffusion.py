"""The quality API's own span of its ``diffusion`` stage (``last_stage_timings``,
host clock, each stage ending in a synchronise or a copy to the host),
summed over the traced requests, in milliseconds a second of audio served."""


def read(ctx):
    timed = [s for s in ctx.served if s.stages and "diffusion" in s.stages]
    audio = sum(s.audio_s for s in timed)
    if not timed or audio <= 0:
        return None
    return 1000.0 * sum(s.stages["diffusion"] for s in timed) / audio
