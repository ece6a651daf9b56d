"""What the served requests of a window needed, counted from their shapes:
model operations (``flops``) and each kernel's least time (``kernels/``).

The shapes come from the requests themselves and from what the recorder
saw: a request's mel tokens and text, its AR decode steps (and of those
K2's launches, the program's counter), its diffusion calls' batches and
valid frames, its vocoder's frames and its wavs' lengths. A prompt is
counted at its unpadded length: the conditioning latent, the start token,
the text's tokens, the API's stop token, the stop token and the mel start
token. The AR prior's layer stack and conditioning encoder are counted by
the configuration's reference module (``reference.autoregressive``).
"""
from __future__ import annotations

import functools

from portbench import flops, reference
from portbench.kernels import k2, k3, k4
from portbench.reference.text import Tokenizer

COND_FRAMES = 132300 // 256 + 1   # the 6 s conditioning clip's mel frames
HOP = 256


@functools.lru_cache(maxsize=1)
def _tokenizer() -> Tokenizer:
    return Tokenizer()


def text_tokens(text: str) -> int:
    return len(_tokenizer().encode(text))


def prompt_len(text: str) -> int:
    return text_tokens(text) + 5


def k2_bound_s(served, mix: dict, config: dict) -> float:
    """Sum of K2's least time over the decode steps that ran K2."""
    ar = config["autoregressive"]
    p0 = sum(prompt_len(t) for t in served.request.texts) / len(served.request.texts)
    return served.batches * sum(k2.bound(ar["layers"], ar["model_dim"], served.batch, p0 + i)
                                for i in range(served.k2_steps // served.batches))


def k3_bound_s(served, config: dict) -> float:
    d = config["diffusion"]
    heads, head_dim = d["num_heads"], d["model_channels"] // d["num_heads"]
    calls = k3.calls_per_forward(d["num_layers"])
    return sum(calls * k3.bound(heads, head_dim, t, valid or [t] * b)
               for b, t, valid in served.diffusion_calls)


def k4_bound_s(served) -> float:
    return sum(k4.bound(f) for f in served.vocoder_frames)


def request_ops(served, mix: dict, config: dict) -> float:
    """The model operations a served request needed."""
    ar = config["autoregressive"]
    prior = reference.autoregressive(config)
    trunk = prior.trunk_ops
    c, vocab = ar["model_dim"], ar["number_mel_codes"]
    req = served.request
    b = served.batch
    steps = served.ar_steps // served.batches
    prompts = [prompt_len(t) for t in req.texts]
    p0 = sum(prompts) / len(prompts)
    # the prompt once a text, then each decode step of each batch, each with
    # the mel head
    ops = sum(trunk(ar, 1, p, 0) for p in prompts) + 2 * len(prompts) * c * vocab
    ops += served.batches * sum(trunk(ar, b, 1, int(p0) + i) + 2 * b * c * vocab
                                for i in range(steps))
    codes = steps + 1
    if mix["entry"] == "tts_with_preset":
        clips = len(_clips(req.voices[0]))
        v = config["clvp"]
        ops += prior.conditioning_ops(ar, COND_FRAMES, clips)
        ops += flops.clvp(v["dim_text"], v["text_enc_depth"], v["speech_enc_depth"],
                          text_tokens(req.texts[0]) + 1, codes, b * served.batches)
        # the winner's latents re-extracted: cond, start, text, stop, start, codes, stop
        ops += trunk(ar, 1, prompts[0] + codes + 1, 0)
        d = config["diffusion"]
        ops += sum(flops.diffusion_step(d["model_channels"], d["num_layers"],
                                        valid or [t] * bb)
                   for bb, t, valid in served.diffusion_calls)
        ops += sum(flops.univnet(f) for f in served.vocoder_frames)
    else:
        if mix["entry"] == "tts_batch":
            ops += sum(trunk(ar, 1, p + codes + 1, 0) for p in prompts)
        h = config["hifigan"]
        ops += sum(flops.hifigan(n // HOP, c, h["upsample_initial_channel"])
                   for n in served.wav_lengths)
    return ops


@functools.lru_cache(maxsize=None)
def _clips(voice: str):
    from portbench.system import load_clips
    return load_clips(voice)
