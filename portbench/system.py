"""The system under test: the port's public pipelines, built from a
configuration file and driven one request at a time.

``Driver`` makes a ``TextToSpeech`` (the quality pipeline) or a
``TextToSpeechFast`` (the fast one) of ``tortoise_tpu_torch`` with the
configuration's sizes and options, the AR prior's configuration class the
one its reference module names (``program_ar_config``); its models get the
benchmark's weights through the program's random-weights path
(``weights.install``).
``Driver.serve`` answers one ``traffic.Request`` through the mix's entry
point and returns what the client saw. The recorder's forward hooks keep
what the judged requests hand between stages (the latent re-extraction,
three diffusion steps, UnivNet and its blocks, HiFi-GAN's decodes) and,
for every request, the shapes the per-layer counts need. Its wrapper on
``models.ar_sampler._step``, the one decode step every AR path calls (K2,
the per-layer stack, the mesh), counts each request's decode steps;
``ops.decode_step.fused_decode_step.launches``, the program's counter of
K2 launches, counts those that ran K2.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import os
import random
import time
import types

import numpy as np
import torch
from scipy.io import wavfile

from portbench import reference
from portbench import weights as bench_weights
from portbench.reference import sampler as ref_sampler

HERE = os.path.dirname(os.path.abspath(__file__))
VOICES_DIR = os.path.join(HERE, "..", "tortoise_tpu", "voices")
SAMPLE_RATE = 24000
# the models besides the AR prior whose weights the benchmark makes (and the
# reference loads)
MADE = ("CLVP", "DiffusionTts", "UnivNetGenerator", "HifiganGenerator")


def made(config: dict) -> tuple[str, ...]:
    """The class names of the models whose weights the benchmark makes:
    the AR prior's from the configuration's reference module, then ``MADE``."""
    return (reference.autoregressive(config).NAME,) + MADE


def program_ar_config(config: dict):
    """The program's configuration class of the AR prior, which the
    configuration's reference module names (``PROGRAM_CONFIG``,
    ``"<module>:<class>"`` under ``tortoise_tpu_torch``)."""
    path = reference.autoregressive(config).PROGRAM_CONFIG
    module, _, cls = path.partition(":")
    if module.split(".")[0] != "tortoise_tpu_torch" or not cls:
        raise ValueError(f"PROGRAM_CONFIG {path!r} is no tortoise_tpu_torch '<module>:<class>'")
    return getattr(importlib.import_module(module), cls)


def load_config(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_clips(voice: str) -> list[np.ndarray]:
    """A built-in voice's wav clips as float32 (1, T) at 22.05 kHz."""
    folder = os.path.join(VOICES_DIR, voice)
    clips = []
    for name in sorted(os.listdir(folder)):
        if not name.endswith(".wav"):
            continue
        sr, data = wavfile.read(os.path.join(folder, name))
        if sr != 22050 or data.dtype != np.int16 or data.ndim != 1:
            raise ValueError(f"{voice}/{name}: expected mono int16 at 22050 Hz")
        clips.append((data.astype(np.float32) / 32768.0)[None])
    return clips


def voice_seed(seed: int, voice: str) -> int:
    """The crop seed of a voice's latent made at set-up (the fast pipeline)."""
    return (int(seed) * 7919 + sum(map(ord, voice))) % (2 ** 31 - 1)


@dataclasses.dataclass
class Served:
    """What one request gave back, with its client-side times (host clock,
    perf_counter seconds)."""
    request: object
    sent: float
    first: float
    done: float
    audio_s: float
    ar_steps: int                     # AR decode steps (``ar_sampler._step`` calls)
    k2_steps: int                     # of those, K2's launches
    batch: int                        # rows of each decode step
    batches: int                      # decode batches (the quality pipeline's)
    wav_lengths: list                 # samples of each wav served
    wavs: list | None = None          # CPU float32 1-D, kept for judged requests
    codes: np.ndarray | None = None   # the served codes, kept for judged requests
    stages: dict | None = None        # the quality API's stage seconds
    record: dict | None = None        # the recorder's tensors of a judged request
    diffusion_calls: list = dataclasses.field(default_factory=list)
    vocoder_frames: list = dataclasses.field(default_factory=list)


class Recorder:
    """Forward hooks on the pipeline's models, and recording wrappers on
    CLVP's ``score_candidates``, the diffusion's ``get_conditioning`` and
    ``timestep_independent_bucketed``, HiFi-GAN's ``inference_window`` and
    the AR sampler's module-level ``_step`` (restored by ``close``). For
    every request it counts the AR decode steps and lists the diffusion
    calls' (batch, frames, valid frames) and the vocoder's frames; for a
    judged request (``keep``) it copies to the host what each judged stage
    was given and gave: every diffusion call's timestep, the latent
    re-extraction's codes and latents, the diffusion's voice latent (its
    conditioning mels) and aligned embeddings (the winner's latents), its
    first, middle and last steps, CLVP's text, candidates and scores,
    UnivNet's noise, mel and output and each of its LVC blocks' input and
    output, and each HiFi-GAN decode's frames, speaker latent, valid
    frames, output and (a stream's window) first u-frame."""

    def __init__(self, tts):
        self.keep = False
        self.step_indices: set = set()
        self.u_start = None
        self.reset()
        self.handles = []
        hooks = [("autoregressive", self._relatent), ("diffusion", self._diffusion),
                 ("vocoder", self._vocoder), ("hifi_decoder", self._hifigan)]
        for name, hook in hooks:
            model = getattr(tts, name, None)
            if model is not None:
                self.handles.append(model.register_forward_hook(hook, with_kwargs=True))
        vocoder = getattr(tts, "vocoder", None)
        for i in range(len(vocoder.config.strides) if vocoder is not None else 0):
            self.handles.append(getattr(vocoder, f"lvc_{i}").register_forward_hook(
                lambda m, args, out, i=i: self._lvc(i, args, out)))
        self.wrapped = []
        from tortoise_tpu_torch.models import ar_sampler
        self._wrap(ar_sampler, "_step", self._ar_step)
        self._wrap(getattr(tts, "clvp", None), "score_candidates", self._clvp)
        self._wrap(getattr(tts, "diffusion", None), "get_conditioning", self._voice)
        self._wrap(getattr(tts, "diffusion", None), "timestep_independent_bucketed",
                   self._aligned)
        self._wrap(getattr(tts, "hifi_decoder", None), "inference_window", self._window)

    def _wrap(self, owner, method: str, record):
        """Route ``owner.method`` (a model's method or a module's function)
        through ``record(original, args, kwargs)``."""
        if owner is None:
            return
        original = getattr(owner, method)

        def wrapper(*args, **kwargs):
            return record(original, args, kwargs)

        setattr(owner, method, wrapper)
        self.wrapped.append((owner, method, original))

    def reset(self):
        self.ar_steps = 0
        self.diffusion_calls, self.vocoder_frames = [], []
        self.kept: dict = {"relatent": [], "diffusion": [], "vocoder": [], "lvc": [],
                           "hifigan": [], "clvp": [], "t": [], "voice": [], "aligned": []}

    def _ar_step(self, original, args, kwargs):
        self.ar_steps += 1
        return original(*args, **kwargs)

    def _relatent(self, module, args, kwargs, out):
        if self.keep:
            self.kept["relatent"].append({"codes": args[2].cpu().numpy(),
                                          "latents": out.float().cpu()})

    def _diffusion(self, module, args, kwargs, out):
        x, valid = args[0], kwargs.get("valid_len")
        index = len(self.diffusion_calls)
        if self.keep:
            self.kept["t"].append(args[1][0])
            if index in self.step_indices:
                self.kept["diffusion"].append({
                    "index": index, "x": x.float().cpu(), "t": args[1].cpu(),
                    "aligned": args[2].float().cpu(), "valid_len": valid.cpu(),
                    "out": out.float().cpu()})
        # the valid frames stay on the device until the request is answered
        self.diffusion_calls.append((x.shape[0], x.shape[1], valid))

    def _clvp(self, original, args, kwargs):
        scores = original(*args, **kwargs)
        if self.keep:
            self.kept["clvp"].append({"text": args[0].cpu(), "candidates": args[1].cpu(),
                                      "scores": scores.float().cpu()})
        return scores

    def _voice(self, original, args, kwargs):
        latent = original(*args, **kwargs)
        if self.keep:
            self.kept["voice"].append({"mels": args[0].float().cpu(),
                                       "latent": latent.float().cpu()})
        return latent

    def _aligned(self, original, args, kwargs):
        out = original(*args, **kwargs)
        if self.keep:
            latents, n, voice, frames = args[:4]
            n, frames = int(n.reshape(-1)[0]), int(frames.reshape(-1)[0])
            self.kept["aligned"].append({"latents": latents[:, :n].float().cpu(),
                                         "voice": voice.float().cpu(),
                                         "out": out[:, :frames].float().cpu()})
        return out

    def _window(self, original, args, kwargs):
        self.u_start = args[4]
        try:
            return original(*args, **kwargs)
        finally:
            self.u_start = None

    def _vocoder(self, module, args, kwargs, out):
        self.vocoder_frames.append(args[0].shape[1])
        if self.keep:
            self.kept["vocoder"].append({"mel": args[0].float().cpu(), "z": args[1].float().cpu(),
                                         "out": out.float().cpu()})

    def _lvc(self, i, args, out):
        if self.keep:
            self.kept["lvc"].append({"block": i, "x": args[0].float().cpu(),
                                     "mel": args[1].float().cpu(), "out": out.float().cpu()})

    def _hifigan(self, module, args, kwargs, out):
        if self.keep:
            self.kept["hifigan"].append({"x": args[0].float().cpu(), "g": args[1].float().cpu(),
                                         "valid": kwargs.get("valid_frames"),
                                         "u_start": self.u_start, "out": out.float().cpu()})

    def begin(self, keep: bool, n_steps: int = 0):
        """Start a request; a kept one keeps the first, middle and last of
        its ``n_steps`` diffusion steps."""
        self.reset()
        self.keep = keep
        self.step_indices = {0, n_steps // 2, n_steps - 1} if n_steps else set()

    def end(self):
        """The request answered: its calls' valid frames to the host."""
        self.diffusion_calls = [(b, f, None if v is None else v.tolist())
                                for b, f, v in self.diffusion_calls]
        self.kept["t"] = [int(t) for t in self.kept["t"]]

    def close(self):
        for h in self.handles:
            h.remove()
        for owner, method, original in reversed(self.wrapped):
            if isinstance(owner, types.ModuleType):
                setattr(owner, method, original)
            else:
                delattr(owner, method)


class Driver:
    """One pipeline instance and the inputs its mix needs."""

    def __init__(self, config: dict, mix: dict, seed: int, device="cuda", options=None):
        import tortoise_tpu_torch.weights as program_weights
        from tortoise_tpu_torch.ops import decode_step

        self.config, self.mix, self.seed = config, mix, int(seed)
        self.api = config["api"]
        self.device = device
        self.k2 = decode_step.fused_decode_step
        ar_ref = reference.autoregressive(config)
        self.specs = dict.fromkeys(made(config))
        self.clips = {v: load_clips(v) for v in mix["voices"]}
        with bench_weights.install(program_weights, seed, self.specs,
                                   {ar_ref.NAME: ar_ref.SUPPRESSED}):
            self.tts = self._build(options or {})
        self.latents = {}
        if self.api == "fast":
            for v, clips in self.clips.items():
                self.latents[v] = self.tts.get_conditioning_latents(
                    clips, crop_rng=random.Random(voice_seed(seed, v)))
        self.recorder = Recorder(self.tts)
        self.n_diffusion_steps = self._diffusion_steps()

    def _build(self, options: dict):
        cfg = self.config
        ctor = dict(cfg["constructor"])
        ar_config = program_ar_config(cfg)(**cfg["autoregressive"])
        if self.api == "quality":
            from tortoise_tpu_torch.api import TextToSpeech
            from tortoise_tpu_torch.models.clvp import CLVPConfig
            from tortoise_tpu_torch.models.diffusion_decoder import DiffusionTtsConfig
            return TextToSpeech(device=self.device, text_bucket=cfg["text_bucket"],
                                ar_config=ar_config,
                                diffusion_config=DiffusionTtsConfig(**cfg["diffusion"]),
                                clvp_config=CLVPConfig(**cfg["clvp"]), **ctor, **options)
        from tortoise_tpu_torch.api_fast import TextToSpeechFast
        ctor["dtype"] = getattr(torch, ctor["dtype"])
        return TextToSpeechFast(device=self.device, text_bucket=cfg["text_bucket"],
                                ar_config=ar_config, **ctor, **options)

    def _diffusion_steps(self) -> int:
        if self.mix["entry"] != "tts_with_preset":
            return 0
        return int(ref_sampler.settings(self.mix["kwargs"])["diffusion_iterations"])

    def _batch(self, req, kwargs) -> tuple[int, int]:
        """(rows of a decode step, decode batches): the quality pipeline
        decodes its candidates in batches of at most its AR batch size."""
        if self.mix["entry"] != "tts_with_preset":
            return len(req.texts), 1
        n = ref_sampler.settings(kwargs)["num_autoregressive_samples"]
        bs = min(n, self.tts.autoregressive_batch_size)
        return bs, max(1, n // self.tts.autoregressive_batch_size)

    def serve(self, req, keep: bool = False) -> Served:
        """Answer ``req``; ``keep`` keeps what the reference needs to judge it."""
        entry = self.mix["entry"]
        kwargs = req.kwargs(self.mix)
        self.recorder.begin(keep, self.n_diffusion_steps)
        steps0 = self.k2.launches
        sent = time.perf_counter()
        first = None
        wavs, codes, stages = [], None, None
        if entry == "tts_with_preset":
            wav = self.tts.tts_with_preset(
                req.texts[0], voice_samples=self.clips[req.voices[0]],
                use_deterministic_seed=req.seed, max_mel_tokens=req.mel_tokens, verbose=False,
                **kwargs)
            wavs = [wav[0, 0]]
            codes = self.tts.last_candidates
            stages = dict(self.tts.last_stage_timings)
        elif entry == "tts_stream":
            for chunk in self.tts.tts_stream(
                    req.texts[0], conditioning_latents=self.latents[req.voices[0]],
                    use_deterministic_seed=req.seed, max_mel_tokens=req.mel_tokens,
                    verbose=False, **kwargs):
                if first is None:
                    first = time.perf_counter()
                wavs.append(chunk)
            wavs = [torch.cat(wavs)]
            codes = np.asarray(self.tts.last_codes)
        else:
            cond = torch.cat([self.latents[v] for v in req.voices])
            wavs = [w[0, 0] for w in self.tts.tts_batch(
                req.texts, conditioning_latents=cond, use_deterministic_seed=req.seed,
                max_mel_tokens=req.mel_tokens, verbose=False,
                text_bucket=self.config.get("batch_text_bucket", 64), **kwargs)]
        done = time.perf_counter()
        self.recorder.end()
        lengths = [int(w.shape[-1]) for w in wavs]
        served = Served(req, sent, first or done, done, sum(lengths) / SAMPLE_RATE,
                        self.recorder.ar_steps, self.k2.launches - steps0,
                        *self._batch(req, kwargs), lengths,
                        stages=stages,
                        diffusion_calls=self.recorder.diffusion_calls,
                        vocoder_frames=self.recorder.vocoder_frames)
        if keep:
            served.wavs, served.codes = [w.float().cpu() for w in wavs], codes
            served.record = self.recorder.kept
        return served

    def close(self):
        self.recorder.close()
        del self.tts
