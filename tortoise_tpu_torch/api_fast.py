"""Fast / streaming TTS: the AR prior's latents decoded by HiFi-GAN.

Port of ``tortoise_tpu/api_fast.py`` (reference tortoise/api_fast.py:173-515):
tokenize -> conditioning latent -> one AR candidate (kernel K2 per decode
step on CUDA) -> teacher-forced latent re-extraction -> HiFi-GAN -> 24 kHz
wav, plus ``tts_stream``, which decodes the AR segment by segment and emits
each audio chunk from a fixed-size window of latents (O(chunk) per chunk,
where the reference re-decodes the whole prefix).

The JAX package fuses stages into single XLA dispatches and pads latents to
buckets to avoid recompiles; here the same stages run in order, eagerly, at
the exact length (its own tests show the padded and exact decodes equal on
the valid region). ``gpt_weights``: "bf16"; "int8", int8 block denses
throughout; "int8_decode", a bf16 model whose decode kernel streams int8
weights (half the bytes of each B=1 step, which the weight stream bounds).

``mesh`` (``parallel.mesh.make_mesh``, every rank of the group making the
same calls): the weights are broadcast from the first rank and
``tts_batch``'s utterances decode over dp when their number divides by it,
each rank vocoding its own; the single-utterance paths ignore the mesh, as
in the JAX package.
"""
from __future__ import annotations

import math
import random
from typing import Iterator

import numpy as np
import torch
import torch.nn.functional as F

from tortoise_tpu_torch import weights as weights_lib
from tortoise_tpu_torch.api import load_autoregressive, load_random_latent_converter
from tortoise_tpu_torch.models import ar_sampler
from tortoise_tpu_torch.models.ar_sampler import SamplerSettings, sample_speech
from tortoise_tpu_torch.models.autoregressive import UnifiedVoiceConfig
from tortoise_tpu_torch.models.hifigan import HifiganConfig, HifiganGenerator
from tortoise_tpu_torch.models.random_latent import sample_random_latent
from tortoise_tpu_torch.ops import mel as mel_ops
from tortoise_tpu_torch.parallel.mesh import batch_sharding, replicate_tree, replicated
from tortoise_tpu_torch.parallel.sharding import gather_rows
from tortoise_tpu_torch.presets import FAST_PRESETS, resolve_preset
from tortoise_tpu_torch.utils.audio import deterministic_state, format_conditioning
from tortoise_tpu_torch.utils.tokenizer import VoiceBpeTokenizer

# Streaming window geometry. A u-frame is one frame of the post-interpolation
# grid that enters the HiFi-GAN conv stack: 256 output samples.
_U_LEN = 256   # u-frames decoded per window
_W_LAT = 64    # latent frames fed per window (covers _U_LEN * 147 / 640 + edges)
_HALO_U = 32   # left context kept, not emitted: the conv receptive field (~15) + margin
_TAIL_U = 32   # right margin: samples within the receptive field of the decode
               # frontier change when more tokens arrive, so they are emitted later


def _u_frames(n_latents: int) -> int:
    """u-frames from n latent frames, floor(floor(4n) * 24000 / 22050) in
    integers; ``_expected_samples(n) == _u_frames(n) * 256``."""
    return (4 * n_latents * 24000) // 22050


def _expected_samples(n_latents: int) -> int:
    """Output samples of n latent frames after the two interpolations and the
    256x upsampling stack."""
    up1 = int(math.floor(n_latents * (1024.0 / 256.0)))
    up2 = int(math.floor(up1 * (24000.0 / 22050.0)))
    return up2 * 256


def handle_chunks(wav_gen: np.ndarray, wav_gen_prev, wav_overlap, overlap_len: int):
    """Streaming chunk crossfade (reference api_fast.py:285-308; copied from
    ``tortoise_tpu/api_fast.py``, which imports jax)."""
    wav_chunk = wav_gen[:-overlap_len]
    if wav_gen_prev is not None:
        wav_chunk = wav_gen[(wav_gen_prev.shape[0] - overlap_len):-overlap_len]
    if wav_overlap is not None:
        if overlap_len > len(wav_chunk):
            if wav_gen_prev is not None:
                wav_chunk = wav_gen[(wav_gen_prev.shape[0] - overlap_len):]
            else:
                wav_chunk = wav_gen[-overlap_len:]
            return wav_chunk, wav_gen, None
        crossfade = wav_chunk[:overlap_len].copy()
        crossfade *= np.linspace(0.0, 1.0, overlap_len, dtype=np.float32)
        wav_chunk = wav_chunk.copy()
        wav_chunk[:overlap_len] = wav_overlap * np.linspace(1.0, 0.0, overlap_len,
                                                            dtype=np.float32)
        wav_chunk[:overlap_len] += crossfade
    wav_overlap = wav_gen[-overlap_len:]
    wav_gen_prev = wav_gen
    return wav_chunk, wav_gen_prev, wav_overlap


class TextToSpeechFast:
    """Fast-path orchestrator (reference api_fast.TextToSpeech) on an explicit
    torch device. On CUDA every entry point decodes with kernel K2 unless
    ``gpt_fused_step=False`` (per instance, or per call of ``tts`` and
    ``tts_batch``); the CPU takes K2's plain version only when asked to."""

    def __init__(self, models_dir=None, tokenizer_vocab_file=None, tokenizer_basic=False,
                 dtype=torch.bfloat16, allow_random_weights=True,
                 ar_config: UnifiedVoiceConfig | None = None, text_bucket: int = 32,
                 gpt_weights="bf16", gpt_fused_step: bool | None = None, device="cuda",
                 mesh=None):
        # HiFi-GAN runs in float32 as in the JAX package: no TF32
        self.device = weights_lib.float32_device(device)
        is_cuda = self.device.type == "cuda"
        self.dtype = dtype
        self.gpt_fused_step = is_cuda if gpt_fused_step is None else bool(gpt_fused_step)
        # text pads to a multiple of this with the stop token (in-distribution:
        # training batches were padded the same way); 0 keeps the exact prompt
        self.text_bucket = text_bucket
        self.tokenizer = VoiceBpeTokenizer(vocab_file=tokenizer_vocab_file,
                                           use_basic_cleaners=tokenizer_basic)
        self.mel_norms = mel_ops.load_mel_norms().to(self.device)
        self._models_dir, self._allow_random = models_dir, allow_random_weights
        self.mesh = mesh
        self._batch_sharding = batch_sharding(mesh) if mesh is not None else None

        self.autoregressive, self.ar_source, self._ar_stacked = load_autoregressive(
            ar_config or UnifiedVoiceConfig(), gpt_weights, self.device, dtype, models_dir,
            allow_random_weights, self.gpt_fused_step, mesh)
        cfg = self.autoregressive.config
        with torch.device(self.device):
            self.hifi_decoder = HifiganGenerator(HifiganConfig(in_channels=cfg.model_dim,
                                                               cond_channels=cfg.model_dim))
        self.hifi_source = weights_lib.load_weights("hifidecoder", self.hifi_decoder, models_dir,
                                                    allow_random_weights, 1)
        self.hifi_decoder.eval()
        if mesh is not None:
            replicate_tree(self.hifi_decoder, mesh)
        self.rlg_auto = None
        self.last_codes = None  # natural-length codes of the last tts / tts_stream call

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def get_conditioning_latents(self, voice_samples, crop_rng: random.Random | None = None):
        """Clips (1, T) at 22.05 kHz -> the AR conditioning latent (1, D);
        clips over 6 s are cropped at offsets drawn from ``crop_rng``
        (reference api_fast.py:229-251)."""
        rng = crop_rng or random.Random()
        conds = torch.stack([format_conditioning(np.asarray(v), self.mel_norms, self.device, rng)
                             for v in voice_samples], dim=1)          # (1, n, T, 80)
        return self.autoregressive.get_conditioning(conds)

    @torch.inference_mode()
    def get_random_conditioning_latents(self, seed: int = 0):
        """A random voice's AR latent (1, D), from the generator seeded with ``seed``."""
        if self.rlg_auto is None:
            self.rlg_auto = load_random_latent_converter(
                "rlg_auto", self.autoregressive.config.model_dim, self.device,
                self._models_dir, self._allow_random, 2, self.mesh)
        return sample_random_latent(self.rlg_auto,
                                    torch.Generator(device=self.device).manual_seed(seed))

    # ------------------------------------------------------------------
    def _prepare(self, text, voice_samples, conditioning_latents, seed):
        """-> (seed, text tokens (1, T) long with the stop pad and bucket, AR
        conditioning latent (1, D)) on the device."""
        det_seed = deterministic_state(seed)
        cfg = self.autoregressive.config
        text_tokens = np.pad(np.asarray(self.tokenizer.encode(text), np.int64)[None],
                             ((0, 0), (0, 1)))                        # api-level pad
        # 400 for the shipped config (reference api_fast.py:448); a smaller
        # text position table lowers the limit
        limit = min(400, cfg.max_text_tokens - 2)
        if text_tokens.shape[-1] >= limit:
            raise ValueError(f"Too much text provided ({text_tokens.shape[-1]} tokens >= "
                             f"{limit}). Break the text up into separate segments.")
        if self.text_bucket:
            tb = min(-(-text_tokens.shape[1] // self.text_bucket) * self.text_bucket,
                     cfg.max_text_tokens)
            text_tokens = np.pad(text_tokens, ((0, 0), (0, tb - text_tokens.shape[1])))
        if voice_samples is not None:
            cond = self.get_conditioning_latents(voice_samples, crop_rng=random.Random(det_seed))
        elif conditioning_latents is not None:
            cond = torch.as_tensor(conditioning_latents, device=self.device)
            cond = cond[None] if cond.ndim == 1 else cond
        else:
            cond = self.get_random_conditioning_latents(det_seed)
        return det_seed, torch.as_tensor(text_tokens, device=self.device), cond

    def _clamp_mel_tokens(self, max_mel_tokens: int) -> int:
        """Generation stays inside the mel position table (a decode step uses
        position step + 2)."""
        return min(max_mel_tokens, self.autoregressive.config.mel_pos_len - 3)

    def _fused(self, override: bool | None) -> bool:
        return (self.gpt_fused_step if override is None else bool(override)) \
            and self._ar_stacked is not None

    def _trim_codes(self, codes: np.ndarray) -> int:
        """Natural length, the stop token included (as HF generate returns it)."""
        idx = np.where(codes == self.autoregressive.config.stop_mel_token)[0]
        return int(idx[0]) + 1 if len(idx) else len(codes)

    def _relatent(self, cond, text_tokens, codes):
        """Teacher-forced latents (B, n, D) f32 of sampled codes (reference
        api_fast.py:500-503)."""
        lengths = torch.full((codes.shape[0],), codes.shape[1] *
                             self.autoregressive.config.mel_length_compression,
                             device=self.device)
        return self.autoregressive(cond, text_tokens, codes, wav_lengths=lengths,
                                   return_latent=True).float()

    def _decode(self, latents, n: int, cond):
        """HiFi-GAN at the exact length: latents (1, >=n, D) -> (1, 1, S)
        float32 on the CPU, S = _expected_samples(n)."""
        wav = self.hifi_decoder.inference(latents[:, :n].float(), cond)
        return wav[:, :_expected_samples(n), 0][:, None, :].float().cpu()

    def _settings(self, max_mel_tokens, fused: bool, emit_latents: bool, **sampling):
        return SamplerSettings(max_generate=self._clamp_mel_tokens(max_mel_tokens),
                               fused_step=fused, emit_latents=emit_latents, **sampling)

    # ------------------------------------------------------------------
    def tts_with_preset(self, text, preset="fast", **kwargs):
        settings = resolve_preset(preset, FAST_PRESETS, **kwargs)
        for k in ("num_autoregressive_samples", "diffusion_iterations", "cond_free",
                  "cond_free_k", "diffusion_temperature", "length_penalty"):
            settings.pop(k, None)
        return self.tts(text, **settings)

    @torch.inference_mode()
    def tts(self, text, voice_samples=None, conditioning_latents=None, k=1, verbose=True,
            use_deterministic_seed=None, return_deterministic_state=False, temperature=0.8,
            repetition_penalty=2.0, top_p=0.8, top_k=50, max_mel_tokens=500,
            gpt_fused_step: bool | None = None, **unused_kwargs):
        """One clip: float32 (1, 1, S) CPU tensor at 24 kHz (reference
        api_fast.py:421-503). ``gpt_fused_step`` overrides the instance's
        choice for this call."""
        det_seed, text_t, cond = self._prepare(text, voice_samples, conditioning_latents,
                                               use_deterministic_seed)
        settings = self._settings(max_mel_tokens, self._fused(gpt_fused_step), False,
                                  temperature=temperature, top_k=top_k, top_p=top_p,
                                  repetition_penalty=repetition_penalty)
        gen = torch.Generator(device=self.device).manual_seed(det_seed)
        codes, _ = sample_speech(self.autoregressive, cond, text_t, gen, 1, settings,
                                 stacked=self._ar_stacked)
        wav = self._finish_wav(cond, text_t, codes)
        if return_deterministic_state:
            return wav, (det_seed, text, voice_samples, conditioning_latents)
        return wav

    def _finish_wav(self, cond, text_tokens, codes):
        """Sampled codes (1, m) -> wav: teacher-forced latents, trimmed after
        the stop token, decoded at their exact length."""
        codes_np = codes[0].cpu().numpy()
        n = self._trim_codes(codes_np)
        self.last_codes = codes_np[:n]
        return self._decode(self._relatent(cond, text_tokens, codes), n, cond)

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def tts_batch(self, texts, conditioning_latents=None, verbose=True,
                  use_deterministic_seed=None, temperature=0.8, repetition_penalty=2.0,
                  top_p=0.8, top_k=50, max_mel_tokens=500, text_bucket: int = 64,
                  gpt_fused_step: bool | None = None, **unused_kwargs):
        """N utterances decoded as one candidate batch. texts: N strings;
        conditioning_latents (N, D), (1, D), (D,) or None (one random voice).
        Texts pad to ``text_bucket`` multiples with the stop token. Returns a
        list of N float32 (1, 1, S_i) CPU tensors, on every rank of a mesh."""
        det_seed = deterministic_state(use_deterministic_seed)
        if self.mesh is not None:   # a seed from the clock differs between ranks
            det_seed = replicated(det_seed, self.mesh)
        cfg = self.autoregressive.config
        n = len(texts)
        ids = [self.tokenizer.encode(t) for t in texts]
        max_len = max(len(i) for i in ids) + 1  # api-level pad
        limit = min(400, cfg.max_text_tokens - 2)
        if max_len >= limit:
            raise ValueError(f"Too much text provided in at least one utterance (longest is "
                             f"{max_len} tokens >= {limit}).")
        tb = -(-max_len // text_bucket) * text_bucket if text_bucket else max_len
        tb = max(min(tb, cfg.max_text_tokens), max_len)
        toks = np.zeros((n, tb), np.int64)
        for r, seq in enumerate(ids):
            toks[r, :len(seq)] = seq
        toks = torch.as_tensor(toks, device=self.device)
        if conditioning_latents is None:
            cond = self.get_random_conditioning_latents(det_seed)
        else:
            cond = torch.as_tensor(conditioning_latents, device=self.device)
            cond = cond[None] if cond.ndim == 1 else cond
        cond = cond.expand(n, -1) if cond.shape[0] == 1 else cond
        settings = self._settings(max_mel_tokens, self._fused(gpt_fused_step), False,
                                  temperature=temperature, top_k=top_k, top_p=top_p,
                                  repetition_penalty=repetition_penalty)
        gen = torch.Generator(device=self.device).manual_seed(det_seed)
        shard = self._batch_sharding
        if shard is not None and n % shard.size:
            shard = None            # unsplit on every rank, as the JAX package falls back
        codes, _ = sample_speech(self.autoregressive, cond, toks, gen, n, settings,
                                 stacked=self._ar_stacked, batch_sharding=shard)
        if shard is None:
            latents = self._relatent(cond, toks, codes)
            codes = codes.cpu().numpy()
            return [self._decode(latents[r:r + 1], self._trim_codes(codes[r]), cond[r:r + 1])
                    for r in range(n)]
        # this rank's utterances, vocoded into a zeroed (n / dp, S_max) block
        rows = shard.rows(n)
        cond, toks = cond[rows], toks[rows]
        latents = self._relatent(cond, toks, codes)
        lengths = [self._trim_codes(c) for c in gather_rows(codes, shard).cpu().numpy()]
        sizes = [_expected_samples(m) for m in lengths]
        block = torch.zeros((codes.shape[0], max(sizes)), device=self.device)
        for j, r in enumerate(range(n)[rows]):
            block[j, :sizes[r]] = self._decode(latents[j:j + 1], lengths[r], cond[j:j + 1])[0, 0]
        wavs = gather_rows(block, shard).cpu()
        return [wavs[r:r + 1, None, :sizes[r]] for r in range(n)]

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def tts_stream(self, text, voice_samples=None, conditioning_latents=None, verbose=True,
                   use_deterministic_seed=None, stream_chunk_size=40, first_chunk_size=16,
                   overlap_wav_len=1024, temperature=0.8, repetition_penalty=2.0, top_p=0.8,
                   top_k=50, max_mel_tokens=500, **unused_kwargs) -> Iterator[torch.Tensor]:
        """Chunked streaming synthesis (reference api_fast.py:311-420): yields
        float32 1-D CPU tensors at 24 kHz.

        The AR decode runs ahead in segments (``first_chunk_size`` tokens,
        then ``stream_chunk_size``), and each chunk is decoded from a
        ``_W_LAT``-frame latent window with global interpolation indices and
        a halo wider than the conv stack's receptive field: the chunks are
        adjacent slices of the full decode of the stream's latents, so no
        crossfade is needed (``overlap_wav_len`` is accepted and unused).
        With ``first_chunk_size + 1 <= _W_LAT`` the first chunk comes from
        one window over the first segment's latents; otherwise the segments
        go through ``stream_speech`` from the start. Same seed, same codes as
        ``tts``."""
        del overlap_wav_len
        det_seed, text_t, cond = self._prepare(text, voice_samples, conditioning_latents,
                                               use_deterministic_seed)
        settings = self._settings(max_mel_tokens, self._fused(None), True,
                                  temperature=temperature, top_k=top_k, top_p=top_p,
                                  repetition_penalty=repetition_penalty)
        max_gen = settings.max_generate
        gen = torch.Generator(device=self.device).manual_seed(det_seed)
        ar, stacked = self.autoregressive, self._ar_stacked
        u_emit = 0  # emission frontier, in u-frames

        def emit_windows(latents, n, target_u):
            """Advance the frontier to ``target_u``; yields the chunks
            [u_emit, emit_to) at the JAX package's boundaries (at most
            _U_LEN - _HALO_U u-frames each). A chunk is cut from fixed-size
            window decodes that keep _HALO_U u-frames of context on each
            side, or reach the decode frontier, so it is an exact slice of
            the full decode. (The JAX package ends each window at the
            chunk's end: once the stream passes _U_LEN u-frames, the last
            receptive field of every chunk is decoded without its right
            context.)"""
            nonlocal u_emit
            u_valid = _u_frames(n)  # decode frontier: frames past it are masked
            while u_emit < target_u:
                emit_to = min(target_u, u_emit + (_U_LEN - _HALO_U))
                pieces, a = [], u_emit
                while a < emit_to:
                    u_start = max(0, a - _HALO_U)
                    end = u_valid if u_start + _U_LEN >= u_valid else u_start + _U_LEN - _HALO_U
                    b = min(emit_to, end)
                    # latent frames the window's interpolation reaches
                    lat_hi = min(n, (u_start + _U_LEN) * 147 // 640 + 3)
                    lat_off = max(0, lat_hi - _W_LAT)
                    lat_win = latents[:, lat_off:lat_off + _W_LAT]
                    lat_win = F.pad(lat_win, (0, 0, 0, _W_LAT - lat_win.shape[1]))  # never read
                    wav = self.hifi_decoder.inference_window(
                        lat_win, cond, lat_off, n, u_start, _U_LEN,
                        min(_U_LEN, max(0, u_valid - u_start)))
                    pieces.append(wav[0, (a - u_start) * 256:(b - u_start) * 256, 0])
                    a = b
                u_emit = emit_to
                yield torch.cat(pieces).float().cpu()

        first_len = min(first_chunk_size, stream_chunk_size, max(max_gen - 1, 0))
        if first_len + 1 <= _W_LAT:
            # the JAX package's fused head: the first segment's target counts
            # a stop token anywhere in it, and the chunk fits one window
            state, toks, latents = ar_sampler.prefill_segment(
                ar, cond, text_t, gen, settings, first_len, stacked=stacked)
            codes = toks[0].cpu().numpy()
            last_n, latents_f32 = self._trim_codes(codes), latents.float()
            stopped = last_n < len(codes)
            u_valid = _u_frames(last_n)
            hit = bool((codes == ar.config.stop_mel_token).any())
            yield from emit_windows(latents_f32, last_n,
                                    u_valid if hit else max(u_valid - _TAIL_U, 0))
            stream = ar_sampler.stream_continue(ar, state, toks, latents, settings,
                                                stream_chunk_size, stacked=stacked)
        else:
            latents_f32, last_n, stopped = None, 0, False
            stream = ar_sampler.stream_speech(ar, cond, text_t, gen, settings,
                                              seg_len=stream_chunk_size,
                                              first_seg_len=first_len, stacked=stacked)
        if not stopped:
            for codes, latents in stream:
                codes = codes[0].cpu().numpy()
                last_n, latents_f32 = self._trim_codes(codes), latents.float()
                stopped = last_n < len(codes)
                if stopped:
                    break
                # hold back the tail: those samples change as tokens arrive
                yield from emit_windows(latents_f32, last_n,
                                        max(0, _u_frames(last_n) - _TAIL_U))
        # final flush: the stop token latched or max_generate was reached
        self.last_codes = codes[:last_n]
        if latents_f32 is not None:
            yield from emit_windows(latents_f32, last_n, _u_frames(last_n))

    def deterministic_state(self, seed=None):
        return deterministic_state(seed)


# the reference's fast API calls its class TextToSpeech too (reference
# api_fast.py:173): ``from tortoise_tpu_torch.api_fast import TextToSpeech``
TextToSpeech = TextToSpeechFast
