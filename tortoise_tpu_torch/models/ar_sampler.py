"""Autoregressive mel-token sampler: prefill, then a Python decode loop.

Port of ``tortoise_tpu/models/ar_sampler.py::sample_speech`` (reference HF
``generate``, tortoise/models/autoregressive.py:535-563). Semantics kept:
the repetition-penalty "seen" set starts with {1, start_mel} (HF's dummy
prompt of 1s), the s-th generated token enters with mel position s+2, a
candidate that emitted the stop token keeps emitting it.

With ``settings.fused_step`` each decode step is kernel K2
(``ops/decode_step.py``) over all layers; otherwise the layer stack runs
``models.gpt2`` with the plain decode attention. Both write the new k/v rows
into the cache in place.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from tortoise_tpu_torch.models.autoregressive import UnifiedVoice
from tortoise_tpu_torch.models.gpt2 import init_kv_cache
from tortoise_tpu_torch.ops import sampling
from tortoise_tpu_torch.ops.decode_step import fused_decode_step

# the decode loop asks the device whether every candidate has finished only
# this often: each question is a host sync, and steps taken after the last
# stop only append stop tokens
FINISH_CHECK_EVERY = 8


@dataclasses.dataclass(frozen=True)
class SamplerSettings:
    temperature: float = 0.8
    top_k: int = 50
    top_p: float = 0.8
    repetition_penalty: float = 2.0
    typical_mass: float | None = None
    max_generate: int = 500
    do_sample: bool = True
    emit_latents: bool = True
    fused_step: bool = False


def _warp_and_sample(settings: SamplerSettings, logits, seen, generator):
    if settings.do_sample and settings.typical_mass is None and settings.top_k > 0:
        return sampling.sample_topk_topp(
            generator, logits, seen, repetition_penalty=settings.repetition_penalty,
            temperature=settings.temperature, top_k=settings.top_k, top_p=settings.top_p)
    warped = sampling.process_logits(
        logits, seen, repetition_penalty=settings.repetition_penalty,
        temperature=settings.temperature if settings.do_sample else 1.0,
        top_k=settings.top_k if settings.do_sample else 0,
        top_p=settings.top_p if settings.do_sample else 1.0,
        typical_mass=settings.typical_mass)
    if settings.do_sample:
        return sampling.categorical(generator, warped)
    return warped.argmax(dim=-1)


def _gpt_step(model: UnifiedVoice, settings: SamplerSettings, stacked, emb, cache, pos: int):
    """(B, 1, C) embedding -> post-ln_f hidden (B, C); writes the step's k/v
    rows into ``cache`` at ``pos`` in place."""
    if settings.fused_step:
        y, k_rows, v_rows = fused_decode_step(stacked, emb[:, 0], cache, pos,
                                              model.config.heads)
        cache["k"][:, :, pos] = k_rows.to(cache["k"].dtype)
        cache["v"][:, :, pos] = v_rows.to(cache["v"].dtype)
        lnf = model.gpt.ln_f
        w, b = lnf.params()
        return F.layer_norm(y.float(), (y.shape[-1],), w, b, lnf.eps).to(emb.dtype)
    hidden, _ = model.gpt(emb, cache=cache, cache_index=pos)
    return hidden[:, 0]


def sample_speech(model: UnifiedVoice, cond_latent, text_tokens, generator: torch.Generator,
                  num_samples: int, settings: SamplerSettings = SamplerSettings(),
                  cache_dtype=torch.bfloat16, stacked=None):
    """Sample ``num_samples`` candidate mel-code sequences.

    cond_latent: (1, D) or (B, D); text_tokens: (1, T) long with the
    api-level stop pad. Returns (codes (B, max_generate) long, latents
    (B, max_generate, D) float32 or None): positions after a candidate's stop
    token hold the stop token. ``stacked`` is the K2 weight stack
    (``ops.decode_step.prepare_stacked_params``), needed with ``fused_step``.
    """
    cfg = model.config
    if settings.fused_step and stacked is None:
        raise ValueError("settings.fused_step needs the stacked decode weights")
    prompt = model.compute_prompt(cond_latent, text_tokens)
    if prompt.shape[0] != num_samples:
        prompt = prompt.expand(num_samples, -1, -1)
    b, p_len, _ = prompt.shape
    dev = prompt.device
    max_gen = settings.max_generate
    # cache padded to a multiple of 256, as in the JAX sampler
    cache_len = -(-(p_len + max_gen) // 256) * 256
    cache = init_kv_cache(cfg.gpt_config, b, cache_len, dtype=cache_dtype, device=dev)
    hidden, _ = model.gpt(prompt, cache=cache, cache_index=0)
    last_hidden = hidden[:, -1]
    logits = model.hidden_to_mel_logits(last_hidden)

    rows = torch.arange(b, device=dev)
    seen = torch.zeros((b, cfg.number_mel_codes), dtype=torch.bool, device=dev)
    seen[:, 1] = True
    seen[:, cfg.start_mel_token] = True
    tok = _warp_and_sample(settings, logits, seen, generator)
    finished = tok == cfg.stop_mel_token
    seen[rows, tok] = True
    toks = torch.full((b, max_gen), cfg.stop_mel_token, dtype=torch.long, device=dev)
    toks[:, 0] = tok
    lats = None
    if settings.emit_latents:
        lats = torch.zeros((b, max_gen, cfg.model_dim), dtype=torch.float32, device=dev)
        lats[:, 0] = model.hidden_to_latent(last_hidden)

    pos = p_len
    for s in range(max_gen - 1):
        if s % FINISH_CHECK_EVERY == 0 and bool(finished.all()):
            break
        emb = model.decode_embed(tok[:, None], s)
        h = _gpt_step(model, settings, stacked, emb, cache, pos)
        logits = model.hidden_to_mel_logits(h)
        tok = _warp_and_sample(settings, logits, seen, generator)
        tok = torch.where(finished, torch.full_like(tok, cfg.stop_mel_token), tok)
        finished = finished | (tok == cfg.stop_mel_token)
        seen[rows, tok] = True
        toks[:, s + 1] = tok
        if lats is not None:
            lats[:, s + 1] = model.hidden_to_latent(h)
        pos += 1
    return toks, lats
