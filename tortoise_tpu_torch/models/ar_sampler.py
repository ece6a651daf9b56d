"""Autoregressive mel-token sampler: prefill, then a Python decode loop.

Port of ``tortoise_tpu/models/ar_sampler.py`` (reference HF ``generate``,
tortoise/models/autoregressive.py:535-563). Semantics kept: the
repetition-penalty "seen" set starts with {1, start_mel} (HF's dummy prompt
of 1s), the s-th generated token enters with mel position s+2, a candidate
that emitted the stop token keeps emitting it.

Two drive modes share one step:
* ``sample_speech`` decodes a batch of candidates to the end;
* ``stream_speech`` (``prefill_segment`` + ``stream_continue``) decodes one
  utterance in segments and yields the codes and latents so far after each.
Both draw from the generator in the same order, so one seed gives the same
codes either way.

With ``settings.fused_step`` each decode step is kernel K2
(``ops/decode_step.py``) over all layers; otherwise the layer stack runs
``models.gpt2`` with the plain decode attention. Both write the new k/v rows
into the cache in place (quantized with their scales into an int8 cache).

Under a mesh ``sample_speech`` decodes this rank's rows of the candidate
batch (``batch_sharding``) into its part of the cache (``cache_sharding``,
whole heads over tp), with the per-layer stack: K2 is off, as in the JAX
package. Each draw is made at the global batch's shape and the rank's rows
taken, and the ranks of a dp group stop together, so the codes are those of
the unsplit decode.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from tortoise_tpu_torch.models.autoregressive import UnifiedVoice
from tortoise_tpu_torch.models.gpt2 import init_kv_cache, quantize_kv_rows
from tortoise_tpu_torch.ops import sampling
from tortoise_tpu_torch.ops.decode_step import fused_decode_step
from tortoise_tpu_torch.parallel.mesh import BatchShard
from tortoise_tpu_torch.parallel.sharding import all_ranks

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


@dataclasses.dataclass
class DecodeState:
    """A decode in progress: the cache, the last sampled tokens (B,), the
    repetition-penalty set, the stop latches, the generator, the mel step
    of the next token, the cache row it writes, and the rows' place in a
    batch split over dp (None unsplit)."""
    cache: dict
    tok: torch.Tensor
    seen: torch.Tensor
    finished: torch.Tensor
    generator: torch.Generator
    step: int
    pos: int
    shard: BatchShard | None = None


def _warp_and_sample(settings: SamplerSettings, logits, seen, generator, shard=None):
    if settings.do_sample and settings.typical_mass is None and settings.top_k > 0:
        return sampling.sample_topk_topp(
            generator, logits, seen, repetition_penalty=settings.repetition_penalty,
            temperature=settings.temperature, top_k=settings.top_k, top_p=settings.top_p,
            shard=shard)
    warped = sampling.process_logits(
        logits, seen, repetition_penalty=settings.repetition_penalty,
        temperature=settings.temperature if settings.do_sample else 1.0,
        top_k=settings.top_k if settings.do_sample else 0,
        top_p=settings.top_p if settings.do_sample else 1.0,
        typical_mass=settings.typical_mass)
    if settings.do_sample:
        return sampling.categorical(generator, warped, shard)
    return warped.argmax(dim=-1)


def _gpt_step(model: UnifiedVoice, settings: SamplerSettings, stacked, emb, cache, pos: int):
    """(B, 1, C) embedding -> post-ln_f hidden (B, C); writes the step's k/v
    rows into ``cache`` at ``pos`` in place. Into an int8 cache K2's bf16
    rows go quantized per (layer, batch, head), with the formula of the
    plain layer stack (``gpt2.quantize_kv_rows``)."""
    if settings.fused_step:
        heads = model.config.heads
        y, k_rows, v_rows = fused_decode_step(stacked, emb[:, 0], cache, pos, heads)
        if "k_scale" in cache:
            for name, rows in (("k", k_rows), ("v", v_rows)):
                cache[name][:, :, pos], cache[f"{name}_scale"][:, :, :, pos] = \
                    quantize_kv_rows(rows, heads)
        else:
            cache["k"][:, :, pos] = k_rows.to(cache["k"].dtype)
            cache["v"][:, :, pos] = v_rows.to(cache["v"].dtype)
        lnf = model.gpt.ln_f
        w, b = lnf.params()
        return F.layer_norm(y.float(), (y.shape[-1],), w, b, lnf.eps).to(emb.dtype)
    hidden, _ = model.gpt(emb, cache=cache, cache_index=pos)
    return hidden[:, 0]


def _prefill(model: UnifiedVoice, cond_latent, text_tokens, generator: torch.Generator,
             num_samples: int, settings: SamplerSettings, cache_dtype,
             batch_sharding: BatchShard | None = None, cache_sharding=None):
    """Prompt through the stack into a fresh cache, token 0 sampled. Returns
    (state, the latent of token 0 (B, D) f32 or None); under a mesh B is
    this rank's rows of the ``num_samples``."""
    cfg = model.config
    prompt = model.compute_prompt(cond_latent, text_tokens)
    if prompt.shape[0] != num_samples:
        prompt = prompt.expand(num_samples, -1, -1)
    if batch_sharding is not None:
        prompt = prompt[batch_sharding.rows(num_samples)]
    b, p_len, _ = prompt.shape
    dev = prompt.device
    # cache padded to a multiple of 256, as in the JAX sampler
    cache_len = -(-(p_len + settings.max_generate) // 256) * 256
    if cache_sharding is not None:
        assert cache_sharding.tp == (model.gpt.tp.size if model.gpt.tp else 1), \
            "the cache's tp split is not the stack's"
        cache = init_kv_cache(cfg.gpt_config, num_samples, cache_len, dtype=cache_dtype,
                              device=dev, sharding=cache_sharding)
    else:
        cache = init_kv_cache(cfg.gpt_config, b, cache_len, dtype=cache_dtype, device=dev)
    hidden, _ = model.gpt(prompt, cache=cache, cache_index=0)
    last_hidden = hidden[:, -1]
    seen = torch.zeros((b, cfg.number_mel_codes), dtype=torch.bool, device=dev)
    seen[:, 1] = True
    seen[:, cfg.start_mel_token] = True
    tok = _warp_and_sample(settings, model.hidden_to_mel_logits(last_hidden), seen, generator,
                           batch_sharding)
    seen[torch.arange(b, device=dev), tok] = True
    state = DecodeState(cache, tok, seen, tok == cfg.stop_mel_token, generator, 0, p_len,
                        batch_sharding)
    return state, (model.hidden_to_latent(last_hidden) if settings.emit_latents else None)


def _step(model: UnifiedVoice, settings: SamplerSettings, stacked, state: DecodeState):
    """One decode step: feeds ``state.tok``, samples the next token (stop once
    stopped). Returns (next tokens (B,), its latent (B, D) f32 or None)."""
    cfg = model.config
    emb = model.decode_embed(state.tok[:, None], state.step)
    h = _gpt_step(model, settings, stacked, emb, state.cache, state.pos)
    tok = _warp_and_sample(settings, model.hidden_to_mel_logits(h), state.seen, state.generator,
                           state.shard)
    tok = torch.where(state.finished, torch.full_like(tok, cfg.stop_mel_token), tok)
    state.finished = state.finished | (tok == cfg.stop_mel_token)
    state.seen[torch.arange(tok.shape[0], device=tok.device), tok] = True
    state.tok = tok
    state.step += 1
    state.pos += 1
    return tok, (model.hidden_to_latent(h) if settings.emit_latents else None)


def _check_stack(settings: SamplerSettings, stacked):
    if settings.fused_step and stacked is None:
        raise ValueError("settings.fused_step needs the stacked decode weights")


def sample_speech(model: UnifiedVoice, cond_latent, text_tokens, generator: torch.Generator,
                  num_samples: int, settings: SamplerSettings = SamplerSettings(),
                  cache_dtype=torch.bfloat16, stacked=None, batch_sharding=None,
                  cache_sharding=None):
    """Sample ``num_samples`` candidate mel-code sequences.

    cond_latent: (1, D) or (B, D); text_tokens: (1, T) or (B, T) long with
    the api-level stop pad. Returns (codes (B, max_generate) long, latents
    (B, max_generate, D) float32 or None): positions after a candidate's stop
    token hold the stop token. ``stacked`` is the K2 weight stack
    (``ops.decode_step.prepare_stacked_params``), needed with ``fused_step``.
    With ``batch_sharding`` (``parallel.mesh.BatchShard``) B is this rank's
    rows of the ``num_samples``; ``cache_sharding``
    (``parallel.sharding.KVCacheSharding``) splits the cache as the model's
    GPT stack is split over tp. Either turns ``fused_step`` off.
    """
    if batch_sharding is not None or cache_sharding is not None:
        # K2 decodes one device's whole stack; the split decode takes the layer stack
        settings = dataclasses.replace(settings, fused_step=False)
        stacked = None
    _check_stack(settings, stacked)
    cfg = model.config
    max_gen = settings.max_generate
    state, latent0 = _prefill(model, cond_latent, text_tokens, generator, num_samples,
                              settings, cache_dtype, batch_sharding, cache_sharding)
    b, dev = state.tok.shape[0], state.tok.device
    toks = torch.full((b, max_gen), cfg.stop_mel_token, dtype=torch.long, device=dev)
    toks[:, 0] = state.tok
    lats = None
    if settings.emit_latents:
        lats = torch.zeros((b, max_gen, cfg.model_dim), dtype=torch.float32, device=dev)
        lats[:, 0] = latent0
    for s in range(max_gen - 1):
        if s % FINISH_CHECK_EVERY == 0 and _all_finished(state):
            break
        tok, latent = _step(model, settings, stacked, state)
        toks[:, s + 1] = tok
        if lats is not None:
            lats[:, s + 1] = latent
    return toks, lats


def _all_finished(state: DecodeState) -> bool:
    """Every candidate latched its stop token: on every rank of a dp split,
    so all of them take the same number of draws from the generator."""
    done = state.finished.all()
    return bool(done) if state.shard is None else all_ranks(done, state.shard)


def _segment(model, settings, stacked, state: DecodeState, n: int):
    """``n`` decode steps -> (tokens (B, n), latents (B, n, D) f32)."""
    toks, lats = [], []
    for _ in range(n):
        tok, latent = _step(model, settings, stacked, state)
        toks.append(tok)
        lats.append(latent)
    return torch.stack(toks, 1), torch.stack(lats, 1)


def prefill_segment(model: UnifiedVoice, cond_latent, text_tokens, generator: torch.Generator,
                    settings: SamplerSettings, seg_len: int, cache_dtype=torch.bfloat16,
                    stacked=None):
    """Prompt, prefill and the first ``seg_len`` decode steps of one
    utterance (``settings.emit_latents`` must be on). Returns (state,
    codes (1, seg_len + 1) long, latents (1, seg_len + 1, D) f32)."""
    _check_stack(settings, stacked)
    state, latent0 = _prefill(model, cond_latent, text_tokens, generator, 1, settings,
                              cache_dtype)
    toks, lats = state.tok[:, None], latent0[:, None]
    if seg_len > 0:
        seg_toks, seg_lats = _segment(model, settings, stacked, state, seg_len)
        toks, lats = torch.cat([toks, seg_toks], 1), torch.cat([lats, seg_lats], 1)
    return state, toks, lats


def stream_continue(model: UnifiedVoice, state: DecodeState, toks, lats,
                    settings: SamplerSettings, seg_len: int, stacked=None):
    """Continue a ``prefill_segment`` decode whose (codes, latents) the caller
    has: yields the cumulative (codes (1, n), latents (1, n, D)) after each
    ``seg_len``-step segment, until the stop token latches or
    ``max_generate`` codes exist."""
    stop = model.config.stop_mel_token
    produced = toks.shape[1]
    finished = bool((toks[0] == stop).any())
    while produced < settings.max_generate and not finished:
        n = min(seg_len, settings.max_generate - produced)
        seg_toks, seg_lats = _segment(model, settings, stacked, state, n)
        toks, lats = torch.cat([toks, seg_toks], 1), torch.cat([lats, seg_lats], 1)
        produced += n
        finished = bool((seg_toks[0] == stop).any())
        yield toks, lats


def stream_speech(model: UnifiedVoice, cond_latent, text_tokens, generator: torch.Generator,
                  settings: SamplerSettings = SamplerSettings(), seg_len: int = 20,
                  cache_dtype=torch.bfloat16, first_seg_len: int | None = None, stacked=None):
    """Incremental decode of one utterance: yields cumulative (codes (1, n),
    latents (1, n, D) f32) after the first ``first_seg_len`` (default
    ``seg_len``) steps and then after each ``seg_len`` steps, stopping once
    the stop token latches."""
    first = min(first_seg_len or seg_len, max(settings.max_generate - 1, 0))
    state, toks, lats = prefill_segment(model, cond_latent, text_tokens, generator, settings,
                                        first, cache_dtype, stacked)
    yield toks, lats
    yield from stream_continue(model, state, toks, lats, settings, seg_len, stacked)
