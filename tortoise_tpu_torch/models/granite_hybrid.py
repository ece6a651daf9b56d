"""Granite-4.0-H-Micro as Tortoise's autoregressive prior: a hybrid stack of
Mamba-2 and attention layers over UnifiedVoice's inputs and heads.

The trunk is IBM's ``granitemoehybrid`` (HF ``GraniteMoeHybridModel``,
https://huggingface.co/ibm-granite/granite-4.0-h-micro/blob/main/config.json):
40 layers 2048 wide, a Mamba-2 mixer in every layer but 5, 15, 25 and 35,
which hold grouped-query attention (32 query and 8 key/value heads of 64)
with no position encoding; a SwiGLU MLP 8192 wide in every layer; RMSNorm;
muP's multipliers: the inputs x12, the attention scale 1/64, each residual
branch x0.22, the logits /8. A layer is ``h + 0.22 mixer(rms(h))``, then
``h + 0.22 mlp(rms(h))``. The Mamba-2 mixer: ``in_proj`` -> z (4096), xBC
(4352), dt (64); a causal depthwise conv of width 4 with bias, then SiLU,
over xBC; dt = softplus(dt + dt_bias); A = -exp(A_log); the SSD recurrence
h_t = exp(dt A) h_{t-1} + dt x_t B_t^T, y_t = h_t C_t + D x_t over 64 heads
of 64 with a 128-wide state in one group; the gated RMSNorm rms(y silu(z))
over all 4096 channels; ``out_proj``.

Tortoise's side is UnifiedVoice's: the conditioning encoder (here 2048 wide
with 32 heads), the text and mel embeddings (no position tables: the trunk
is NoPE), the prompt [cond | start, text, stop, stop | start_mel], the mel
head with its bias, and the final norm's output as the latent. Granite's
100352-token vocabulary and its tied head are not used.

The residual stream is float32 (mamba_ssm's ``residual_in_fp32``); the
products run in the weights' dtype, the norms, the conv, the scan and the
attention's softmax in float32. ``A_log``, ``D`` and ``dt_bias`` stay
float32 when the model is cast (``weights.cast_for_inference``).

Serving (``models/ar_sampler.py``): ``prefill`` runs the prompt once, the
Mamba layers by the chunked SSD scan, and fans its states out to every
candidate row of a decode cache the model keeps for each batch size
(``decode_cache``): the SSM state (36, B, 64, 64, 128) and conv state (36,
B, 4352, 3) in the weights' dtype, the attention layers' keys and values
(4, B, 8, T, 64) over a fixed T, and the position on the device.
``decode_step`` runs the 40 layers for one token a row, each Mamba layer's
recurrence in kernel ``ssm_decode_step`` (``ops/ssm_step.py``); on the card
(eval, no grad) its first call for a cache computes eagerly and captures a
CUDA graph of the step, which every later call replays. Attention reads
the cache's full length, masked by the device-side position, so one graph
serves every length.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from tortoise_tpu_torch.models.blocks import ConditioningEncoder
from tortoise_tpu_torch.models.layers import Conv1d, Dense, Embed
from tortoise_tpu_torch.ops.ssm_step import ssm_decode_step
from tortoise_tpu_torch.utils import profiling
from tortoise_tpu_torch.utils.graphs import Graphs


@dataclasses.dataclass(frozen=True)
class GraniteVoiceConfig:
    layers: int = 40
    model_dim: int = 2048
    attention_layers: tuple = (5, 15, 25, 35)
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    attention_multiplier: float = 0.015625
    mamba_n_heads: int = 64
    mamba_d_head: int = 64
    mamba_d_state: int = 128
    mamba_n_groups: int = 1
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_chunk_size: int = 256
    shared_intermediate_size: int = 8192
    embedding_multiplier: float = 12.0
    residual_multiplier: float = 0.22
    logits_scaling: float = 8.0
    rms_norm_eps: float = 1e-5
    conditioning_heads: int = 32
    max_text_tokens: int = 402
    max_mel_tokens: int = 604
    max_conditioning_inputs: int = 2
    mel_length_compression: int = 1024
    number_text_tokens: int = 255
    start_text_token: int = 255
    stop_text_token: int = 0
    number_mel_codes: int = 8194
    start_mel_token: int = 8192
    stop_mel_token: int = 8193

    def __post_init__(self):
        object.__setattr__(self, "attention_layers", tuple(self.attention_layers))
        if not all(0 <= i < self.layers for i in self.attention_layers):
            raise ValueError(f"attention_layers {self.attention_layers} outside {self.layers} "
                             "layers")
        if self.mamba_n_heads * self.mamba_d_head != self.mamba_inner:
            raise ValueError(f"mamba_n_heads x mamba_d_head = "
                             f"{self.mamba_n_heads * self.mamba_d_head}, not mamba_expand x "
                             f"model_dim = {self.mamba_inner}")
        if self.mamba_n_groups != 1:
            raise ValueError("mamba_n_groups: one group (B and C shared by all heads) only")

    @property
    def mamba_inner(self) -> int:
        return self.mamba_expand * self.model_dim

    @property
    def conv_dim(self) -> int:
        return self.mamba_inner + 2 * self.mamba_n_groups * self.mamba_d_state

    @property
    def head_dim(self) -> int:
        return self.model_dim // self.num_attention_heads

    @property
    def mamba_layers(self) -> tuple:
        return tuple(i for i in range(self.layers) if i not in self.attention_layers)

    @property
    def text_vocab(self) -> int:
        return self.number_text_tokens + 1

    @property
    def mel_pos_len(self) -> int:
        return self.max_mel_tokens + 2 + self.max_conditioning_inputs

    @property
    def cache_rows(self) -> int:
        """The attention cache's length: the longest prompt (the text
        limit, start, stop, conditioning and mel start) and the longest
        decode, in multiples of 256."""
        return -(-(self.max_text_tokens + 4 + self.mel_pos_len - 3) // 256) * 256

    def cache_bytes_per_candidate(self) -> int:
        """One candidate row of the bf16 decode cache: SSM and conv state of
        the Mamba layers, keys and values of the attention layers."""
        ssm = self.mamba_n_heads * self.mamba_d_head * self.mamba_d_state
        conv = self.conv_dim * (self.mamba_d_conv - 1)
        kv = 2 * self.num_key_value_heads * self.cache_rows * self.head_dim
        return 2 * (len(self.mamba_layers) * (ssm + conv) + len(self.attention_layers) * kv)


class RMSNorm(nn.Module):
    """HF's ``GraniteMoeHybridRMSNorm`` in float32: x rsqrt(mean x^2 + eps) w."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x):
        return F.rms_norm(x.float(), (x.shape[-1],), self.weight.float(), self.eps)


def segsum(x):
    """(..., T) -> (..., T, T): [i, j] = x[j+1] + ... + x[i] for j <= i, -inf
    above the diagonal (the SSD reference's stable segment sum)."""
    t = x.shape[-1]
    x = x[..., None].expand(*x.shape, t)
    below = torch.ones(t, t, dtype=torch.bool, device=x.device).tril(-1)
    sums = x.masked_fill(~below, 0).cumsum(-2)
    return sums.masked_fill(~torch.ones_like(below).tril(), float("-inf"))


def ssd_chunked(x, dt, a, bm, cm, chunk: int):
    """The SSD recurrence over a whole sequence, chunk by chunk (Mamba-2's
    ``ssd_minimal_discrete``), float32: x (B, T, H, P), dt (B, T, H) after
    its softplus, a (H,), bm and cm (B, T, N) (one group). Returns (y
    (B, T, H, P) without D x, the state after the last token (B, H, P, N)).
    The sequence pads to a multiple of ``chunk`` with dt = 0: no decay and
    no input, so the final state is the last real token's."""
    b, t, h, p = x.shape
    pad = -t % chunk
    if pad:
        x, dt, bm, cm = (F.pad(v, (0, 0) * (v.dim() - 2) + (0, pad)) for v in (x, dt, bm, cm))
    c = (t + pad) // chunk
    xd = (x * dt[..., None]).reshape(b, c, chunk, h, p)
    da = (dt * a).reshape(b, c, chunk, h).permute(0, 3, 1, 2)             # (B, H, C, L)
    bm, cm = bm.reshape(b, c, chunk, -1), cm.reshape(b, c, chunk, -1)
    cum = da.cumsum(-1)
    within = torch.exp(segsum(da))                                         # (B, H, C, L, L)
    y = torch.einsum("bcln,bcsn,bhcls,bcshp->bclhp", cm, bm, within, xd)
    decay = torch.exp(cum[..., -1:] - cum)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", bm, decay, xd)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], 1)
    across = torch.exp(segsum(F.pad(cum[..., -1], (1, 0))))                # (B, H, C+1, C+1)
    states = torch.einsum("bhzc,bchpn->bzhpn", across, states)
    y = y + torch.einsum("bcln,bchpn,bhcl->bclhp", cm, states[:, :-1], torch.exp(cum))
    return y.reshape(b, c * chunk, h, p)[:, :t], states[:, -1]


class MambaMixer(nn.Module):
    def __init__(self, cfg: GraniteVoiceConfig):
        super().__init__()
        self.cfg = cfg
        d, h = cfg.model_dim, cfg.mamba_n_heads
        self.in_proj = Dense(d, cfg.mamba_inner + cfg.conv_dim + h, bias=False)
        self.conv1d = Conv1d(cfg.conv_dim, cfg.conv_dim, cfg.mamba_d_conv, groups=cfg.conv_dim)
        self.dt_bias = nn.Parameter(torch.ones(h))
        self.A_log = nn.Parameter(torch.ones(h))
        self.D = nn.Parameter(torch.ones(h))
        self.norm = RMSNorm(cfg.mamba_inner, cfg.rms_norm_eps)
        self.out_proj = Dense(cfg.mamba_inner, d, bias=False)

    def _split(self, u):
        cfg = self.cfg
        return self.in_proj(u).split([cfg.mamba_inner, cfg.conv_dim, cfg.mamba_n_heads], -1)

    def _out(self, y, z):
        """The gated RMSNorm over all inner channels, then out_proj."""
        gated = F.rms_norm(y * F.silu(z.float()), (y.shape[-1],), self.norm.weight.float(),
                           self.norm.eps)
        return self.out_proj(gated.to(z.dtype))

    def forward(self, u):
        """u (B, T, C) -> (out (B, T, C), final SSM state (B, H, P, N) f32,
        conv state (B, conv_dim, K - 1): the last K - 1 inputs, zeros before
        the first)."""
        cfg = self.cfg
        b, t, _ = u.shape
        k = cfg.mamba_d_conv
        z, xbc, dt = self._split(u)
        conv_state = F.pad(xbc, (0, 0, k - 1, 0))[:, -(k - 1):].transpose(1, 2)
        conv = F.conv1d(F.pad(xbc.float().transpose(1, 2), (k - 1, 0)),
                        self.conv1d.weight.float(), self.conv1d.bias.float(),
                        groups=cfg.conv_dim).transpose(1, 2)
        x, bm, cm = F.silu(conv).split([cfg.mamba_inner, cfg.mamba_d_state,
                                        cfg.mamba_d_state], -1)
        x = x.reshape(b, t, cfg.mamba_n_heads, cfg.mamba_d_head)
        dt = F.softplus(dt.float() + self.dt_bias.float())
        y, state = ssd_chunked(x, dt, -torch.exp(self.A_log.float()), bm, cm,
                               cfg.mamba_chunk_size)
        y = (y + self.D.float()[:, None] * x).reshape(b, t, cfg.mamba_inner)
        return self._out(y, z), state, conv_state

    def decode(self, u, conv_state, state, counters):
        """u (B, C), one token a row; updates the layer's conv and SSM state."""
        z, xbc, dt = self._split(u)
        y = ssm_decode_step(xbc, dt, conv_state, self.conv1d.weight, self.conv1d.bias,
                            self.dt_bias, self.A_log, self.D, state, counters)
        return self._out(y, z)


class Attention(nn.Module):
    """Grouped-query attention with no position encoding, scale
    ``attention_multiplier``; query head i reads key/value head i // (32 / 8)."""

    def __init__(self, cfg: GraniteVoiceConfig):
        super().__init__()
        self.cfg = cfg
        d, hd = cfg.model_dim, cfg.head_dim
        self.q_proj = Dense(d, cfg.num_attention_heads * hd, bias=False)
        self.k_proj = Dense(d, cfg.num_key_value_heads * hd, bias=False)
        self.v_proj = Dense(d, cfg.num_key_value_heads * hd, bias=False)
        self.o_proj = Dense(cfg.num_attention_heads * hd, d, bias=False)

    def _qkv(self, u):
        """q (B, T, G, R, D), k and v (B, T, G, D)."""
        cfg = self.cfg
        b, t, _ = u.shape
        g, hd = cfg.num_key_value_heads, cfg.head_dim
        q = self.q_proj(u).reshape(b, t, g, cfg.num_attention_heads // g, hd)
        return q, self.k_proj(u).reshape(b, t, g, hd), self.v_proj(u).reshape(b, t, g, hd)

    def forward(self, u):
        """Causal attention over u (B, T, C) -> (out, k, v (B, G, T, D))."""
        q, k, v = self._qkv(u)
        b, t = u.shape[:2]
        s = torch.einsum("btgrd,bsgd->bgrts", q.float(), k.float()) * self.cfg.attention_multiplier
        causal = torch.ones(t, t, dtype=torch.bool, device=u.device).tril()
        w = torch.softmax(s.masked_fill(~causal, float("-inf")), -1)
        o = torch.einsum("bgrts,bsgd->btgrd", w, v.float()).reshape(b, t, -1)
        return self.o_proj(o.to(u.dtype)), k.transpose(1, 2), v.transpose(1, 2)

    def decode(self, u, kc, vc, pos):
        """u (B, C), one token a row at cache row ``pos`` (a (1,) device
        tensor); writes its key and value into kc, vc (B, G, T, D) there and
        attends over rows 0..pos of the whole cache."""
        q, k, v = self._qkv(u[:, None])
        b, g, t, hd = kc.shape
        kc.index_copy_(2, pos, k.transpose(1, 2).to(kc.dtype))
        vc.index_copy_(2, pos, v.transpose(1, 2).to(vc.dtype))
        q = q[:, 0].to(kc.dtype)                                           # (B, G, R, D)
        s = torch.matmul(q, kc.transpose(-1, -2)).float() * self.cfg.attention_multiplier
        s = s.masked_fill(torch.arange(t, device=u.device) > pos, float("-inf"))
        o = torch.matmul(torch.softmax(s, -1).to(vc.dtype), vc)
        return self.o_proj(o.reshape(b, -1).to(u.dtype))


class SharedMLP(nn.Module):
    """SwiGLU: ``output_linear(silu(gate) * up)``, gate and up the two halves
    of ``input_linear``'s output."""

    def __init__(self, cfg: GraniteVoiceConfig):
        super().__init__()
        d, i = cfg.model_dim, cfg.shared_intermediate_size
        self.input_linear = Dense(d, 2 * i, bias=False)
        self.output_linear = Dense(i, d, bias=False)

    def forward(self, u):
        gate, up = self.input_linear(u).chunk(2, -1)
        return self.output_linear(F.silu(gate) * up)


class HybridLayer(nn.Module):
    def __init__(self, cfg: GraniteVoiceConfig, attention: bool):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.model_dim, cfg.rms_norm_eps)
        if attention:
            self.self_attn = Attention(cfg)
        else:
            self.mamba = MambaMixer(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.model_dim, cfg.rms_norm_eps)
        self.shared_mlp = SharedMLP(cfg)


class GraniteVoice(nn.Module):
    def __init__(self, config: GraniteVoiceConfig = GraniteVoiceConfig()):
        super().__init__()
        cfg = self.config = config
        d = cfg.model_dim
        self.conditioning_encoder = ConditioningEncoder(80, d, attn_blocks=6,
                                                        num_attn_heads=cfg.conditioning_heads)
        self.text_embedding = Embed(cfg.text_vocab, d)
        self.mel_embedding = Embed(cfg.number_mel_codes, d)
        self.layers = nn.ModuleList(HybridLayer(cfg, i in cfg.attention_layers)
                                    for i in range(cfg.layers))
        self.final_norm = RMSNorm(d, cfg.rms_norm_eps)
        self.mel_head = Dense(d, cfg.number_mel_codes)
        # (batch, device) -> the decode cache of that many candidate rows, the
        # last size asked for only; the decode step's graphs read it
        self._caches: dict = {}
        self.graphs = Graphs("tts.ar.capture", ("rows",), ssm_decode_step)

    def _apply(self, fn, *args, **kwargs):
        self._caches.clear()
        self.graphs.clear()
        return super()._apply(fn, *args, **kwargs)

    @property
    def _dtype(self) -> torch.dtype:
        return self.mel_head.weight.dtype

    # -- UnifiedVoice's interface --------------------------------------
    def get_conditioning(self, cond_mels):
        """(B, n_clips, T, 80) -> (B, model_dim): the encoder's t=0 vector,
        averaged over clips."""
        b, n, t, c = cond_mels.shape
        enc = self.conditioning_encoder(cond_mels.reshape(b * n, t, c))
        return enc.reshape(b, n, -1).mean(dim=1)

    def compute_prompt(self, cond_latent, text_tokens):
        """Decode prompt [cond | start, text..., stop, stop | start_mel] (B, P, D);
        ``text_tokens`` already carries the api-level stop pad."""
        cfg = self.config
        text = F.pad(F.pad(text_tokens, (0, 1), value=cfg.stop_text_token), (1, 0),
                     value=cfg.start_text_token)
        text_emb = self.text_embedding(text)
        start = torch.full((text.shape[0], 1), cfg.start_mel_token, dtype=torch.long,
                           device=text.device)
        return torch.cat([cond_latent[:, None, :].to(text_emb.dtype), text_emb,
                          self.mel_embedding(start)], dim=1)

    def decode_embed(self, tokens, step: int):
        """Embedding of generated mel tokens (no positions: NoPE)."""
        return self.mel_embedding(tokens)

    def hidden_to_mel_logits(self, hidden):
        logits = self.mel_head(self.final_norm(hidden).to(self._dtype))
        return logits / self.config.logits_scaling

    def hidden_to_latent(self, hidden):
        """The final norm's output (float32)."""
        return self.final_norm(hidden)

    def forward(self, cond_latent, text_inputs, mel_codes, wav_lengths=None,
                return_latent: bool = True):
        """Teacher-forced forward over [cond | start, text, stop | start_mel,
        codes, stop]: the mel latents (B, Tm, D), the quality API's latent
        re-extraction (UnifiedVoice's ``return_latent``; the prior has no
        training loss). Mel positions past wav_length // 1024 + 1 become the
        stop token."""
        if not return_latent:
            raise ValueError("return_latent: the hybrid prior's forward gives its latents only")
        cfg = self.config
        if wav_lengths is not None:
            mel_lengths = wav_lengths // cfg.mel_length_compression
            pos = torch.arange(mel_codes.shape[1], device=mel_codes.device)[None, :]
            mel_codes = torch.where(pos >= mel_lengths[:, None] + 1,
                                    torch.full_like(mel_codes, cfg.stop_mel_token), mel_codes)
        text = F.pad(F.pad(text_inputs, (0, 1), value=cfg.stop_text_token), (1, 0),
                     value=cfg.start_text_token)
        mel = F.pad(F.pad(mel_codes, (0, 1), value=cfg.stop_mel_token), (1, 0),
                    value=cfg.start_mel_token)
        text_emb = self.text_embedding(text)
        emb = torch.cat([cond_latent[:, None, :].to(text_emb.dtype), text_emb,
                         self.mel_embedding(mel)], dim=1)
        return self.hidden_to_latent(self._trunk(emb)[0][:, -mel.shape[1]:-2])

    # -- the trunk -------------------------------------------------------
    def _trunk(self, emb):
        """The 40 layers over emb (B, T, C) -> (residual (B, T, C) float32,
        each Mamba layer's (SSM state, conv state), each attention layer's
        (k, v) (B, G, T, D))."""
        cfg = self.config
        dtype = self._dtype
        h = emb.float() * cfg.embedding_multiplier
        mamba, attn = [], []
        for layer in self.layers:
            u = layer.input_layernorm(h).to(dtype)
            if hasattr(layer, "mamba"):
                out, state, conv = layer.mamba(u)
                mamba.append((state, conv))
            else:
                out, k, v = layer.self_attn(u)
                attn.append((k, v))
            h = torch.add(h, out, alpha=cfg.residual_multiplier)
            u = layer.post_attention_layernorm(h).to(dtype)
            h = torch.add(h, layer.shared_mlp(u), alpha=cfg.residual_multiplier)
        return h, mamba, attn

    # -- serving ---------------------------------------------------------
    def decode_cache(self, batch: int, device) -> dict:
        """The decode cache of ``batch`` candidate rows on ``device``, made
        at its first use and kept (with its captured graphs) until another
        size is asked for, which drops it: a request decodes all its batches
        at one size, and a cache is 47.1 MB a row (4.5 GB at B=96). "ssm"
        (L_m, B, H, P, N), "conv" (L_m, B, conv_dim, K - 1), "k" and "v"
        (L_a, B, G, T, D), all in the weights' dtype; "pos" (1,) long;
        "counters" (B,) int32, the kernel's."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        key = (batch, device)
        cache = self._caches.get(key)
        if cache is None:
            self._caches.clear()
            self.graphs.clear()
            cfg = self.config
            n_m, n_a = len(cfg.mamba_layers), len(cfg.attention_layers)
            kv = (n_a, batch, cfg.num_key_value_heads, cfg.cache_rows, cfg.head_dim)
            with torch.inference_mode(False):
                cache = {
                    "ssm": torch.zeros((n_m, batch, cfg.mamba_n_heads, cfg.mamba_d_head,
                                        cfg.mamba_d_state), dtype=self._dtype, device=device),
                    "conv": torch.zeros((n_m, batch, cfg.conv_dim, cfg.mamba_d_conv - 1),
                                        dtype=self._dtype, device=device),
                    "k": torch.zeros(kv, dtype=self._dtype, device=device),
                    "v": torch.zeros(kv, dtype=self._dtype, device=device),
                    "pos": torch.zeros((1,), dtype=torch.long, device=device),
                    "counters": torch.zeros((batch,), dtype=torch.int32, device=device)}
            self._caches[key] = cache
        return cache

    def prefill(self, prompt, cache):
        """One prompt (1, P, C) through the trunk (the Mamba layers by the
        chunked scan), its states copied to every row of ``cache`` and the
        position set to P. Returns the last position's residual (1, C)."""
        p = prompt.shape[1]
        if prompt.shape[0] != 1:
            raise ValueError(f"prefill: one prompt row fans out, got {prompt.shape[0]}")
        if p >= self.config.cache_rows:
            raise ValueError(f"prefill: a {p}-token prompt fills the {self.config.cache_rows}-row "
                             "cache")
        h, mamba, attn = self._trunk(prompt)
        with profiling.span("tts.ar.fanout", rows=cache["counters"].shape[0]):
            for name, parts in (("ssm", [s for s, _ in mamba]), ("conv", [c for _, c in mamba])):
                cache[name].copy_(torch.stack(parts).expand_as(cache[name]))
            for name, i in (("k", 0), ("v", 1)):
                rows = cache[name][:, :, :, :p]
                rows.copy_(torch.stack([kv[i] for kv in attn]).expand_as(rows))
            cache["pos"].fill_(p)
        return h[:, -1]

    def _decode_layers(self, x, cache):
        """One token a row through the 40 layers: x (B, C) -> residual (B, C)
        float32; advances ``cache["pos"]``."""
        cfg = self.config
        dtype = self._dtype
        pos = cache["pos"]
        h = x.float() * cfg.embedding_multiplier
        m = a = 0
        for layer in self.layers:
            u = layer.input_layernorm(h).to(dtype)
            if hasattr(layer, "mamba"):
                out = layer.mamba.decode(u, cache["conv"][m], cache["ssm"][m], cache["counters"])
                m += 1
            else:
                out = layer.self_attn.decode(u, cache["k"][a], cache["v"][a], pos)
                a += 1
            h = torch.add(h, out, alpha=cfg.residual_multiplier)
            u = layer.post_attention_layernorm(h).to(dtype)
            h = torch.add(h, layer.shared_mlp(u), alpha=cfg.residual_multiplier)
        pos.add_(1)
        return h

    def decode_step(self, x, cache):
        """One decode step: the embeddings x (B, C) of the rows' last tokens
        -> the residual (B, C) float32, ``cache`` (the model's, of B rows)
        advanced. On the card in eval mode without grad it replays a CUDA
        graph of the step over that cache (``utils/graphs.py``), captured
        after the cache's first such call computes eagerly; otherwise
        eager."""
        if not Graphs.eligible(self, x):
            return self._decode_layers(x, cache)
        # the cache lives until the graphs are cleared (``decode_cache``)
        return self.graphs((id(cache), x.dtype), lambda x: self._decode_layers(x, cache), (x,))
