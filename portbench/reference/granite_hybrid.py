"""Granite-4.0-H-Micro as Tortoise's autoregressive prior, as a plain
float32 model.

The trunk follows HF's ``GraniteMoeHybridModel`` (config:
https://huggingface.co/ibm-granite/granite-4.0-h-micro/blob/main/config.json):
the inputs times ``embedding_multiplier``; each of ``layers`` layers is
``h + residual_multiplier * mixer(rms(h))`` then ``h + residual_multiplier *
mlp(rms(h))``, the mixer Mamba-2 but at ``attention_layers``, which hold
causal grouped-query attention with no position encoding, scaled by
``attention_multiplier``; the MLP is SwiGLU (``input_linear``'s halves,
silu(gate) * up, ``output_linear``); a final RMSNorm. Mamba-2's mixer:
``in_proj`` -> z, xBC, dt; a causal depthwise conv with bias and SiLU over
xBC, split into x, B and C (one group); dt = softplus(dt + dt_bias), A =
-exp(A_log); the state h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T, computed
token by token (the recurrence itself, not the chunked form the program
scans a prompt with), y_t = h_t C_t + D x_t; the gated RMSNorm rms(y
silu(z)) over all inner channels; ``out_proj``. Tortoise's side is
UnifiedVoice's reference (the conditioning encoder, here
``conditioning_heads`` wide, the text and mel embeddings, the prompt
[cond | start, text, stop | start_mel, codes], the mel head with its bias),
the latents the final norm's output, the logits the head's over
``logits_scaling``. No position tables: ``served_positions`` changes
nothing.

``set_precision`` reaches every product, as in ``unified_voice``; under
``"fp8"`` (the control of a bf16 prior, whose served state is stored in
bf16 every step) the carried SSM state is rounded to fp8 every token too.
TF32 is off in every product outside the leaves.

The AR reference interface of ``portbench.reference``: ``NAME``,
``PROGRAM_CONFIG``, ``SUPPRESSED``, ``build``, ``trunk_ops`` and
``conditioning_ops``.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from portbench import flops
from portbench.reference.layers import Dense, Embed, _Leaf, fp8_round, tf32
from portbench.reference.unified_voice import ConditioningEncoder

NAME = "GraniteVoice"
PROGRAM_CONFIG = "tortoise_tpu_torch.models.granite_hybrid:GraniteVoiceConfig"
# the calm code 83 and the vocabulary's last two codes, the start and stop
# tokens: -30 once the logits are divided by 8, as UnifiedVoice's
SUPPRESSED = ("mel_head.bias", (83, -2, -1), -240.0)
# keys only the program reads: the chunk of its prompt scan (the recurrence
# here has none) and the wav-to-mel compression of the API's re-extraction
IGNORED = ("mamba_chunk_size", "mel_length_compression")


@dataclasses.dataclass(frozen=True)
class Config:
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
    shared_intermediate_size: int = 8192
    embedding_multiplier: float = 12.0
    residual_multiplier: float = 0.22
    logits_scaling: float = 8.0
    rms_norm_eps: float = 1e-5
    conditioning_heads: int = 32
    max_text_tokens: int = 402
    max_mel_tokens: int = 604
    max_conditioning_inputs: int = 2
    number_text_tokens: int = 255
    start_text_token: int = 255
    stop_text_token: int = 0
    number_mel_codes: int = 8194
    start_mel_token: int = 8192
    stop_mel_token: int = 8193

    @property
    def inner(self) -> int:
        return self.mamba_expand * self.model_dim

    @property
    def conv_dim(self) -> int:
        return self.inner + 2 * self.mamba_n_groups * self.mamba_d_state

    @property
    def head_dim(self) -> int:
        return self.model_dim // self.num_attention_heads


def rms(x, weight, eps):
    x = x.float()
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * weight.float()


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x):
        return rms(x, self.weight, self.eps)


class Conv1d(_Leaf):
    """A causal depthwise convolution over time of (B, T, C) activations:
    weight (C, 1, K), bias (C,), the output at t from inputs t-K+1..t."""

    def __init__(self, channels: int, kernel_size: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, 1, kernel_size))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        xo, w = self._operands(x, self.weight)
        k = w.shape[-1]
        return self._run(lambda: F.conv1d(F.pad(xo.transpose(1, 2), (k - 1, 0)), w,
                                          self.bias.float(), groups=w.shape[0]).transpose(1, 2))


class Mamba(nn.Module):
    precision = "f32"

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        d, h = cfg.model_dim, cfg.mamba_n_heads
        self.in_proj = Dense(d, cfg.inner + cfg.conv_dim + h, bias=False)
        self.conv1d = Conv1d(cfg.conv_dim, cfg.mamba_d_conv)
        self.dt_bias = nn.Parameter(torch.zeros(h))
        self.A_log = nn.Parameter(torch.zeros(h))
        self.D = nn.Parameter(torch.ones(h))
        self.norm = RMSNorm(cfg.inner, cfg.rms_norm_eps)
        self.out_proj = Dense(cfg.inner, d, bias=False)

    def forward(self, u):
        cfg = self.cfg
        b, t, _ = u.shape
        hh, p, n = cfg.mamba_n_heads, cfg.mamba_d_head, cfg.mamba_d_state
        z, xbc, dt = self.in_proj(u).split([cfg.inner, cfg.conv_dim, hh], -1)
        x, bm, cm = F.silu(self.conv1d(xbc)).split([cfg.inner, n, n], -1)
        x = x.reshape(b, t, hh, p)
        dt = F.softplus(dt + self.dt_bias.float())
        a = -torch.exp(self.A_log.float())
        d = self.D.float()
        state = torch.zeros(b, hh, p, n, device=u.device)
        ys = []
        with tf32(False):
            for i in range(t):
                decay = torch.exp(dt[:, i] * a)[:, :, None, None]
                state = state * decay \
                    + (dt[:, i, :, None] * x[:, i])[..., None] * bm[:, i, None, None, :]
                if self.precision == "fp8":
                    state = fp8_round(state)
                ys.append(torch.einsum("bhpn,bn->bhp", state, cm[:, i]) + d[:, None] * x[:, i])
        y = torch.stack(ys, 1).reshape(b, t, cfg.inner)
        return self.out_proj(self.norm(y * F.silu(z)))


class Attention(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        d, hd = cfg.model_dim, cfg.head_dim
        self.q_proj = Dense(d, cfg.num_attention_heads * hd, bias=False)
        self.k_proj = Dense(d, cfg.num_key_value_heads * hd, bias=False)
        self.v_proj = Dense(d, cfg.num_key_value_heads * hd, bias=False)
        self.o_proj = Dense(cfg.num_attention_heads * hd, d, bias=False)

    def forward(self, u):
        cfg = self.cfg
        b, t, _ = u.shape
        hq, hk, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        q = self.q_proj(u).reshape(b, t, hq, hd).transpose(1, 2)
        # each key/value head serves hq / hk query heads in turn (HF's repeat_kv)
        k, v = (proj(u).reshape(b, t, hk, hd).transpose(1, 2).repeat_interleave(hq // hk, 1)
                for proj in (self.k_proj, self.v_proj))
        causal = torch.ones(t, t, dtype=torch.bool, device=u.device).tril()
        with tf32(False):
            s = (q @ k.transpose(-1, -2)) * cfg.attention_multiplier
            w = torch.softmax(s.masked_fill(~causal, float("-inf")), -1)
            o = (w @ v).transpose(1, 2).reshape(b, t, hq * hd)
        return self.o_proj(o)


class SharedMLP(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        d, i = cfg.model_dim, cfg.shared_intermediate_size
        self.input_linear = Dense(d, 2 * i, bias=False)
        self.output_linear = Dense(i, d, bias=False)

    def forward(self, u):
        gate, up = self.input_linear(u).chunk(2, -1)
        return self.output_linear(F.silu(gate) * up)


class Layer(nn.Module):
    def __init__(self, cfg: Config, attention: bool):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.model_dim, cfg.rms_norm_eps)
        if attention:
            self.self_attn = Attention(cfg)
        else:
            self.mamba = Mamba(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.model_dim, cfg.rms_norm_eps)
        self.shared_mlp = SharedMLP(cfg)

    def forward(self, h, mult: float):
        mixer = self.self_attn if hasattr(self, "self_attn") else self.mamba
        h = h + mult * mixer(self.input_layernorm(h))
        return h + mult * self.shared_mlp(self.post_attention_layernorm(h))


class GraniteVoice(nn.Module):
    def __init__(self, cfg: Config = Config()):
        super().__init__()
        self.config = cfg
        d = cfg.model_dim
        self.conditioning_encoder = ConditioningEncoder(80, d, 6, cfg.conditioning_heads)
        self.text_embedding = Embed(cfg.number_text_tokens + 1, d)
        self.mel_embedding = Embed(cfg.number_mel_codes, d)
        self.layers = nn.ModuleList(Layer(cfg, i in cfg.attention_layers)
                                    for i in range(cfg.layers))
        self.final_norm = RMSNorm(d, cfg.rms_norm_eps)
        self.mel_head = Dense(d, cfg.number_mel_codes)

    def conditioning(self, cond_mels):
        """(1, n_clips, T, 80) -> (1, D): the clips' latents averaged."""
        b, n, t, c = cond_mels.shape
        return self.conditioning_encoder(cond_mels.reshape(b * n, t, c)).reshape(b, n, -1) \
            .mean(dim=1)

    def teacher_forced(self, cond, text, codes, served_positions: bool):
        """cond (B, D); text (B, T) as the served API holds it; codes (B, M).
        Returns (logits (B, M, V), latents (B, M, D)) from the final norm where
        the token before codes[:, i] is fed: logits[:, i] predicts codes[:, i].
        NoPE: ``served_positions`` changes nothing."""
        cfg = self.config
        text = F.pad(F.pad(text, (1, 0), value=cfg.start_text_token), (0, 1),
                     value=cfg.stop_text_token)
        mel = F.pad(codes, (1, 0), value=cfg.start_mel_token)
        h = torch.cat([cond[:, None].float(), self.text_embedding(text),
                       self.mel_embedding(mel)], dim=1) * cfg.embedding_multiplier
        for layer in self.layers:
            h = layer(h, cfg.residual_multiplier)
        m = codes.shape[1]
        latents = self.final_norm(h[:, -(m + 1):-1])
        return self.mel_head(latents) / cfg.logits_scaling, latents


def config(ar: dict) -> Config:
    """The ``autoregressive`` group as this model's ``Config``; raises on a
    key that is neither a field nor ``IGNORED``."""
    fields = Config.__dataclass_fields__
    unknown = sorted(k for k in ar if k not in fields and k not in IGNORED)
    if unknown:
        raise ValueError(f"{__name__}: unknown autoregressive key(s) {', '.join(unknown)}")
    cfg = Config(**{k: v for k, v in ar.items() if k in fields})
    return dataclasses.replace(cfg, attention_layers=tuple(cfg.attention_layers))


def build(ar: dict) -> GraniteVoice:
    return GraniteVoice(config(ar))


def trunk_ops(ar: dict, batch: int, new: int, context: int) -> float:
    """The layer stack over ``new`` tokens a row after ``context``: per
    token, each Mamba layer's in_proj and out_proj, its conv and its state's
    update and output (2 H P N each), each attention layer's projections,
    every layer's SwiGLU; each attention layer's scores and weighted sum
    over the keys a query sees (4 x keys x heads x head dim)."""
    cfg = config(ar)
    d, inner, h = cfg.model_dim, cfg.inner, cfg.mamba_n_heads
    hd, hq, hk = cfg.head_dim, cfg.num_attention_heads, cfg.num_key_value_heads
    n_attn = len(cfg.attention_layers)
    n_mamba = cfg.layers - n_attn
    mamba = 2 * d * (inner + cfg.conv_dim + h) + 2 * inner * d + 2 * cfg.conv_dim * \
        cfg.mamba_d_conv + 4 * h * cfg.mamba_d_head * cfg.mamba_d_state
    attention = 2 * d * (hq + 2 * hk) * hd + 2 * hq * hd * d
    mlp = 3 * 2 * d * cfg.shared_intermediate_size
    keys = new * context + new * (new + 1) // 2
    return batch * (new * (n_mamba * mamba + n_attn * attention + cfg.layers * mlp)
                    + n_attn * 4 * keys * hq * hd)


def conditioning_ops(ar: dict, frames: int, clips: int) -> float:
    return flops.conditioning_encoder(ar["model_dim"], frames, clips)
