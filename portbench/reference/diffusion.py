"""DiffusionTts, the quality pipeline's mel diffusion decoder, as a plain
float32 model.

Reference tortoise/models/diffusion_decoder.py:134-322: a timestep
embedding, three conditioning DiffusionLayers (a scale-shift ResBlock and an
attention block with a T5 relative-position bias) over the aligned
embeddings, the noisy mel's input conv joined by a dense, ten
DiffusionLayers, three timestep ResBlocks, a group norm, SiLU and the output
conv (eps and variance channels). ``step`` is one evaluation of the network
from given aligned embeddings, the quantity the sampling loop calls at every
step. ``voice_latent`` is the contextual embedder over a voice's 24 kHz
conditioning mels (reference diffusion_decoder.py:280-290) and ``aligned``
the latent conditioner at the winner's exact length, FiLM'd by that voice
latent and resized to the output's frames (diffusion_decoder.py:232-260);
the code path's parameters are declared so that the weights the benchmark
makes load whole.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.layers import Conv1d, Dense, Embed
from portbench.reference.unified_voice import AttentionBlock, GroupNorm32

CH, LAYERS, HEADS, IN_CH, OUT_CH, TOKENS = 1024, 10, 16, 100, 200, 8193


def relative_bucket(rel: np.ndarray, num_buckets: int = 32, max_distance: int = 64):
    """T5's bidirectional log buckets of key minus query offsets."""
    num_buckets //= 2
    ret = (rel > 0).astype(np.int64) * num_buckets
    n = np.abs(rel)
    exact = num_buckets // 2
    with np.errstate(divide="ignore"):
        large = exact + (np.log(n.astype(np.float32) / exact + np.float32(1e-20))
                         / np.float32(np.log(max_distance / exact))
                         * (num_buckets - exact)).astype(np.int64)
    return ret + np.where(n < exact, n, np.minimum(large, num_buckets - 1))


def rel_bias(table, t: int, scale: float):
    """A (32, H) bucket table -> the (1, H, T, T) bias of a T-frame run."""
    idx = np.arange(t)
    buckets = torch.as_tensor(relative_bucket(idx[None, :] - idx[:, None]), device=table.device)
    return (table.float()[buckets] * scale).permute(2, 0, 1)[None]


def timestep_embedding(t, dim: int):
    half = dim // 2
    freqs = torch.as_tensor(np.exp(-np.log(10000) * np.arange(half) / half).astype(np.float32),
                            device=t.device)
    args = t[:, None].float() * freqs[None]
    return torch.cat([args.cos(), args.sin()], dim=-1)


class ResBlock(nn.Module):
    """Scale-shift-norm ResBlock: 1x1 in and skip convs, a k=3 out conv."""

    def __init__(self, ch: int, lead=()):
        super().__init__()
        self.GroupNorm32_0 = GroupNorm32(ch, lead)
        self.in_conv = Dense(ch, ch, lead=lead)
        self.emb_proj = Dense(ch, 2 * ch, lead=lead)
        self.GroupNorm32_1 = GroupNorm32(ch, lead)
        self.out_conv = Conv1d(ch, ch, 3, padding=1, lead=lead)

    def forward(self, x, emb, mask, l=None):
        h = self.in_conv(F.silu(self.GroupNorm32_0(x, mask, l)), l)
        scale, shift = self.emb_proj(F.silu(emb), l)[:, None, :].chunk(2, dim=-1)
        h = F.silu(self.GroupNorm32_1(h, mask, l) * (1 + scale) + shift) * mask[:, :, None]
        return (x + self.out_conv(h, l)) * mask[:, :, None]


class Layer(nn.Module):
    def __init__(self, ch: int, heads: int, n: int):
        super().__init__()
        self.resblk = ResBlock(ch, (n,))
        self.attn = AttentionBlock(ch, heads, relative_pos=True, lead=(n,))
        self.scale = (ch // heads) ** 0.5

    def forward(self, x, emb, mask, l):
        bias = rel_bias(self.attn.rel_pos.weight[l], x.shape[1], self.scale)
        return self.attn(self.resblk(x, emb, mask, l), mask, bias, l)


class _Stacked(nn.Module):
    def __init__(self, ch: int, heads: int, n: int):
        super().__init__()
        self.layer, self.n = Layer(ch, heads, n), n


class DiffusionTts(nn.Module):
    def __init__(self, ch: int = CH, layers: int = LAYERS, heads: int = HEADS,
                 latent_ch: int = 1024):
        super().__init__()
        CH = self.ch = ch
        attn = lambda c: AttentionBlock(c, heads, relative_pos=True)
        self.inp_block = Conv1d(IN_CH, CH, 3, padding=1)
        self.time_embed_1 = Dense(CH, CH)
        self.time_embed_2 = Dense(CH, CH)
        self.code_norm = GroupNorm32(CH)
        self.latent_conv = Conv1d(latent_ch, CH, 3, padding=1)
        for i in range(4):
            setattr(self, f"latent_attn_{i}", attn(CH))
        self.ctx_conv1 = Conv1d(IN_CH, CH, 3, stride=2, padding=1)
        self.ctx_conv2 = Conv1d(CH, 2 * CH, 3, stride=2, padding=1)
        for i in range(5):
            setattr(self, f"ctx_attn_{i}", attn(2 * CH))
        self.unconditioned_embedding = nn.Parameter(torch.empty(1, 1, CH))
        self.cond_scan = _Stacked(CH, heads, 3)
        self.integrating_conv = Dense(2 * CH, CH)
        self.layers_scan = _Stacked(CH, heads, layers)
        for i in range(3):
            setattr(self, f"tail_{i}", ResBlock(CH))
        self.out_norm = GroupNorm32(CH)
        self.out_conv = Conv1d(CH, OUT_CH, 3, padding=1)
        self.code_embedding = Embed(TOKENS, CH)
        for i in range(3):
            setattr(self, f"code_converter_{i}", attn(CH))
        self.mel_head = Conv1d(CH, IN_CH, 3, padding=1)

    @staticmethod
    def _attend(block, h):
        """An attention block over all of ``h``'s frames with its own
        relative-position bias."""
        scale = (h.shape[-1] // block.heads) ** 0.5
        return block(h, None, rel_bias(block.rel_pos.weight, h.shape[1], scale))

    def voice_latent(self, mels):
        """(B, n_clips, T, 100) conditioning mels -> the (B, 2 ch) voice
        latent: the mean over every clip's frames of the contextual embedder."""
        b, n, t, c = mels.shape
        h = self.ctx_conv2(self.ctx_conv1(mels.reshape(b * n, t, c).float()))
        for i in range(5):
            h = self._attend(getattr(self, f"ctx_attn_{i}"), h)
        return h.reshape(b, -1, h.shape[-1]).mean(dim=1)

    def aligned(self, latents, voice, frames: int):
        """Latents (B, n, D) at their exact length and the voice latent
        (B, 2 ch) -> the (B, frames, ch) aligned embeddings: frame i reads
        latent floor(i n / frames)."""
        h = self.latent_conv(latents.float())
        for i in range(4):
            h = self._attend(getattr(self, f"latent_attn_{i}"), h)
        scale, shift = voice.float().chunk(2, dim=-1)
        h = self.code_norm(h) * (1 + scale[:, None]) + shift[:, None]
        idx = torch.arange(frames, device=h.device) * latents.shape[1] // frames
        return h[:, idx]

    def step(self, x, timesteps, aligned, valid_len):
        """x (B, T, 100) noisy mels, timesteps (B,), aligned (B, T, 1024) the
        aligned embeddings, valid_len (B,) the valid frames of each row.
        Returns (B, T, 200); only each row's valid frames carry meaning."""
        mask = torch.arange(x.shape[1], device=x.device)[None, :] < valid_len.reshape(-1, 1)
        m = mask[:, :, None].float()
        x = x.float() * m
        emb = self.time_embed_2(F.silu(self.time_embed_1(timestep_embedding(timesteps,
                                                                            self.ch))))
        code = aligned.float()
        for l in range(self.cond_scan.n):
            code = self.cond_scan.layer(code, emb, mask, l)
        h = self.integrating_conv(torch.cat([self.inp_block(x), code], -1))
        for l in range(self.layers_scan.n):
            h = self.layers_scan.layer(h, emb, mask, l)
        for i in range(3):
            h = getattr(self, f"tail_{i}")(h, emb, mask)
        h = F.silu(self.out_norm(h, mask)) * m
        return self.out_conv(h)
