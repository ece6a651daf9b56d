"""wav2vec2-CTC acoustic model for alignment and redaction.

Port of ``tortoise_tpu/models/wav2vec2.py``: the HF ``Wav2Vec2ForCTC``
checkpoint the reference aligner loads
(``jbetker/wav2vec2-large-robust-ft-libritts-voxpopuli``, reference
tortoise/utils/wav2vec_alignment.py:48-57), the "large-robust"
architecture: a layer-norm feature extractor of VALID convolutions, a
pre-LN ("stable layer norm") encoder whose layers are stacked under
``layers.layer`` as the JAX ``nn.scan`` stacks them, a grouped conv
positional embedding and a CTC head over the Tacotron symbol set.

``n_samples`` gives the true length of a zero-padded waveform: frames past
its frame count are zeroed before the positional conv and masked as keys,
so the valid logits equal an unpadded run's (every convolution is VALID, so
no frame straddles the pad boundary). The aligner itself runs each clip at
its exact length (``utils/wav2vec_alignment.wav2vec2_logits_fn``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tortoise_tpu_torch.models.layers import Conv1d, Dense, LayerNorm

NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    """Defaults: wav2vec2-large-robust, the shipped aligner checkpoint."""
    vocab_size: int = 64  # the Tacotron symbol set ('jbetker/tacotron-symbols')
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    conv_dim: tuple = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: tuple = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: tuple = (5, 2, 2, 2, 2, 2, 2)
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5

    def frame_count(self, n_samples: int) -> int:
        """Output frames for n input samples: floor((L - k) / s) + 1 per
        VALID convolution (HF _get_feat_extract_output_lengths)."""
        n = n_samples
        for k, s in zip(self.conv_kernel, self.conv_stride):
            n = (n - k) // s + 1
        return n


class _FeatureExtractor(nn.Module):
    """Conv waveform front end, each conv followed by a float32 LayerNorm
    over channels and exact-erf GELU (HF feat_extract_norm="layer")."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.n = len(cfg.conv_dim)
        in_ch = 1
        for i, (c, k, s) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel, cfg.conv_stride)):
            setattr(self, f"conv_{i}", Conv1d(in_ch, c, k, stride=s))
            setattr(self, f"ln_{i}", LayerNorm(c, cfg.layer_norm_eps))
            in_ch = c

    def forward(self, x):
        h = x[:, :, None]                                    # (B, T, 1)
        for i in range(self.n):
            h = getattr(self, f"conv_{i}")(h)
            h = F.gelu(getattr(self, f"ln_{i}")(h).to(h.dtype))
        return h                                             # (B, frames, conv_dim[-1])


class _EncoderLayers(nn.Module):
    """All pre-LN encoder layers' parameters, stacked: (num_layers, ...)."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        c, lead = cfg.hidden_size, (cfg.num_layers,)
        self.ln_attn = LayerNorm(c, cfg.layer_norm_eps, lead=lead)
        self.qkv = Dense(c, 3 * c, lead=lead)
        self.attn_out = Dense(c, c, lead=lead)
        self.ln_ff = LayerNorm(c, cfg.layer_norm_eps, lead=lead)
        self.ff_in = Dense(c, cfg.intermediate_size, lead=lead)
        self.ff_out = Dense(cfg.intermediate_size, c, lead=lead)


class _ScanBody(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.num_layers, self.num_heads = cfg.num_layers, cfg.num_heads
        self.layer = _EncoderLayers(cfg)

    def forward(self, h, key_mask=None):
        ls = self.layer
        b, t, c = h.shape
        nh = self.num_heads
        dh = c // nh
        for l in range(self.num_layers):
            x = ls.ln_attn(h, l).to(h.dtype)
            q, k, v = (a.reshape(b, t, nh, dh).transpose(1, 2)
                       for a in ls.qkv(x, l).chunk(3, dim=-1))
            # float32 logits and softmax, as preferred_element_type=float32
            logits = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float()) / np.sqrt(dh)
            if key_mask is not None:
                logits = logits.masked_fill(~key_mask[:, None, None, :], NEG_INF)
            w = torch.softmax(logits, dim=-1).to(h.dtype)
            attn = torch.einsum("bhts,bhsd->bhtd", w, v).transpose(1, 2).reshape(b, t, c)
            h = h + ls.attn_out(attn, l)
            x = ls.ln_ff(h, l).to(h.dtype)
            h = h + ls.ff_out(F.gelu(ls.ff_in(x, l)), l)
        return h


class Wav2Vec2ForCTC(nn.Module):
    def __init__(self, config: Wav2Vec2Config = Wav2Vec2Config()):
        super().__init__()
        cfg = self.config = config
        c = cfg.hidden_size
        k = cfg.num_conv_pos_embeddings
        self.feature_extractor = _FeatureExtractor(cfg)
        self.proj_ln = LayerNorm(cfg.conv_dim[-1], cfg.layer_norm_eps)
        self.proj = Dense(cfg.conv_dim[-1], c)
        # weight norm folded at conversion
        self.pos_conv = Conv1d(c, c, k, padding=k // 2,
                               groups=cfg.num_conv_pos_embedding_groups)
        self.layers = _ScanBody(cfg)
        self.encoder_ln = LayerNorm(c, cfg.layer_norm_eps)
        self.lm_head = Dense(c, cfg.vocab_size)

    def forward(self, audio, n_samples: int | None = None):
        """audio: (B, T) 16 kHz waveform, already normalised to zero mean and
        unit variance by the caller (reference wav2vec_alignment.py:65).
        Returns (float32 logits (B, frames, vocab), the valid frame count)."""
        cfg = self.config
        feats = self.feature_extractor(audio)
        total = feats.shape[1]
        if n_samples is None:
            n_frames, frame_mask = total, None
        else:
            n_frames = cfg.frame_count(n_samples)
            frame_mask = torch.arange(total, device=feats.device)[None, :] < n_frames
        h = self.proj(self.proj_ln(feats).to(feats.dtype))
        if frame_mask is not None:
            # pad frames enter the positional conv as zeros, which is what
            # its own zero padding gives at the true end of the sequence
            h = h * frame_mask[:, :, None].to(h.dtype)
        pos = self.pos_conv(h)
        if cfg.num_conv_pos_embeddings % 2 == 0:
            pos = pos[:, :-1]  # even kernel: drop one trailing frame (HF num_pad_remove)
        h = h + F.gelu(pos)
        h = self.layers(h, frame_mask)
        h = self.encoder_ln(h)                               # float32
        logits = F.linear(h, self.lm_head.weight.float(), self.lm_head.bias.float())
        return logits, n_frames
