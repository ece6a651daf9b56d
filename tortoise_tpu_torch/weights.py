"""Model weights: seeded random initialization, checkpoint loading, casting.

A model's weights come from the reference's ``<models_dir>/<reference
name>.pth`` (through the numpy converters of ``convert/torch_import.py`` and
then ``convert/from_jax.py``) or, when allowed, from a seeded
``torch.Generator`` at full width.
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from tortoise_tpu_torch.convert import torch_import as ti
from tortoise_tpu_torch.convert.from_jax import from_jax
from tortoise_tpu_torch.models.layers import (Conv1d, ConvTranspose1d, Dense, Embed, Norm,
                                              QuantDense, quantize_rows)
from tortoise_tpu_torch.models.random_latent import EqualLinear

REFERENCE_CHECKPOINTS = {
    "autoregressive": "autoregressive.pth",
    "diffusion_decoder": "diffusion_decoder.pth",
    "clvp": "clvp2.pth",
    "cvvp": "cvvp.pth",
    "classifier": "classifier.pth",
    "wav2vec2": "wav2vec2.pth",
    "vocoder": "vocoder.pth",
    "hifidecoder": "hifidecoder.pth",
    "rlg_auto": "rlg_auto.pth",
    "rlg_diffuser": "rlg_diffuser.pth",
}
# names of float parameters that stay float32 under cast_for_inference, as in
# tortoise_tpu/weights.py::cast_for_inference
_KEEP_F32 = ("Norm", "norm", "ln_", "qscale")
GPT_WEIGHTS = ("bf16", "int8", "int8_decode")
_QUANT_NAMES = ("c_attn", "c_proj", "mlp_fc", "mlp_proj")


def float32_device(device) -> torch.device:
    """``device`` as a ``torch.device`` for models that compute in float32,
    as the JAX package does. Asking for CUDA without a card raises. On CUDA,
    cuBLAS and cuDNN keep float32 products in float32 (PyTorch lets cuDNN
    use TF32 by default). The flags are process-wide, so every entry point
    that runs a float32 model on the card calls this first."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' asked for, but torch sees no CUDA device")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def resolve_gpt_quant(cfg, gpt_weights: str):
    """A ``gpt_weights`` option applied to a UnifiedVoiceConfig: "int8" turns
    on the int8 block denses (QuantDense) everywhere; "bf16" and
    "int8_decode" (int8 only in the decode kernel's stack) keep the model
    full precision."""
    if gpt_weights not in GPT_WEIGHTS:
        raise ValueError(f"gpt_weights={gpt_weights!r}: one of {GPT_WEIGHTS}")
    if gpt_weights == "int8" and not cfg.quant_weights:
        cfg = dataclasses.replace(cfg, quant_weights=True)
    return cfg


def quantize_gpt_weights(params: dict) -> dict:
    """A JAX-layout UnifiedVoice param tree with the GPT stack's block dense
    kernels (c_attn/c_proj/mlp_fc/mlp_proj; (in, out) or stacked (L, in,
    out)) quantized per output channel ({kernel int8, qscale f32, bias}), as
    ``tortoise_tpu/weights.py::quantize_gpt_weights``; already-int8 kernels
    pass through. numpy in, numpy out."""
    def walk(d, name=""):
        if not isinstance(d, Mapping):
            return d
        if name in _QUANT_NAMES and "kernel" in d:
            k = np.asarray(d["kernel"])
            if k.dtype == np.int8:
                return d
            q, s = quantize_rows(torch.from_numpy(np.array(k, np.float32)).transpose(-1, -2))
            return dict(d, kernel=q.transpose(-1, -2).numpy(), qscale=s.numpy())
        return {k: walk(v, k) for k, v in d.items()}

    out = dict(params)
    if "gpt" in out:
        out["gpt"] = walk(out["gpt"])
    return out


@torch.no_grad()
def init_random(model: nn.Module, seed: int) -> None:
    """Fill every parameter from a seeded generator on the model's device:
    dense/conv weights N(0, 1/fan_in), embeddings N(0, 0.02^2), the
    unconditioned embedding N(0, 1), EqualLinear weights N(0, 1/lr_mul^2),
    biases 0, norm scales and the CLVP temperature 1. An int8 QuantDense
    weight is uniform in [-127, 127] with qscale 1/(127 sqrt(in)), the JAX
    package's random init of that layer."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal_(p, std):
        p.copy_(torch.randn(p.shape, generator=gen, device=dev) * std)

    for _, module in model.named_modules():
        for name, p in module.named_parameters(recurse=False):
            if isinstance(module, QuantDense) and name != "bias":
                if name == "weight":
                    p.copy_(torch.randint(-127, 128, p.shape, generator=gen, device=dev))
                else:
                    p.fill_(1.0 / (127.0 * module.weight.shape[-1] ** 0.5))
            elif isinstance(module, EqualLinear) and name == "weight":
                normal_(p, 1.0 / module.lr_mul)
            elif isinstance(module, (Dense, Conv1d, ConvTranspose1d)) and name == "weight":
                if isinstance(module, Dense):
                    fan_in = p.shape[-1]
                elif isinstance(module, Conv1d):
                    fan_in = p.shape[-2] * p.shape[-1]
                else:
                    fan_in = p.shape[0] * p.shape[-1]
                normal_(p, fan_in ** -0.5)
            elif isinstance(module, Embed):
                normal_(p, 0.02)
            elif isinstance(module, Norm):
                p.fill_(1.0 if name == "weight" else 0.0)
            elif name == "unconditioned_embedding":
                normal_(p, 1.0)
            elif name == "bias":
                p.zero_()
            else:  # RMSNorm g, CLVP temperature
                p.fill_(1.0)


@torch.no_grad()
def cast_for_inference(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast float parameters to the serving dtype, keeping normalization
    parameters in float32."""
    for name, p in model.named_parameters():
        if p.dtype == torch.float32 and not any(k in name for k in _KEEP_F32):
            p.data = p.data.to(dtype)
    return model


def convert_reference_checkpoint(name: str, path: str, model: nn.Module) -> dict:
    """A reference ``.pth`` -> the port's state_dict."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if name == "vocoder":
        sd = sd["model_g"]
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    converters = {
        "autoregressive": lambda s: ti.unified_voice_params(s, layers=model.config.layers),
        "diffusion_decoder": lambda s: ti.diffusion_tts_params(
            s, num_layers=model.config.num_layers),
        "clvp": ti.clvp_params,
        "cvvp": lambda s: ti.cvvp_params(s, cond_depth=model.config.conditioning_enc_depth,
                                         speech_depth=model.config.speech_enc_depth),
        "classifier": lambda s: ti.classifier_params(
            s, depth=model.config.depth, resnet_blocks=model.config.resnet_blocks,
            attn_blocks=model.config.attn_blocks),
        "wav2vec2": lambda s: ti.wav2vec2_params(s, num_layers=model.config.num_layers,
                                                 num_convs=len(model.config.conv_dim)),
        "vocoder": ti.univnet_params,
        "hifidecoder": ti.hifigan_params,
        "rlg_auto": ti.rlg_params,
        "rlg_diffuser": ti.rlg_params,
    }
    params = converters[name](sd)
    if name == "autoregressive" and model.config.gpt_config.quant_weights:
        params = quantize_gpt_weights(params)
    return from_jax(model, params)


def load_weights(name: str, model: nn.Module, models_dir: str | None, allow_random: bool,
                 seed: int) -> str:
    """Fill ``model`` in place; returns where the weights came from:
    'reference' or 'random'."""
    if models_dir:
        ref_path = os.path.join(models_dir, REFERENCE_CHECKPOINTS[name])
        if os.path.exists(ref_path):
            model.load_state_dict(convert_reference_checkpoint(name, ref_path, model))
            return "reference"
    if not allow_random:
        raise FileNotFoundError(f"no checkpoint for '{name}' in {models_dir!r}")
    warnings.warn(f"no checkpoint for '{name}'; using random weights (seed {seed}): "
                  "the audio will be noise", stacklevel=2)
    init_random(model, seed)
    return "random"
