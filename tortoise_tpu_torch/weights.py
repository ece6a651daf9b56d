"""Model weights: seeded random initialization, checkpoint loading, casting.

``load_weights`` searches where the JAX package's ``get_params`` does
(``tortoise_tpu/weights.py``), in this order:

1. ``{models_dir or MODELS_DIR}/{name}.npz``: a flat ``np.savez`` of the JAX
   package's param tree, keys joined with "/" (``save_params``; the JAX
   package and ``tools/convert_checkpoints.py`` write them);
2. the reference's ``{models_dir}/{reference name}.pth``;
3. the same ``.pth`` in ``TORCH_MODELS_DIR``, whose converted tree is then
   cached as step 1's ``.npz`` (a write that fails is ignored);
4. when allowed, a seeded ``torch.Generator`` at full width.

``MODELS_DIR`` is ``$TORTOISE_TPU_MODELS_DIR`` (default
``~/.cache/tortoise_tpu/models``) and ``TORCH_MODELS_DIR``
``$TORTOISE_MODELS_DIR`` (default ``~/.cache/tortoise/models``, where the
reference downloads its checkpoints). A ``.pth`` goes through the numpy
converters of ``convert/torch_import.py``; every tree then reaches the model
through ``convert/from_jax.py``.
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

DEFAULT_MODELS_DIR = os.path.join(os.path.expanduser("~"), ".cache", "tortoise_tpu", "models")
MODELS_DIR = os.environ.get("TORTOISE_TPU_MODELS_DIR", DEFAULT_MODELS_DIR)
TORCH_MODELS_DIR = os.environ.get(
    "TORTOISE_MODELS_DIR", os.path.join(os.path.expanduser("~"), ".cache", "tortoise", "models"))

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
    biases 0, norm scales and the CLVP temperature 1, LayerScale gains their
    layer's CaiT epsilon. An int8 QuantDense weight is uniform in [-127,
    127] with qscale 1/(127 sqrt(in)), the JAX package's random init of
    that layer."""
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
            elif name in ("attn_scale", "ff_scale"):     # SimpleTransformer's LayerScale
                p.fill_(module.layerscale)
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


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def save_params(path: str, tree: Mapping) -> None:
    """A param tree as a flat ``np.savez``, keys joined with "/": the JAX
    package's ``.npz`` format."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **_flatten(tree))


def load_params(path: str) -> dict:
    """The nested numpy tree of a ``save_params`` file (either package's)."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return tree


def find_checkpoint(name: str, models_dir: str | None = None) -> str | None:
    """``{models_dir or MODELS_DIR}/{name}.npz`` if it exists, else None."""
    path = os.path.join(models_dir or MODELS_DIR, f"{name}.npz")
    return path if os.path.exists(path) else None


def convert_from_torch(name: str, path: str, config=None) -> dict:
    """A reference ``.pth`` -> the JAX-layout numpy param tree. ``config``
    is the model's config where the layout needs its depths (None: the
    shipped ones, as the JAX package's converter assumes)."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if name == "vocoder":
        sd = sd["model_g"]
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    c = config
    # converter, and its layout arguments from the model's config
    converters = {
        "autoregressive": (ti.unified_voice_params, lambda: dict(layers=c.layers)),
        "diffusion_decoder": (ti.diffusion_tts_params, lambda: dict(num_layers=c.num_layers)),
        "clvp": (ti.clvp_params, dict),
        "cvvp": (ti.cvvp_params, lambda: dict(cond_depth=c.conditioning_enc_depth,
                                              speech_depth=c.speech_enc_depth)),
        "classifier": (ti.classifier_params, lambda: dict(
            depth=c.depth, resnet_blocks=c.resnet_blocks, attn_blocks=c.attn_blocks)),
        "wav2vec2": (ti.wav2vec2_params, lambda: dict(num_layers=c.num_layers,
                                                      num_convs=len(c.conv_dim))),
        "vocoder": (ti.univnet_params, dict),
        "hifidecoder": (ti.hifigan_params, dict),
        "rlg_auto": (ti.rlg_params, dict),
        "rlg_diffuser": (ti.rlg_params, dict),
    }
    convert, layout = converters[name]
    return convert(sd, **(layout() if c is not None else {}))


def find_params(name: str, models_dir: str | None = None, config=None) -> tuple[dict | None, str]:
    """The JAX-layout numpy tree of model ``name`` and where it came from,
    by the module's search order: (tree, "native") from an ``.npz``, (tree,
    "reference") from a ``.pth``, or (None, "random") when there is none.
    A tree under a "params" root is returned without it."""
    native = find_checkpoint(name, models_dir)
    if native:
        tree = load_params(native)
        return tree.get("params", tree), "native"
    ref_name = REFERENCE_CHECKPOINTS[name]
    if models_dir and os.path.exists(os.path.join(models_dir, ref_name)):
        return convert_from_torch(name, os.path.join(models_dir, ref_name), config), "reference"
    ref_path = os.path.join(TORCH_MODELS_DIR, ref_name)
    if os.path.exists(ref_path):
        tree = convert_from_torch(name, ref_path, config)
        try:    # cached for next time, as the JAX package's get_params does
            save_params(os.path.join(models_dir or MODELS_DIR, f"{name}.npz"), tree)
        except OSError:
            pass
        return tree, "reference"
    return None, "random"


def load_weights(name: str, model: nn.Module, models_dir: str | None, allow_random: bool,
                 seed: int, found: tuple[dict | None, str] | None = None) -> str:
    """Fill ``model`` in place from ``find_params`` (or ``found``, what a
    caller that chose the model's config from the tree already found);
    returns where the weights came from: "native", "reference" or
    "random". An UnifiedVoice with int8 block denses gets its tree
    quantized, whatever its source."""
    config = getattr(model, "config", None)
    tree, source = found or find_params(name, models_dir, config)
    if tree is None:
        if not allow_random:
            raise FileNotFoundError(f"no checkpoint for '{name}' in "
                                    f"{models_dir or MODELS_DIR} or {TORCH_MODELS_DIR}")
        warnings.warn(f"no checkpoint for '{name}'; using random weights (seed {seed}): "
                      "the audio will be noise", stacklevel=2)
        init_random(model, seed)
        return "random"
    if name == "autoregressive" and config.gpt_config.quant_weights:
        tree = quantize_gpt_weights(tree)
    model.load_state_dict(from_jax(model, tree))
    return source
