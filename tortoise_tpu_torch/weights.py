"""Model weights: seeded random initialization, checkpoint loading, casting.

A model's weights come from the reference's ``<models_dir>/<reference
name>.pth`` (through the numpy converters of
``tortoise_tpu/convert/torch_import.py`` and then ``convert/from_jax.py``)
or, when allowed, from a seeded ``torch.Generator`` at full width.
"""
from __future__ import annotations

import contextlib
import os
import sys
import types
import warnings
from collections.abc import Mapping

import torch
from torch import nn

from tortoise_tpu_torch.convert.from_jax import from_jax
from tortoise_tpu_torch.models.layers import Conv1d, ConvTranspose1d, Dense, Embed, Norm

REFERENCE_CHECKPOINTS = {
    "autoregressive": "autoregressive.pth",
    "diffusion_decoder": "diffusion_decoder.pth",
    "clvp": "clvp2.pth",
    "vocoder": "vocoder.pth",
}
# names of float parameters that stay float32 under cast_for_inference, as in
# tortoise_tpu/weights.py::cast_for_inference
_KEEP_F32 = ("Norm", "norm", "ln_")


@torch.no_grad()
def init_random(model: nn.Module, seed: int) -> None:
    """Fill every parameter from a seeded generator on the model's device:
    dense/conv weights N(0, 1/fan_in), embeddings N(0, 0.02^2), the
    unconditioned embedding N(0, 1), biases 0, norm scales and the CLVP
    temperature 1."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal_(p, std):
        p.copy_(torch.randn(p.shape, generator=gen, device=dev) * std)

    for _, module in model.named_modules():
        for name, p in module.named_parameters(recurse=False):
            if isinstance(module, (Dense, Conv1d, ConvTranspose1d)) and name == "weight":
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


def _tree_map(fn, tree, *rest):
    """``jax.tree.map`` over nested dicts, which is all ``torch_import`` asks of it."""
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


@contextlib.contextmanager
def _layer_stacking_without_jax():
    """``torch_import`` stacks per-layer dicts of numpy arrays with
    ``jax.tree.map(np.stack)``, imported inside its functions; that is its
    only use of jax. Unless jax is loaded already, a stand-in ``jax`` module
    holding just that function is importable while the conversion runs, so a
    checkpoint loads where jax is not installed and the port never imports
    it.

    The stand-in is process-wide: another thread that imports jax while a
    conversion runs gets it. That is acceptable only while checkpoints are
    converted once, in ``TextToSpeech.__init__``, and the repo ships none;
    the lasting fix is a numpy tree map that ``torch_import`` takes as a
    parameter (ROADMAP.md, Queue 1)."""
    if "jax" in sys.modules:
        yield
        return
    stand_in = types.ModuleType("jax")
    stand_in.tree = types.SimpleNamespace(map=_tree_map)
    sys.modules["jax"] = stand_in
    try:
        yield
    finally:
        del sys.modules["jax"]


def convert_reference_checkpoint(name: str, path: str, model: nn.Module) -> dict:
    """A reference ``.pth`` -> the port's state_dict."""
    from tortoise_tpu.convert import torch_import as ti

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
        "vocoder": ti.univnet_params,
    }
    with _layer_stacking_without_jax():
        params = converters[name](sd)
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
