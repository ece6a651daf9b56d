"""JAX param tree -> the port's ``state_dict``.

The port's modules sit at the same paths as the JAX package's flax modules
(``gpt.h_scan.block.attn.c_attn`` is ``gpt/h_scan/block/attn/c_attn``), so
the conversion walks the port model and reads each leaf module's JAX
counterpart, changing layout by module type:

* Dense ``kernel (…, in, out)`` -> ``weight (…, out, in)``;
* QuantDense ``kernel`` int8 ``(…, in, out)`` -> int8 ``weight (…, out, in)``,
  with ``qscale`` and ``bias`` as they are;
* Conv ``kernel (…, K, in, out)`` -> ``weight (…, out, in, K)``;
* ConvTranspose (time-flipped ``(K, in, out)``) -> ``weight (in, out, K)``;
* LayerNorm/GroupNorm ``scale`` -> ``weight``; Embed ``embedding`` -> ``weight``;
* any other parameter (``g``, ``temperature``, ``unconditioned_embedding``,
  the EqualLinear ``weight``/``bias`` of the random-latent generators, whose
  JAX layout is torch's) is copied under its own name.

``…`` is the leading layer axis of the scan-stacked layers, kept as is.
The same walk maps a JAX gradient tree onto the port's parameters. A
reference ``.pth`` reaches this through the port's
numpy converters (``convert/torch_import.py``); see ``weights.py``.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from tortoise_tpu_torch.models.layers import (Conv1d, ConvTranspose1d, Dense, Embed, Norm,
                                              QuantDense)


def _lookup(tree: Mapping, path: list[str], key: str) -> Mapping:
    node = tree
    for i, p in enumerate(path):
        if not isinstance(node, Mapping) or p not in node:
            raise KeyError(f"JAX tree has no entry {'/'.join(path[:i + 1])} (for {key})")
        node = node[p]
    return node


def _convert(module: nn.Module, name: str, sub: Mapping) -> np.ndarray:
    a = lambda k: np.asarray(sub[k], dtype=np.float32)
    if isinstance(module, Dense):
        return np.swapaxes(a("kernel"), -1, -2) if name == "weight" else a("bias")
    if isinstance(module, QuantDense):
        if name == "weight":
            k = np.asarray(sub["kernel"])
            if k.dtype != np.int8:
                raise ValueError("QuantDense needs an int8 kernel: quantize the JAX tree first "
                                 "(weights.quantize_gpt_weights)")
            return np.swapaxes(k, -1, -2)
        return a(name)
    if isinstance(module, Conv1d):
        return np.swapaxes(a("kernel"), -1, -3) if name == "weight" else a("bias")
    if isinstance(module, ConvTranspose1d):
        return a("kernel")[::-1].transpose(1, 2, 0) if name == "weight" else a("bias")
    if isinstance(module, Norm):
        return a("scale") if name == "weight" else a("bias")
    if isinstance(module, Embed):
        return a("embedding")
    return a(name)


def from_jax(model: nn.Module, params: Mapping) -> dict[str, torch.Tensor]:
    """``params``: the JAX tree (the "params" collection) of the model that
    ``model`` ports. Returns a state_dict with exactly ``model``'s keys."""
    out = {}
    for mname, module in model.named_modules():
        path = mname.split(".") if mname else []
        for pname, p in module.named_parameters(recurse=False):
            key = f"{mname}.{pname}" if mname else pname
            arr = np.array(_convert(module, pname, _lookup(params, path, key)), order="C")
            if arr.shape != tuple(p.shape):
                raise ValueError(f"{key}: JAX shape {arr.shape} != port shape {tuple(p.shape)}")
            out[key] = torch.from_numpy(arr)
    return out
