"""The benchmark's weights: seeded random values made on the device.

Both sides get the same values: ``fill`` writes them into a model of the
program as it is built, through the program's random-weights path
(``install``), and the reference models load them by ``fill`` too. A
model's values follow from the run's seed, the model's name and its
parameters' names, shapes and kinds alone, drawn in one ``torch.randn``
a model in the order of the sorted names:

* dense and conv weights N(0, 1/fan_in); embeddings N(0, 0.02^2); the
  diffusion decoder's unconditioned embedding N(0, 1);
* norm scales 1, biases 0, any other parameter 1;
* the AR prior's logit bias -30 at the calm code and the start and stop
  tokens (its reference module's ``SUPPRESSED``, handed to ``fill`` and
  ``install``): the random prior never emits them, so every request
  decodes and delivers exactly the mel tokens it asks for (a stop token
  would end it early, and a run of nine calm codes trims the quality
  pipeline's audio, each at seeds the weights choose).

The kind of a parameter is read from the class name of the module that
holds it, which the reference's leaf modules share with the program's.
"""
from __future__ import annotations

import contextlib
import zlib

import torch
from torch import nn

MATRIX = {"Dense", "Conv1d", "ConvTranspose1d"}
NORMS = {"Norm", "LayerNorm"}


def spec(model: nn.Module) -> list[tuple[str, tuple, float | None]]:
    """(name, shape, std) of each parameter, sorted by name; std None for
    the constants, whose value ``_constant`` gives."""
    out = []
    for mname, module in model.named_modules():
        kind = type(module).__name__
        for pname, p in module.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            shape = tuple(p.shape)
            std = None
            if kind in MATRIX and pname == "weight":
                fan_in = shape[0] * shape[-1] if kind == "ConvTranspose1d" else \
                    (shape[-1] if kind == "Dense" else shape[-2] * shape[-1])
                std = fan_in ** -0.5
            elif kind == "Embed":
                std = 0.02
            elif pname == "unconditioned_embedding":
                std = 1.0
            out.append((name, shape, std))
    return sorted(out)


def _constant(name: str) -> float:
    return 0.0 if name.endswith("bias") else 1.0


def make(model_name: str, entries, seed: int, device,
         suppressed: tuple | None = None) -> dict[str, torch.Tensor]:
    """The state dict of ``entries`` (``spec``'s list) for ``model_name``
    under the run's ``seed``, float32 on ``device``; ``suppressed``
    (parameter, indices, value) sets those entries of that parameter, which
    the model must have."""
    g = torch.Generator(device=device).manual_seed(
        (int(seed) * 1000003 + zlib.crc32(model_name.encode())) % (1 << 63))
    total = sum(torch.Size(s).numel() for _, s, std in entries if std is not None)
    noise = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for name, shape, std in entries:
        n = torch.Size(shape).numel()
        if std is None:
            out[name] = torch.full(shape, _constant(name), device=device)
        else:
            out[name] = noise[at:at + n].view(shape).mul_(std)
            at += n
    if suppressed is not None:
        param, indices, value = suppressed
        if param not in out:
            raise ValueError(f"{model_name} has no parameter {param} to suppress codes in")
        out[param][list(indices)] = value
    return out


@torch.no_grad()
def fill(model: nn.Module, model_name: str, seed: int, suppressed: tuple | None = None) -> list:
    """Load the benchmark's values into ``model`` (strict); returns its spec."""
    entries = spec(model)
    device = next(model.parameters()).device
    model.load_state_dict(make(model_name, entries, seed, device, suppressed), strict=True)
    return entries


@contextlib.contextmanager
def install(weights_module, seed: int, specs: dict, suppressed: dict | None = None):
    """While the block runs, the program's random-weights hook
    (``weights_module.init_random``, which its loaders call for a model
    with no checkpoint) fills each model of the classes in ``specs`` with
    the benchmark's values (``suppressed``: class name -> ``make``'s
    ``suppressed``) and records its spec there; other models keep the
    program's own random values."""
    suppressed = suppressed or {}
    original = weights_module.init_random

    def init_random(model, program_seed):
        name = type(model).__name__
        if name in specs:
            specs[name] = fill(model, name, seed, suppressed.get(name))
        else:
            original(model, program_seed)

    weights_module.init_random = init_random
    try:
        yield
    finally:
        weights_module.init_random = original
