"""Convert and verify the reference's checkpoints found on disk.

Counterpart of ``tools/fetch_weights.py``'s ``--offline`` path, flag for
flag (its downloads are not ported: this tool reads only what is already on
disk):

    python3 -m tortoise_tpu_torch.tools.fetch_weights --offline [names... | fast] \\
        [--src DIR] [--dst DIR] [--force]

For each checkpoint family (default: all; ``fast`` = the fast path's set)
it converts the reference ``.pth`` in ``--src`` (``$TORTOISE_MODELS_DIR``)
to the JAX-layout ``.npz`` tree in ``--dst`` (``$TORTOISE_TPU_MODELS_DIR``)
through ``weights.convert_from_torch``, or reads the ``.npz`` already there
(``--force`` converts again), and verifies that the tree covers the
shipped-config model key for key and shape for shape: the port's model is
built on the ``meta`` device and its JAX-layout names and shapes come from
``convert/from_jax.jax_shapes``. Host code: no GPU.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from tortoise_tpu_torch import weights

FAST_SET = ("autoregressive", "classifier", "rlg_auto", "hifidecoder")


def shipped_model(name: str) -> torch.nn.Module:
    """The shipped-config port model of checkpoint family ``name``, on the
    ``meta`` device."""
    from tortoise_tpu_torch.models import (autoregressive, classifier, clvp, cvvp,
                                           diffusion_decoder, hifigan, random_latent, vocoder,
                                           wav2vec2)

    families = {
        "autoregressive": lambda: autoregressive.UnifiedVoice(),
        "diffusion_decoder": lambda: diffusion_decoder.DiffusionTts(),
        "clvp": lambda: clvp.CLVP(),
        "cvvp": lambda: cvvp.CVVP(),
        "vocoder": lambda: vocoder.UnivNetGenerator(vocoder.UnivNetConfig()),
        "classifier": lambda: classifier.AudioMiniEncoderWithClassifierHead(
            classifier.ClassifierConfig()),
        "rlg_auto": lambda: random_latent.RandomLatentConverter(1024),
        "rlg_diffuser": lambda: random_latent.RandomLatentConverter(2048),
        "hifidecoder": lambda: hifigan.HifiganGenerator(
            hifigan.HifiganConfig(in_channels=1024, cond_channels=1024)),
        "wav2vec2": lambda: wav2vec2.Wav2Vec2ForCTC(wav2vec2.Wav2Vec2Config()),
    }
    with torch.device("meta"):
        return families[name]()


def _flat_shapes(tree, prefix: str = "") -> dict[str, tuple]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        out.update(_flat_shapes(v, key) if isinstance(v, dict) else {key: np.shape(v)})
    return out


def verify_coverage(name: str, params: dict) -> list[str]:
    """Key and shape differences of a converted tree against the shipped
    model's, as the JAX tool words them (empty: verified)."""
    from tortoise_tpu_torch.convert.from_jax import jax_shapes

    want = jax_shapes(shipped_model(name))
    got = _flat_shapes(params)
    problems = [f"missing key {k} {want[k]}" for k in sorted(want.keys() - got.keys())]
    problems += [f"unexpected key {k} {got[k]}" for k in sorted(got.keys() - want.keys())]
    problems += [f"shape mismatch {k}: converted {got[k]} != model {want[k]}"
                 for k in sorted(want.keys() & got.keys()) if want[k] != got[k]]
    return problems


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("names", nargs="*",
                        help="checkpoint families (default: all); 'fast' = the fast-path set")
    parser.add_argument("--offline", action="store_true",
                        help="never touch the network; convert/verify local files (required: "
                             "downloads are not ported)")
    parser.add_argument("--src", default=weights.TORCH_MODELS_DIR,
                        help="torch checkpoint cache ($TORTOISE_MODELS_DIR)")
    parser.add_argument("--dst", default=weights.MODELS_DIR,
                        help="native checkpoint dir ($TORTOISE_TPU_MODELS_DIR)")
    parser.add_argument("--force", action="store_true",
                        help="re-convert even if the .npz exists")
    return parser


def _one(name: str, args) -> str:
    fname = weights.REFERENCE_CHECKPOINTS[name]
    torch_path = os.path.join(args.src, fname)
    npz_path = os.path.join(args.dst, f"{name}.npz")
    print(f"[{name}]")
    if not os.path.exists(torch_path):
        print(f"    no local {fname}, --offline: skipped")
        return "skipped (offline, no local file)"
    if args.force or not os.path.exists(npz_path):
        try:
            params = weights.convert_from_torch(name, torch_path)
        except Exception as e:  # noqa: BLE001 - reported per family, as the JAX tool does
            print(f"    convert FAILED: {type(e).__name__}: {e}")
            return f"convert failed: {e}"
        weights.save_params(npz_path, params)
        print(f"    converted -> {npz_path}")
    else:
        params = weights.load_params(npz_path)
        print(f"    already converted ({npz_path})")
    problems = verify_coverage(name, params)
    if problems:
        for p in problems[:12]:
            print(f"    VERIFY: {p}")
        if len(problems) > 12:
            print(f"    VERIFY: ... {len(problems) - 12} more")
        return f"verify failed ({len(problems)} problems)"
    n_params = sum(int(np.prod(s)) for s in _flat_shapes(params).values())
    print(f"    verified: full key+shape coverage ({n_params / 1e6:.1f}M params)")
    return "ok"


def main(argv=None) -> dict:
    """Returns {family: "ok", "skipped (...)", "convert failed: ..." or
    "verify failed (N problems)"}. Without ``--offline`` it raises: the
    JAX tool downloads what is missing, and that is not ported."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if not args.offline:
        raise NotImplementedError("fetch_weights: downloads are not ported; pass --offline to "
                                  "convert and verify the checkpoints already in --src")
    names = list(weights.REFERENCE_CHECKPOINTS)
    if args.names == ["fast"]:
        names = list(FAST_SET)
    elif args.names:
        unknown = set(args.names) - set(weights.REFERENCE_CHECKPOINTS)
        if unknown:
            parser.error(f"unknown families {sorted(unknown)}; "
                         f"choose from {sorted(weights.REFERENCE_CHECKPOINTS)}")
        names = args.names
    results = {name: _one(name, args) for name in names}
    print("\nsummary:")
    for name, status in results.items():
        print(f"  {name:20s} {status}")
    return results


if __name__ == "__main__":
    res = main()
    sys.exit(0 if all(v == "ok" or v.startswith("skipped") for v in res.values()) else 1)
