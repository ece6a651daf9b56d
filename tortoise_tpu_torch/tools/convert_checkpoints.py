"""Convert the reference's torch checkpoints into ``.npz`` param trees.

Counterpart of ``tools/convert_checkpoints.py``, flag for flag:

    python3 -m tortoise_tpu_torch.tools.convert_checkpoints [--src DIR] [--dst DIR] [names...]

Without names it converts every reference checkpoint it finds in ``--src``
(default ``$TORTOISE_MODELS_DIR``, ``~/.cache/tortoise/models``) into
``--dst`` (default ``$TORTOISE_TPU_MODELS_DIR``,
``~/.cache/tortoise_tpu/models``), where ``weights.load_weights`` and the
JAX package's ``get_params`` look first. A tree is converted at the
shipped configs' depths, as the JAX tool converts it. Host code: no GPU.
"""
from __future__ import annotations

import argparse
import os

from tortoise_tpu_torch import weights


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("names", nargs="*", default=[])
    parser.add_argument("--src", default=weights.TORCH_MODELS_DIR)
    parser.add_argument("--dst", default=weights.MODELS_DIR)
    return parser


def main(argv=None) -> dict:
    """Returns {name: the path written, or why it was skipped}."""
    args = build_parser().parse_args(argv)
    out = {}
    for name in args.names or list(weights.REFERENCE_CHECKPOINTS):
        src = os.path.join(args.src, weights.REFERENCE_CHECKPOINTS[name])
        if not os.path.exists(src):
            out[name] = f"skip: {src} not found"
        else:
            dst = os.path.join(args.dst, f"{name}.npz")
            weights.save_params(dst, weights.convert_from_torch(name, src))
            out[name] = dst
        print(f"{name}: {out[name]}")
    return out


if __name__ == "__main__":
    main()
