"""One-time converter: an HF ``tokenizers`` BPE json -> the BPE vocab asset.

Counterpart of ``tools/convert_tokenizer.py``: the same output file. It
extracts the 255-symbol BPE vocab and merge list of a reference
``tokenizer.json`` (reference tortoise/data/tokenizer.json, read by
tortoise/utils/tokenizer.py:172-194) into the compact schema that
``utils/tokenizer.py`` reads. Usage:

    python3 -m tortoise_tpu_torch.tools.convert_tokenizer tokenizer.json \\
        tortoise_tpu_torch/data/bpe_vocab.json
"""
from __future__ import annotations

import argparse
import json


def convert(src: str, dst: str) -> dict:
    """Writes ``dst`` from ``src``; returns the asset written."""
    with open(src) as f:
        d = json.load(f)
    model = d["model"]
    out = {
        "schema": "tortoise-tpu-bpe-v1",
        "unk_token": model.get("unk_token", "[UNK]"),
        "special_tokens": [t["content"] for t in d.get("added_tokens", [])],
        "vocab": model["vocab"],
        "merges": model["merges"],
    }
    with open(dst, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
    print(f"wrote {dst}: {len(out['vocab'])} tokens, {len(out['merges'])} merges")
    return out


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("src")
    parser.add_argument("dst")
    return parser


def main(argv=None) -> dict:
    """Returns {"dst": the file written, "tokens": its vocab size, "merges":
    its merge count}."""
    args = build_parser().parse_args(argv)
    out = convert(args.src, args.dst)
    return {"dst": args.dst, "tokens": len(out["vocab"]), "merges": len(out["merges"])}


if __name__ == "__main__":
    main()
