"""The traffic generator: one general reader of the mix files in ``traffic/``.

A mix file (``traffic/<mix>.json``) states its parameters; ``requests``
turns it and the run's seed into an endless, reproducible sequence of
requests for a closed loop with one client. Every seed gets the same work
in another order: the sizes come in cycles, each cycle the same
``cycle`` mel-token counts spaced evenly over ``mel_tokens`` (both ends in),
the longest first and the rest in an order drawn from the seed. A request's text is words of
``words.txt`` drawn from the seed up to ``count / mel_tokens_per_char``
characters (Tortoise speaks about 15 characters and 21.5 mel tokens a
second). In each cycle the first (longest) request and
``greedy_per_cycle - 1`` others drawn from the seed decode greedily, so that the reference can
judge their tokens; the rest sample as the entry point's defaults do.

Keys of a mix file:

* ``entry``: ``tts_with_preset``, ``tts_stream`` or ``tts_batch``;
* ``mel_tokens``: [least, most] decoded mel tokens a request;
* ``cycle``, ``greedy_per_cycle``, ``mel_tokens_per_char``;
* ``voices``: the built-in voices whose clips condition the requests, one
  drawn in turn from each cycle's shuffled list;
* ``batch``: utterances a ``tts_batch`` call (one mel-token count a call);
* ``kwargs``: fixed keyword arguments of the entry point (``preset``,
  ``first_chunk_size``, ...);
* ``warm_requests``: requests answered in set-up, the first of a sequence
  drawn from the seed plus one (the longest first);
* ``trace_requests``: requests the ``--trace 1`` run traces;
* ``check_requests``: the window's first requests, which the reference
  judges (the greedy ones' tokens too).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterator

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ENTRIES = ("tts_with_preset", "tts_stream", "tts_batch")
# keyword arguments that make a request greedy: no repetition penalty, and
# one token left after top-p (top_k=1 where the entry takes it)
GREEDY = {"tts_with_preset": {"top_p": 1e-9, "repetition_penalty": 1.0},
          "tts_stream": {"top_k": 1, "repetition_penalty": 1.0},
          "tts_batch": {"top_k": 1, "repetition_penalty": 1.0}}


@dataclasses.dataclass
class Request:
    index: int
    texts: list[str]
    voices: list[str]
    mel_tokens: int
    greedy: bool
    seed: int

    def kwargs(self, mix: dict) -> dict:
        out = dict(mix.get("kwargs", {}))
        if self.greedy:
            out.update(GREEDY[mix["entry"]])
        return out


def load_mix(name: str) -> dict:
    """``traffic/<name>.json``, or the file ``name`` itself if it ends in .json."""
    path = name if name.endswith(".json") else os.path.join(HERE, "traffic", f"{name}.json")
    with open(path) as f:
        mix = json.load(f)
    if mix["entry"] not in ENTRIES:
        raise ValueError(f"traffic {name}: entry {mix['entry']!r} is not one of {ENTRIES}")
    return mix


def load_words() -> list[str]:
    with open(os.path.join(HERE, "words.txt")) as f:
        return f.read().split()


def cycle_sizes(mix: dict) -> list[int]:
    lo, hi = mix["mel_tokens"]
    n = mix["cycle"]
    return [int(round(lo + i * (hi - lo) / (n - 1))) for i in range(n)]


def text_for(rng: np.random.Generator, words: list[str], chars: int) -> str:
    out, length = [], 0
    while length < chars:
        w = words[int(rng.integers(len(words)))]
        out.append(w)
        length += len(w) + 1
    return " ".join(out).capitalize() + "."


def requests(mix: dict, seed: int) -> Iterator[Request]:
    rng = np.random.default_rng(int(seed))
    words = load_words()
    sizes = cycle_sizes(mix)
    ratio = float(mix["mel_tokens_per_char"])
    batch = int(mix.get("batch", 1))
    index = 0
    while True:
        # the longest first, the rest in an order drawn from the seed
        order = [len(sizes) - 1] + [int(i) for i in rng.permutation(len(sizes) - 1)]
        voices = [mix["voices"][i] for i in rng.permutation(len(mix["voices"]))]
        greedy = {0, *(1 + rng.choice(len(sizes) - 1, mix["greedy_per_cycle"] - 1,
                                      replace=False))}
        for j, i in enumerate(order):
            tokens = sizes[i]
            texts = [text_for(rng, words, int(round(tokens / ratio))) for _ in range(batch)]
            vs = [voices[(j + r) % len(voices)] for r in range(batch)]
            yield Request(index, texts, vs, tokens, j in greedy,
                          int(rng.integers(1, 2 ** 31 - 1)))
            index += 1
