"""Voice BPE tokenizer in pure Python.

Port of ``tortoise_tpu/utils/tokenizer.py`` without the HF ``tokenizers``
package: clean the text, replace spaces with ``[SPACE]``, split out the
special tokens, pre-tokenize like HF's ``Whitespace`` (``\\w+|[^\\w\\s]+``),
map characters to symbols (unknown ones to ``[UNK]``, unfused), then apply
the merges of ``data/bpe_vocab.json`` (a copy of the JAX package's) lowest
rank first, leftmost first among equal ranks, as HF's BPE model does.
``decode`` joins the ids' symbols and undoes the ``[SPACE]`` replacement.
"""
from __future__ import annotations

import json
import os
import re

from tortoise_tpu_torch.utils.cleaners import basic_cleaners, english_cleaners

DEFAULT_VOCAB_FILE = os.path.join(os.path.dirname(os.path.realpath(__file__)), "..", "data",
                                  "bpe_vocab.json")

_PRE_TOKEN = re.compile(r"\w+|[^\w\s]+")


class VoiceBpeTokenizer:
    def __init__(self, vocab_file: str | None = None, use_basic_cleaners: bool = False):
        with open(vocab_file or DEFAULT_VOCAB_FILE) as f:
            d = json.load(f)
        if d.get("schema") != "tortoise-tpu-bpe-v1":
            raise ValueError("expected a tortoise-tpu-bpe-v1 vocabulary "
                             "(tools/convert_tokenizer.py converts an HF tokenizer file)")
        self.vocab: dict[str, int] = d["vocab"]
        self.symbols = {i: sym for sym, i in self.vocab.items()}
        self.unk_id = self.vocab[d["unk_token"]]
        merges = [tuple(m.split(" ")) if isinstance(m, str) else tuple(m) for m in d["merges"]]
        self.ranks = {pair: i for i, pair in enumerate(merges)}
        self.special = {t: self.vocab[t] for t in d.get("special_tokens", [])}
        self._special_re = re.compile("|".join(
            re.escape(t) for t in sorted(self.special, key=len, reverse=True))) \
            if self.special else None
        self.preprocess_text = basic_cleaners if use_basic_cleaners else english_cleaners

    def vocab_size(self) -> int:
        return len(self.vocab)

    def _bpe(self, word: str) -> list[int]:
        syms: list[str | None] = [c if c in self.vocab else None for c in word]
        while len(syms) > 1:
            best, best_rank = -1, None
            for i in range(len(syms) - 1):
                a, b = syms[i], syms[i + 1]
                if a is None or b is None:
                    continue
                r = self.ranks.get((a, b))
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = i, r
            if best < 0:
                break
            syms[best:best + 2] = [syms[best] + syms[best + 1]]
        return [self.unk_id if s is None else self.vocab[s] for s in syms]

    def _encode_plain(self, text: str) -> list[int]:
        ids: list[int] = []
        for word in _PRE_TOKEN.findall(text):
            ids.extend(self._bpe(word))
        return ids

    def encode(self, txt: str) -> list[int]:
        txt = self.preprocess_text(txt).replace(" ", "[SPACE]")
        if self._special_re is None:
            return self._encode_plain(txt)
        ids: list[int] = []
        pos = 0
        for m in self._special_re.finditer(txt):
            ids.extend(self._encode_plain(txt[pos:m.start()]))
            ids.append(self.special[m.group(0)])
            pos = m.end()
        ids.extend(self._encode_plain(txt[pos:]))
        return ids

    def decode(self, seq) -> str:
        """Ids (ints, numpy ints or a 1-D tensor) -> text, as the JAX
        package's ``decode`` through HF's: the ids' symbols joined, ids
        without one (at or above the vocabulary's size) dropped, spaces
        removed, ``[SPACE]`` made a space, ``[STOP]`` and ``[UNK]`` dropped.
        A negative id raises ``OverflowError``, as HF's does."""
        syms = []
        for s in seq:
            i = int(s)
            if i < 0:
                raise OverflowError(f"token id {i} is negative")
            if i in self.symbols:
                syms.append(self.symbols[i])
        txt = "".join(syms).replace(" ", "")
        return txt.replace("[SPACE]", " ").replace("[STOP]", "").replace("[UNK]", "")
