"""Sentence-aware text chunking for long-form synthesis.

A copy of ``tortoise_tpu/utils/text.py``: the port imports nothing of the
JAX package.

Behavioral equivalent of the reference splitter (reference:
tortoise/utils/text.py:4-73), held to spec by golden-output tests: emit
chunks of roughly ``desired_length`` characters, breaking at sentence
boundaries (quote-aware), force-splitting at ``max_length`` by backtracking
to the last boundary or, failing that, to a word boundary.

Design notes (intentional quirk preservation — the reference's behavior is
the contract, verified by tests/test_text_and_tokenizer.py golden cases):

* Lookahead cannot see the final character of the text (out-of-range
  lookahead yields ``""``, and ``"" in "\\n "`` is True, so text-end acts
  like a boundary).
* Quote state is tracked by *toggling on every character the cursor steps
  onto*, in either direction. Because a backward step toggles on the char
  stepped onto (not the one stepped off), a rewind is not an exact inverse
  of the forward walk; we replicate that arithmetic rather than using
  positional parity.
"""
from __future__ import annotations

import re

_SENTENCE_ENDERS = "!?\n"
_BOUNDARY_TAIL = "\n "  # chars that may legally follow '.' or a closing quote
_PUNCT_ONLY = re.compile(r"^[\s\.,;:!?]*$")


def _normalize(text: str) -> str:
    text = re.sub(r"\n\n+", "\n", text)
    text = re.sub(r"\s+", " ", text)
    return re.sub(r"[“”]", '"', text)


def split_and_recombine_text(
    text: str, desired_length: int = 200, max_length: int = 300
) -> list[str]:
    text = _normalize(text)

    last = len(text) - 1

    def look(p: int) -> str:
        # Reference quirk: the final character is invisible to lookahead.
        return text[p] if 0 <= p < last else ""

    chunks: list[str] = []
    start = 0          # first index of the chunk being assembled
    i = -1             # index of the last character consumed
    boundaries: list[int] = []  # split candidates inside the current chunk
    quoted = False

    def emit(upto: int) -> int:
        """Close the current chunk at index ``upto`` (inclusive)."""
        nonlocal boundaries
        chunks.append(text[start : upto + 1])
        boundaries = []
        return upto + 1

    while i < last:
        i += 1
        if text[i] == '"':
            quoted = not quoted
        size = i - start + 1

        if size >= max_length:
            # Overlong chunk: cut at the best known sentence boundary if the
            # kept part stays reasonably long; otherwise walk back to a word
            # boundary (but never shrink below desired_length).
            if boundaries and size > desired_length / 2:
                cut = boundaries[-1]
                for j in range(i - 1, cut - 1, -1):  # backward steps toggle
                    if text[j] == '"':
                        quoted = not quoted
                i = cut
            else:
                while (
                    text[i] not in "!?.\n "
                    and i > 0
                    and (i - start + 1) > desired_length
                ):
                    i -= 1
                    if text[i] == '"':
                        quoted = not quoted
            start = emit(i)
        elif not quoted and (
            text[i] in _SENTENCE_ENDERS
            or (text[i] == "." and look(i + 1) in _BOUNDARY_TAIL)
        ):
            # Absorb runs of terminal punctuation ("?!", "...") into the
            # boundary before recording it.
            while i < last and (i - start + 1) < max_length and look(i + 1) in "!?.":
                i += 1
                if text[i] == '"':
                    quoted = not quoted
            boundaries.append(i)
            if i - start + 1 >= desired_length:
                start = emit(i)
        elif quoted and look(i + 1) == '"' and look(i + 2) in _BOUNDARY_TAIL:
            # A sentence that ends at a closing quote: consume the quote and
            # mark the boundary after it.
            for _ in range(2):
                i += 1
                if text[i] == '"':
                    quoted = not quoted
            boundaries.append(i)

    chunks.append(text[start:])

    return [c.strip() for c in chunks if c.strip() and not _PUNCT_ONLY.match(c)]
