"""wav2vec2-CTC audio <-> text alignment and bracket redaction.

Port of ``tortoise_tpu/utils/wav2vec_alignment.py`` (reference
tortoise/utils/wav2vec_alignment.py): a character-level DP alignment of the
expected text against the CTC argmax string, used to cut ``[bracketed]``
prompt-engineering spans out of the audio.

As in the JAX package, the DP (``max_alignment``) is iterative, with the
native library's DP as its fast path, and ``logits_fn`` stays injectable.
The default acoustic model is the port's ``models/wav2vec2.Wav2Vec2ForCTC``
on the aligner's device, run at each clip's exact length
(``wav2vec2_logits_fn``): the JAX package's 1 s length buckets only avoid
XLA recompiles. Its weights come from ``<models_dir>/wav2vec2.pth`` (the HF
checkpoint's state dict) through the port's converter. Unlike the JAX
package, there is no fallback to the HF hub: the port imports no
``transformers`` and fetches nothing, so with no checkpoint the first use
raises ``FileNotFoundError``, which ``TextToSpeech`` turns into a warning
and unredacted audio.
"""
from __future__ import annotations

import os
from typing import Callable

import numpy as np
import torch


def max_alignment(s1: str, s2: str, skip_character: str = "~") -> str:
    """Align s1 to s2, replacing unmatched s1 characters with ``~``.

    Iterative LCS-style DP with the same tie-breaking as the reference
    (prefer consuming s2 when scores are equal, reference
    wav2vec_alignment.py:10-45).
    """
    assert skip_character not in s1, (
        f"Found the skip character {skip_character} in the provided string, {s1}")
    from tortoise_tpu_torch import native

    if native.available():
        fast = native.align_dp(s1, s2, skip_character)
        if fast is not None:
            return fast
    n, m = len(s1), len(s2)
    if n == 0:
        return ""
    if m == 0:
        return skip_character * n
    if s1 == s2:
        return s1

    # score[i][j] = matched chars aligning s1[i:] with s2[j:]
    score = np.zeros((n + 1, m + 1), dtype=np.int32)
    for i in range(n - 1, -1, -1):
        for j in range(m - 1, -1, -1):
            if s1[i] == s2[j]:
                score[i, j] = 1 + score[i + 1, j + 1]
            else:
                score[i, j] = max(score[i, j + 1], score[i + 1, j])
    out = []
    i = j = 0
    while i < n:
        if j >= m:
            out.append(skip_character)
            i += 1
        elif s1[i] == s2[j]:
            out.append(s1[i])
            i += 1
            j += 1
        elif score[i, j + 1] > score[i + 1, j]:
            j += 1  # consume s2 (take_s1 branch in the reference)
        else:
            out.append(skip_character)
            i += 1
    return "".join(out)


# Tacotron symbol set used by the CTC tokenizer ('jbetker/tacotron-symbols'):
# pad '_' at 0, then punctuation, letters; space maps to its own symbol.
_TACOTRON_SYMBOLS = ["_", "-", "!", "'", "(", ")", ",", ".", ":", ";", "?", " "] + \
    list("abcdefghijklmnopqrstuvwxyz") + list("ABCDEFGHIJKLMNOPQRSTUVWXYZ")


class TacotronCTCTokenizer:
    """Character tokenizer with CTC decode (collapse repeats, drop blanks)."""

    def __init__(self, symbols=None):
        self.symbols = symbols or _TACOTRON_SYMBOLS
        self.sym_to_id = {s: i for i, s in enumerate(self.symbols)}

    UNK = -100  # never equals an argmax id; keeps token/char lists aligned

    def encode(self, text: str) -> list[int]:
        return [self.sym_to_id.get(c, self.UNK) for c in text]

    def decode(self, ids) -> str:
        out = []
        prev = None
        for i in ids:
            if i != prev and i != 0:
                out.append(self.symbols[i])
            prev = i
        return "".join(out)


def _bracket_segments(text: str) -> list[tuple[str, bool]]:
    """Split ``a [b] c`` markup into (segment, is_bracketed) pieces."""
    segments = []
    rest = text
    while rest:
        if rest.startswith("["):
            close = rest.find("]")
            assert close != -1, \
                'Every "[" character must be paired with a "]" with no nesting.'
            inner = rest[1:close]
            assert "[" not in inner, \
                'Every "[" character must be paired with a "]" with no nesting.'
            segments.append((inner, True))
            rest = rest[close + 1:]
        else:
            nxt = rest.find("[")
            cut = len(rest) if nxt == -1 else nxt
            segments.append((rest[:cut], False))
            rest = rest[cut:]
    return segments


def _fill_gaps(offsets: list[int], end: int) -> list[int]:
    """Replace -1 runs with integer-linearly spaced values between their
    known neighbors (same arithmetic as reference :111-121); ``end`` bounds
    the final run."""
    offsets = offsets + [end]
    i = 0
    while i < len(offsets):
        if offsets[i] != -1:
            i += 1
            continue
        j = i
        while offsets[j] == -1:
            j += 1
        span = offsets[j] - offsets[i - 1]
        for k in range(i, j):
            offsets[k] = offsets[i - 1] + (k - i + 1) * span // (j - i + 1)
        i = j + 1
    return offsets[:-1]


class Wav2VecAlignment:
    """Audio <-> text alignment through a CTC model (reference :48-150).

    ``logits_fn(audio_16k) -> (frames, vocab)`` supplies the acoustic model;
    by default the port's wav2vec2 is loaded on ``device`` from
    ``<models_dir>/wav2vec2.pth`` at the first call that needs it.
    """

    def __init__(self, logits_fn: Callable | None = None, tokenizer=None,
                 models_dir: str | None = None, device="cuda"):
        self._logits_fn = logits_fn
        self._models_dir = models_dir
        self.device = torch.device(device)
        self.tokenizer = tokenizer or TacotronCTCTokenizer()

    def _default_logits_fn(self):
        from tortoise_tpu_torch import weights as weights_lib
        from tortoise_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2ForCTC

        # fail before allocating the 315M-parameter model
        name = weights_lib.REFERENCE_CHECKPOINTS["wav2vec2"]
        if not (self._models_dir and os.path.exists(os.path.join(self._models_dir, name))):
            raise FileNotFoundError(f"no wav2vec2 checkpoint ({name}) in {self._models_dir!r}")
        with torch.device(self.device):
            model = Wav2Vec2ForCTC(Wav2Vec2Config(vocab_size=len(self.tokenizer.symbols)))
        weights_lib.load_weights("wav2vec2", model, self._models_dir, False, 0)
        return wav2vec2_logits_fn(model.eval(), self.device)

    def _logits(self, audio: np.ndarray, sample_rate: int) -> np.ndarray:
        from tortoise_tpu_torch.utils.audio import resample

        if self._logits_fn is None:  # before resampling: a missing checkpoint fails fast
            self._logits_fn = self._default_logits_fn()
        return self._logits_fn(resample(np.asarray(audio, np.float32), sample_rate, 16000))

    def align(self, audio: np.ndarray, expected_text: str,
              audio_sample_rate: int = 24000) -> list[int]:
        """-> per-character sample offsets of expected_text within audio
        (reference :58-123)."""
        audio = np.asarray(audio)
        if audio.ndim > 1:
            audio = audio.reshape(-1)
        total_samples = audio.shape[-1]
        logits = self._logits(audio, audio_sample_rate)
        frame_ids = logits.argmax(-1)
        heard = self.tokenizer.decode(frame_ids.tolist())

        # mark expected chars the model never voiced with '~'
        matched = max_alignment(expected_text.lower(), heard)
        chars = list(matched)
        char_ids = self.tokenizer.encode(matched)
        if len(chars) == 1:
            return [0]
        samples_per_frame = total_samples // len(frame_ids)

        # two-pointer sweep: give each voiced char the first frame whose
        # argmax matches it; unvoiced ('~') chars get -1 for interpolation
        offsets = [0]  # the first char is pinned to the clip start
        f, n_frames = 0, len(frame_ids)
        c = 1
        while c < len(chars):
            if chars[c] == "~":
                offsets.append(-1)
                c += 1
                continue
            while f < n_frames and int(frame_ids[f]) != char_ids[c]:
                f += 1
            if f == n_frames:
                break  # ran out of audio before placing every char
            offsets.append(f * samples_per_frame)
            f += 1
            c += 1

        if c < len(chars) or len(offsets) != len(expected_text):
            np.savez("alignment_debug.npz", audio=audio, text=expected_text)
            raise AssertionError(
                "Something went wrong with the alignment algorithm. I've dumped a "
                "file, 'alignment_debug.npz' to your current working directory. "
                "Please report this along with the file so it can get fixed.")

        return _fill_gaps(offsets, total_samples)

    def transcribe(self, audio: np.ndarray, audio_sample_rate: int = 24000) -> str:
        """Greedy CTC transcript of ``audio`` (argmax per frame, collapse
        repeats, drop blanks). Not in the reference — used by apps/eval.py
        as an automated intelligibility proxy (character error rate vs the
        prompt)."""
        audio = np.asarray(audio).reshape(-1)
        logits = self._logits(audio, audio_sample_rate)
        return self.tokenizer.decode(logits.argmax(-1).tolist())

    def redact(self, audio: np.ndarray, expected_text: str,
               audio_sample_rate: int = 24000) -> np.ndarray:
        """Cut out the audio spans for [bracketed] text (reference :125-150)."""
        if "[" not in expected_text:
            return audio
        audio = np.asarray(audio)
        squeeze = audio.ndim == 1
        if squeeze:
            audio = audio[None]

        segments = _bracket_segments(expected_text)
        bare_text = "".join(seg for seg, _ in segments)

        # character spans to keep; the end index is the segment's LAST char
        # (reference quirk: it drops that char's audio span, :137-140)
        keep: list[tuple[int, int]] = []
        pos = 0
        for seg, bracketed in segments:
            if not bracketed and seg:
                keep.append((pos, max(0, pos + len(seg) - 1)))
            pos += len(seg)

        offsets = self.align(audio.reshape(-1), bare_text, audio_sample_rate)
        kept = [audio[:, offsets[s]:offsets[e]] for s, e in keep]
        result = np.concatenate(kept, axis=-1)
        return result[0] if squeeze else result


def wav2vec2_logits_fn(model, device) -> Callable[[np.ndarray], np.ndarray]:
    """``logits_fn`` of a port ``Wav2Vec2ForCTC`` on ``device``: a 16 kHz clip
    -> float32 (frames, vocab) logits, at the clip's exact length. The clip
    is normalised over its samples first: zero mean, unbiased variance,
    ``(x - mean) / sqrt(var + 1e-7)`` (reference :65). On CUDA it runs in
    float32 with TF32 off, as the JAX aligner does."""
    from tortoise_tpu_torch.weights import float32_device

    device = float32_device(device)

    @torch.inference_mode()
    def fn(audio_16k: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(np.asarray(audio_16k, np.float32).reshape(1, -1), device=device)
        x = (x - x.mean()) / torch.sqrt(x.var() + 1e-7)
        logits, n_frames = model(x)
        return logits[0, :n_frames].float().cpu().numpy()

    return fn


def character_error_rate(reference: str, hypothesis: str) -> float:
    """Levenshtein(ref, hyp) / len(ref) over the CTC symbol alphabet.

    Both strings are normalized the way the acoustic model hears them:
    lowercased, characters outside the Tacotron symbol set dropped,
    whitespace collapsed. Returns 0.0 for a perfect transcript; can exceed
    1.0 when the hypothesis is much longer than the reference. (The
    reference repo ships an unused ``lev_distance`` helper,
    tortoise/utils/tokenizer.py:153-166, but never computes an error rate —
    this is the automated intelligibility metric its eval.py lacked.)
    """
    keep = set(_TACOTRON_SYMBOLS)

    def norm(s):
        s = "".join(c for c in s.lower() if c in keep)
        return " ".join(s.split())

    ref, hyp = norm(reference), norm(hypothesis)
    if not ref:
        return 0.0 if not hyp else float(len(hyp))
    # single-row edit distance
    prev = list(range(len(hyp) + 1))
    for i, rc in enumerate(ref, 1):
        cur = [i]
        for j, hc in enumerate(hyp, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (rc != hc)))
        prev = cur
    return prev[-1] / len(ref)
