"""ctypes bindings for the native host-side runtime (libaudioio.so).

A copy of ``tortoise_tpu/native`` with two changes: the library is built
with ``make`` at first use into ``build/native/`` beside the package (a
directory git ignores), never into the package. It binds the resampler,
the redaction aligner's DP and the streaming crossfade. Each binding
returns None when the library cannot be built or loaded, and its caller
then takes scipy's polyphase resampler or the Python DP, so the native
library is an accelerator, never a hard dependency. (No path of the package
crossfades: ``tts_stream`` yields exact slices of the full decode; the
binding is kept for callers that stitch overlapping chunks.) This is host
code, not a device kernel.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_DIR, "..", "..", "build", "native")
_LIB_PATH = os.path.join(BUILD_DIR, "libaudioio.so")
_lock = threading.Lock()
_lib = None


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_LIB_PATH):
            # built under a name of this process's own, then renamed: another
            # process loading the library never sees it half written
            tmp = os.path.abspath(f"{_LIB_PATH}.{os.getpid()}.tmp")
            try:
                os.makedirs(BUILD_DIR, exist_ok=True)
                subprocess.run(["make", "-C", _DIR, f"OUT={tmp}"],
                               check=True, capture_output=True, timeout=120)
                os.replace(tmp, _LIB_PATH)
            except (OSError, subprocess.SubprocessError):
                _lib = False
                return _lib
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            _lib = False
            return _lib
        lib.resample_f32.restype = ctypes.c_int64
        lib.resample_f32.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
        lib.align_dp.restype = None
        lib.align_dp.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_char]
        lib.crossfade_f32.restype = None
        lib.crossfade_f32.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
        _lib = lib
        return _lib


def available() -> bool:
    return bool(_load())


def resample(audio: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray | None:
    """Native polyphase resample of a 1-D float32 array; None if unavailable."""
    lib = _load()
    if not lib:
        return None
    x = np.ascontiguousarray(audio, dtype=np.float32).reshape(-1)
    n_out = lib.resample_f32(x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                             len(x), sr_in, sr_out, None, 0)
    out = np.empty(n_out, np.float32)
    lib.resample_f32(x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(x),
                     sr_in, sr_out,
                     out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_out)
    return out


def align_dp(s1: str, s2: str, skip: str = "~") -> str | None:
    """Native ``max_alignment`` DP of ASCII strings; None if unavailable or
    either string is not ASCII (byte and character indices would differ)."""
    lib = _load()
    if not lib:
        return None
    b1, b2 = s1.encode("utf-8"), s2.encode("utf-8")
    if len(b1) != len(s1) or len(b2) != len(s2):
        return None
    out = ctypes.create_string_buffer(len(b1) + 1)
    lib.align_dp(b1, len(b1), b2, len(b2), out, skip.encode()[0])
    return out.value.decode("utf-8")


def crossfade(chunk: np.ndarray, overlap: np.ndarray) -> np.ndarray | None:
    """A float32 copy of ``chunk`` whose first n = min(len(chunk),
    len(overlap)) samples blend linearly from ``overlap`` into ``chunk``:
    ``overlap[i] * (1 - t) + chunk[i] * t``, t = i / (n - 1) (t = 0 when
    n = 1); None if the library is unavailable."""
    lib = _load()
    if not lib:
        return None
    c = np.array(chunk, dtype=np.float32).reshape(-1)
    o = np.ascontiguousarray(overlap, dtype=np.float32).reshape(-1)
    lib.crossfade_f32(c.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                      o.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), min(len(c), len(o)))
    return c
