"""Build and load the hand-written CUDA kernels in ``tortoise_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface, loaded through ``ctypes`` (no PyTorch headers, so a build
takes seconds). Libraries go to ``build/kernels/`` beside the package, named
by a hash of every source under ``csrc/`` and the compiler flags, so an edit
rebuilds and an unchanged tree reuses the last build. Nothing here runs at
import time; a missing ``nvcc`` or a failed compile raises.

Every wrapper launches through ``Kernel``, the path with the least host
work a call: the library is built and the function looked up at its first
call only, and the stream is read raw rather than through a
``torch.cuda.Stream`` object.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC_DIR.parent.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of tortoise_tpu_torch are "
                       "compiled from source at first use and need the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}_{_digest()}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless the current sources are built already."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = CSRC_DIR / f"{name}.cu"
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {src.name} (exit {proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def resource_usage(name: str) -> str:
    """What ``ptxas -v`` reports for ``csrc/<name>.cu`` under the build's
    flags: each kernel's registers, shared memory and spills. Compiles to a
    throwaway object; raises on a failed compile."""
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [_nvcc(), *[f for f in NVCC_FLAGS if f != "-shared"], "-c", "-Xptxas", "-v",
               "-o", os.path.join(tmp, f"{name}.o"), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc -Xptxas -v failed on {name}.cu (exit {proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    return proc.stderr


def _library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it, once a process."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build(name)))
        return lib


class Kernel:
    """One C entry point ``fn`` of ``csrc/<lib>.cu`` whose last parameter is
    the CUDA stream and which returns a CUDA error code. ``kernel(device,
    *args)`` launches it on ``device``'s (an int index) current stream and
    raises on a nonzero return. ``argtypes`` leaves out the stream. The
    caller checks its arguments: the kernel trusts them."""

    def __init__(self, lib: str, fn: str, argtypes: list):
        self.lib, self.fn, self.argtypes = lib, fn, argtypes
        self._f = None

    def _load(self):
        f = ctypes.CFUNCTYPE(ctypes.c_int, *self.argtypes, ctypes.c_void_p)(
            (self.fn, _library(self.lib)))
        self._f = f
        return f

    def __call__(self, device: int, *args) -> None:
        err = (self._f or self._load())(*args, torch._C._cuda_getCurrentRawStream(device))
        if err:
            raise RuntimeError(f"{self.lib}.{self.fn} failed with CUDA error {err}")
