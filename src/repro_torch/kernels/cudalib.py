"""Build and load the port's CUDA kernels (``repro_torch/csrc``).

The kernels have a plain C interface and are compiled with ``nvcc`` for
Hopper (``sm_90a``) into one shared library under the repo's ``build/``
directory at first use, then loaded with ``ctypes``.  The library's name
carries a hash of the sources and flags, so an unchanged checkout loads
the cached build and an edited one rebuilds.  Each ``.cu`` file compiles
in its own ``nvcc`` process, all started together, then one link.

Nothing here runs at import time: this module imports on machines with
neither ``nvcc`` nor a GPU, and only :func:`load` needs them.  A failed
build raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import List, Optional, Tuple

import torch

__all__ = ["load", "build_seconds", "build_log", "check", "ptr",
           "chunk_ptrs", "stream_ptr"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("expand.cu", "fold.cu", "emit.cu", "leapfrog.cu",
           "flash_attention.cu", "tier2.cu")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
# argument lists of the C entry points (csrc/*.cu): pointers and the
# stream as c_void_p (a plain int would be cut to 32 bits), sizes as
# c_int (a scratch length as c_longlong), a float scale as c_float
_SIGNATURES = {
    "ctj_expand": [_P] * 8 + [_P, _P, _P, _I] + [_I] * 7 + [_P] * 7
                  + [_P, _L, _P],
    "ctj_fold_replay": [_P] * 5 + [_P, _P] + [_P] * 4 + [_I] * 5 + [_P] * 7
                       + [_P, _L, _P],
    "ctj_fold_splice": [_P] * 5 + [_P] * 4 + [_I] * 6 + [_P] * 7
                       + [_P, _L, _P],
    "ctj_fold_merged": [_P] * 5 + [_P, _P] + [_P] * 4 + [_P] * 4 + [_I] * 6
                       + [_P] * 7 + [_P, _L, _P],
    "ctj_emit": [_P, _P, _I, _I, _P, _P, _P, _L, _P],
    "ctj_bound": [_P] * 4 + [_I] * 3 + [_P, _P],
    "ctj_bound_atoms": [_P, _I] + [_P] * 4 + [_I, _I, _P],
    "ctj_flash_attention": [_P] * 4 + [_I] * 10 + [_F, _P],
    "ctj_tier2_probe": [_P] * 8 + [_I] * 4 + [_P] * 5,
    "ctj_tier2_insert": [_P] * 12 + [_I] * 6 + [_P] * 5,
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_s = 0.0
_log = ""


def _digest() -> str:
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _compile(target: Path) -> str:
    """Compile every source in parallel and link them into ``target``."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    logs: List[str] = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (Path(s).stem + ".o") for s in SOURCES]
        procs = [subprocess.Popen(
            [nvcc, *ARCH, *FLAGS, "-c", str(CSRC / s), "-o", str(o)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(SOURCES, objs)]
        failed = []
        for s, p in zip(SOURCES, procs):
            out, _ = p.communicate()
            logs.append(f"== {s}\n{out}")
            if p.returncode != 0:
                failed.append(s)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_so = Path(tmp) / target.name
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(tmp_so), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_so, target)  # atomic for concurrent loaders
    return "\n".join(logs)


def load() -> ctypes.CDLL:
    """The kernel library, built on first use (raises if it cannot be)."""
    global _lib, _build_s, _log
    with _lock:
        if _lib is not None:
            return _lib
        target = BUILD_DIR / f"libctj_{_digest()}.so"
        if not target.exists():
            t0 = time.perf_counter()
            _log = _compile(target)
            _build_s = time.perf_counter() - t0
        lib = ctypes.CDLL(str(target))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def build_seconds() -> float:
    """Seconds this process spent compiling the kernels (0 when the
    library was already built)."""
    return _build_s


def build_log() -> str:
    """nvcc's output (ptxas register and spill report) of this process's
    build; empty when the library was already built."""
    return _log


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_ptr(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a raw handle."""
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t: torch.Tensor, what: str, device: torch.device,
        dtype: torch.dtype, shape: Tuple[int, ...]) -> int:
    """``t``'s device address, after checking that a kernel can take it:
    on ``device`` (a CUDA device), contiguous, of ``dtype`` and ``shape``
    (-1 matches any length)."""
    if t.device != device or device.type != "cuda":
        raise ValueError(f"{what}: on {t.device}, kernel runs on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: {t.dtype}, kernel takes {dtype}")
    if t.dim() != len(shape) or any(
            want not in (-1, got) for want, got in zip(shape, t.shape)):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, kernel takes "
                         f"{shape}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: not contiguous")
    return t.data_ptr()


def chunk_ptrs(F, what: str, device: torch.device, C: int, n: int,
               m: int) -> dict:
    """Checked addresses of a Frontier-shaped chunk's six fields."""
    i32 = torch.int32
    want = {"assign": (i32, (C, n)), "factor": (torch.int64, (C,)),
            "valid": (torch.bool, (C,)), "orig": (i32, (C,)),
            "lo": (i32, (C, m)), "hi": (i32, (C, m))}
    return {f: ptr(getattr(F, f), f"{what}.{f}", device, *want[f])
            for f in want}
