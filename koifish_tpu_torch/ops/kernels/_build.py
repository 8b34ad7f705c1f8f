"""Build the port's CUDA kernels and load them with ctypes.

Each source under ``koifish_tpu_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, at first
use, into ``build/kernels/`` at the repository root (git ignores it). A
library's file name carries a digest of its sources and flags, so an edited
source is rebuilt and a stale library is never loaded. ``build()`` starts
one ``nvcc`` per source, all at once, and waits for them together.

Pointers, the stream and 64-bit strides are passed as ``c_void_p`` /
``c_longlong``: without ``argtypes`` ctypes would pass a Python int as a
32-bit C int and cut the pointer.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parents[2]          # koifish_tpu_torch/
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"

#: library name -> CUDA source (one nvcc call each)
SOURCES = {
    "flash_fwd": "flash_fwd.cu",
    "qmatmul": "qmatmul.cu",
    "qmm": "qmm.cu",
    "decode_attn": "decode_attn.cu",
    "flash_bwd": "flash_bwd.cu",
    "fused_ce": "fused_ce.cu",
    "slotwrite": "slotwrite.cu",
    "fused_ce_int8": "fused_ce_int8.cu",
    "quantize": "quantize.cu",
    "qdgrad": "qdgrad.cu",
    "qmv_int8": "qmv_int8.cu",
    "paged_attn": "paged_attn.cu",
    "ring_attn": "ring_attn.cu",
}
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
         "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the koifish_tpu_torch kernels")


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / SOURCES[name]]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH + FLAGS).encode())
    return h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def log_path(name: str) -> Path:
    return BUILD_DIR / f"{name}.log"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named libraries (all by default) that are not built yet,
    in parallel. Returns seconds per library compiled; raises with nvcc's
    output if any compile fails."""
    names = list(SOURCES if names is None else names)
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = BUILD_DIR / f".lib{n}-{os.getpid()}.so.tmp"
        cmd = [nvcc, *ARCH, *FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / SOURCES[n])]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    secs, errors = {}, []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        secs[n] = time.perf_counter() - t0
        log_path(n).write_text(out)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {SOURCES[n]} "
                          f"(rc={proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib_path(n))
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = lib_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            lib.koifish_error_string.argtypes = [ctypes.c_int]
            lib.koifish_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (``cudaGetLastError``)."""
    if rc != 0:
        msg = lib.koifish_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def ptxas_summary(name: str) -> str:
    """Register / shared-memory / spill lines ptxas printed for ``name``."""
    p = log_path(name)
    if not p.exists():
        return ""
    keep = [ln.strip() for ln in p.read_text().splitlines()
            if "registers" in ln or "spill" in ln]
    return "\n".join(keep)
