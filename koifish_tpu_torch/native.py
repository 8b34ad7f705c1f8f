"""ctypes bindings to the C++ host layer (the JAX package's ``native.py``):
the ranked-merge BPE engine, the mmap'd token shard, the safetensors
reader and the prefetching batch server of ``native/*.cpp``.

The library is built from those sources at first use, by ``g++ -O3 -fPIC
-std=c++17 -shared -lpthread``, into ``build/native/`` at the repository
root (git ignores it), under a name keyed by a digest of the sources and
flags, as ``ops/kernels/_build.py`` keys the kernels: an edited source is
rebuilt and a stale library is never loaded. The port never runs the
sources' Makefile and never loads a library it did not build itself.

Each entry point has a pure-Python path; ``data/tokenizer.py`` and
``data/tokenset.py`` take the native one where the JAX package does, and a
library that cannot be built, or a call that fails, is logged through
``utils/kernel_log.fallback`` before the Python path runs. ``CALLS`` counts
the native calls that were made (``count_call``), so a run can show that it
took the native paths.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

_ROOT = Path(__file__).resolve().parents[1]
NATIVE_SRC = _ROOT / "native"
BUILD_DIR = _ROOT / "build" / "native"
SOURCES = ("bpe.cpp", "tokenset.cpp", "safetensors.cpp", "batchserver.cpp")
FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]
LIBS = ["-lpthread"]

#: native entry -> calls made since the last reset
CALLS: Dict[str, int] = {}

_lib: Optional[ctypes.CDLL] = None
_tried = False
_error: Optional[str] = None
_lock = threading.Lock()


def count_call(name: str) -> None:
    CALLS[name] = CALLS.get(name, 0) + 1


def reset_calls() -> None:
    CALLS.clear()


def calls() -> Dict[str, int]:
    return dict(CALLS)


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((NATIVE_SRC / name).read_bytes())
    h.update(" ".join(FLAGS + LIBS).encode())
    return h.hexdigest()[:16]


def lib_path() -> Path:
    return BUILD_DIR / f"libkoifish_native-{_digest()}.so"


def build() -> Path:
    """Compile the library if it is not built yet (a temporary file renamed
    into place, so ranks building at once never load half a file). Raises
    with the compiler's output on failure."""
    path = lib_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{path.name}.{os.getpid()}.tmp"
    cmd = [os.environ.get("CXX", "g++"), *FLAGS, "-o", str(tmp),
           *[str(NATIVE_SRC / s) for s in SOURCES], *LIBS]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native build failed (rc={proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def _bind(lib: ctypes.CDLL) -> None:
    c = ctypes
    lib.ktok_new.restype = c.c_void_p
    lib.ktok_new.argtypes = [c.c_char_p, c.c_char_p]
    lib.ktok_free.argtypes = [c.c_void_p]
    lib.ktok_encode_batch.restype = c.c_int32
    lib.ktok_encode_batch.argtypes = [
        c.c_void_p, c.c_char_p, c.POINTER(c.c_uint32), c.c_int32,
        c.POINTER(c.c_int32), c.c_int32, c.POINTER(c.c_int32)]
    lib.kts_open.restype = c.c_void_p
    lib.kts_open.argtypes = [c.c_char_p, c.POINTER(c.c_int64),
                             c.POINTER(c.c_int32)]
    lib.kts_close.argtypes = [c.c_void_p]
    lib.kts_gather.argtypes = [c.c_void_p, c.POINTER(c.c_int64), c.c_int32,
                               c.c_int32, c.POINTER(c.c_int32)]
    lib.kst_open.restype = c.c_void_p
    lib.kst_open.argtypes = [c.c_char_p]
    lib.kst_count.restype = c.c_int32
    lib.kst_count.argtypes = [c.c_void_p]
    lib.kst_info.restype = c.c_int32
    lib.kst_info.argtypes = [
        c.c_void_p, c.c_int32, c.c_char_p, c.c_int32, c.c_char_p,
        c.POINTER(c.c_int64), c.c_int32, c.POINTER(c.c_uint64)]
    lib.kst_data.restype = c.POINTER(c.c_uint8)
    lib.kst_data.argtypes = [c.c_void_p, c.c_int32]
    lib.kst_close.argtypes = [c.c_void_p]
    lib.kbs_new.restype = c.c_void_p
    lib.kbs_new.argtypes = [
        c.c_char_p, c.c_int32, c.POINTER(c.c_int32), c.POINTER(c.c_int64),
        c.c_int64, c.c_int32, c.c_int32, c.c_int32]
    lib.kbs_next.restype = c.c_int32
    lib.kbs_next.argtypes = [c.c_void_p, c.POINTER(c.c_int32)]
    lib.kbs_free.argtypes = [c.c_void_p]


def load_native() -> Optional[ctypes.CDLL]:
    """The native library, built first if needed; None if it cannot be
    built or loaded (the reason logged once through ``kernel_log``)."""
    global _lib, _tried, _error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(build()))
            _bind(lib)
            _lib = lib
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _error = f"{type(e).__name__}: {e}"
            from koifish_tpu_torch.utils import kernel_log
            kernel_log.fallback("native", f"no native library: "
                                f"{_error.splitlines()[0]}")
        return _lib


def native_available() -> bool:
    return load_native() is not None


def _need() -> ctypes.CDLL:
    lib = load_native()
    if lib is None:
        raise RuntimeError(f"native library unavailable ({_error})")
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


# ---------------------------------------------------------------------------
# BPE engine
# ---------------------------------------------------------------------------

class NativeBPE:
    """C++ ranked-merge BPE over pretoken byte strings, built from a
    ``data/tokenizer.BPETokenizer``; ``encode_pretokens`` replaces its merge
    loop (the same ids, the byte fallback included)."""

    def __init__(self, tokenizer) -> None:
        lib = _need()
        self._lib = lib
        u2b = tokenizer._u2b
        ids = sorted(tokenizer.vocab.items(), key=lambda kv: kv[1])
        n_vocab = ids[-1][1] + 1
        strings = [b""] * n_vocab
        for tok, i in ids:
            strings[i] = bytes(u2b[ch] for ch in tok)
        offsets = np.zeros(n_vocab + 1, np.uint32)
        for i, s in enumerate(strings):
            offsets[i + 1] = offsets[i] + len(s)
        vocab_blob = (np.uint32(n_vocab).tobytes() + offsets.tobytes()
                      + b"".join(strings))
        merges = []
        for (a, b), _ in sorted(tokenizer.ranks.items(),
                                key=lambda kv: kv[1]):
            ia, ib = tokenizer.vocab.get(a), tokenizer.vocab.get(b)
            im = tokenizer.vocab.get(a + b)
            if ia is None or ib is None or im is None:
                continue
            merges.append((ia, ib, im))
        marr = (np.array(merges, np.uint32) if merges
                else np.zeros((0, 3), np.uint32))
        merge_blob = np.uint32(len(merges)).tobytes() + marr.tobytes()
        self._h = lib.ktok_new(vocab_blob, merge_blob)
        if not self._h:
            raise RuntimeError("ktok_new failed")

    def encode_pretokens(self, pretokens: Sequence[str]) -> List[int]:
        bufs = [p.encode("utf-8") for p in pretokens]
        text = b"".join(bufs)
        offsets = np.zeros(len(bufs) + 1, np.uint32)
        for i, b in enumerate(bufs):
            offsets[i + 1] = offsets[i] + len(b)
        max_out = len(text) + 16           # ids never exceed input bytes
        out = np.zeros(max_out, np.int32)
        counts = np.zeros(len(bufs), np.int32)
        n = self._lib.ktok_encode_batch(
            self._h, text, _ptr(offsets, ctypes.c_uint32), len(bufs),
            _ptr(out, ctypes.c_int32), max_out,
            _ptr(counts, ctypes.c_int32))
        if n < 0:
            raise RuntimeError("native encode overflow")
        count_call("bpe")
        return out[:n].tolist()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ktok_free(self._h)
            self._h = None


# ---------------------------------------------------------------------------
# Shard reader
# ---------------------------------------------------------------------------

class NativeShard:
    """A token shard mmap'd by the library, with a C batch gather."""

    def __init__(self, path: str) -> None:
        lib = _need()
        self._lib = lib
        count, bpt = ctypes.c_int64(), ctypes.c_int32()
        self._h = lib.kts_open(path.encode(), ctypes.byref(count),
                               ctypes.byref(bpt))
        if not self._h:
            raise OSError(f"cannot open shard {path}")
        self.count, self.bpt = count.value, bpt.value

    def gather(self, offsets: np.ndarray, width: int) -> np.ndarray:
        """[len(offsets), width] int32: the windows at ``offsets``; raises
        IndexError for a window past the shard (the C gather reads
        unchecked)."""
        offsets = np.ascontiguousarray(offsets, np.int64)
        if len(offsets) and (width < 0 or offsets.min() < 0
                             or offsets.max() + width > self.count):
            raise IndexError(f"gather of {width} tokens at offsets "
                             f"{offsets.min()}..{offsets.max()} from a "
                             f"shard of {self.count}")
        out = np.empty((len(offsets), width), np.int32)
        self._lib.kts_gather(self._h, _ptr(offsets, ctypes.c_int64),
                             len(offsets), width, _ptr(out, ctypes.c_int32))
        count_call("shard")
        return out

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.kts_close(self._h)
            self._h = None


# ---------------------------------------------------------------------------
# Safetensors reader
# ---------------------------------------------------------------------------

class NativeSafetensors:
    """A safetensors (or ``.kun``) file mmap'd and parsed by the library;
    ``tensors()`` returns CPU tensors that view the mapped data (each view
    keeps the reader, so the mapping, alive)."""

    def __init__(self, path: str) -> None:
        lib = _need()
        self._lib = lib
        self._h = lib.kst_open(path.encode())
        if not self._h:
            raise OSError(f"cannot parse safetensors {path}")
        self.n = lib.kst_count(self._h)

    def tensors(self):
        """{name: tensor} in the file's order, each dtype read as
        ``io/safetensors.py`` (or ``io/kun.py``) reads it; an unknown dtype
        name gives its raw uint8 bytes."""
        import torch

        from koifish_tpu_torch.io.kun import _KOI_DTYPES
        from koifish_tpu_torch.io.safetensors import _DTYPES
        out = {}
        for i in range(self.n):
            name = ctypes.create_string_buffer(512)
            dt = ctypes.create_string_buffer(16)
            shape = (ctypes.c_int64 * 8)()
            offs = (ctypes.c_uint64 * 2)()
            nd = self._lib.kst_info(self._h, i, name, 512, dt, shape, 8,
                                    offs)
            if nd < 0:
                raise OSError(f"bad tensor entry {i}")
            nbytes = offs[1] - offs[0]
            buf = np.zeros(0, np.uint8)
            if nbytes:
                region = (ctypes.c_uint8 * nbytes).from_address(
                    ctypes.addressof(self._lib.kst_data(self._h, i).contents))
                region.reader = self       # the mapping outlives the views
                buf = np.frombuffer(region, np.uint8)
            dname = dt.value.decode()
            store, tdt = (_DTYPES.get(dname) or _KOI_DTYPES.get(dname)
                          or (np.uint8, torch.uint8))
            arr = buf.view(store)
            dims = tuple(shape[j] for j in range(nd))
            if int(np.prod(dims)) == arr.size:
                arr = arr.reshape(dims)
            t = torch.from_numpy(arr)
            out[name.value.decode()] = t if t.dtype == tdt else t.view(tdt)
        count_call("safetensors")
        return out

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.kst_close(self._h)
            self._h = None


# ---------------------------------------------------------------------------
# Prefetching batch server
# ---------------------------------------------------------------------------

class NativeBatchServer:
    """A C++ producer thread gathering token windows from mmap'd shards into
    a ring of ``depth`` batch buffers, ahead of the consumer. The caller
    hands over the whole (shard, offset) schedule in batch order, so the
    batches are the Python path's."""

    def __init__(self, paths: Sequence[str], sched_shard: np.ndarray,
                 sched_off: np.ndarray, group: int, width: int,
                 depth: int = 3):
        self._lib = _need()
        blob = b"".join(p.encode() + b"\0" for p in paths)
        ss = np.ascontiguousarray(sched_shard, dtype=np.int32)
        so = np.ascontiguousarray(sched_off, dtype=np.int64)
        self.group, self.width = group, width
        self.n_batches = len(ss) // group
        self._h = self._lib.kbs_new(
            blob, len(paths), _ptr(ss, ctypes.c_int32),
            _ptr(so, ctypes.c_int64), len(ss), group, width, depth)
        if not self._h:
            raise RuntimeError("kbs_new failed (a shard cannot be opened)")

    def __iter__(self):
        out = np.empty((self.group, self.width), np.int32)
        for _ in range(self.n_batches):
            if not self._lib.kbs_next(self._h, _ptr(out, ctypes.c_int32)):
                break
            count_call("batchserver")
            yield out.copy()

    def close(self):
        if getattr(self, "_h", None):
            self._lib.kbs_free(self._h)
            self._h = None

    def __del__(self):
        self.close()
