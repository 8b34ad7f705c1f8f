"""Safetensors read/write, and HF model folders (single file or sharded).

The same format and header as the JAX package's ``io/safetensors.py``: an
8-byte little-endian header length, the JSON header (``__metadata__``
included, padded with spaces to 8 bytes), then the raw tensor bytes in
header order. Reads return CPU tensors that view one copy-on-write
``np.memmap`` of the file, so nothing is copied until a tensor is moved or
written. bf16 (and fp8) bytes are read as an unsigned integer buffer of the
same width and reinterpreted as the torch dtype, bit for bit; no
``ml_dtypes`` is needed. A file the JAX package writes loads here bit for
bit, and the reverse.
"""
from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

# safetensors dtype name -> (numpy storage dtype of the bytes, torch dtype)
_DTYPES = {
    "F64": (np.float64, torch.float64), "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16), "BF16": (np.uint16, torch.bfloat16),
    "F8_E4M3": (np.uint8, torch.float8_e4m3fn),
    "F8_E5M2": (np.uint8, torch.float8_e5m2),
    "I64": (np.int64, torch.int64), "I32": (np.int32, torch.int32),
    "I16": (np.int16, torch.int16), "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8), "U16": (np.uint16, torch.uint16),
    "U32": (np.uint32, torch.uint32), "U64": (np.uint64, torch.uint64),
    "BOOL": (np.bool_, torch.bool),
}
_TORCH_NAMES = {t: name for name, (_, t) in _DTYPES.items()}


def read_header(path: str) -> Tuple[Dict[str, Any], int]:
    """Parse the 8-byte length + JSON header. Returns (header, data_start)."""
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen))
    return header, 8 + hlen


def _view(flat: np.ndarray, dtype_name: str, shape) -> torch.Tensor:
    store, tdt = _DTYPES[dtype_name]
    t = torch.from_numpy(flat.view(store).reshape(shape))
    return t if t.dtype == tdt else t.view(tdt)


def read_safetensors(path: str, mmap: bool = True
                     ) -> Tuple[Dict[str, torch.Tensor], Dict[str, str]]:
    """Returns ({name: CPU tensor}, metadata). With ``mmap`` the tensors view
    one copy-on-write memmap of the file (writes never reach the file)."""
    header, start = read_header(path)
    meta = header.pop("__metadata__", {})
    if mmap:
        buf = np.memmap(path, dtype=np.uint8, mode="c")
    else:
        with open(path, "rb") as f:
            buf = np.frombuffer(bytearray(f.read()), dtype=np.uint8)
    out = {}
    for name, info in header.items():
        s, e = info["data_offsets"]
        out[name] = _view(buf[start + s: start + e], info["dtype"],
                          info["shape"])
    return out, meta


def _bytes(t: torch.Tensor) -> bytes:
    t = t.detach().cpu().contiguous()
    if t.dtype in (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2):
        t = t.view(torch.uint16 if t.element_size() == 2 else torch.uint8)
    return t.numpy().tobytes()


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor],
                      metadata: Optional[Dict[str, str]] = None) -> None:
    """Write CPU or CUDA ``tensors`` in the JAX package's layout: the same
    header, key order and padding."""
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = {k: str(v) for k, v in metadata.items()}
    offset = 0
    blobs = []
    for name, t in tensors.items():
        data = _bytes(t)
        header[name] = {
            "dtype": _TORCH_NAMES[t.dtype],
            "shape": list(t.shape),
            "data_offsets": [offset, offset + len(data)],
        }
        offset += len(data)
        blobs.append(data)
    hjson = json.dumps(header).encode()
    hjson += b" " * (-len(hjson) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for data in blobs:
            f.write(data)


def iter_hf_folder(folder: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """Yield (name, tensor) across a HF model dir: a sharded folder with a
    ``model.safetensors.index.json``, one ``model.safetensors``, or any
    ``*.safetensors`` files in name order."""
    index = os.path.join(folder, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            weight_map = json.load(f)["weight_map"]
        files = sorted(set(weight_map.values()))
    elif os.path.exists(os.path.join(folder, "model.safetensors")):
        files = ["model.safetensors"]
    else:
        files = sorted(f for f in os.listdir(folder)
                       if f.endswith(".safetensors"))
        if not files:
            raise FileNotFoundError(f"no safetensors in {folder}")
    for fname in files:
        tensors, _ = read_safetensors(os.path.join(folder, fname))
        yield from tensors.items()
