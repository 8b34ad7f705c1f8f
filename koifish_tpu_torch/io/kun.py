"""Reference checkpoint-format interop: ``.kun`` / ``.ckp`` / tokenizer.dat
(the JAX package's ``io/kun.py``).

The reference ships three formats (src/CLI_params.hpp:157-165, 846-855):

- ``.kun`` (BEST/FULL) — a safetensors file whose extra tensor
  ``__koifish__config__`` (U8) holds the whole config JSON as **msgpack**
  (``K_SafeTensors::insertJS``/``loadJS``, src/Tensor/Safetensors.hpp:
  87-119; the config lives under ``jsConfig["CLI_params"]["config"]``,
  Serialize.cpp:514). Non-HF header entries carry extra keys
  ``szData``/``szGama``/``loAB`` and koifish dtype names (``K_FLOATS``,
  src/g_float.hpp:127-151, e.g. "BF16(E8)", "FLOAT", "Q<4>").
- ``.ckp`` (STATE) — the same container; each param tensor's data region
  is ``[data | gama | m | v]`` (huTensor.cu:501-515, 574-578): the weights,
  optional per-group bf16 gama scales, then bf16 AdamW moments.
- ``tokenizer.dat`` — the binary token table of PreTokenizer.py: header
  ``<III`` (max_token_length, bos_id, eos_id), then per token ``<f``
  score, ``<I`` byte length, raw bytes (PreTokenizer.py:136-146).

Tensors are CPU tensors viewing one copy-on-write ``np.memmap`` of the
file. bf16 (and fp8) bytes are read as an unsigned integer buffer of the
same width and reinterpreted as the torch dtype, so no ``ml_dtypes`` is
needed; a file written here is byte for byte the one the JAX package writes
for the same tensors, and each package reads the other's. msgpack is
implemented inline (the subset nlohmann::json emits).
"""
from __future__ import annotations

import json
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from koifish_tpu_torch.io.safetensors import (_DTYPES, _TORCH_NAMES, _bytes,
                                              read_header)

CONFIG_KEY = "__koifish__config__"   # Safetensors.cpp:13

# koifish dtype names (K_FLOATS, g_float.hpp:127-151) -> (numpy storage
# dtype of the bytes, torch dtype). Sub-byte packed types are raw bytes.
_KOI_DTYPES = {
    "FLOAT": (np.float32, torch.float32), "F32": (np.float32, torch.float32),
    "F16(E5)": (np.float16, torch.float16), "F16": (np.float16, torch.float16),
    "BF16(E8)": (np.uint16, torch.bfloat16), "BF16": (np.uint16, torch.bfloat16),
    "F8E5M2": (np.uint8, torch.float8_e5m2),
    "F8E4M3": (np.uint8, torch.float8_e4m3fn),
    "U8": (np.uint8, torch.uint8), "I8": (np.int8, torch.int8),
    "U16": (np.uint16, torch.uint16), "I16": (np.int16, torch.int16),
    "U32": (np.uint32, torch.uint32), "I32": (np.int32, torch.int32),
    "U64": (np.uint64, torch.uint64), "I64": (np.int64, torch.int64),
    "F64": (np.float64, torch.float64),
    # packed sub-byte formats: raw bytes
    "Q<4>": (np.uint8, torch.uint8), "Q<3>": (np.uint8, torch.uint8),
    "Q<2>": (np.uint8, torch.uint8), "TERNARY": (np.uint8, torch.uint8),
    "BINARY": (np.uint8, torch.uint8), "BOOL<1>": (np.uint8, torch.uint8),
}
_KOI_BITS = {"Q<4>": 4, "Q<3>": 3, "Q<2>": 2, "TERNARY": 2, "BINARY": 1}
# the writer's koifish names; other dtypes take their safetensors name
_KOI_NAMES = {torch.float32: "FLOAT", torch.bfloat16: "BF16(E8)",
              torch.float16: "F16(E5)"}


# ---------------------------------------------------------------------------
# msgpack (subset nlohmann::json to_msgpack/from_msgpack uses)
# ---------------------------------------------------------------------------

def msgpack_encode(obj: Any) -> bytes:
    out = bytearray()
    _mp_enc(obj, out)
    return bytes(out)


def _mp_enc(o: Any, out: bytearray) -> None:
    if o is None:
        out.append(0xC0)
    elif o is True:
        out.append(0xC3)
    elif o is False:
        out.append(0xC2)
    elif isinstance(o, int):
        if 0 <= o <= 0x7F:
            out.append(o)
        elif -32 <= o < 0:
            out.append(0x100 + o)
        elif 0 <= o <= 0xFF:
            out += b"\xcc" + struct.pack(">B", o)
        elif 0 <= o <= 0xFFFF:
            out += b"\xcd" + struct.pack(">H", o)
        elif 0 <= o <= 0xFFFFFFFF:
            out += b"\xce" + struct.pack(">I", o)
        elif o >= 0:
            out += b"\xcf" + struct.pack(">Q", o)
        elif o >= -0x80:
            out += b"\xd0" + struct.pack(">b", o)
        elif o >= -0x8000:
            out += b"\xd1" + struct.pack(">h", o)
        elif o >= -0x80000000:
            out += b"\xd2" + struct.pack(">i", o)
        else:
            out += b"\xd3" + struct.pack(">q", o)
    elif isinstance(o, float):
        out += b"\xcb" + struct.pack(">d", o)
    elif isinstance(o, str):
        b = o.encode("utf-8")
        n = len(b)
        if n <= 31:
            out.append(0xA0 | n)
        elif n <= 0xFF:
            out += b"\xd9" + struct.pack(">B", n)
        elif n <= 0xFFFF:
            out += b"\xda" + struct.pack(">H", n)
        else:
            out += b"\xdb" + struct.pack(">I", n)
        out += b
    elif isinstance(o, (bytes, bytearray)):
        n = len(o)
        if n <= 0xFF:
            out += b"\xc4" + struct.pack(">B", n)
        elif n <= 0xFFFF:
            out += b"\xc5" + struct.pack(">H", n)
        else:
            out += b"\xc6" + struct.pack(">I", n)
        out += bytes(o)
    elif isinstance(o, (list, tuple)):
        n = len(o)
        if n <= 15:
            out.append(0x90 | n)
        elif n <= 0xFFFF:
            out += b"\xdc" + struct.pack(">H", n)
        else:
            out += b"\xdd" + struct.pack(">I", n)
        for x in o:
            _mp_enc(x, out)
    elif isinstance(o, dict):
        n = len(o)
        if n <= 15:
            out.append(0x80 | n)
        elif n <= 0xFFFF:
            out += b"\xde" + struct.pack(">H", n)
        else:
            out += b"\xdf" + struct.pack(">I", n)
        for k, v in o.items():
            _mp_enc(str(k), out)
            _mp_enc(v, out)
    else:
        raise TypeError(f"msgpack: unsupported type {type(o)}")


def msgpack_decode(buf: bytes) -> Any:
    val, pos = _mp_dec(memoryview(buf), 0)
    return val


def _mp_dec(b: memoryview, i: int) -> Tuple[Any, int]:
    t = b[i]
    i += 1
    if t <= 0x7F:
        return t, i
    if t >= 0xE0:
        return t - 0x100, i
    if 0x80 <= t <= 0x8F:
        return _mp_map(b, i, t & 0x0F)
    if 0x90 <= t <= 0x9F:
        return _mp_arr(b, i, t & 0x0F)
    if 0xA0 <= t <= 0xBF:
        n = t & 0x1F
        return str(b[i:i + n], "utf-8"), i + n
    if t == 0xC0:
        return None, i
    if t == 0xC2:
        return False, i
    if t == 0xC3:
        return True, i
    if t in (0xC4, 0xC5, 0xC6):
        w = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[t]
        sz = struct.calcsize(w)
        (n,) = struct.unpack_from(w, b, i)
        i += sz
        return bytes(b[i:i + n]), i + n
    if t == 0xCA:
        return struct.unpack_from(">f", b, i)[0], i + 4
    if t == 0xCB:
        return struct.unpack_from(">d", b, i)[0], i + 8
    if t in (0xCC, 0xCD, 0xCE, 0xCF):
        w = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q"}[t]
        sz = struct.calcsize(w)
        return struct.unpack_from(w, b, i)[0], i + sz
    if t in (0xD0, 0xD1, 0xD2, 0xD3):
        w = {0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}[t]
        sz = struct.calcsize(w)
        return struct.unpack_from(w, b, i)[0], i + sz
    if t in (0xD9, 0xDA, 0xDB):
        w = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[t]
        sz = struct.calcsize(w)
        (n,) = struct.unpack_from(w, b, i)
        i += sz
        return str(b[i:i + n], "utf-8"), i + n
    if t in (0xDC, 0xDD):
        w = ">H" if t == 0xDC else ">I"
        sz = struct.calcsize(w)
        (n,) = struct.unpack_from(w, b, i)
        return _mp_arr(b, i + sz, n)
    if t in (0xDE, 0xDF):
        w = ">H" if t == 0xDE else ">I"
        sz = struct.calcsize(w)
        (n,) = struct.unpack_from(w, b, i)
        return _mp_map(b, i + sz, n)
    raise ValueError(f"msgpack: bad type byte 0x{t:02x}")


def _mp_arr(b, i, n):
    out = []
    for _ in range(n):
        v, i = _mp_dec(b, i)
        out.append(v)
    return out, i


def _mp_map(b, i, n):
    out = {}
    for _ in range(n):
        k, i = _mp_dec(b, i)
        v, i = _mp_dec(b, i)
        out[k] = v
    return out, i


# ---------------------------------------------------------------------------
# .kun / .ckp readers
# ---------------------------------------------------------------------------

def _entry_dtype(name: str):
    """(numpy storage dtype, torch dtype) of a header dtype name: koifish
    names first, then the standard safetensors ones."""
    dt = _KOI_DTYPES.get(name) or _DTYPES.get(name)
    if dt is None:
        raise ValueError(f"unknown dtype {name!r} in kun/ckp header")
    return dt


def _as(region: np.ndarray, store, tdt) -> torch.Tensor:
    t = torch.from_numpy(region.view(store))
    return t if t.dtype == tdt else t.view(tdt)


class KunTensor:
    """One entry of a .kun/.ckp file — raw region plus parsed views.

    data:  the weight bytes viewed as the entry's dtype (packed formats:
           uint8), shaped when the sizes agree
    gama:  per-group scales — bf16, not f32 (``floatGama = __nv_bfloat16``,
           g_float.hpp:261) — when szGama > 0
    m, v:  AdamW moments (bf16 views, floatMV, g_float.hpp:249) when the
           region extends past szData+szGama (STATE checkpoints)
    """

    def __init__(self, name: str, info: Dict[str, Any], region: np.ndarray):
        self.name = name
        self.shape = tuple(info["shape"])
        self.dtype_name = info["dtype"]
        store, tdt = _entry_dtype(info["dtype"])
        sz_total = region.nbytes
        sz_data = int(info.get("szData", sz_total))
        sz_gama = int(info.get("szGama", 0))
        self.data_raw = torch.from_numpy(region[:sz_data])
        self.data = _as(region[:sz_data], store, tdt)
        if self.dtype_name not in _KOI_BITS and \
                int(np.prod(self.shape)) == self.data.numel():
            self.data = self.data.reshape(self.shape)
        bf16 = (np.uint16, torch.bfloat16)
        self.gama = (_as(region[sz_data:sz_data + sz_gama], *bf16)
                     if sz_gama else None)
        rest = region[sz_data + sz_gama:]
        self.m = self.v = None
        if rest.nbytes:
            half = rest.nbytes // 2
            self.m = _as(rest[:half], *bf16)
            self.v = _as(rest[half:], *bf16)


def read_kun(path: str
             ) -> Tuple[Optional[Dict[str, Any]], Dict[str, KunTensor]]:
    """Read a ``.kun``/``.ckp`` file. Returns (config, tensors): config is
    the embedded reference config JSON (``["CLI_params"]["config"]``) or
    None, tensors map name -> KunTensor with data/gama/m/v views (CPU
    tensors over a copy-on-write memmap: writes never reach the file)."""
    header, start = read_header(path)
    header.pop("__metadata__", None)
    buf = np.memmap(path, dtype=np.uint8, mode="c")
    config = None
    tensors: Dict[str, KunTensor] = {}
    for name, info in header.items():
        s, e = info["data_offsets"]
        region = buf[start + s: start + e]
        if name == CONFIG_KEY:
            js = msgpack_decode(region.tobytes())
            config = js.get("CLI_params", {}).get("config", js)
            continue
        tensors[name] = KunTensor(name, info, region)
    return config, tensors


read_ckp = read_kun   # same container; STATE entries carry moments


def write_kun(path: str, config: Dict[str, Any],
              tensors: Dict[str, torch.Tensor],
              moments: Optional[Dict[str, Tuple[torch.Tensor,
                                                torch.Tensor]]] = None,
              ) -> None:
    """Write a reference-compatible ``.kun`` (or ``.ckp`` when ``moments``
    are given: each named tensor's region is followed by its m and v in
    bf16): the koifish header dialect plus the msgpack config tensor.
    Tensors may lie on any device; the bytes are the JAX writer's."""
    mp = msgpack_encode({"CLI_params": {"config": config}})
    header: Dict[str, Any] = {}
    blobs: List[bytes] = []
    offset = 0

    def add(name, entry, blob):
        nonlocal offset
        entry["data_offsets"] = [offset, offset + len(blob)]
        header[name] = entry
        blobs.append(blob)
        offset += len(blob)

    add(CONFIG_KEY, {"dtype": "U8", "shape": [len(mp)], "loAB": 0,
                     "szData": len(mp), "szGama": 0}, mp)
    for name, t in tensors.items():
        dname = _KOI_NAMES.get(t.dtype) or _TORCH_NAMES[t.dtype]
        blob = _bytes(t)
        entry = {"dtype": dname, "shape": list(t.shape), "loAB": 0,
                 "szData": len(blob), "szGama": 0}
        if moments and name in moments:
            m, v = moments[name]
            blob = blob + _bytes(m.to(torch.bfloat16)) + \
                _bytes(v.to(torch.bfloat16))
        add(name, entry, blob)
    hjson = json.dumps(header).encode()
    hjson += b" " * (-len(hjson) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for b in blobs:
            f.write(b)


# ---------------------------------------------------------------------------
# tokenizer.dat
# ---------------------------------------------------------------------------

def read_tokenizer_dat(path: str) -> Dict[str, Any]:
    """Parse the reference's binary token table (PreTokenizer.py:136-146).
    Returns {max_token_length, bos_id, eos_id, tokens: [bytes], scores}."""
    with open(path, "rb") as f:
        raw = f.read()
    max_len, bos, eos = struct.unpack_from("<III", raw, 0)
    pos = 12
    tokens: List[bytes] = []
    scores: List[float] = []
    while pos < len(raw):
        (score,) = struct.unpack_from("<f", raw, pos)
        (n,) = struct.unpack_from("<I", raw, pos + 4)
        pos += 8
        tokens.append(raw[pos:pos + n])
        pos += n
        scores.append(score)
    return {"max_token_length": max_len, "bos_id": bos, "eos_id": eos,
            "tokens": tokens, "scores": scores}


def write_tokenizer_dat(path: str, tokens: List[bytes], scores: List[float],
                        bos_id: int, eos_id: int) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<III", max(len(t) for t in tokens), bos_id,
                            eos_id))
        for t, s in zip(tokens, scores):
            f.write(struct.pack("<f", s))
            f.write(struct.pack("<I", len(t)))
            f.write(t)
