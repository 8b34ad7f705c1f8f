"""Numeric and quantized-format registry (PyTorch side).

The same ``QFormat`` enum as the JAX package (``koifish_tpu/dtypes.py``),
with a torch storage dtype in place of the ``jnp`` one. Sub-byte codes pack
along the contraction (in-feature) axis in group-local block-split order
(``quant/packing.py``); group scales use group size 128 by default.
"""
from __future__ import annotations

import enum

import torch


class QFormat(enum.Enum):
    """Weight / number storage formats (values match the JAX package)."""

    F32 = "f32"
    BF16 = "bf16"
    F16 = "f16"
    F8_E4M3 = "f8_e4m3"
    F8_E5M2 = "f8_e5m2"
    INT8 = "int8"       # groupwise absmax, 1 code / byte
    INT4 = "int4"       # groupwise absmax, 2 codes / byte
    NF4 = "nf4"         # 4-bit NormalFloat codebook
    NF3 = "nf3"         # 3-bit NormalFloat codebook
    INT3 = "int3"       # stored 2 codes/byte like INT4 (range [-4,3])
    INT2 = "int2"       # 4 codes / byte
    TERNARY = "ternary"  # {-1,0,+1}, 4 codes / byte (2b each)
    BINARY = "binary"    # {-1,+1}, 8 codes / byte
    QJL = "qjl"          # KV-only: sign-of-JL-projection keys + norms

    @property
    def bits(self) -> int:
        return _BITS[self]

    @property
    def is_sub_byte(self) -> bool:
        return self in _SUB_BYTE

    @property
    def is_quantized(self) -> bool:
        return self in _QUANTIZED

    @property
    def is_codebook(self) -> bool:
        return self in (QFormat.NF4, QFormat.NF3)

    @property
    def codes_per_byte(self) -> int:
        if not self.is_sub_byte:
            raise ValueError(f"{self} is not a sub-byte format")
        return 8 // _PACK_BITS[self]

    @property
    def pack_bits(self) -> int:
        """Bits used per code in the packed byte (int3 is stored in 4 bits)."""
        return _PACK_BITS[self]

    @property
    def torch_dtype(self) -> torch.dtype:
        """Storage dtype for the (packed) code array."""
        if self in _QUANTIZED:
            return torch.int8 if self is QFormat.INT8 else torch.uint8
        return _FLOAT_DTYPES[self]


_BITS = {
    QFormat.F32: 32, QFormat.BF16: 16, QFormat.F16: 16,
    QFormat.F8_E4M3: 8, QFormat.F8_E5M2: 8,
    QFormat.INT8: 8, QFormat.INT4: 4, QFormat.NF4: 4, QFormat.NF3: 3,
    QFormat.INT3: 3, QFormat.INT2: 2, QFormat.TERNARY: 2, QFormat.BINARY: 1,
}
_PACK_BITS = {
    QFormat.INT4: 4, QFormat.NF4: 4, QFormat.NF3: 4, QFormat.INT3: 4,
    QFormat.INT2: 2, QFormat.TERNARY: 2, QFormat.BINARY: 1,
}
_SUB_BYTE = frozenset(_PACK_BITS)
_QUANTIZED = frozenset({QFormat.INT8} | _SUB_BYTE)
_FLOAT_DTYPES = {
    QFormat.F32: torch.float32, QFormat.BF16: torch.bfloat16,
    QFormat.F16: torch.float16, QFormat.F8_E4M3: torch.float8_e4m3fn,
    QFormat.F8_E5M2: torch.float8_e5m2,
}

#: default quantization group size along the in-feature axis
DEFAULT_GROUP = 128


def qformat_from_bits(bits: int, nf: bool = False) -> QFormat:
    """Map a ``bits`` field from a reference-style quantizer card to a format."""
    table = {
        16: QFormat.BF16, 8: QFormat.INT8,
        4: QFormat.NF4 if nf else QFormat.INT4,
        3: QFormat.NF3 if nf else QFormat.INT3,
        2: QFormat.TERNARY, 1: QFormat.BINARY,
    }
    if bits not in table:
        raise ValueError(f"unsupported quant bits: {bits}")
    return table[bits]
