"""Sub-byte code packing — byte-identical to the JAX package.

Codes pack along the contraction axis (axis 0) in **group-local
block-split** order: within each quantization group of ``group`` rows,
byte row r holds the codes of rows ``r``, ``r + group/cpb``,
``r + 2·group/cpb``, … (one per bit slot, lowest slot first). For INT4 at
group 128: byte row r holds rows r (low nibble) and r + 64 (high nibble).
"""
from __future__ import annotations

import torch

from koifish_tpu_torch.dtypes import QFormat


def pack_codes(codes: torch.Tensor, fmt: QFormat, group: int = 128
               ) -> torch.Tensor:
    """Pack unsigned codes (< 2**fmt.pack_bits) along axis 0 into uint8.

    codes: [n, ...] integer tensor, n divisible by ``group`` (or by
    codes_per_byte when n < group — degenerate single-group case).
    Returns [n / cpb, ...] uint8.
    """
    if not fmt.is_sub_byte:
        return codes.to(fmt.torch_dtype)
    bits = fmt.pack_bits
    cpb = fmt.codes_per_byte
    n = codes.shape[0]
    if n % group:
        group = n                      # single-group fallback
    if group % cpb or n % group:
        raise ValueError(f"axis-0 length {n} / group {group} not packable "
                         f"for {fmt}")
    sub = group // cpb
    rest = tuple(codes.shape[1:])
    c = codes.to(torch.uint8).reshape((n // group, cpb, sub) + rest)
    out = torch.zeros((n // group, sub) + rest, dtype=torch.uint8,
                      device=codes.device)
    for j in range(cpb):
        out |= c[:, j] << (bits * j)
    return out.reshape((n // cpb,) + rest)


def unpack_codes(packed: torch.Tensor, fmt: QFormat, n: int,
                 group: int = 128) -> torch.Tensor:
    """Inverse of :func:`pack_codes`. Returns [n, ...] uint8 codes."""
    if not fmt.is_sub_byte:
        return packed
    bits = fmt.pack_bits
    cpb = fmt.codes_per_byte
    if n % group:
        group = n
    sub = group // cpb
    mask = (1 << bits) - 1
    rest = tuple(packed.shape[1:])
    p = packed.reshape((n // group, sub) + rest)
    parts = [(p >> (bits * j)) & mask for j in range(cpb)]
    # [ng, cpb, sub, ...] -> [n, ...]: contiguous block copies per group
    return torch.stack(parts, dim=1).reshape((n,) + rest)
