"""AWQ checkpoint import -> QTensor.

The JAX package's ``quant/awq.py``: AWQ triples (qweight / qzeros / scales)
are unpacked once at load into the packed QTensor layout.

AWQ GEMM format:
- qweight: int32 [in, out/8] — eight 4-bit codes per int32, column order
  [0, 2, 4, 6, 1, 3, 5, 7] (the "AWQ order")
- qzeros:  int32 [in/group, out/8] — same packing, per-group zero points
- scales:  f16  [in/group, out]
- dequant: w[i, j] = (code[i, j] - zero[i//g, j]) * scale[i//g, j]

The result is an asymmetric INT4 QTensor (``zeros`` holds -zero·scale), which
``ops/matmul.qmatmul`` sends to the plain dequantize-and-matmul path, as the
JAX package does.
"""
from __future__ import annotations

from typing import Dict

import torch

from koifish_tpu_torch.dtypes import QFormat
from koifish_tpu_torch.quant.packing import pack_codes
from koifish_tpu_torch.quant.qtensor import QTensor

AWQ_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def _unpack_int32_awq(packed: torch.Tensor) -> torch.Tensor:
    """[rows, cols/8] int32 -> [rows, cols] uint8 codes in logical order."""
    rows, c8 = packed.shape
    p = packed.to(torch.int32)
    out = torch.empty((rows, c8, 8), dtype=torch.uint8, device=p.device)
    for slot in range(8):
        out[:, :, AWQ_ORDER[slot]] = ((p >> (4 * slot)) & 0xF).to(torch.uint8)
    return out.reshape(rows, c8 * 8)


def awq_to_qtensor(qweight: torch.Tensor, qzeros: torch.Tensor,
                   scales: torch.Tensor) -> QTensor:
    """Convert one AWQ triple into an asymmetric INT4 QTensor [in, out]."""
    codes = _unpack_int32_awq(qweight)                  # [in, out]
    zeros_codes = _unpack_int32_awq(qzeros)             # [in/g, out]
    scale = scales.to(torch.float32)                    # [in/g, out]
    n_in, n_out = codes.shape
    group = n_in // scale.shape[0]
    # asymmetric dequant: w = codes·scale + zeros_offset
    zeros_offset = -zeros_codes.to(torch.float32) * scale
    return QTensor(codes=pack_codes(codes, QFormat.INT4, group=group),
                   scales=scale, zeros=zeros_offset, fmt=QFormat.INT4,
                   shape=(n_in, n_out), group=group)


def is_awq_checkpoint(raw: Dict[str, torch.Tensor]) -> bool:
    return any(k.endswith(".qweight") for k in raw)


def convert_awq_weights(raw: Dict[str, torch.Tensor]) -> Dict[str, object]:
    """Replace every (qweight, qzeros, scales) triple in a raw HF tensor
    dict with '<prefix>.weight' -> QTensor; other tensors pass through."""
    out: Dict[str, object] = {}
    done = set()
    for name in raw:
        if name.endswith(".qweight"):
            prefix = name[: -len(".qweight")]
            out[prefix + ".weight"] = awq_to_qtensor(
                raw[name], raw[prefix + ".qzeros"], raw[prefix + ".scales"])
            done.update({name, prefix + ".qzeros", prefix + ".scales"})
    for name, arr in raw.items():
        if name not in done and name not in out:
            out[name] = arr
    return out
