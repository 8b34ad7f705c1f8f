"""QTensor — a quantized weight: packed codes plus per-group scales.

The same fields as the JAX package's ``quant/qtensor.py``. Canonical weight
layout is **[in, out]** (``y = x @ w``): groups tile and codes pack along
axis 0; ``scales`` is ``[in/group, out]``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from koifish_tpu_torch.dtypes import DEFAULT_GROUP, QFormat
from koifish_tpu_torch.quant.packing import unpack_codes

# NF4 codebook (QLoRA NormalFloat-4) — the JAX package's constants.
NF4_VALUES = (
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0,
)
# NF3: 8-level NormalFloat (quantiles of N(0,1), zero included, normalized).
NF3_VALUES = (
    -1.0, -0.5350227355957031, -0.2469314038753510, 0.0,
    0.1833375245332718, 0.3819939494132996, 0.6229856610298157, 1.0,
)


#: the codebooks as f32 CPU tensors (``codebook_for`` places them)
NF4_CODEBOOK = torch.tensor(NF4_VALUES, dtype=torch.float32)
NF3_CODEBOOK = torch.tensor(NF3_VALUES, dtype=torch.float32)


def codebook_for(fmt: QFormat, device=None) -> torch.Tensor:
    if fmt is QFormat.NF4:
        return torch.tensor(NF4_VALUES, dtype=torch.float32, device=device)
    if fmt is QFormat.NF3:
        return torch.tensor(NF3_VALUES, dtype=torch.float32, device=device)
    raise ValueError(f"{fmt} has no codebook")


def code_values(raw: torch.Tensor, fmt: QFormat) -> torch.Tensor:
    """Unpacked unsigned codes -> f32 code values (scales not applied) for
    the symmetric formats: signed INT4/INT3/INT2 are stored biased by
    2**(bits-1), TERNARY is raw-1, BINARY is 2·raw-1, NF via the codebook."""
    if fmt is QFormat.INT8:
        return raw.to(torch.float32)
    if fmt.is_codebook:
        return codebook_for(fmt, raw.device)[raw.long()]
    if fmt is QFormat.BINARY:
        return raw.to(torch.float32) * 2.0 - 1.0
    if fmt is QFormat.TERNARY:
        return raw.to(torch.float32) - 1.0
    return raw.to(torch.float32) - float(1 << (fmt.bits - 1))


#: QTensor's tensor fields, in its field order (the JAX pytree's leaves)
TENSOR_FIELDS = ("codes", "scales", "zeros", "codebook", "row_scale")


@dataclasses.dataclass
class QTensor:
    """Packed quantized tensor + per-group scales.

    codes:  packed code array — [ceil(in*pack_bits/8), out] uint8 for
            sub-byte formats, [in, out] int8 for INT8.
    scales: [in/group, out] per-group scales (f32 or bf16).
    zeros:  optional [in/group, out] zero-points (asymmetric modes).
    """

    codes: torch.Tensor
    scales: torch.Tensor
    zeros: Optional[torch.Tensor] = None
    fmt: QFormat = QFormat.INT8
    shape: tuple = ()
    group: int = DEFAULT_GROUP
    # learned per-tensor ([k]) or per-row ([in, k]) codebook
    codebook: Optional[torch.Tensor] = None
    # per-in-row scale from Sinkhorn normalization; folds into activations
    row_scale: Optional[torch.Tensor] = None

    @property
    def in_features(self) -> int:
        return self.shape[0]

    @property
    def out_features(self) -> int:
        return self.shape[-1]

    @property
    def n_groups(self) -> int:
        return self.scales.shape[0]

    @property
    def device(self) -> torch.device:
        return self.codes.device

    def nbytes(self) -> int:
        n = self.codes.numel() * self.codes.element_size()
        n += self.scales.numel() * self.scales.element_size()
        if self.zeros is not None:
            n += self.zeros.numel() * self.zeros.element_size()
        return n

    def to(self, device) -> "QTensor":
        mv = lambda t: None if t is None else t.to(device)
        return dataclasses.replace(
            self, codes=mv(self.codes), scales=mv(self.scales),
            zeros=mv(self.zeros), codebook=mv(self.codebook),
            row_scale=mv(self.row_scale))

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        """Plain dequantization — the correctness oracle (same math as the
        JAX package's ``QTensor.dequantize``)."""
        fmt = self.fmt
        n_in = self.shape[0]
        if fmt in (QFormat.INT8, QFormat.F8_E5M2, QFormat.F8_E4M3):
            codes = self.codes.to(torch.float32)
        else:
            raw = unpack_codes(self.codes, fmt, n_in, group=self.group)
            if self.codebook is not None and self.codebook.dim() == 2:
                codes = torch.gather(self.codebook.to(torch.float32), 1,
                                     raw.long())
            elif self.codebook is not None:
                codes = self.codebook.to(torch.float32)[raw.long()]
            elif self.zeros is not None:
                codes = raw.to(torch.float32)   # asymmetric: unsigned codes
            else:
                codes = code_values(raw, fmt)
        g = self.group
        codes = codes.reshape(self.n_groups, g, -1)
        w = codes * self.scales.to(torch.float32)[:, None, :]
        if self.zeros is not None:
            w = w + self.zeros.to(torch.float32)[:, None, :]
        w = w.reshape(self.shape)
        if self.row_scale is not None:   # Sinkhorn row factors
            w = w * self.row_scale.to(torch.float32)[:, None]
        return w.to(dtype)
