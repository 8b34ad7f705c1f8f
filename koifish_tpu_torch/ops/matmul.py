"""Quantization-aware matmul — dispatch into the dequant-fused kernel.

``qmatmul`` sends every QTensor the kernel covers (symmetric codes at group
128, with the format's constant code values or a learned k-means/MINI
codebook on an NF4/NF3 layout) to ``ops/kernels/matmul.py``: the GEMV shape
for m <= 32, the GEMM shape above. The JAX package's TPU-only gates (K %
1024, the 32 < m < 64 dead zone) do not carry over, and codebook tensors
take the book kernel where the JAX model path dequantizes them. Other
QTensors (zero points, another group size) take the plain
dequantize-then-matmul path (logged through ``kernel_log``). Unquantized
products stay ``torch.matmul``, except under an int8 training policy
(``ops/tracectx.py``): weights that pass its size gate take
``ops/int8_train.int8_matmul``.

INT8 weights at decode widths (m <= 32) take one of two kernels, chosen by
the module-level ``INT8_GEMV`` flavour (initialised from
``KOIFISH_INT8_GEMV`` with the JAX package's default ``"dot"`` and read at
each call): ``"dot"`` keeps the dequant-fused GEMV, ``"mxu"`` the int8 GEMV
that quantizes the activations in the kernel (``ops/kernels/qmv_int8.py``).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Union

import torch

from koifish_tpu_torch.ops.int8_train import int8_matmul
from koifish_tpu_torch.ops.kernels import matmul as kmm
from koifish_tpu_torch.ops.kernels import qmv_int8 as kq8
from koifish_tpu_torch.ops.tracectx import current_int8
from koifish_tpu_torch.quant.qtensor import QTensor
from koifish_tpu_torch.utils import kernel_log

Weight = Union[torch.Tensor, QTensor]

#: INT8 decode-GEMV flavour: "dot" (dequant-fused GEMV) or "mxu" (int8 GEMV)
INT8_GEMV = os.environ.get("KOIFISH_INT8_GEMV", "dot")


def _dense(x: torch.Tensor, w: torch.Tensor, out_dtype) -> torch.Tensor:
    """``x @ w`` at the target dtype; an f32 result accumulates in f32."""
    if torch.empty((), dtype=out_dtype).element_size() > 2:
        return torch.matmul(x.to(torch.float32), w.to(torch.float32)
                            ).to(out_dtype)
    return torch.matmul(x, w.to(x.dtype)).to(out_dtype)


def qmatmul(x: torch.Tensor, w: Weight, out_dtype=None) -> torch.Tensor:
    """``x @ w`` with ``w`` possibly quantized. x: [..., in], w: [in, out]."""
    out_dtype = out_dtype or x.dtype
    if not isinstance(w, QTensor):
        pol = current_int8()
        if pol is not None and pol.applies(w.shape):
            return int8_matmul(x, w, pol.wgrad, pol.dgrad).to(out_dtype)
        return _dense(x, w, out_dtype)
    if w.row_scale is not None:
        # Sinkhorn row factors fold into the activations:
        # y = x @ (r . wq) = (x * r) @ wq
        x = (x.to(torch.float32) * w.row_scale.to(torch.float32)).to(x.dtype)
        w = dataclasses.replace(w, row_scale=None)
    if kmm.takes(w):
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1]).to(torch.bfloat16).contiguous()
        if (INT8_GEMV == "mxu" and x2.shape[0] <= kq8.MAX_M
                and kq8.takes(w)):
            y = kq8.qmv_int8(x2, w.codes, w.scales)
        else:
            y = kmm.qmatmul(x2, w, torch.float32 if out_dtype ==
                            torch.float32 else torch.bfloat16)
        return y.reshape(*lead, w.out_features).to(out_dtype)
    kernel_log.fallback(
        "qmatmul", f"k={w.shape[0]} n={w.shape[-1]} fmt={w.fmt.name} "
        f"group={w.group} zeros={w.zeros is not None} "
        f"codebook={w.codebook is not None}: the kernel takes symmetric "
        f"codes at group {kmm.GROUP} (books on NF4/NF3 layouts) -> torch "
        f"dequant+matmul")
    wd = w.dequantize(x.dtype)
    return _dense(x, wd, out_dtype)


def linear(x: torch.Tensor, w: Weight, b: Optional[torch.Tensor] = None,
           out_dtype=None) -> torch.Tensor:
    y = qmatmul(x, w, out_dtype=out_dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y
