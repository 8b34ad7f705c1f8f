"""Int8 training matmuls (the JAX package's ``ops/int8_train.py``): the
dynamic-range analog of the reference's FP8 GEMMs,

    y = (q8(x) · q8(w))_int32 · s_x[row] · s_w[col]

``int8_matmul`` is an autograd Function with the JAX custom VJP's contract:
the forward quantizes x per row and w per column (the quantize kernel,
``ops/kernels/quantize.py``, in the jitted step's rounding), multiplies the
codes exactly in int32 (``int8_dot``) and applies the scales in f32. It
saves (x, wq, sw), not w. The backward's dgrad has three modes, fixed at the
forward as the JAX package's static arguments are:

- ``False``: a bf16 dot against bf16(wq·sw), the dequantized forward codes;
- ``True``/``"fold"``: dy·sw quantized per row, then an int8 dot with wqᵀ;
- ``"tile"``: the per-tile int8 dgrad kernel (``ops/kernels/qdgrad.py``)
  where n % 1024 == 0, else the bf16 dot.

``wgrad=True`` takes the (measured-harmful, experimental) int8 wgrad: x and
dy quantized per column; otherwise dw = xᵀ·dy in bf16.
"""
from __future__ import annotations

import torch

from koifish_tpu_torch.ops.kernels import quantize as kq
from koifish_tpu_torch.ops.kernels.qdgrad import dgrad_int8_tile_or_none
from koifish_tpu_torch.ops.kernels.quantize import int8_dot


def _rowwise_q8(x: torch.Tensor):
    """(codes int8, scale f32 [.., 1]) per row of x [M, K]."""
    return kq.rowquant(x, kq.TRAIN_ROUNDING)


def _colwise_q8(w: torch.Tensor):
    """(codes int8, scale f32 [1, N]) per column of w [K, N]."""
    return kq.colquant(w, kq.TRAIN_ROUNDING)


def _dequant(wq: torch.Tensor, sw: torch.Tensor) -> torch.Tensor:
    return (wq.to(torch.float32) * sw).to(torch.bfloat16)


class Int8Matmul(torch.autograd.Function):
    """y = Int8Matmul.apply(x [..., K], w [K, N], wgrad, dgrad)."""

    @staticmethod
    def forward(ctx, x, w, wgrad, dgrad):
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        wq, sw = _colwise_q8(w)
        xq, sx = _rowwise_q8(x2)
        y = int8_dot(xq, wq).to(torch.float32) * sx * sw
        ctx.save_for_backward(x, wq, sw)
        ctx.flags = (wgrad, dgrad, w.dtype)
        return y.reshape(*lead, w.shape[-1]).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, wq, sw = ctx.saved_tensors
        wgrad, dgrad, w_dtype = ctx.flags
        lead = x.shape[:-1]
        g2 = g.reshape(-1, g.shape[-1])
        dx = None
        if ctx.needs_input_grad[0]:
            if dgrad == "tile":
                dx = dgrad_int8_tile_or_none(g2, wq, sw)
                if dx is None:
                    dx = g2.to(torch.bfloat16) @ _dequant(wq, sw).T
            elif dgrad:
                gs = g2.to(torch.float32) * sw
                gq, sg = _rowwise_q8(gs)
                dx = int8_dot(gq, wq.T).to(torch.float32) * sg
            else:
                dx = g2.to(torch.bfloat16) @ _dequant(wq, sw).T
            dx = dx.reshape(*lead, x.shape[-1]).to(x.dtype)
        dw = None
        if ctx.needs_input_grad[1]:
            x2 = x.reshape(-1, x.shape[-1])
            if wgrad:
                xq_c, sx_c = _colwise_q8(x2)       # scales over K
                gq_c, sg_c = _colwise_q8(g2)       # scales over N
                dw = int8_dot(xq_c.T, gq_c).to(torch.float32)
                dw = dw * sx_c.reshape(-1, 1) * sg_c.reshape(1, -1)
            else:
                dw = x2.to(torch.bfloat16).T @ g2.to(torch.bfloat16)
            dw = dw.to(w_dtype)
        return dx, dw, None, None


def int8_matmul(x: torch.Tensor, w: torch.Tensor, wgrad: bool = False,
                dgrad=False) -> torch.Tensor:
    """x [..., K] @ w [K, N] with an int8 forward; see the module doc."""
    return Int8Matmul.apply(x, w, wgrad, dgrad)
