"""Quantization-aware training: straight-through fake quantization (the
JAX package's ``quant/qat.py``; the reference's in-path ``CU_FQUANT_128_``,
quantizer.cu:195-247). The bf16 parameter is the master copy: the forward
sees ``ste_fake_quant(w)`` and the gradient passes straight through to w.
Scale-only ("gama") training needs no fake quantization: the params are
QTensors already (``quantize_params``), their codes frozen and their scales
trained through ``ops/kernels/matmul.QMatmul`` (``train/trainer.py``).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from koifish_tpu_torch.config import ModelCard, QuantCard
from koifish_tpu_torch.dtypes import QFormat
from koifish_tpu_torch.quant.apply import param_path
from koifish_tpu_torch.quant.rtn import fake_quant


class _STE(torch.autograd.Function):
    """Forward: the quantized value; backward: identity to the master."""

    @staticmethod
    def forward(ctx, w, fq):
        return fq.view_as(fq)

    @staticmethod
    def backward(ctx, g):
        return g, None


def ste_fake_quant(w: torch.Tensor, fmt: QFormat, group: int = 128
                   ) -> torch.Tensor:
    """fake_quant(w) with a straight-through gradient."""
    with torch.no_grad():
        fq = fake_quant(w.detach(), fmt, group=group)
    return _STE.apply(w, fq)


def apply_qat(params: Dict[str, Any], qcard: QuantCard,
              card: ModelCard = None) -> Dict[str, Any]:
    """Rule-matched 2-D layer weights become their fake-quantized values
    with straight-through gradients; call inside the loss so gradients
    reach the master (bf16) parameters."""
    out = dict(params)
    new_layers = []
    for li, lp in enumerate(params["layers"]):
        nlp = dict(lp)
        for key, w in lp.items():
            if key.endswith("_b") or getattr(w, "ndim", 0) != 2:
                continue
            rule = qcard.rule_for(param_path(li, key))
            if rule is None or w.shape[0] % rule.group:
                continue
            nlp[key] = ste_fake_quant(w, rule.fmt, rule.group)
        new_layers.append(nlp)
    out["layers"] = new_layers
    return out
