"""The plain reference of a served request, in float32: the configuration's
model over its prompt and the tokens the program served, teacher-forced,
with the configuration's quantization worked out here from the float
weights: RTN INT4 projections, and an INT8 KV cache that the decode
positions read (the prompt's own rows attend in the prefill with the
exact K and V, as a fresh prefill does). Returns the logits at every
position that chose a served token: the prompt's last, then each served
token's but the last.

``control=True`` computes one precision lower: FP8 E4M3 activations into
every projection and an INT4 KV cache.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from kbench.reference.models import (F32, forward_hidden, logits, plain_lin,
                                     strict_f32)
from kbench.reference.quant import fake_fp8, kv_quant, rtn_int4
from kbench.work import Shapes

PROJ = ("q", "k", "v", "o", "gate", "up", "down", "fc", "proj")


def quantized_tree(tree: Dict, group: int = 128) -> Dict:
    """The weight tree with every layer projection replaced by its RTN INT4
    values (float32); norms and the tied table as they are."""
    out = {k: v for k, v in tree.items() if k != "layers"}
    out["layers"] = [{k: (rtn_int4(v, group) if k in PROJ else v)
                      for k, v in lp.items()} for lp in tree["layers"]]
    return out


@torch.no_grad()
def request_logits(sh: Shapes, qtree: Dict, prompt: Sequence[int],
                   served: Sequence[int], theta: float, control=False,
                   device="cuda") -> torch.Tensor:
    """[len(served), V] float32 logits of the positions that chose the
    served tokens."""
    strict_f32()
    ids = list(prompt) + list(served[:-1])
    toks = torch.tensor([ids], dtype=torch.int64, device=device)
    P = len(prompt)
    qmax = 7.0 if control else 127.0

    def kv(k, v):
        return kv_quant(k, qmax), kv_quant(v, qmax), P

    if control:
        def lin(x, w, name):
            return fake_fp8(x, -1) @ w.to(F32)
    else:
        lin = plain_lin
    h = forward_hidden(sh, qtree, toks, lin=lin, kv=kv, theta=theta)
    return logits(sh, qtree, h[0, P - 1:], lin=lin)


def logit_gap(ref: torch.Tensor, values: torch.Tensor, ids: torch.Tensor
              ) -> torch.Tensor:
    """The widest gap, at each position, between the other side's logits
    (``values`` at ``ids``, [n, k]) and the reference's at the same ids,
    over the spread (standard deviation) of the reference's row."""
    own = ref.gather(-1, ids.long())
    return (values.to(ref.dtype) - own).abs().amax(-1) / ref.std(-1)


def below_kth(ref: torch.Tensor, chosen: torch.Tensor, k: int
              ) -> torch.Tensor:
    """By how much each chosen token's reference logit lies below the
    reference's k-th best (0 where it is among the k best)."""
    kth = torch.topk(ref, k, dim=-1).values[:, -1]
    own = ref.gather(-1, chosen.long()[:, None])[:, 0]
    return torch.clamp(kth - own, min=0.0)
