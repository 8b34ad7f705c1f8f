"""Knowledge distillation: teacher-logits KD with annealed mixing (the JAX
package's ``train/distill.py``; the reference's Fuzi distillation,
src/Fuzi/Distillation.{hpp,cpp}, with its ``UpdateSigma`` annealing).

Loss = (1-σ)·CE(student, labels) + σ·T²·KL(teacher_T ‖ student_T), σ
annealed over training. Both models' [B, T, V] f32 logits are made, as in
the JAX package; the teacher runs under ``torch.no_grad()``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from koifish_tpu_torch.config import ModelCard
from koifish_tpu_torch.models.transformer import model_forward
from koifish_tpu_torch.ops.cross_entropy import cross_entropy_loss


@dataclasses.dataclass
class DistillSchedule:
    """σ annealing (UpdateSigma analog): start strong on the teacher, hand
    over to the hard labels."""
    sigma0: float = 0.9
    sigma1: float = 0.1
    total_steps: int = 1000
    kind: str = "cosine"       # cosine | linear | static

    def sigma(self, step) -> torch.Tensor:
        """σ at ``step`` as an f32 scalar tensor (on the CPU)."""
        t = torch.clamp(torch.tensor(float(step), dtype=torch.float32)
                        / max(self.total_steps, 1), 0.0, 1.0)
        if self.kind == "static":
            return torch.tensor(self.sigma0, dtype=torch.float32)
        if self.kind == "linear":
            return self.sigma0 + (self.sigma1 - self.sigma0) * t
        return self.sigma1 + 0.5 * (self.sigma0 - self.sigma1) * \
            (1 + torch.cos(math.pi * t))


def kd_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
            temperature: float = 2.0,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """T²-scaled KL(teacher ‖ student), the mean over masked tokens."""
    sl = student_logits.to(torch.float32) / temperature
    tl = teacher_logits.to(torch.float32) / temperature
    t_prob = torch.softmax(tl, dim=-1)
    s_logp = torch.log_softmax(sl, dim=-1)
    t_logp = torch.log_softmax(tl, dim=-1)
    kl = torch.sum(t_prob * (t_logp - s_logp), dim=-1)   # [B, T]
    kl = kl * temperature ** 2
    if mask is None:
        return kl.mean()
    m = mask.to(torch.float32)
    return (kl * m).sum() / torch.clamp(m.sum(), min=1.0)


def distill_step_loss(card: ModelCard, params, teacher_card: ModelCard,
                      teacher_params, tokens: torch.Tensor, step,
                      schedule: DistillSchedule, temperature: float = 2.0,
                      loss_mask: Optional[torch.Tensor] = None,
                      remat=False):
    """(loss, {"ce", "kd", "sigma"}) of one [B, T+1] batch; the teacher's
    logits carry no gradient."""
    s_logits = model_forward(card, params, tokens[:, :-1], remat=remat)
    with torch.no_grad():
        t_logits = model_forward(teacher_card, teacher_params,
                                 tokens[:, :-1])
    mask = loss_mask[:, 1:] if loss_mask is not None else None
    ce, _ = cross_entropy_loss(s_logits, tokens[:, 1:], mask)
    kd = kd_loss(s_logits, t_logits, temperature, mask)
    sigma = schedule.sigma(step).to(ce.device)
    return (1.0 - sigma) * ce + sigma * kd, {"ce": ce, "kd": kd,
                                             "sigma": sigma}
