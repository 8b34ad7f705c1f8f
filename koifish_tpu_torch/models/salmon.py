"""Salmon — the masked-diffusion ("scoring") language model (the JAX
package's ``models/salmon.py``; the reference's Salmon arch,
src/Transformer/Salmon.cpp, XI_CARD in src/CLI_params.hpp:413-421).

Bidirectional attention (``card.causal`` False, the plain attention path
in both packages) over sequences where a random fraction of the tokens is
replaced by a mask token, trained to reconstruct them:

- training: per sequence t ~ U(eps, 1), each position masked with
  probability t, loss = CE over the masked positions weighted 1/t (the
  discrete-diffusion ELBO);
- generation: fully masked after the prompt, S denoise steps, each keeping
  the most confident fraction of a linear unmask schedule.

The draws are the JAX package's: ``split(key)`` into the t and mask keys,
``uniform`` in numpy (``utils/prng.py``). Callers may hand ``t`` and the
mask in instead. Sampling at ``temperature > 0`` in ``diffusion_generate`` draws
from a ``torch.Generator``; greedy generation is the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from koifish_tpu_torch.config import ModelCard
from koifish_tpu_torch.models.transformer import model_forward
from koifish_tpu_torch.ops.sampling import _categorical
from koifish_tpu_torch.utils import prng


@dataclasses.dataclass
class XICard:
    """Diffusion config (XI_CARD analog, CLI_params.hpp:413-421)."""
    mask_seed: int = 20260713      # reference default
    timesteps: int = 16            # denoise steps at generation
    eps: float = 1e-3              # min mask ratio

    @classmethod
    def from_json(cls, j: Dict[str, Any]) -> "XICard":
        return cls(mask_seed=int(j.get("mask_seed", 20260713)),
                   timesteps=int(j.get("timesteps", 16)),
                   eps=float(j.get("eps", 1e-3)))


def mask_id(card: ModelCard) -> int:
    return card.mask_token_id if card.mask_token_id >= 0 \
        else card.vocab_size - 1


def diffusion_draws(key: np.ndarray, B: int, T: int, eps: float = 1e-3
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(t [B, 1] f32, masked [B, T] bool) from a uint32 [2] key, as the
    JAX ``diffusion_loss`` draws them."""
    k_t, k_m = prng.split(key)
    t = prng.uniform(k_t, (B, 1), eps, 1.0)
    return t, prng.uniform(k_m, (B, T)) < t


def diffusion_loss(card: ModelCard, params, tokens: torch.Tensor,
                   key: Optional[np.ndarray] = None,
                   xi: Optional[XICard] = None,
                   loss_mask: Optional[torch.Tensor] = None,
                   t: Optional[torch.Tensor] = None,
                   masked: Optional[torch.Tensor] = None,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked-diffusion ELBO loss over [B, T] tokens -> (loss, per-position
    CE · mask). ``t`` [B, 1] and ``masked`` [B, T] are drawn from ``key``
    (None: PRNGKey(0)) unless given; ``loss_mask`` restricts which positions
    may be masked and scored (SFT: assistant spans only)."""
    xi = xi or XICard()
    B, T = tokens.shape
    dev = tokens.device
    if t is None or masked is None:
        tn, mn = diffusion_draws(prng.prng_key(0) if key is None else key,
                                 B, T, xi.eps)
        t = torch.from_numpy(tn) if t is None else t
        masked = torch.from_numpy(mn) if masked is None else masked
    t = t.to(dev, torch.float32)
    masked = masked.to(dev, torch.bool)
    if loss_mask is not None:
        masked = masked & loss_mask.to(dev, torch.bool)
    noisy = torch.where(masked, mask_id(card), tokens)
    logits = model_forward(card, params, noisy, logits_dtype=torch.bfloat16)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    tok_lp = torch.gather(logp, -1, tokens.long()[..., None])[..., 0]
    ce = -tok_lp * masked                         # CE only on masked slots
    w = 1.0 / t                                   # ELBO weight, per sequence
    loss = torch.sum(ce * w) / (torch.sum(masked * w) + 1e-9)
    return loss, ce


@torch.no_grad()
def diffusion_generate(card: ModelCard, params, prompt: torch.Tensor,
                       total_len: int, steps: int = 16,
                       temperature: float = 0.0,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
    """Iterative unmasking: [B, P] prompt -> [B, total_len] tokens. Linear
    schedule: after step s the top (s+1)/steps fraction of the generated
    positions by confidence are unmasked; a last greedy pass resolves any
    mask the rounding left."""
    B, P = prompt.shape
    if P >= total_len:
        raise ValueError(f"prompt of {P} tokens leaves nothing to generate "
                         f"in {total_len}")
    dev = prompt.device
    mid = mask_id(card)
    gen_len = total_len - P
    x = torch.cat([prompt.long(), torch.full((B, gen_len), mid,
                                             dtype=torch.long, device=dev)],
                  dim=1)
    is_prompt = torch.arange(total_len, device=dev)[None, :] < P
    inf = torch.tensor(float("inf"), device=dev)
    for s in range(steps):
        logits = model_forward(card, params, x,
                               logits_dtype=torch.bfloat16).to(torch.float32)
        if temperature > 0:
            pred = _categorical(generator, logits / temperature)
        else:
            pred = torch.argmax(logits, dim=-1)
        conf = torch.softmax(logits, dim=-1).amax(dim=-1)       # [B, T]
        still_masked = x == mid
        conf = torch.where(still_masked, conf, inf)
        n_keep = ((s + 1) * gen_len) // steps
        conf_gen = torch.where(is_prompt, inf, conf)
        order = torch.argsort(-conf_gen, dim=-1, stable=True)   # high first
        rank = torch.argsort(order, dim=-1)
        unmask = rank < (P + n_keep)
        x = torch.where(still_masked & unmask, pred.long(), x)
    logits = model_forward(card, params, x, logits_dtype=torch.bfloat16)
    pred = torch.argmax(logits.to(torch.float32), dim=-1)
    return torch.where(x == mid, pred, x).to(torch.int32)
