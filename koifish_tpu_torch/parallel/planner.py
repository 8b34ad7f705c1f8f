"""Memory planner — how many cards does a model need, and on what mesh?
(the JAX package's ``parallel/planner.py``).

The reference runs everything on one 24 GB 4090 and answers "does it
fit?" by trial (README.md:23 "Qwen3-32B inference on a single 4090" via
INT4 + HotPicker). With several cards the same question becomes a mesh
choice; this module sizes weights / KV / optimizer / activations
analytically and recommends the smallest mesh that fits, so
``bubble --tp`` / ``koifish --dp --tp --fsdp`` can be driven from a
preset name instead of OOM roulette. The arithmetic is the JAX package's;
the capacity is one H100's and the reserve the CUDA context and caching
allocator's overhead, both measured on the card by ``chip_smoke.py``'s
parallel phase (``PERF.md`` §5). Pass ``hbm_bytes``/``reserve`` to plan
for another card.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from koifish_tpu_torch.utils.mfu import matmul_params

H100_HBM = 80 * 1000 ** 3         # bytes per H100 80GB card
#: what a rank needs beside its tensors: a fresh process's CUDA context
#: (524 MiB) plus the caching allocator's largest slack at a training
#: step's peak (reserved - allocated, 1.65 GiB), measured by
#: chip_smoke.py's parallel phase on an NVIDIA H100 80GB HBM3 (700 W)
RESERVE = int(2.16 * 1024 ** 3)


def param_count(card) -> int:
    """Total parameters (embedding included; tied head counted once)."""
    embed = card.vocab_size * card.n_embd
    P = matmul_params(card) + embed
    if card.tie_embeddings:
        P -= card.vocab_size * card.n_embd   # matmul_params counted the head
    if card.pos_embed == "learned":
        P += card.max_pos * card.n_embd
    return P


@dataclasses.dataclass
class MemoryPlan:
    weights_bytes: int
    kv_bytes: int
    opt_bytes: int            # f32 moments (training only)
    act_bytes: int            # activation estimate at the given batch
    total_bytes: int
    n_chips: int              # smallest power-of-2 chip count that fits
    mesh: Dict[str, int]      # recommended axis sizes
    per_chip_bytes: int

    def summary(self) -> str:
        g = 1024 ** 3
        return (f"weights={self.weights_bytes/g:.1f}G kv={self.kv_bytes/g:.1f}G "
                f"opt={self.opt_bytes/g:.1f}G act={self.act_bytes/g:.1f}G -> "
                f"{self.n_chips} chip(s) {self.mesh}, "
                f"{self.per_chip_bytes/g:.1f}G/chip")


def plan_serving(card, batch: int, ctx: int, weight_bits: int = 4,
                 kv_bits: int = 8, hbm_bytes: int = H100_HBM,
                 max_chips: int = 256,
                 reserve: int = RESERVE) -> MemoryPlan:
    """Mesh plan for inference: weights TP-sharded, KV sharded over the
    same axis (heads divide), activations replicated per chip."""
    P = param_count(card)
    wb = int(P * weight_bits / 8 * 1.06)    # + scales/zeros overhead
    kvb = int(2 * card.n_layer * batch * card.n_kv_head * ctx *
              card.head_dim * kv_bits / 8 * 1.06)
    act = int(batch * ctx * card.n_embd * 2 * 8)   # ~8 live [B,T,E] bf16
    n = 1
    while n <= max_chips:
        per = (wb + kvb) // n + act + reserve
        if per <= hbm_bytes and card.n_kv_head % min(n, card.n_kv_head) == 0:
            break
        n *= 2
    mesh = {"tp": n}
    return MemoryPlan(wb, kvb, 0, act, wb + kvb + act, n, mesh,
                      (wb + kvb) // n + act)


def plan_decode(card, batch: int, ctx: int, weight_bits: int = 4,
                kv_bits: int = 8, n_chips: int = 1,
                hbm_bytes: int = H100_HBM,
                layered: bool = True,
                reserve: int = RESERVE) -> Dict[str, int]:
    """Per-component decode memory accounting for ONE batch size.

    ``layered=True`` (the serving path): caches are born per layer
    (``cache_for(layered=True)`` / ``init_layered_cache``), so steady
    state holds ONE copy of the KV and the per-step allocation transient
    is one layer. ``layered=False`` models a stacked cache split into
    per-layer leaves (``serve/layered.split_cache``), which holds both
    copies for one step: the admission test must clear ``2 x kv_bytes``.

    Keys: weights / kv / kv_transient / logits / act / total / fits
    (all bytes, per card — weights and KV divide over ``n_chips`` of a
    tp mesh)."""
    P = param_count(card)
    wb = int(P * weight_bits / 8 * 1.06) // n_chips
    hd = card.head_dim or card.n_embd // card.n_head
    kv_elem = 2 * card.n_layer * batch * card.n_kv_head * ctx
    kvb = kv_elem * hd * kv_bits // 8
    if kv_bits in (4, 8):
        kvb += kv_elem * 4                    # f32 per-(h, pos) scales
    kvb //= n_chips
    logits = batch * card.vocab_size * 4      # f32 sampling columns
    act = batch * card.n_embd * 2 * 16        # [B, 1, E] working set
    transient = kvb // card.n_layer if layered else kvb
    total = wb + kvb + transient + logits + act + reserve
    return {"weights": wb, "kv": kvb, "kv_transient": transient,
            "logits": logits, "act": act, "total": total,
            "fits": total <= hbm_bytes}


def plan_training(card, batch: int, ctx: int, remat="dots",
                  hbm_bytes: int = H100_HBM, max_chips: int = 256,
                  optimizer: str = "adamw",
                  moment_dtype: str = "f32",
                  reserve: int = RESERVE) -> MemoryPlan:
    """Mesh plan for training: bf16 params + moments FSDP-sharded,
    batch DP-sharded. ``remat`` scales the activation estimate the same
    way models/transformer.py interprets it (True=full per-layer
    checkpoint, "dots"=GEMM outputs resident, False=everything).
    ``moment_dtype="bf16"`` matches TrainCard.moment_dtype (the shipped
    774M/1558M recipe) — halves optimizer-state bytes."""
    P = param_count(card)
    wb = P * 2                                   # bf16 params
    n_moments = 2 if optimizer == "adamw" else 1  # muon: momentum only
    ob = P * (2 if moment_dtype == "bf16" else 4) * n_moments
    # per-layer resident activations per token (bytes, bf16):
    E, F = card.n_embd, card.n_ffn
    q = card.n_head * card.head_dim
    kv = card.n_kv_head * card.head_dim
    full = (2 * E                      # block input + post-attn residual
            + q + 2 * kv + q           # qkv + attn out
            + 3 * F + E) * 2           # gate/up/act + down
    per_tok = {True: 2 * E * 2,        # just the carried residual
               "dots": (2 * E + q + 2 * kv + q + 2 * F + E) * 2,
               False: full}[remat]
    act = int(batch * ctx * card.n_layer * per_tok
              + batch * ctx * E * 2 * 8)         # + head/CE working set
    n = 1
    while n <= max_chips:
        # params/moments shard over fsdp, activations over dp (batch)
        dp = min(n, batch)
        per = (wb + ob) // n + act // dp + reserve
        if per <= hbm_bytes:
            break
        n *= 2
    # grads live at param size during the step; folded into reserve for
    # donated-buffer steps, counted when they don't fit
    dp = min(n, batch)
    mesh = {"dp": dp, "fsdp": n // dp} if n > 1 else {"dp": 1}
    return MemoryPlan(wb, 0, ob, act, wb + ob + act, n, mesh,
                      (wb + ob) // n + act // dp)
