"""Mamba (selective SSM) blocks — the JAX package's ``models/mamba.py``.

Block: x -> in_proj -> (u, z); depthwise causal conv1d (k = 4) -> silu;
selection: dt = softplus(dt_proj(x_proj_dt(u)) + dt_bias), B, C =
x_proj(u); the scan h_t = a_t·h_{t-1} + b_t over the state dim N with
a = exp(dt·A), b = dt·u·B; y = C·h + D·u; out = out_proj(y · silu(z)).

The JAX package runs the recurrence as one ``associative_scan`` that XLA
lowers; no Pallas kernel exists, so the port's scan is plain PyTorch too.
Its tensors a, b and h are [B, T, Ei, N] f32 (805 MB each at mamba-130m's
widths, B 8 × T 1024), so ``selective_scan`` is an autograd function that
keeps none of them: the forward makes a and b, runs the odd-even scan of
``associative_scan`` — linear traffic, about four launches a level and
log2(T) levels — and contracts h with C at once; it saves only its inputs
([B, T, Ei] and smaller). The backward rebuilds a, b and h the same way and
runs the adjoint recurrence λ_t = g_t + a_{t+1}·λ_{t+1} as a reverse scan.
A layer's transient peak is about six such tensors, and nothing of size
[B, T, Ei, N] outlives the layer. Under remat the model recomputes the
projections on either side of the scan (``mamba_in``, ``mamba_out``), never
the scan. The scan pairs terms as XLA's does, but XLA may fuse a product
and a sum into one rounding, so h agrees with JAX's within f32 rounding
(``tests/test_torch_zoo_mamba.py`` states the tolerance).
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from koifish_tpu_torch.config import ModelCard

D_STATE = 16
D_CONV = 4
EXPAND = 2


def _dims(card: ModelCard):
    ei = EXPAND * card.n_embd
    dt_rank = max(card.n_embd // 16, 1)
    return ei, dt_rank


def init_mamba_layer(card: ModelCard, gen: torch.Generator,
                     dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """One layer's leaves: S4D-real A (``A_log`` = log 1..N), and dt_bias
    the inverse softplus of dt drawn log-uniform in [1e-3, 1e-1]."""
    E = card.n_embd
    ei, dt_rank = _dims(card)
    std = 0.02

    def nrm(shape, s=std):
        w = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32)
        return (w * s).to(dtype)

    A = torch.arange(1, D_STATE + 1, dtype=torch.float32,
                     device=device).expand(ei, D_STATE)
    r = torch.rand((ei,), generator=gen, device=device, dtype=torch.float32)
    dt = torch.exp(r * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt + torch.log(-torch.expm1(-dt))          # inverse softplus
    return {
        "in_proj": nrm((E, 2 * ei)),
        "conv_w": nrm((D_CONV, ei), 0.2),
        "conv_b": torch.zeros((ei,), dtype=dtype, device=device),
        "x_proj": nrm((ei, dt_rank + 2 * D_STATE)),
        "dt_proj": nrm((dt_rank, ei), dt_rank ** -0.5),
        "dt_bias": dt_bias,
        "A_log": torch.log(A).contiguous(),
        "Dd": torch.ones((ei,), dtype=torch.float32, device=device),
        "out_proj": nrm((ei, E), std / math.sqrt(2 * card.n_layer)),
    }


def _causal_conv1d(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                   ) -> torch.Tensor:
    """Depthwise causal conv over time, in u's dtype, its terms summed in
    the JAX package's order. u [B, T, Ei]; w [K, Ei]."""
    K, T = w.shape[0], u.shape[1]
    up = F.pad(u, (0, 0, K - 1, 0))
    out = up[:, 0:T] * w[0]
    for i in range(1, K):
        out = out + up[:, i: i + T] * w[i]
    return out + b


def _scan_into(a: torch.Tensor, b: torch.Tensor, h: torch.Tensor,
               reverse: bool) -> None:
    """Writes into ``h`` the recurrence h_t = a_t·h_{t-1} + b_t along dim 1
    (``reverse``: h_t = a_t·h_{t+1} + b_t) by the odd-even recursion of
    ``jax.lax.associative_scan``: combine adjacent pairs, scan the pairs
    straight into h's odd steps (in scan order), then finish the even steps
    from them. Each level moves half the elements of the one above, so the
    traffic is linear in T and the launches grow with log2(T). The running
    products of a are never formed: h needs only the pairs' products."""
    n = b.shape[1]
    first = n - 1 if reverse else 0
    h.select(1, first).copy_(b.select(1, first))
    if n == 1:
        return
    # in scan order: pairs (k, k + 1) for even k; steps k >= 2 even
    if reverse:
        lo, hi = slice(1 + n % 2, n, 2), slice(n % 2, n - 1, 2)
        ev, n_ev = slice((n - 1) % 2, n - 2, 2), (n - 1) // 2
        odd = slice(n // 2 - n_ev, n // 2)
    else:
        lo, hi = slice(0, n - 1, 2), slice(1, n, 2)
        ev, n_ev = slice(2, n, 2), (n - 1) // 2
        odd = slice(0, n_ev)
    a_hi = a[:, hi]
    ra = torch.mul(a[:, lo], a_hi) if n // 2 > 1 else a_hi
    rb = torch.addcmul(b[:, hi], b[:, lo], a_hi)
    _scan_into(ra, rb, h[:, hi], reverse)
    del ra, rb
    if n_ev:
        torch.addcmul(b[:, ev], h[:, hi][:, odd], a[:, ev], out=h[:, ev])


def _scan(a: torch.Tensor, b: torch.Tensor, reverse: bool = False
          ) -> torch.Tensor:
    """h_t = a_t·h_{t-1} + b_t along dim 1 (``reverse``: h_t = a_t·h_{t+1}
    + b_t), summed in the order of ``jax.lax.associative_scan``. Out of
    place; a and b are not written."""
    h = torch.empty_like(b)
    _scan_into(a, b, h, reverse)
    return h


def _ab(u, dt, A, Bm):
    a = torch.exp(dt[..., None] * A)                     # [B, T, Ei, N]
    b = (dt * u)[..., None] * Bm[:, :, None, :]
    return a, b


class SelectiveScan(torch.autograd.Function):
    """y = Σ_n h·C with h the scan of a = exp(dt·A), b = dt·u·B. Inputs
    f32: u, dt [B, T, Ei]; A [Ei, N]; Bm, Cm [B, T, N]."""

    @staticmethod
    def forward(ctx, u, dt, A, Bm, Cm):
        a, b = _ab(u, dt, A, Bm)
        h = _scan(a, b)
        del a, b
        ctx.save_for_backward(u, dt, A, Bm, Cm)
        return torch.einsum("btun,btn->btu", h, Cm)

    @staticmethod
    def backward(ctx, gy):
        u, dt, A, Bm, Cm = ctx.saved_tensors
        a, b = _ab(u, dt, A, Bm)
        h = _scan(a, b)
        del a, b
        gCm = torch.einsum("btun,btu->btn", h, gy)
        # the adjoint λ_t = g_t + a_{t+1}·λ_{t+1}, a_{t+1} from dt shifted
        dt_next = torch.zeros_like(dt)
        dt_next[:, :-1] = dt[:, 1:]
        a_next = torch.exp(dt_next[..., None] * A)
        del dt_next
        lam = _scan(a_next, gy[..., None] * Cm[:, :, None, :], reverse=True)
        # da_t = λ_t·h_{t-1}; through a_t = exp(dt_t·A) = a_next_{t-1}:
        # d(dt·A) = da·a
        ga = torch.zeros_like(lam)
        torch.mul(lam[:, 1:], h[:, :-1], out=ga[:, 1:])
        del h
        ga[:, 1:].mul_(a_next[:, :-1])
        del a_next
        gdt = torch.einsum("btun,un->btu", ga, A)
        gA = torch.einsum("btun,btu->un", ga, dt)
        del ga
        gdu = torch.einsum("btun,btn->btu", lam, Bm)     # d(dt·u)
        gBm = torch.einsum("btun,btu->btn", lam, dt * u)
        return gdu * dt, gdt + gdu * u, gA, gBm, gCm


def selective_scan(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor) -> torch.Tensor:
    return SelectiveScan.apply(u, dt, A, Bm, Cm)


def scan_ref(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor) -> torch.Tensor:
    """``selective_scan`` as a step-by-step loop over T with autograd
    through every step: the plain version the scan is held against."""
    a, b = _ab(u, dt, A, Bm)
    h = torch.zeros_like(a[:, 0])
    ys = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        ys.append(torch.einsum("bun,bn->bu", h, Cm[:, t]))
    return torch.stack(ys, dim=1)


def mamba_in(card: ModelCard, lp: Dict[str, Any], x: torch.Tensor):
    """The mixer up to the scan: x [B, T, E] -> the scan's inputs (u, dt,
    A, B, C) and the gate z."""
    ei, dt_rank = _dims(card)
    dt_x = x.dtype
    xz = torch.matmul(x, lp["in_proj"].to(dt_x))
    u, z = xz[..., :ei], xz[..., ei:]
    u = _causal_conv1d(u, lp["conv_w"].to(u.dtype), lp["conv_b"].to(u.dtype))
    u = F.silu(u.to(torch.float32))                      # [B, T, Ei] f32

    sel = torch.matmul(u.to(dt_x), lp["x_proj"].to(dt_x))
    dt_in = sel[..., :dt_rank]
    Bm = sel[..., dt_rank:dt_rank + D_STATE].to(torch.float32)
    Cm = sel[..., dt_rank + D_STATE:].to(torch.float32)
    dt = F.softplus(torch.matmul(dt_in, lp["dt_proj"].to(dt_x)
                                 ).to(torch.float32) + lp["dt_bias"])
    A = -torch.exp(lp["A_log"].to(torch.float32))        # [Ei, N]
    return u, dt, A, Bm, Cm, z


def mamba_out(lp: Dict[str, Any], y: torch.Tensor, u: torch.Tensor,
              z: torch.Tensor) -> torch.Tensor:
    """The mixer after the scan: y + D·u, gated by silu(z), out_proj (in
    z's dtype)."""
    y = y + lp["Dd"] * u
    y = y * F.silu(z.to(torch.float32))
    return torch.matmul(y.to(z.dtype), lp["out_proj"].to(z.dtype))


def mamba_block(card: ModelCard, lp: Dict[str, Any], x: torch.Tensor
                ) -> torch.Tensor:
    """One mamba mixer over [B, T, E] (bf16 in, bf16 out)."""
    u, dt, A, Bm, Cm, z = mamba_in(card, lp, x)
    return mamba_out(lp, selective_scan(u, dt, A, Bm, Cm), u, z)
