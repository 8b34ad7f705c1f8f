"""Flash attention, forward and backward: the CUDA kernels' wrappers, their
plain versions, and the autograd Function that joins them.

The forward kernel (``csrc/flash_fwd.cu``) replaces the JAX package's
Pallas forward kernels in ``koifish_tpu/ops/pallas/flash.py`` — the
column-layout (``_fwd_cols_single``, ``_flash_cols_fwd_call``) and
head-major (``_fwd_single``, ``_flash_fwd_call``) variants alike: q/k/v
arrive as ``[B, T, H, D]`` views with arbitrary strides, so both layouts
reach it without a transpose copy. The backward pair (``csrc/flash_bwd.cu``:
``flash_bwd_dkv``, ``flash_bwd_dq``) replaces the four Pallas backward
variants (``_bwd_fused``, ``_bwd_twopass``, ``_bwd_cols_fused``,
``_bwd_cols_twopass``) the same way.

Rounding points follow the Pallas kernels: q is scaled in f32 and rounded
to bf16 before QKᵀ, p is rounded to bf16 before PV (and before dV), masked
logits are -1e30 (not -inf), the row sum is clamped at 1e-30, ds is
rounded to bf16 before dK and dQ, and dk/dv are summed in f32 over the q
heads of a kv group before one rounding to bf16.

``FlashAttention`` is the differentiable entry: on a CUDA tensor its
forward and backward launch the kernels; on a CPU tensor they run the
plain versions, so a CPU test exercises the very Function the card runs.
"""
from __future__ import annotations

import ctypes

import torch

from koifish_tpu_torch.ops.kernels import _build
from koifish_tpu_torch.utils import kernel_log

NAME = "flash_fwd"
NAME_DKV, NAME_DQ = "flash_bwd_dkv", "flash_bwd_dq"
HEAD_DIMS = (64, 128, 256)
_NEG_INF = -1e30

_fn = None
_bwd = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load(NAME)
        fn = lib.koifish_flash_fwd
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = (lib, fn)
    return _fn


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, scale: float, window: int = 0):
    """Plain PyTorch version: (o [B,T,Hq,D] in q's dtype, lse [B,Hq,T] f32).
    One tile over the whole sequence — the math of the single-tile Pallas
    kernels (``_fwd_cols_single_kernel``)."""
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    g = Hq // Hkv
    qs = (q.to(torch.float32) * scale).to(torch.bfloat16).to(torch.float32)
    qs = qs.reshape(B, T, Hkv, g, D)
    s = torch.einsum("bthgd,bshd->bhgts", qs, k.to(torch.float32))
    pos = torch.arange(T, device=q.device)
    allowed = pos[None, :] <= pos[:, None]
    if window > 0:
        allowed &= pos[None, :] > pos[:, None] - window
    s = torch.where(allowed, s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)                     # [B,Hkv,g,T,1]
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    pv = torch.einsum("bhgts,bshd->bthgd",
                      p.to(torch.bfloat16).to(torch.float32),
                      v.to(torch.float32))
    o = pv / l.permute(0, 3, 1, 2, 4)
    lse = (m + torch.log(l)).reshape(B, Hq, T)
    return o.reshape(B, T, Hq, D).to(q.dtype), lse


def _check(q, k, v, window, extra=(), what="flash_fwd"):
    """Raise on what the kernels do not take: shapes, head dim, device,
    dtype and strides of q, k, v (and ``extra`` [B,T,Hq,D] tensors)."""
    B, T, Hq, D = q.shape
    shape = f"q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}"
    if k.dim() != 4 or k.shape != v.shape or k.shape[:2] != (B, T) \
            or k.shape[3] != D:
        raise ValueError(f"{what}: {shape}: need q [B,T,Hq,D] and "
                         f"k, v [B,T,Hkv,D] of the same B, T, D")
    if Hq % k.shape[2]:
        raise ValueError(f"{what}: {shape}: Hq must be a multiple of Hkv")
    if D not in HEAD_DIMS:
        raise ValueError(f"{what}: {shape}: head dim {D} not in "
                         f"{HEAD_DIMS}")
    if window < 0:
        raise ValueError(f"{what}: window {window} < 0")
    for name, t in (("q", q), ("k", k), ("v", v)) + tuple(extra):
        if name not in ("q", "k", "v") and t.shape != q.shape:
            raise ValueError(f"{what}: {name}{tuple(t.shape)} must have "
                             f"q's shape {tuple(q.shape)}")
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError(f"{what}: {name} lies on {t.device}, need "
                             f"the CUDA device of q ({q.device})")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{what}: {name} is {t.dtype}, need bf16")
        if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(
                f"{what}: {name} strides {t.stride()} of {shape}: need a "
                f"unit last-dim stride and 16-byte aligned rows")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, scale: float, window: int = 0):
    """Causal (+ sliding-window) GQA flash attention forward.

    q [B,T,Hq,D], k/v [B,T,Hkv,D] bf16 (any strides with a unit last-dim
    stride). Returns (o [B,T,Hq,D] bf16, lse [B,Hq,T] f32). A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale=scale, window=window)
    _check(q, k, v, window)
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    o = torch.empty((B, T, Hq, D), dtype=torch.bfloat16, device=q.device)
    lse = torch.empty((B, Hq, T), dtype=torch.float32, device=q.device)
    lib, fn = _kernel()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, T, Hq, Hkv, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            float(scale), int(window), stream)
    _build.check(lib, rc, f"flash_fwd q{tuple(q.shape)}")
    kernel_log.count(NAME)
    return o, lse


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

def _bwd_kernels():
    global _bwd
    if _bwd is None:
        lib = _build.load("flash_bwd")
        fns = []
        for name, n_out in (("koifish_flash_bwd_dkv", 2),
                            ("koifish_flash_bwd_dq", 1)):
            fn = getattr(lib, name)
            # q k v o do lse delta, outputs; B T Hq Hkv D; 5 x 3 strides;
            # scale, window, make_delta, stream
            fn.argtypes = ([ctypes.c_void_p] * (7 + n_out)
                           + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 15
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p])
            fn.restype = ctypes.c_int
            fns.append(fn)
        _bwd = (lib, *fns)
    return _bwd


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, scale: float,
                              window: int = 0):
    """Plain PyTorch backward: (dq [B,T,Hq,D], dk, dv [B,T,Hkv,D]) in the
    inputs' dtypes, from the forward's o and f32 lse [B,Hq,T]. The rounding
    points of ``_bwd_cols_fused_kernel`` / ``_bwd_dkv_kernel`` /
    ``_bwd_dq_kernel``: qs = bf16(q·scale); p = exp(s − lse); dv = bf16(p)ᵀ·dO;
    delta = rowsum(dO·O); ds = p·(dp − delta)·scale; dk = bf16(ds)ᵀ·q and
    dq = bf16(ds)·k; dk and dv are summed in f32 over the q group."""
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    g = Hq // Hkv
    f32, bf16 = torch.float32, torch.bfloat16
    qf = q.to(f32).reshape(B, T, Hkv, g, D)
    qs = (qf * scale).to(bf16).to(f32)
    kf, vf = k.to(f32), v.to(f32)
    dof = do.to(f32).reshape(B, T, Hkv, g, D)
    s = torch.einsum("bthgd,bshd->bhgts", qs, kf)
    pos = torch.arange(T, device=q.device)
    allowed = pos[None, :] <= pos[:, None]
    if window > 0:
        allowed &= pos[None, :] > pos[:, None] - window
    s = torch.where(allowed, s, _NEG_INF)
    p = torch.exp(s - lse.reshape(B, Hkv, g, T, 1))
    dv = torch.einsum("bhgts,bthgd->bshd", p.to(bf16).to(f32), dof)
    dp = torch.einsum("bthgd,bshd->bhgts", dof, vf)
    delta = (dof * o.to(f32).reshape(B, T, Hkv, g, D)).sum(-1)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None]) * scale
    dsb = ds.to(bf16).to(f32)
    dk = torch.einsum("bhgts,bthgd->bshd", dsb, qf)
    dq = torch.einsum("bhgts,bshd->bthgd", dsb, kf).reshape(B, T, Hq, D)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bwd_launch(which: int, q, k, v, o, lse, do, scale, window, delta=None):
    """Check the inputs, allocate the outputs and launch one backward
    kernel: 0 = ``flash_bwd_dkv`` -> (dk, dv), 1 = ``flash_bwd_dq`` -> dq.
    Returns (outputs, delta): delta = rowsum(dO·O) f32 [B,Hq,T] is computed
    by the same launch when not given (a row-sum pass before the kernel)."""
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    for name, t in (("lse", lse), ("delta", delta)):
        if t is None:
            continue
        if t.shape != (B, Hq, T) or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"flash_bwd: {name} {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}: need a contiguous f32 "
                             f"[B,Hq,T] on q's device")
    _check(q, k, v, window, extra=(("o", o), ("do", do)), what="flash_bwd")
    make = delta is None
    if make:
        delta = torch.empty((B, Hq, T), dtype=torch.float32, device=q.device)
    lib, *fns = _bwd_kernels()
    outs = ([torch.empty((B, T, Hkv, D), dtype=torch.bfloat16,
                         device=q.device) for _ in range(2)] if which == 0
            else [torch.empty((B, T, Hq, D), dtype=torch.bfloat16,
                              device=q.device)])
    rc = fns[which](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in outs),
        B, T, Hq, Hkv, D, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *o.stride()[:3], *do.stride()[:3], float(scale), int(window),
        int(make), torch.cuda.current_stream(q.device).cuda_stream)
    name = (NAME_DKV, NAME_DQ)[which]
    _build.check(lib, rc, f"{name} q{tuple(q.shape)}")
    kernel_log.count(name)
    return outs, delta


def flash_bwd_dkv(q, k, v, o, lse, do, *, scale: float, window: int = 0):
    """(dk, dv) [B,T,Hkv,D] bf16: the ``flash_bwd_dkv`` kernel (CUDA only),
    with delta = rowsum(dO·O) computed by the same launch."""
    (dk, dv), _ = _bwd_launch(0, q, k, v, o, lse, do, scale, window)
    return dk, dv


def flash_bwd_dq(q, k, v, o, lse, do, *, scale: float, window: int = 0,
                 delta=None):
    """dq [B,T,Hq,D] bf16: the ``flash_bwd_dq`` kernel (CUDA only). ``delta``
    (f32 [B,Hq,T], as ``flash_bwd_dkv``'s launch leaves it) is computed by
    the same launch when not given."""
    return _bwd_launch(1, q, k, v, o, lse, do, scale, window, delta)[0][0]


def flash_attention_bwd(q, k, v, o, lse, do, *, scale: float,
                        window: int = 0):
    """Causal (+ window) GQA flash attention backward: (dq, dk, dv) bf16.

    q, o, do [B,T,Hq,D] and k, v [B,T,Hkv,D] bf16 (any strides with a unit
    last-dim stride), lse [B,Hq,T] f32 from the forward. A CPU tensor takes
    the plain version; a CUDA tensor launches ``flash_bwd_dkv`` (which
    computes delta first) and then ``flash_bwd_dq`` on the same delta."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, scale=scale,
                                         window=window)
    (dk, dv), delta = _bwd_launch(0, q, k, v, o, lse, do, scale, window)
    dq = _bwd_launch(1, q, k, v, o, lse, do, scale, window, delta)[0][0]
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: o = FlashAttention.apply(q, k, v,
    scale, window). The forward saves q, k, v, o and the f32 lse; the
    backward runs ``flash_attention_bwd`` (kernels on the card, the plain
    backward on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, window):
        o, lse = flash_attention_fwd(q, k, v, scale=scale, window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.window = scale, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.to(q.dtype),
                                         scale=ctx.scale, window=ctx.window)
        return dq, dk, dv, None, None
