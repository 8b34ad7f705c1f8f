"""The sequence-parallel ring attention's kernel ring and its plain version.

Row 13: ``csrc/ring_attn.cu`` replaces the JAX package's
``parallel/ring_pallas.py:152`` (``ring_attention_pallas``, kernel body
``_ring_kernel``): the forward pass of causal GQA attention over a sequence
sharded in n equal chunks, one rank a chunk. Rank ``my`` holds q
[B, Tl, Hq, D] and k/v [B, Tl, Hkv, D]; at step s it holds the chunk of
rank ``src = (my - s) % n`` and passes it to its right neighbour's other
slot of a 2-slot bf16 buffer while it attends over it.

The TPU kernel runs the whole ring in one kernel per device. Here the host
drives it (``ring_attention``): each rank has a compute stream and a copy
stream; a step is one kernel launch per rank over its q rows and the chunk
in its slot, the online softmax's (o, m, l) carried in f32 device memory
from launch to launch and the normalisation folded into the rank's last
launch. The transfer sits behind ``LocalTransport`` (send my slot to the
right neighbour's other slot, wait for my receive, acknowledge my slot),
ordered by CUDA events: a compute waits for its slot's receive; a copy
into a slot waits for that slot's ack and its owner's own send from it,
so a rank one step ahead never overwrites a slot its neighbour still
reads. Between cards the copy is a peer copy; ranks sharing a card
(virtual ranks, ``parallel/mesh.py``) copy within it.

Chunks with ``src > my`` lie wholly above the diagonal. Once step 0 (the
diagonal, always first) has made every row's m finite, their p is exactly
0 and they change nothing, so rank ``my`` launches only steps 0..my and
still forwards every chunk: n(n+1)/2 compute launches a ring, and
2·n·(n-1) chunk copies (K and V apart).

The plain version (``ring_step_plain``, ``ring_plain``) computes the same
in PyTorch, in the kernel's rounding: q and K in bf16, logits in f32, the
online softmax updated once a 64-key tile (the TPU kernel: once a chunk),
p rounded to bf16 for P·V, o / max(l, 1e-30) in q's dtype. A CPU tensor
takes it; a CUDA tensor launches the kernel or raises. The ring has no
gradient (the JAX kernel defines no VJP): an input that requires one
raises.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import List, Optional, Sequence

import torch

from koifish_tpu_torch.ops.kernels import _build
from koifish_tpu_torch.utils import kernel_log

NAME = "ring_attn"
TILE = 64                 # keys a tile: the online softmax's unit
HEAD_DIMS = (64, 128)
_NEG_INF = -1e30

_fns = None


def _kernel():
    """(lib, step launch, chunk copy) from ``csrc/ring_attn.cu``."""
    global _fns
    if _fns is None:
        lib = _build.load(NAME)
        step = lib.koifish_ring_attn_step
        step.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong]
                         + [ctypes.c_void_p] * 6 + [ctypes.c_longlong]
                         + [ctypes.c_int] * 7 + [ctypes.c_float]
                         + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        step.restype = ctypes.c_int
        copy = lib.koifish_ring_copy
        copy.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                         ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
        copy.restype = ctypes.c_int
        _fns = (lib, step, copy)
    return _fns


def _new_stream(device):
    """A stream of PyTorch's pool on ``device``. Two of them may share one
    CUDA stream when many are drawn; that only orders more, since every
    wait refers to an event already recorded."""
    return torch.cuda.Stream(device=device)


def _new_event():
    return torch.cuda.Event()


def _index(device: torch.device) -> int:
    return device.index if device.index is not None \
        else torch.cuda.current_device()


def _on(device: torch.device):
    """The device made current for a launch or copy on its streams."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def ring_step_plain(q, k, v, state, q_off: int, k_off: int, scale: float):
    """One launch's work in the kernel's rounding: rank q [B, Tl, Hq, D]
    (at positions q_off..) against the chunk k, v [B, Tk, Hkv, D] (at
    k_off..), one online-softmax update a 64-key tile. ``state`` is
    (o [B, Hkv, g, Tl, D], m, l [B, Hkv, g, Tl]) in f32, or None for the
    first launch (o = 0, m = -1e30, l = 0). Returns the new state."""
    B, Tl, Hq, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    dev = q.device
    qb = q.to(torch.bfloat16).to(torch.float32).reshape(B, Tl, Hkv, g, D)
    if state is None:
        o = torch.zeros((B, Hkv, g, Tl, D), dtype=torch.float32, device=dev)
        m = torch.full((B, Hkv, g, Tl), _NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, Hkv, g, Tl), dtype=torch.float32, device=dev)
    else:
        o, m, l = state
    qpos = q_off + torch.arange(Tl, device=dev)
    for t0 in range(0, Tk, TILE):
        kt = k[:, t0:t0 + TILE].to(torch.bfloat16).to(torch.float32)
        vt = v[:, t0:t0 + TILE].to(torch.bfloat16).to(torch.float32)
        s = torch.einsum("bthgd,bshd->bhgts", qb, kt) * scale
        kpos = k_off + t0 + torch.arange(kt.shape[1], device=dev)
        s = torch.where(kpos[None, :] <= qpos[:, None], s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        pv = torch.einsum("bhgts,bshd->bhgtd",
                          p.to(torch.bfloat16).to(torch.float32), vt)
        o = o * alpha[..., None] + pv
        m = m_new
    return o, m, l


def ring_finish_plain(state, dtype) -> torch.Tensor:
    """o / max(l, 1e-30) in ``dtype``, as [B, Tl, Hq, D]."""
    o, _, l = state
    B, Hkv, g, Tl, D = o.shape
    out = o / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Tl, Hkv * g, D).to(dtype)


def ring_states_plain(qs, ks, vs, scale: Optional[float] = None,
                      skip_masked: bool = True) -> list:
    """The ring's per-rank state after its last step, in the kernel's
    order: rank r's step s takes the chunk of rank (r - s) % n, step 0 the
    diagonal. ``skip_masked`` leaves out the chunks wholly above the
    diagonal (src > r), as the kernel ring does."""
    n = len(qs)
    Tl, D = qs[0].shape[1], qs[0].shape[3]
    scale = scale if scale is not None else 1.0 / D ** 0.5
    states = [None] * n
    for s in range(n):
        for r in range(n):
            src = (r - s) % n
            if skip_masked and src > r:
                continue
            states[r] = ring_step_plain(qs[r], ks[src], vs[src], states[r],
                                        r * Tl, src * Tl, scale)
    return states


def ring_plain(qs, ks, vs, scale: Optional[float] = None) -> list:
    """The whole ring in plain PyTorch: per-rank outputs [B, Tl, Hq, D] in
    q's dtype. (Every rank reads every chunk in place: the transfer is
    the kernel ring's, and moves no value.)"""
    return [ring_finish_plain(st, q.dtype)
            for st, q in zip(ring_states_plain(qs, ks, vs, scale), qs)]


# ---------------------------------------------------------------------------
# the kernel ring
# ---------------------------------------------------------------------------

def _copy_async(dst: torch.Tensor, src: torch.Tensor, stream) -> None:
    """dst <- src (same bytes) on ``stream``: a peer copy between cards."""
    lib, _, copy = _kernel()
    rc = copy(dst.data_ptr(), _index(dst.device), src.data_ptr(),
              _index(src.device), src.numel() * src.element_size(),
              stream.cuda_stream)
    _build.check(lib, rc, f"ring_attn chunk copy {tuple(src.shape)}")


class LocalTransport:
    """The ring's transfers within one process. Rank r owns two bf16 slots
    of K and of V [B, Tl, Hkv, D] on its device (``k[r][c]``, ``v[r][c]``)
    and a copy stream. The interface the ring uses:

    - ``filled(r, stream)``: slot 0 of rank r holds its own chunk (written
      on ``stream``).
    - ``wait_recv(r, c, stream)``: ``stream`` waits until slot c of rank r
      holds the chunk sent into it.
    - ``ack(r, c, stream)``: rank r's compute on ``stream`` is done reading
      slot c.
    - ``send(r, c)``: copy rank r's slot c to the other slot of its right
      neighbour, after r's receive of c and after the neighbour's ack of
      and own send from that slot.

    A ``torch.distributed`` transport (NCCL isend/irecv between processes)
    would offer the same four calls."""

    def __init__(self, devices: Sequence[torch.device], shape):
        self.n = len(devices)
        self.devices = list(devices)
        self.k = [[torch.empty(shape, dtype=torch.bfloat16, device=d)
                   for _ in range(2)] for d in devices]
        self.v = [[torch.empty(shape, dtype=torch.bfloat16, device=d)
                   for _ in range(2)] for d in devices]
        self.streams = [_new_stream(d) for d in devices]
        ev = lambda: [[_new_event(), _new_event()] for _ in devices]
        self.recv, self.acked, self.sent = ev(), ev(), ev()
        self._acked, self._sent = set(), set()

    def peer(self, r: int) -> int:
        return (r + 1) % self.n

    def filled(self, r: int, stream) -> None:
        self.recv[r][0].record(stream)

    def wait_recv(self, r: int, c: int, stream) -> None:
        stream.wait_event(self.recv[r][c])

    def ack(self, r: int, c: int, stream) -> None:
        self.acked[r][c].record(stream)
        self._acked.add((r, c))

    def send(self, r: int, c: int) -> None:
        dst, nc = self.peer(r), 1 - c
        s = self.streams[r]
        s.wait_event(self.recv[r][c])
        if (dst, nc) in self._acked:
            s.wait_event(self.acked[dst][nc])
        if (dst, nc) in self._sent:
            s.wait_event(self.sent[dst][nc])
        with _on(self.devices[r]):
            _copy_async(self.k[dst][nc], self.k[r][c], s)
            _copy_async(self.v[dst][nc], self.v[r][c], s)
        self.recv[dst][nc].record(s)
        self.sent[r][c].record(s)
        self._sent.add((r, c))


def _check(qs, ks, vs):
    n = len(qs)
    if n < 1 or len(ks) != n or len(vs) != n:
        raise ValueError(f"ring_attn: {len(qs)}, {len(ks)}, {len(vs)} "
                         f"q, k, v chunks: need one of each a rank")
    B, Tl, Hq, D = qs[0].shape
    Hkv = ks[0].shape[2]
    shape = f"q{tuple(qs[0].shape)} k{tuple(ks[0].shape)} n={n}"
    for r in range(n):
        if tuple(qs[r].shape) != (B, Tl, Hq, D) or \
                tuple(ks[r].shape) != (B, Tl, Hkv, D) or \
                tuple(vs[r].shape) != (B, Tl, Hkv, D):
            raise ValueError(f"ring_attn: rank {r}: {shape}: every rank "
                             f"needs q [B, Tl, Hq, D] and k/v [B, Tl, Hkv, D]")
        if not (qs[r].device == ks[r].device == vs[r].device):
            raise ValueError(f"ring_attn: rank {r}'s q, k, v lie on "
                             f"{qs[r].device}, {ks[r].device}, {vs[r].device}")
        if qs[r].dtype != qs[0].dtype:
            raise ValueError(f"ring_attn: rank {r}'s q is {qs[r].dtype}, "
                             f"rank 0's {qs[0].dtype}")
    if Hq % Hkv or D not in HEAD_DIMS:
        raise ValueError(f"ring_attn: {shape}: need Hq % Hkv == 0 and D in "
                         f"{HEAD_DIMS}")
    if qs[0].dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"ring_attn: q is {qs[0].dtype}: need bf16 or f32")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (*qs, *ks, *vs)):
        raise RuntimeError("ring_attn: an input requires a gradient; the "
                           "kernel ring is forward-only (the JAX kernel "
                           "defines no VJP): use parallel.ring_attention")
    kinds = {t.device.type for t in (*qs, *ks, *vs)}
    if len(kinds) > 1:
        raise ValueError(f"ring_attn: ranks on {sorted(kinds)}: every rank "
                         f"on the CPU (the plain version) or on a card")


def _rows_ok(t: torch.Tensor) -> bool:
    """[B, Tl, H, D] with contiguous rows (any batch stride)."""
    _, Tl, H, D = t.shape
    return t.stride(3) == 1 and t.stride(2) == D and \
        (Tl == 1 or t.stride(1) == H * D) and t.data_ptr() % 16 == 0 and \
        t.stride(0) % 8 == 0


def _launch_step(q, kslot, vslot, o, m, l, out, q_off, k_off, scale, first,
                 last, stream) -> None:
    """One launch of the step kernel on ``stream`` (counted)."""
    B, Tl, Hq, D = q.shape
    Hkv = kslot.shape[2]
    lib, step, _ = _kernel()
    rc = step(q.data_ptr(), int(q.dtype == torch.float32), q.stride(0),
              kslot.data_ptr(), vslot.data_ptr(), o.data_ptr(), m.data_ptr(),
              l.data_ptr(), out.data_ptr() if last else None,
              out.stride(0) if last else 0, B, Tl, Hq, Hkv, D, q_off, k_off,
              float(scale), int(first), int(last), stream.cuda_stream)
    _build.check(lib, rc, f"ring_attn step q{tuple(q.shape)} k_off={k_off}")
    kernel_log.count(NAME)


def ring_attention(qs: List[torch.Tensor], ks: List[torch.Tensor],
                   vs: List[torch.Tensor], scale: Optional[float] = None,
                   transport=LocalTransport) -> List[torch.Tensor]:
    """The kernel ring over n ranks: rank r's q [B, Tl, Hq, D] (bf16 or
    f32) and k/v [B, Tl, Hkv, D] chunks lie on its device; returns each
    rank's output chunk [B, Tl, Hq, D] in q's dtype. CPU chunks take the
    plain version. ``transport``: the class that moves the chunks."""
    _check(qs, ks, vs)
    n = len(qs)
    B, Tl, Hq, D = qs[0].shape
    Hkv = ks[0].shape[2]
    scale = scale if scale is not None else 1.0 / D ** 0.5
    if qs[0].device.type == "cpu":
        return ring_plain(qs, ks, vs, scale)

    qs = [q if _rows_ok(q) else q.contiguous() for q in qs]
    devs = [q.device for q in qs]
    outs = [torch.empty_like(q) for q in qs]
    # set-up on each device's current stream: slots, state, slot 0 <- k, v
    mains = {str(d): torch.cuda.current_stream(d) for d in devs}
    tr = transport(devs, (B, Tl, Hkv, D))
    state = [(torch.empty((B, Tl, Hq, D), dtype=torch.float32, device=d),
              torch.empty((B, Hq, Tl), dtype=torch.float32, device=d),
              torch.empty((B, Hq, Tl), dtype=torch.float32, device=d))
             for d in devs]
    for r in range(n):
        tr.k[r][0].copy_(ks[r])
        tr.v[r][0].copy_(vs[r])
        tr.filled(r, mains[str(devs[r])])
    comp = [_new_stream(d) for d in devs]
    for r, d in enumerate(devs):
        start = _new_event()
        start.record(mains[str(d)])
        comp[r].wait_event(start)
        tr.streams[r].wait_event(start)

    for s in range(n):
        c = s % 2
        for r in range(n):                       # compute on the slot in hand
            tr.wait_recv(r, c, comp[r])
            if s <= r:                           # src = r - s <= r: not masked
                with _on(devs[r]):
                    _launch_step(qs[r], tr.k[r][c], tr.v[r][c], *state[r],
                                 outs[r], r * Tl, (r - s) * Tl, scale,
                                 s == 0, s == r, comp[r])
            tr.ack(r, c, comp[r])
        if s + 1 < n:
            for r in range(n):                   # pass it to the right
                tr.send(r, c)

    for r, d in enumerate(devs):                 # join: outs and buffers
        for st in (comp[r], tr.streams[r]):
            done = _new_event()
            done.record(st)
            mains[str(d)].wait_event(done)
    return outs
