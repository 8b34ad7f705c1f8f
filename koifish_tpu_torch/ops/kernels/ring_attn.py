"""The sequence-parallel ring attention's kernel ring and its plain version.

Row 13: ``csrc/ring_attn.cu`` replaces the JAX package's
``parallel/ring_pallas.py:152`` (``ring_attention_pallas``, kernel body
``_ring_kernel``): the forward pass of causal GQA attention over a sequence
sharded in n equal chunks, one rank a chunk. Rank ``my`` holds q
[B, Tl, Hq, D] and k/v [B, Tl, Hkv, D]; at step s it holds the chunk of
rank ``src = (my - s) % n`` in one slot of a 2-slot bf16 buffer and passes
it to its right neighbour's other slot while it attends over it.

The TPU kernel runs the whole ring in one kernel per device. Here the host
drives it (``ring_attention``): step s is one launch on each card's current
stream that takes every rank of that card with work at step s, the online
softmax's (o, m, l) carried in f32 device memory from launch to launch and
the normalisation folded into a rank's last launch, which writes the
caller's output rows. Within one card a chunk travels inside the launch
that computes on it: the work item holding a (rank, batch, kv head)'s last
packed rows reads every tile of the chunk and stores it into the
neighbour's other slot (the slot row ``LocalTransport.fold`` names). Step s
reads slot s % 2 and writes the other, which the neighbour last read at step
s - 1, so the stream's order alone orders the slots' reuse. A neighbour on
another card gets the chunk by a copy on the sender's copy stream after the
launch (``LocalTransport.send``), ordered by CUDA events: after the
sender's launch and the receiver's previous one, before the receiver's next.

Where each rank is a process (``ring_attention_rank`` with a
``ProcessTransport``), the process runs only its own rank's launches, one a
step at steps 0..my, and a chunk goes to the neighbour process by
``parallel/comm.send``/``recv`` into its slot, staged through host memory
under gloo. The kernel is the same: ``fold`` is always None there, so no
launch stores a slot.

Chunks with ``src > my`` lie wholly above the diagonal. Once step 0 (the
diagonal, always first) has made every row's m finite, their p is exactly 0
and they change nothing, so rank ``my`` computes only at steps 0..my, and
rank ``my`` forwards its chunk only where the neighbour computes on it
(steps 0..my, rank n - 1 never): n launches a ring on one card and
n(n - 1)/2 chunk transfers, chunk c reaching ranks c..n - 1.

A launch's work items (``plan``): (rank, batch, kv head, tile of packed
rows), the TPU kernel's (position, group member) rows of one kv head, P =
128 // g positions a tile, numbered heaviest first, as the kernel takes
them.

The plain version (``ring_step_plain``, ``ring_plain``) computes the same
in PyTorch, in the kernel's rounding: q and K in bf16, logits in f32 scaled
by scale·log2(e) (base 2), the online softmax updated once a 128-key tile
(the TPU kernel: once a chunk), p rounded to bf16 for P·V, o / max(l,
1e-30) in q's dtype. A CPU tensor takes it; a CUDA tensor launches the
kernel or raises. The ring has no gradient (the JAX kernel defines no
VJP): an input that requires one raises.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import struct
from typing import List, NamedTuple, Optional, Sequence

import torch

from koifish_tpu_torch.ops.kernels import _build
from koifish_tpu_torch.utils import kernel_log

NAME = "ring_attn"
TILE = 128                # keys a tile: the online softmax's unit
ROWS = 128                # packed query rows a work item (at most)
HEAD_DIMS = (64, 128)
MAX_RANKS = 16            # ranks one launch takes
LOG2E = 1.4426950408889634
_NEG_INF = -1e30

_fns = None


class _Rank(ctypes.Structure):
    """One rank's part of a launch (``Rank`` in ``csrc/ring_attn.cu``)."""
    _fields_ = [("q", ctypes.c_void_p), ("o", ctypes.c_void_p),
                ("m", ctypes.c_void_p), ("l", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("q_sb", ctypes.c_longlong),
                ("out_sb", ctypes.c_longlong), ("q_off", ctypes.c_int),
                ("k_off", ctypes.c_int), ("slot", ctypes.c_int),
                ("send", ctypes.c_int), ("first", ctypes.c_int),
                ("last", ctypes.c_int)]


def _kernel():
    """(lib, step launch, chunk copy) from ``csrc/ring_attn.cu``."""
    global _fns
    if _fns is None:
        lib = _build.load(NAME)
        step = lib.koifish_ring_attn_step
        step.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_void_p] + [ctypes.c_int] * 8
                         + [ctypes.c_float, ctypes.c_void_p])
        step.restype = ctypes.c_int
        copy = lib.koifish_ring_copy
        copy.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                         ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
        copy.restype = ctypes.c_int
        _fns = (lib, step, copy)
    return _fns


def _new_stream(device):
    return torch.cuda.Stream(device=device)


def _new_event():
    return torch.cuda.Event()


def _index(device: torch.device) -> int:
    return device.index if device.index is not None \
        else torch.cuda.current_device()


def _key(device: torch.device):
    """One card (or CPU/meta device) as a hashable key."""
    return (device.type, _index(device) if device.type == "cuda"
            else device.index)


def _on(device: torch.device):
    """The device made current for a launch or copy on its streams."""
    if device.type != "cuda" or _index(device) == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _f32(x: float) -> float:
    return struct.unpack("f", struct.pack("f", x))[0]


def _sl2(scale: float) -> float:
    """scale·log2(e) as the kernel takes it: the f32 product of the two
    rounded to f32 (a double holds their product exactly)."""
    return _f32(_f32(scale) * _f32(LOG2E))


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def ring_step_plain(q, k, v, state, q_off: int, k_off: int, scale: float):
    """One rank's part of a launch in the kernel's rounding: q [B, Tl, Hq,
    D] (at positions q_off..) against the chunk k, v [B, Tk, Hkv, D] (at
    k_off..), one online-softmax update a 128-key tile, in base 2. ``state``
    is (o [B, Hkv, g, Tl, D], m, l [B, Hkv, g, Tl]) in f32, or None for the
    first launch (o = 0, m = -1e30, l = 0). Returns the new state."""
    B, Tl, Hq, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    dev = q.device
    sl2 = _sl2(scale)
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
        s = torch.einsum("bthgd,bshd->bhgts", qb, kt) * sl2
        kpos = k_off + t0 + torch.arange(kt.shape[1], device=dev)
        s = torch.where(kpos[None, :] <= qpos[:, None], s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
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
# the work plan
# ---------------------------------------------------------------------------

def positions_a_tile(g: int) -> int:
    """P: the positions of a work item's packed rows (g·P <= 128)."""
    return ROWS // g


class Item(NamedTuple):
    """A work item of one launch: rank ``r`` (its index in the launch) at
    batch ``b``, kv head ``hk``, packed rows [p0, p0 + rows) (tile ``t``),
    its ``n`` live kv tiles from the first; ``send``: it forwards the
    chunk."""
    r: int
    b: int
    hk: int
    t: int
    p0: int
    rows: int
    n: int
    send: bool


def plan(diags: Sequence[int], sends: Sequence[bool], B: int, Tl: int,
         Hkv: int, g: int) -> List[Item]:
    """The work items of one launch in the order the kernel numbers them
    (``item_of`` in ``csrc/ring_attn.cu``): the ranks' q_off - k_off
    (``diags``) and whether each forwards its chunk; heaviest first (the
    last packed rows see the most keys)."""
    P = positions_a_tile(g)
    NT = -(-Tl // P)
    per = len(diags) * B * Hkv
    items = []
    for w in range(per * NT):
        t, x = NT - 1 - w // per, w % per
        hk, b, r = x % Hkv, (x // Hkv) % B, x // (Hkv * B)
        t0, t1 = t * P, min(t * P + P, Tl) - 1
        n = min(-(-Tl // TILE), (diags[r] + t1) // TILE + 1)
        items.append(Item(r, b, hk, t, t0 * g, (t1 - t0 + 1) * g, n,
                          sends[r] and t == NT - 1))
    return items


def schedule(n: int):
    """The ring's steps: for each step s the (rank, src, first, last, send)
    of the ranks that compute at s (ranks s..n - 1: src = r - s <= r); a
    rank forwards the chunk in hand where its neighbour computes on it at
    step s + 1 (every rank but n - 1)."""
    return [[(r, r - s, s == 0, s == r, r < n - 1) for r in range(s, n)]
            for s in range(n)]


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
    """The ring's slots and transfers within one process. Each device holds
    one bf16 buffer of K and one of V, [2·(its ranks), B, Tl, Hkv, D],
    slot-major: rank r's slots ``k[r][c]``, ``v[r][c]`` are rows ``row(r,
    c)`` of its device's buffers (``buffers``), the slots 0 of a device's
    ranks one block (filled by one copy). The interface the ring uses:

    - ``peer(r)``: the rank r sends to.
    - ``fold(r, c)``: the row of its device's buffers into which r's launch
      stores slot c's chunk (the peer's other slot), or None when the peer
      lies on another device.
    - ``launched(device, stream)``: a launch on ``device`` was enqueued.
    - ``send(r, c)``: copy rank r's slot c to the peer's other slot on
      another device, after r's launch of this step and the peer device's
      latest launch (the peer is done reading that slot).
    - ``wait_recv(r, c, stream)``: ``stream`` waits for a copy into slot c
      of rank r.
    - ``join()``: each sender device's current stream waits for its copies
      (the slots they read are freed with the transport).

    ``ProcessTransport`` offers the same calls between processes, with
    ``fold`` always None."""

    def __init__(self, devices: Sequence[torch.device], shape):
        self.n = len(devices)
        self.devices = list(devices)
        self.key = [_key(d) for d in devices]
        self.local, self._count, first = [], {}, {}
        for r, k in enumerate(self.key):
            self.local.append(self._count.get(k, 0))
            self._count[k] = self.local[-1] + 1
            first.setdefault(k, self.devices[r])
        self._buf = {k: tuple(torch.empty((2 * c, *shape), dtype=torch.bfloat16,
                                          device=first[k]) for _ in "kv")
                     for k, c in self._count.items()}
        self._streams, self._launch, self._recv = {}, {}, {}
        # events are needed only where a chunk crosses devices
        self._cross = any(self.key[self.peer(r)] != self.key[r]
                          for r in range(self.n))

    def peer(self, r: int) -> int:
        return (r + 1) % self.n

    @functools.cached_property
    def k(self):
        return self._views(0)

    @functools.cached_property
    def v(self):
        return self._views(1)

    def _views(self, i):
        """[rank][slot] views of the K (i = 0) or V buffers (made on first
        use: the ring itself passes the buffers and rows to the kernel)."""
        return [[self._buf[self.key[r]][i][self.row(r, c)] for c in (0, 1)]
                for r in range(self.n)]

    def row(self, r: int, c: int) -> int:
        return c * self._count[self.key[r]] + self.local[r]

    def buffers(self, device: torch.device):
        return self._buf[_key(device)]

    def fold(self, r: int, c: int) -> Optional[int]:
        dst = self.peer(r)
        return self.row(dst, 1 - c) if self.key[dst] == self.key[r] else None

    def launched(self, device: torch.device, stream) -> None:
        if not self._cross:
            return
        ev = _new_event()
        ev.record(stream)
        self._launch[_key(device)] = ev

    def wait_recv(self, r: int, c: int, stream) -> None:
        ev = self._recv.pop((r, c), None)
        if ev is not None:
            stream.wait_event(ev)

    def send(self, r: int, c: int) -> None:
        dst, nc = self.peer(r), 1 - c
        s = self._streams.get(r)
        if s is None:
            s = self._streams[r] = _new_stream(self.devices[r])
        for k in (self.key[r], self.key[dst]):
            if k in self._launch:
                s.wait_event(self._launch[k])
        with _on(self.devices[r]):
            _copy_async(self.k[dst][nc], self.k[r][c], s)
            _copy_async(self.v[dst][nc], self.v[r][c], s)
        ev = _new_event()
        ev.record(s)
        self._recv[(dst, nc)] = ev

    def join(self) -> None:
        for r, s in self._streams.items():
            ev = _new_event()
            ev.record(s)
            torch.cuda.current_stream(self.devices[r]).wait_event(ev)


class ProcessTransport:
    """The ring's slots and transfers when each rank is a process: this
    process holds rank ``index``'s two slots only ([2, B, Tl, Hkv, D] bf16
    buffers of K and V, ``row(index, c) = c``) and passes a chunk to the
    next rank of ``ranks`` (global ranks in ring order) with
    ``parallel/comm.send``, receiving the previous rank's with
    ``comm.recv`` (both staged through pinned host memory under gloo,
    where ranks share a card). The calls of ``LocalTransport``:

    - ``peer(r)``, ``fold(r, c)`` (always None: the neighbour is another
      process), ``launched(device, stream)`` (nothing to record: a send
      is enqueued after the stream's work it reads);
    - ``send(r, c)``: start sending slot c's K and V to the peer;
    - ``wait_recv(r, c, stream)``: receive the previous rank's chunk into
      slot c, on ``stream`` after the launches that read the slot before;
    - ``join()``: wait for this rank's sends.

    ``log`` records each transfer as (sender, chunk, receiver)."""

    def __init__(self, ranks: Sequence[int], index: int,
                 device: torch.device, shape):
        self.ranks, self.rank, self.n = list(ranks), index, len(ranks)
        self.device = torch.device(device)
        self._buf = tuple(torch.empty((2, *shape), dtype=torch.bfloat16,
                                      device=self.device) for _ in "kv")
        self._chunk = [index, None]        # whose chunk each slot holds
        self._sends = {0: [], 1: []}       # each slot's sends in flight
        self.log: list = []

    def peer(self, r: int) -> int:
        return (r + 1) % self.n

    def row(self, r: int, c: int) -> int:
        return c

    def buffers(self, device=None):
        return self._buf

    def fold(self, r: int, c: int) -> Optional[int]:
        return None

    def launched(self, device, stream) -> None:
        pass

    def send(self, r: int, c: int) -> None:
        from koifish_tpu_torch.parallel import comm
        dst = self.ranks[self.peer(r)]
        for b in self._buf:
            self._sends[c].append(comm.send(b[c], dst))
        self.log.append((r, self._chunk[c], self.peer(r)))

    def wait_recv(self, r: int, c: int, stream) -> None:
        from koifish_tpu_torch.parallel import comm
        src = self.ranks[(r - 1) % self.n]
        self._wait(c)                  # the slot's last send has read it
        for b in self._buf:
            x = comm.recv(b.shape[1:], b.dtype, src, self.device)
            with torch.cuda.stream(stream) if stream is not None \
                    else contextlib.nullcontext():
                b[c].copy_(x)
        self._chunk[c] = (self._chunk[1 - c] - 1) % self.n

    def _wait(self, c: int) -> None:
        for h in self._sends[c]:
            h.wait()
        self._sends[c] = []

    def join(self) -> None:
        for c in (0, 1):
            self._wait(c)


def _check(qs, ks, vs, scale: float):
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
    if Hq % Hkv or D not in HEAD_DIMS or Hq // Hkv > ROWS:
        raise ValueError(f"ring_attn: {shape}: need Hq % Hkv == 0, "
                         f"Hq // Hkv <= {ROWS} and D in {HEAD_DIMS}")
    if not scale > 0:
        raise ValueError(f"ring_attn: scale {scale}: need scale > 0")
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


def _joined(chunks) -> Optional[torch.Tensor]:
    """[n, B, Tl, H, D]: the chunks as one strided view where they are
    consecutive pieces along T of one tensor (as ``shard_seq`` cuts them),
    else None."""
    x = chunks[0]
    Tl, es, st = x.shape[1], x.element_size(), x.stride()
    for i, c in enumerate(chunks):
        if c.shape != x.shape or c.stride() != st or c.dtype != x.dtype or \
                c.device != x.device or \
                c.data_ptr() != x.data_ptr() + i * Tl * st[1] * es:
            return None
    # the last chunk's last element within x's storage (adjacent chunks of
    # two allocations are not one tensor)
    storage = x.untyped_storage()
    end = chunks[-1].data_ptr() + es * (1 + sum(
        (n - 1) * d for n, d in zip(x.shape, st)))
    if end > storage.data_ptr() + storage.nbytes():
        return None
    s0, s1, s2, s3 = st
    return x.as_strided((len(chunks), *x.shape), (Tl * s1, s0, s1, s2, s3))


def _fill(tr, groups, ks, vs) -> None:
    """Slot 0 of every rank <- its own chunk in bf16: one copy a device for
    K and one for V where its ranks' chunks are consecutive pieces of one
    tensor, else one a rank."""
    for members in groups.values():
        if members == list(range(members[0], members[0] + len(members))):
            jk = _joined([ks[r] for r in members])
            jv = _joined([vs[r] for r in members])
            if jk is not None and jv is not None:
                kb, vb = tr.buffers(ks[members[0]].device)
                rows = [tr.row(r, 0) for r in members]
                if rows == list(range(rows[0], rows[0] + len(rows))):
                    kb[rows[0]:rows[0] + len(rows)].copy_(jk)
                    vb[rows[0]:rows[0] + len(rows)].copy_(jv)
                    continue
        for r in members:
            tr.k[r][0].copy_(ks[r])
            tr.v[r][0].copy_(vs[r])


def _desc(ptrs, q_off, k_off, slot, send, first, last) -> _Rank:
    """One rank's part of a launch: ``ptrs`` (its q, o, m, l and output
    pointers, q's and the output's batch strides), the positions, the slot
    row it reads and the row its chunk goes to (None: no send)."""
    return _Rank(*ptrs, q_off, k_off, slot, -1 if send is None else send,
                 int(first), int(last))


def _launch(descs, bufs, B, Tl, Hq, Hkv, D, q_f32, sl2, stream) -> None:
    """One launch of the step kernel on ``stream`` (counted)."""
    lib, step, _ = _kernel()
    kb, vb = bufs
    arr = (_Rank * len(descs))(*descs)
    rc = step(arr, len(descs), kb.data_ptr(),
              vb.data_ptr(), kb.shape[0], B, Tl, Hq, Hkv, D,
              positions_a_tile(Hq // Hkv), int(q_f32), sl2,
              stream.cuda_stream)
    _build.check(lib, rc, f"ring_attn step {len(descs)} ranks B{B} Tl{Tl} "
                          f"Hq{Hq} Hkv{Hkv} D{D}")
    kernel_log.count(NAME)


def _outs_for(qs, outs):
    """Each rank's output chunk: the caller's view where given (checked),
    else a new tensor like q."""
    res = []
    for r, q in enumerate(qs):
        o = outs[r] if outs is not None else None
        if o is None:
            o = torch.empty_like(q, memory_format=torch.contiguous_format)
        elif o.shape != q.shape or o.dtype != q.dtype or \
                o.device != q.device or not _rows_ok(o):
            raise ValueError(f"ring_attn: rank {r}'s output {o.dtype} "
                             f"{tuple(o.shape)} on {o.device} with strides "
                             f"{o.stride()}: need q's shape, dtype and "
                             f"device with contiguous rows")
        res.append(o)
    return res


def ring_attention(qs: List[torch.Tensor], ks: List[torch.Tensor],
                   vs: List[torch.Tensor], scale: Optional[float] = None,
                   transport=LocalTransport,
                   outs: Optional[List[Optional[torch.Tensor]]] = None
                   ) -> List[torch.Tensor]:
    """The kernel ring over n ranks: rank r's q [B, Tl, Hq, D] (bf16 or
    f32) and k/v [B, Tl, Hkv, D] chunks lie on its device; returns each
    rank's output chunk [B, Tl, Hq, D] in q's dtype: ``outs[r]`` where the
    caller gives one (a view of a larger tensor: rows contiguous, any batch
    stride), written in place. CPU chunks take the plain version.
    ``transport``: the class that holds the slots and moves the chunks."""
    n = len(qs)
    if n and scale is None:
        scale = 1.0 / qs[0].shape[3] ** 0.5
    _check(qs, ks, vs, scale)
    B, Tl, Hq, D = qs[0].shape
    Hkv = ks[0].shape[2]
    if qs[0].device.type == "cpu":
        res = ring_plain(qs, ks, vs, scale)
        if outs is None:
            return res
        outs = _outs_for(qs, outs)
        for o, x in zip(outs, res):
            o.copy_(x)
        return outs

    qs = [q if _rows_ok(q) else q.contiguous() for q in qs]
    outs = _outs_for(qs, outs)
    g = Hq // Hkv
    tr = transport([q.device for q in qs], (B, Tl, Hkv, D))
    groups = {}
    for r, k in enumerate(tr.key):
        groups.setdefault(k, []).append(r)
    _fill(tr, groups, ks, vs)
    # each rank's pointers: q, its part of its device's state buffers (o,
    # m, l in f32; rank 0, first and last at its one step, leaves its part
    # unused), its output rows, and the batch strides. ``states`` holds
    # every device's buffers until all the launches are enqueued: the
    # launches see only pointers, and a buffer dropped earlier would go
    # back to the caching allocator while its device's work is queued
    ptrs = [None] * n
    states = {}
    for key, members in groups.items():
        state = states[key] = [
            torch.empty((len(members), B, Hkv, Tl * g) + tail,
                        dtype=torch.float32, device=qs[members[0]].device)
            for tail in ((D,), (), ())]
        for i, r in enumerate(members):
            ptrs[r] = (qs[r].data_ptr(), *(x.data_ptr() + i * x.stride(0) * 4
                                           for x in state),
                       outs[r].data_ptr(), qs[r].stride(0), outs[r].stride(0))
    sl2 = _sl2(scale)
    q_f32 = qs[0].dtype == torch.float32
    streams = {k: torch.cuda.current_stream(qs[m[0]].device)
               for k, m in groups.items()}
    for s, ranks in enumerate(schedule(n)):
        c = s % 2
        for key, members in groups.items():
            work = [x for x in ranks if x[0] in members]
            if not work:
                continue
            dev, stream = qs[work[0][0]].device, streams[key]
            descs = []
            for r, src, first, last, send in work:
                tr.wait_recv(r, c, stream)
                descs.append(_desc(ptrs[r], r * Tl, src * Tl, tr.row(r, c),
                                   tr.fold(r, c) if send else None, first,
                                   last))
            with _on(dev):
                for i in range(0, len(descs), MAX_RANKS):
                    _launch(descs[i:i + MAX_RANKS], tr.buffers(dev), B, Tl,
                            Hq, Hkv, D, q_f32, sl2, stream)
            tr.launched(dev, stream)
        for r, _, _, _, send in ranks:  # to a neighbour on another device
            if send and tr.fold(r, c) is None:
                tr.send(r, c)
    tr.join()
    del states     # every launch that reads them is enqueued
    return outs


def ring_attention_rank(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        transport: ProcessTransport,
                        scale: Optional[float] = None,
                        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rank ``transport.rank``'s part of the kernel ring whose other ranks
    are other processes: its q [B, Tl, Hq, D] and k/v [B, Tl, Hkv, D]
    chunks; returns its output chunk (``out`` where given). The rank runs
    ``ring_attention``'s steps for itself: at step s (0..rank) it attends
    to the chunk of rank (rank - s) in slot s % 2, one launch a step, and
    forwards that chunk first unless it is the last rank. A CPU chunk takes
    the plain version, through the same transfers."""
    tr = transport
    n, me = tr.n, tr.rank
    if scale is None:
        scale = 1.0 / q.shape[3] ** 0.5
    _check([q], [k], [v], scale)
    B, Tl, Hq, D = q.shape
    Hkv = k.shape[2]
    kb, vb = tr.buffers(q.device)
    kb[0].copy_(k)
    vb[0].copy_(v)
    cpu = q.device.type == "cpu"
    if not cpu:
        q = q if _rows_ok(q) else q.contiguous()
    out = _outs_for([q], None if out is None else [out])[0]
    g = Hq // Hkv
    state = None if cpu else [
        torch.empty((1, B, Hkv, Tl * g) + tail, dtype=torch.float32,
                    device=q.device) for tail in ((D,), (), ())]
    stream = None if cpu else torch.cuda.current_stream(q.device)
    for s in range(me + 1):
        c = s % 2
        if s:
            tr.wait_recv(me, c, stream)
        if me < n - 1:
            tr.send(me, c)
        if cpu:
            state = ring_step_plain(q, kb[c], vb[c], state, me * Tl,
                                    (me - s) * Tl, scale)
            continue
        ptrs = (q.data_ptr(), *(x.data_ptr() for x in state),
                out.data_ptr(), q.stride(0), out.stride(0))
        with _on(q.device):
            _launch([_desc(ptrs, me * Tl, (me - s) * Tl, tr.row(me, c),
                           None, s == 0, s == me)], (kb, vb), B, Tl, Hq,
                    Hkv, D, q.dtype == torch.float32, _sl2(scale), stream)
        tr.launched(q.device, stream)
    tr.join()
    if cpu:
        out.copy_(ring_finish_plain(state, q.dtype))
    del state      # every launch that reads it is enqueued
    return out
