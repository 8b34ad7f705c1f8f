"""The kernel ring's host loop (``ops/kernels/ring_attn.ring_attention``)
run on "meta" (and CPU) chunks with the step launch, the chunk copy, the
streams and the events replaced by recorders, and a happens-before check
of what the recorded ops read and write: races on a slot (between ops, or
between two ranks of one launch), launches that read another chunk than
their k_off names, and ops not joined into a caller's stream."""
import math
import weakref

import torch

from koifish_tpu_torch.ops.kernels import ring_attn as ra
from koifish_tpu_torch.utils import kernel_log

HQ, HKV, D, TL = 4, 2, 64, 64
_EMPTY = torch.empty


class Stream:
    """A recorded stream: each op depends on the stream's previous op and,
    for a wait, on the event's latest record at the time of the wait."""

    def __init__(self, ops, registry, name, device):
        self.ops, self.name, self.device, self.last = ops, name, device, None
        self.cuda_stream = 1000 + len(registry)
        registry[self.cuda_stream] = self

    def op(self, kind, deps=(), **info):
        d = ([self.last] if self.last is not None else []) + \
            [x for x in deps if x is not None]
        self.ops.append(dict(kind=kind, stream=self.name, dev=self.device,
                             deps=d, **info))
        self.last = len(self.ops) - 1
        return self.last

    def wait_event(self, ev):
        self.op("wait", deps=[ev.last])


class Event:
    def __init__(self):
        self.last = None

    def record(self, stream):
        self.last = stream.op("record")


def run(monkeypatch, devices, transport, mixed=False):
    """The kernel ring on ranks whose chunks (B 1, Tl 64, Hq 4, Hkv 2, D 64,
    bf16) lie on ``devices`` ("meta" or "cpu", rank 0 on "meta"). ``mixed``:
    the ranks span both kinds, which the ring's own check refuses, so it is
    skipped. Returns (ops, the transport). Each launch records, under
    ``f32``, how many f32 tensors the ring had made by ``torch.empty`` (its
    (o, m, l) state) and, under ``f32_dead``, which of them were already
    freed (a weak reference taken when each was made no longer resolves)."""
    ops, made, registry, f32 = [], [], {}, []
    mains = {d: Stream(ops, registry, f"main-{d}", d) for d in set(devices)}
    big = _EMPTY((1 << 40,), dtype=torch.uint8, device="meta")
    off = [1 << 20]

    def empty(shape, dtype=torch.float32, device=None, **kw):
        if str(device) != "meta":
            t = _EMPTY(shape, dtype=dtype, device=device, **kw)
        else:
            nb = math.prod(shape) * torch.tensor([], dtype=dtype
                                                 ).element_size()
            o, off[0] = off[0], off[0] + nb + 256
            t = big[o:o + nb].view(dtype).view(shape)
        if dtype == torch.float32:
            f32.append(weakref.ref(t))
        return t

    def step(ranks, n, kb, vb, n_slots, *args):
        stream = registry[args[-1]]
        stream.op("launch", kb=kb, vb=vb, n_slots=n_slots, args=args[:-1],
                  f32=len(f32),
                  f32_dead=[i for i, w in enumerate(f32) if w() is None],
                  ranks=[dict((f, getattr(ranks[i], f)) for f, _ in
                              ra._Rank._fields_) for i in range(n)])
        return 0

    def copy(dst, dst_dev, src, src_dev, nbytes, stream):
        registry[stream].op("copy", dst=dst, src=src, nbytes=nbytes)
        return 0

    class Recorded(transport):
        def __init__(self, *a):
            super().__init__(*a)
            made.append(self)

    names = iter(range(10 ** 6))
    monkeypatch.setattr(ra, "_new_stream", lambda device: Stream(
        ops, registry, f"s{next(names)}", torch.device(device).type))
    monkeypatch.setattr(ra, "_new_event", Event)
    monkeypatch.setattr(ra, "_kernel", lambda: (None, step, copy))
    monkeypatch.setattr(ra, "_index", lambda device: 0)
    monkeypatch.setattr(ra._build, "check", lambda lib, rc, what: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: mains[torch.device(device).type])
    monkeypatch.setattr(torch, "empty", empty)
    if mixed:
        monkeypatch.setattr(ra, "_check", lambda *a: None)
    qs = [torch.empty((1, TL, HQ, D), dtype=torch.bfloat16, device=d)
          for d in devices]
    ks = [torch.empty((1, TL, HKV, D), dtype=torch.bfloat16, device=d)
          for d in devices]
    kernel_log.reset_launches()
    outs = ra.ring_attention(qs, ks, ks, transport=Recorded)
    assert len(outs) == len(devices) and outs[0].shape == qs[0].shape
    for m in mains.values():
        m.op("end")                  # what each caller's stream runs next
    return ops, made[0]


def _ancestors(ops):
    anc = []
    for i, o in enumerate(ops):
        a = 0
        for d in o["deps"]:
            a |= anc[d] | (1 << d)
        anc.append(a)
    return lambda i, j: bool(anc[j] >> i & 1)      # i happens before j


def slot_ids(tr):
    """data pointer -> (rank, slot, "k" | "v") of the transport's slots."""
    ids = {}
    for r in range(tr.n):
        for c in range(2):
            ids[tr.k[r][c].data_ptr()] = (r, c, "k")
            ids[tr.v[r][c].data_ptr()] = (r, c, "v")
    return ids


def accesses(op, ids):
    """(reads, writes) of a launch or copy: [(slot, rank index in the
    launch or None)], and for a launch the slot each rank's send copies."""
    if op["kind"] == "copy":
        return [(ids[op["src"]], None)], [(ids[op["dst"]], None)]
    cb = TL * HKV * D * 2                      # one chunk's bytes (B 1)
    reads, writes = [], []
    for i, d in enumerate(op["ranks"]):
        for base in (op["kb"], op["vb"]):
            reads.append((ids[base + d["slot"] * cb], i))
            if d["send"] >= 0:
                writes.append((ids[base + d["send"] * cb], i))
    return reads, writes


def check(ops, tr):
    """(problems): races on a slot, wrong chunks read, ops not joined into
    their own device's caller stream; and the (rank, chunk) pairs the
    launches read."""
    before = _ancestors(ops)
    ids = slot_ids(tr)
    problems, pairs = [], []
    by_slot = {}                        # slot -> [(op, write?)]
    for i, o in enumerate(ops):
        if o["kind"] not in ("launch", "copy"):
            continue
        reads, writes = accesses(o, ids)
        for s, _ in reads:
            by_slot.setdefault(s, []).append((i, False))
        for s, r in writes:
            by_slot.setdefault(s, []).append((i, True))
            others = [x for x in reads + writes if x[0] == s and x[1] != r]
            if others:
                problems.append(f"race on slot {s} within op {i}")
    for s, acc in by_slot.items():
        for w, is_w in acc:
            for x, _ in acc:
                if is_w and x != w and not (before(w, x) or before(x, w)):
                    problems.append(f"race on slot {s}: ops {w} and {x}")
    held = {(r, 0, kv): r for r in range(tr.n) for kv in "kv"}
    for i, o in enumerate(ops):
        if o["kind"] == "copy":
            held[ids[o["dst"]]] = held.get(ids[o["src"]])
        elif o["kind"] == "launch":
            reads, writes = accesses(o, ids)
            for d in o["ranks"]:
                pairs.append((d["q_off"] // TL, d["k_off"] // TL))
            for s, r in reads:
                want = o["ranks"][r]["k_off"] // TL
                if held.get(s) != want:
                    problems.append(f"launch {i} at k_off {want * TL} reads "
                                    f"rank {held.get(s)}'s chunk")
            new = {s: held.get(next(x for x, y in reads if y == r and
                                    x[2] == s[2])) for s, r in writes}
            held.update(new)
    ends = {o["dev"]: i for i, o in enumerate(ops) if o["kind"] == "end"}
    for i, o in enumerate(ops):
        if o["kind"] in ("launch", "copy") and not before(i, ends[o["dev"]]):
            problems.append(f"op {i} is not joined into its device's "
                            f"caller stream")
    return problems, pairs
