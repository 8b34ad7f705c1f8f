"""The kernel ring's work plan and transfers (``ops/kernels/ring_attn.py``,
row 13), on the CPU.

A launch's work items (``plan``, the order ``csrc/ring_attn.cu`` numbers
them in) are checked against a direct count of the live (rank, packed row,
kv tile) triples; the ring's schedule is run on "meta" and CPU chunks with
the kernel, the copies, the streams and the events recorded
(``ring_recorder.py``): which ranks read each chunk, and the event-ordered
copies where a neighbour lies on another device. The plain version at the
kernel's 128-key tile is held against one-piece attention where a chunk
holds several tiles, the last one ragged; the output rows are written in
place, and the sharded entry gathers only a rank on another device."""
import numpy as np
import pytest
import torch

from koifish_tpu_torch.ops.kernels import ring_attn as ra
from koifish_tpu_torch.parallel import make_mesh, ring_attention_pallas_sharded
from koifish_tpu_torch.parallel import mesh as tmesh
from koifish_tpu_torch.utils import kernel_log

import ring_recorder as rec
from torch_helpers import torch_threads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _live_tiles(t_last: int, diag: int, Tl: int) -> int:
    """kv tiles a row set reaches when its last position is t_last: keys
    k < Tl with k <= t_last + diag, counted key by key."""
    keys = [k for k in range(Tl) if k <= t_last + diag]
    return len({k // ra.TILE for k in keys})


# g 1, 2, 3 (P 42: 126 rows an item) and 8; Tl ragged against both the
# packed rows and the 128-key tiles; the diagonal (diag 0), a chunk below
# it (diag Tl), and the two in one launch
@pytest.mark.parametrize("g,Tl,diags", [
    (1, 300, (0,)), (2, 257, (0, 0)), (3, 200, (0, 200, 400)),
    (8, 129, (129,)), (3, 130, (0,)), (2, 64, (64, 128))])
def test_plan_covers_every_live_tile_once(g, Tl, diags):
    """Every packed row of every (rank, batch, kv head) lies in exactly one
    item of at most 128 rows, and each item's n kv tiles are exactly the
    live ones of its rows (from tile 0)."""
    B, Hkv = 2, 3
    sends = [r % 2 == 0 for r in range(len(diags))]
    items = ra.plan(diags, sends, B, Tl, Hkv, g)
    rows = {}
    for it in items:
        assert 0 < it.rows <= ra.ROWS and it.p0 % g == 0
        for p in range(it.p0, it.p0 + it.rows):
            key = (it.r, it.b, it.hk, p)
            assert key not in rows
            rows[key] = it
        t_last = (it.p0 + it.rows - 1) // g
        assert it.n == _live_tiles(t_last, diags[it.r], Tl)
    assert sorted(rows) == sorted((r, b, h, p) for r in range(len(diags))
                                  for b in range(B) for h in range(Hkv)
                                  for p in range(Tl * g))


@pytest.mark.parametrize("g", [1, 2, 3, 8])
def test_plan_is_heaviest_first_and_senders_read_every_tile(g):
    """Within a launch (one step: every rank the same q_off - k_off) the
    items come heaviest first; the item of a (rank, batch, kv head)'s last
    packed rows is its only sender, on the diagonal too, and reads every
    tile of the chunk; ranks that do not send have no sender."""
    B, Hkv, Tl = 2, 2, 1000
    for diag in (0, Tl, 3 * Tl):
        items = ra.plan([diag] * 3, [True, True, False], B, Tl, Hkv, g)
        n = [it.n for it in items]
        assert n == sorted(n, reverse=True)
        senders = [it for it in items if it.send]
        assert sorted((it.r, it.b, it.hk) for it in senders) == sorted(
            (r, b, h) for r in (0, 1) for b in range(B) for h in range(Hkv))
        nt = -(-Tl // ra.positions_a_tile(g))
        assert all(it.t == nt - 1 and it.n == -(-Tl // ra.TILE)
                   for it in senders)


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_chunk_c_reaches_ranks_c_to_n_minus_1(monkeypatch, n):
    """Each launch's ranks read, through the slots the folded sends fill,
    chunk c at ranks c..n-1, each (rank, chunk) once; the schedule's
    launches and sends are the ones the ring makes."""
    ops, tr = rec.run(monkeypatch, ["meta"] * n, ra.LocalTransport)
    problems, pairs = rec.check(ops, tr)
    assert problems == []
    assert sorted(pairs) == sorted((r, c) for c in range(n)
                                   for r in range(c, n))
    sched = ra.schedule(n)
    assert [len(s) for s in sched] == list(range(n, 0, -1))
    assert sum(x[4] for s in sched for x in s) == n * (n - 1) // 2


def test_ranks_past_a_launch_take_more_launches(monkeypatch):
    """More ranks on one card than a launch takes (``MAX_RANKS``, here 2)
    split a step into launches of at most that many ranks, on the same
    stream: every check of the ring still holds."""
    monkeypatch.setattr(ra, "MAX_RANKS", 2)
    ops, tr = rec.run(monkeypatch, ["meta"] * 5, ra.LocalTransport)
    launches = [o for o in ops if o["kind"] == "launch"]
    assert [len(o["ranks"]) for o in launches] == [2, 2, 1, 2, 2, 2, 1, 2, 1]
    assert rec.check(ops, tr)[0] == []


@pytest.mark.parametrize("mesh", [
    ("meta", "meta", "cpu", "cpu"), ("meta", "cpu", "meta", "cpu"),
    ("meta", "cpu", "cpu")])
def test_copies_to_another_device_are_event_ordered(monkeypatch, mesh):
    """Ranks on two devices: one launch a step on each device with work;
    a neighbour on the same device gets the chunk inside the launch, one on
    the other device by a K and a V copy on the sender's copy stream; the
    two together make the n(n-1)/2 transfers; the recorded events order
    every copy after the sender's launch and the receiver's last read of
    the slot, and before the receiver's next launch (no race, every launch
    reads the chunk its k_off names, all joined)."""
    n = len(mesh)
    ops, tr = rec.run(monkeypatch, list(mesh), ra.LocalTransport, mixed=True)
    launches = [o for o in ops if o["kind"] == "launch"]
    copies = [o for o in ops if o["kind"] == "copy"]
    want = sum(1 for d in set(mesh) for s in range(n)
               if any(mesh[r] == d for r in range(s, n)))
    assert len(launches) == want == kernel_log.launches()["ring_attn"]
    cross = [(s, r) for s in range(n) for r in range(s, n - 1)
             if mesh[r] != mesh[r + 1]]
    folded = sum(d["send"] >= 0 for o in launches for d in o["ranks"])
    assert len(copies) == 2 * len(cross)
    assert folded + len(cross) == n * (n - 1) // 2
    assert all(c["nbytes"] == rec.TL * rec.HKV * rec.D * 2 for c in copies)
    assert all(o["stream"].startswith("s") for o in copies)
    problems, pairs = rec.check(ops, tr)
    assert problems == []
    assert sorted(pairs) == sorted((r, c) for c in range(n)
                                   for r in range(c, n))


@pytest.mark.parametrize("mesh", [
    ("meta", "cpu", "meta", "cpu"), ("meta", "meta", "cpu", "cpu"),
    ("meta", "cpu", "cpu")])
def test_every_groups_state_is_alive_at_its_launches(monkeypatch, mesh):
    """Each device group's (o, m, l) state is made by ``torch.empty`` and
    handed to the launches only as pointers: every one of them (three a
    device) must still be referenced when each launch is enqueued, or a
    device's buffers could go back to the caching allocator while its work
    is queued."""
    ops, _ = rec.run(monkeypatch, list(mesh), ra.LocalTransport, mixed=True)
    launches = [o for o in ops if o["kind"] == "launch"]
    assert launches and all(o["f32"] == 3 * len(set(mesh))
                            for o in launches)
    assert [o["f32_dead"] for o in launches] == [[]] * len(launches)


@pytest.mark.parametrize("g,D", [(1, 64), (3, 128)])
def test_plain_ring_at_the_kernel_tile(g, D):
    """Chunks of 300 positions (3 tiles of 128 keys, the last ragged) on 3
    ranks: the plain version against one-piece causal attention in f32
    within 2e-2, the JAX ring test's gate (both round nothing but the
    plain version's bf16 q, K and p); a bf16 q gives the f32 q's result
    rounded once."""
    n, Tl, Hkv = 3, 300, 2
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (1, n * Tl, h, D)).astype(np.float32)) for h in (g * Hkv, Hkv, Hkv))
    ch = lambda x: list(x.chunk(n, dim=1))
    out = torch.cat(ra.ring_plain(ch(q), ch(k), ch(v)), dim=1)
    kf, vf = k.repeat_interleave(g, 2), v.repeat_interleave(g, 2)
    s = torch.einsum("bthd,bshd->bhts", q, kf) / D ** 0.5
    T = n * Tl
    s = s.masked_fill(~torch.tril(torch.ones(T, T, dtype=torch.bool)), -1e30)
    ref = torch.einsum("bhts,bshd->bthd", s.softmax(-1), vf)
    assert (out - ref).abs().max() <= 2e-2
    qb = q.to(torch.bfloat16)
    out16 = torch.cat(ra.ring_plain(ch(qb), ch(k), ch(v)), dim=1)
    out32 = torch.cat(ra.ring_plain(ch(qb.float()), ch(k), ch(v)), dim=1)
    assert torch.equal(out16, out32.to(torch.bfloat16))


def test_ring_writes_the_callers_rows():
    """``outs``: the ring writes each rank's rows of the caller's tensor in
    place (the plain version copies into them on the CPU) and refuses an
    output of another shape or dtype."""
    rng = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (2, 256, h, 64)).astype(np.float32)) for h in (4, 2, 2))
    ch = lambda x: list(x.chunk(2, dim=1))
    out = torch.full_like(q, float("nan"))
    res = ra.ring_attention(ch(q), ch(k), ch(v), outs=ch(out))
    assert all(a.data_ptr() == b.data_ptr() for a, b in zip(res, ch(out)))
    assert torch.equal(out, torch.cat(ra.ring_plain(ch(q), ch(k), ch(v)), 1))
    with pytest.raises(ValueError, match="output"):
        ra.ring_attention(ch(q), ch(k), ch(v),
                          outs=[o.to(torch.bfloat16) for o in ch(out)])
    with pytest.raises(ValueError, match="scale"):
        ra.ring_attention(ch(q), ch(k), ch(v), scale=-1.0)


def test_fill_joins_consecutive_chunks():
    """Slot 0 of every rank holds its own chunk in bf16, filled by one copy
    a device when the chunks are consecutive pieces of one tensor (as
    ``shard_seq`` cuts them: ``_joined`` sees them as one view) and by one
    copy a rank otherwise."""
    rng = np.random.default_rng(13)
    k = torch.from_numpy(rng.standard_normal((2, 4 * 32, 2, 64)).astype(
        np.float32))
    pieces = list(k.chunk(4, dim=1))
    apart = [p.clone() for p in pieces]
    joined = ra._joined(pieces)
    assert joined is not None and torch.equal(
        joined, torch.stack(pieces))
    assert ra._joined(apart) is None
    assert ra._joined(pieces[::2]) is None
    for chunks in (pieces, apart):
        tr = ra.LocalTransport([torch.device("cpu")] * 4, (2, 32, 2, 64))
        ra._fill(tr, {("cpu", None): [0, 1, 2, 3]}, chunks, chunks)
        for r in range(4):
            assert torch.equal(tr.k[r][0], pieces[r].to(torch.bfloat16))
            assert torch.equal(tr.v[r][0], pieces[r].to(torch.bfloat16))


def test_sharded_entry_writes_in_place_and_gathers_the_rest(monkeypatch):
    """``ring_attention_pallas_sharded`` hands the ring views of the global
    output for the ranks on q's device, to be written in place, and None
    for a rank on another device, whose returned chunk it copies into its
    rows (the ring here a stand-in that fills each rank's rows with its
    rank number)."""
    monkeypatch.setattr(tmesh, "_device", torch.device)
    mesh = make_mesh({"sp": 4}, devices=["cpu", "cpu", "meta", "cpu"])
    seen = []

    def ring(qs, ks, vs, outs=None):
        seen.append([o is not None for o in outs])
        res = []
        for r, (q, o) in enumerate(zip(qs, outs)):
            x = torch.full(q.shape, float(r), dtype=q.dtype)
            if o is not None:
                o.copy_(x)
                x = o
            res.append(x)
        return res

    monkeypatch.setattr(ra, "ring_attention", ring)
    q = torch.zeros((2, 64, 4, 64))
    k = torch.zeros((2, 64, 2, 64))
    out = ring_attention_pallas_sharded(mesh, "sp")(q, k, k)
    assert [d.type for d in mesh.axis_devices("sp")] == \
        ["cpu", "cpu", "meta", "cpu"]
    assert seen == [[True, True, False, True]]
    assert torch.equal(out, torch.arange(4.0).repeat_interleave(16)[
        None, :, None, None].expand(q.shape))
