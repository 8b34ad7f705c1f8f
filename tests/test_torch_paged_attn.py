"""The paged decode attention and its fused page write, checked on the CPU.

The kernel (``csrc/paged_attn.cu``) runs only on the card, where
``chip_smoke.py`` holds it against its plain versions. Here: the plain
versions against the JAX package's gather oracle ``_paged_attention_ref``
and page write ``_page_write_ref`` (``koifish_tpu/serve/paged.py``) on
scattered tables with stale ids past each lane's length; the host's split
plan and the ranks' tiles; a plain emulation of the ranks' (m, l, o) merged
in rank order against the one-piece softmax; what each wrapper hands its
one launch (on the "meta" device, the kernel replaced by a recorder); a
tiny model's paged decode step, which writes and attends in one call a
layer; and the gap between the port's math and the TPU library kernel's
rounding (a documented difference).
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koifish_tpu.serve import paged as jpaged

from koifish_tpu_torch.ops.kernels import paged_attn as kpa
from koifish_tpu_torch.ops.kernels import slotwrite as ksw
from koifish_tpu_torch.serve import paged as tpaged
from koifish_tpu_torch.utils import kernel_log

from torch_helpers import bf16_pair, f32, tiny_models

PAGE = kpa.PAGE


def _table(rng, B, maxp, lengths, NP):
    """Each lane's live pages distinct ids in scattered order, its entries
    past its length stale ids drawn from the whole pool."""
    table = rng.integers(0, NP, size=(B, maxp)).astype(np.int32)
    perm = rng.permutation(NP).astype(np.int32)
    taken = 0
    for b, n in enumerate(lengths):
        live = -(-n // PAGE)
        table[b, :live] = perm[taken:taken + live]
        taken += live
    return table


def _inputs(seed, Hq, Hkv, D, maxp, lengths):
    rng = np.random.default_rng(seed)
    B = len(lengths)
    NP = B * maxp + 3
    table = _table(rng, B, maxp, lengths, NP)
    jk, tk = bf16_pair(rng.standard_normal((Hkv, NP, PAGE, D)
                                           ).astype(np.float32))
    jv, tv = bf16_pair(rng.standard_normal((Hkv, NP, PAGE, D)
                                           ).astype(np.float32))
    jq, tq = bf16_pair(rng.standard_normal((B, Hq, D)).astype(np.float32))
    lens = np.asarray(lengths, np.int32)
    return (jq, jk, jv, jnp.asarray(lens), jnp.asarray(table)), \
        (tq, tk, tv, torch.from_numpy(lens), torch.from_numpy(table))


@pytest.mark.parametrize("g,D,maxp", [(1, 64, 3), (2, 128, 4), (8, 64, 4),
                                      (8, 128, 3), (2, 64, 4)])
def test_plain_matches_jax_gather(g, D, maxp):
    """paged_attention_plain against the JAX package's
    ``_paged_attention_ref`` at lengths 1, 127, 128, 129 and MAXP·128 on a
    scattered table with stale ids past each length: f32 softmax of bf16
    inputs, 1e-2 absolute on O(1) outputs (tests/test_torch_paged.py)."""
    Hkv = 2
    lengths = [1, 127, 128, 129, maxp * PAGE]
    j, t = _inputs(g * 10 + D + maxp, g * Hkv, Hkv, D, maxp, lengths)
    ref = jpaged._paged_attention_ref(*j, D ** -0.5)
    out = kpa.paged_attention_plain(*t, D ** -0.5)
    assert out.dtype == torch.bfloat16 and out.shape == (len(lengths),
                                                         g * Hkv, D)
    assert np.abs(f32(out) - f32(ref)).max() <= 1e-2
    # the entry takes the plain version on a CPU tensor
    assert torch.equal(kpa.paged_attention(*t, D ** -0.5), out)


@pytest.mark.parametrize("g,D,maxp,lengths", [
    (2, 128, 4, [1, 127, 128, 129, 512]),
    (8, 64, 3, [200, 5, 384]),
    (1, 64, 4, [130, 300]),
])
def test_write_plain_matches_jax(g, D, maxp, lengths):
    """paged_attention_write_plain against ``_page_write_ref`` of K and V
    at each lane's last position, then ``_paged_attention_ref``: the pools
    equal bit for bit, the output within 1e-2; the entry on a CPU tensor
    gives the same."""
    Hkv = 2
    (jq, jk, jv, jl, jt), (tq, tk, tv, tl, tt) = _inputs(
        g + D + maxp, g * Hkv, Hkv, D, maxp, lengths)
    rng = np.random.default_rng(D)
    B = len(lengths)
    jkn, tkn = bf16_pair(rng.standard_normal((B, Hkv, D)).astype(np.float32))
    jvn, tvn = bf16_pair(rng.standard_normal((B, Hkv, D)).astype(np.float32))
    pos = np.asarray(lengths) - 1
    pids = np.asarray(tt)[np.arange(B), pos // PAGE].astype(np.int32)
    rows = (pos % PAGE).astype(np.int32)
    jk2 = jpaged._page_write_ref(jk, jkn, jnp.asarray(pids),
                                 jnp.asarray(rows))
    jv2 = jpaged._page_write_ref(jv, jvn, jnp.asarray(pids),
                                 jnp.asarray(rows))
    ref = jpaged._paged_attention_ref(jq, jk2, jv2, jl, jt, D ** -0.5)
    tp, tr = torch.from_numpy(pids), torch.from_numpy(rows)
    for entry in (kpa.paged_attention_write_plain, kpa.paged_attention_write):
        kp, vp = tk.clone(), tv.clone()
        out = entry(tq, tkn, tvn, kp, vp, tl, tt, tp, tr, D ** -0.5)
        for pool, jpool in ((kp, jk2), (vp, jv2)):
            assert torch.equal(pool, torch.from_numpy(f32(jpool)).to(
                torch.bfloat16))
        assert not torch.equal(kp, tk)          # the write is not a no-op
        assert np.abs(f32(out) - f32(ref)).max() <= 1e-2


@pytest.mark.parametrize("B,Hq,Hkv,maxp,sms", [
    (32, 16, 8, 4, 132), (1, 16, 8, 64, 132), (8, 64, 8, 64, 132),
    (16, 12, 12, 8, 132), (3, 64, 4, 5, 132), (1, 16, 8, 3, 114),
    (2, 4, 2, 7, 16),
])
def test_split_plan_covers_live_tiles_once(B, Hq, Hkv, maxp, sms):
    """1-8 splits from the grid, MAXP·128 and the SM count alone, the grid
    within one block a SM where it splits at all; for every length 0 ..
    MAXP·128 + 1 the ranks' tiles cover the live tiles exactly once, in
    rank order, live ranks first, and no tile lies in a page at or past
    ceil(length / 128)."""
    splits = kpa.plan(B, Hq, Hkv, maxp, sms)
    groups = -(-(Hq // Hkv) // kpa.GROUP)
    assert 1 <= splits <= kpa.MAX_SPLITS
    if splits > 1:
        assert B * Hkv * groups * splits <= sms
    S = maxp * PAGE
    for length in range(S + 2):
        ranges = kpa.rank_tiles(length, maxp, splits)
        tiles = [t for t0, t1 in ranges for t in range(t0, t1)]
        live = -(-min(length, S) // kpa.TILE)
        assert tiles == list(range(live))
        assert all(t // 2 < -(-min(length, S) // PAGE) for t in tiles)
        per = max(1, -(-live // splits))
        nlive = min(splits, -(-live // per))
        assert [t1 > t0 for t0, t1 in ranges] \
            == [r < nlive for r in range(splits)]


@pytest.mark.parametrize("B,Hq,Hkv,maxp,lengths", [
    (1, 16, 8, 64, [8000]),              # 8 splits, every rank live
    (1, 4, 2, 8, [300]),                 # 8 splits, 5 live
    (8, 64, 8, 16, [2000, 70, 300, 513, 64, 65, 1900, 1]),   # 2 splits
])
def test_rank_order_merge_matches_one_piece(B, Hq, Hkv, maxp, lengths):
    """The ranks' (m, l, o) merged in rank order equal the one-piece softmax
    to f32 rounding, and the plain version to its bf16 rounding (half an
    ulp of outputs below 4); dropping the last live rank's partial moves
    it past the kernel's 2e-2."""
    _, t = _inputs(maxp + B, Hq, Hkv, 128, maxp, lengths)
    sc = 128 ** -0.5
    splits = kpa.plan(B, Hq, Hkv, maxp)
    plain = kpa.paged_attention_plain(*t, sc).float()
    one = kpa.paged_attention_splits_plain(*t, sc, 1)
    split = kpa.paged_attention_splits_plain(*t, sc, splits)
    assert torch.allclose(split, one, rtol=1e-5, atol=1e-6)
    assert float((split - plain).abs().max()) <= 8e-3
    dropped = kpa.paged_attention_splits_plain(*t, sc, splits,
                                               drop_last=True)
    assert float((dropped - plain).abs().max()) > 2e-2


def _fake_launch(monkeypatch):
    """Run the wrappers' card branch on the "meta" device with the kernel
    replaced by a recorder: returns (launch argument tuples, allocations)."""
    calls, allocs = [], []
    real_empty = torch.empty

    def empty(*a, **k):
        t = real_empty(*a, **k)
        allocs.append((tuple(t.shape), t.dtype))
        return t

    def fn(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(kpa, "_check", lambda *a, **k: None)
    monkeypatch.setattr(kpa, "_kernel", lambda: (None, fn))
    monkeypatch.setattr(kpa, "_sm_count", lambda device: 132)
    monkeypatch.setattr(kpa._build, "check", lambda lib, rc, what: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None:
                        types.SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(torch, "empty", empty)
    return calls, allocs


@pytest.mark.parametrize("write", [False, True])
@pytest.mark.parametrize("B,Hq,Hkv,D,NP,maxp", [
    (32, 16, 8, 128, 64, 4), (1, 16, 8, 128, 72, 64), (16, 12, 12, 64, 40, 8),
    (3, 64, 4, 256, 20, 5),
])
def test_one_launch_no_workspace(monkeypatch, write, B, Hq, Hkv, D, NP,
                                 maxp):
    """Each entry is one launch that allocates its bf16 output and nothing
    else; it gets the plan's split, the new K/V, page ids and rows only
    when it writes, and counts paged_attn (and paged_attn_write when it
    writes)."""
    meta = dict(device="meta")
    q = torch.empty((B, Hq, D), dtype=torch.bfloat16, **meta)
    kp = torch.empty((Hkv, NP, PAGE, D), dtype=torch.bfloat16, **meta)
    vp = torch.empty((Hkv, NP, PAGE, D), dtype=torch.bfloat16, **meta)
    lengths = torch.empty((B,), dtype=torch.int32, **meta)
    table = torch.empty((B, maxp), dtype=torch.int32, **meta)
    kn = torch.empty((B, Hkv, D), dtype=torch.bfloat16, **meta)
    vn = torch.empty((B, Hkv, D), dtype=torch.bfloat16, **meta)
    pids = torch.empty((B,), dtype=torch.int32, **meta)
    rows = torch.empty((B,), dtype=torch.int32, **meta)
    calls, allocs = _fake_launch(monkeypatch)
    kernel_log.reset_launches()
    if write:
        out = kpa.paged_attention_write(q, kn, vn, kp, vp, lengths, table,
                                        pids, rows, 0.1)
    else:
        out = kpa.paged_attention(q, kp, vp, lengths, table, 0.1)
    assert out.shape == (B, Hq, D) and out.dtype == torch.bfloat16
    assert allocs == [((B, Hq, D), torch.bfloat16)]
    assert len(calls) == 1
    args = calls[0]
    assert len(args) == 19
    assert all((a is not None) == write for a in args[6:10])
    assert args[10:16] == (B, Hq, Hkv, NP, maxp, D)
    assert args[16] == pytest.approx(0.1)
    assert args[17:] == (kpa.plan(B, Hq, Hkv, maxp, 132), 7)
    want = {"paged_attn": 1, "paged_attn_write": 1} if write \
        else {"paged_attn": 1}
    assert kernel_log.launches() == want


def test_decode_step_writes_and_attends_in_one_call(monkeypatch):
    """A tiny model's decode_step_paged makes one fused call a layer, on
    that layer's pools, and nothing else writes or reads the pages: the
    standalone page writes, the gather oracle and the read-only dispatch
    are made to raise. The rows it wrote are the new K/V's bf16 rows at
    each lane's position, and the step's logits equal those of the same
    step through the plain write and gather."""
    _, card, _, tp = tiny_models()
    B = 3
    cache, alloc = tpaged.init_paged_cache(card.n_layer, B, card.n_kv_head,
                                           card.head_dim, max_pages=3,
                                           device="cpu")
    cache = alloc.ensure(cache, PAGE + 3)
    g = torch.Generator().manual_seed(0)
    for pool in cache.k_pages + cache.v_pages:
        pool.copy_(torch.randn(pool.shape, generator=g))
    cache.pos.fill_(PAGE)                 # the first row of each 2nd page
    tok = torch.tensor([7, 8, 9])
    ref_cache = tpaged.PagedKVCache(
        k_pages=tuple(p.clone() for p in cache.k_pages),
        v_pages=tuple(p.clone() for p in cache.v_pages),
        page_table=cache.page_table.clone(), pos=cache.pos.clone())

    def plain_step(q, kn, vn, kp, vp, lengths, table, pids, rows, scale):
        ksw.page_write_many([(kp, kn), (vp, vn)], pids, rows)
        return kpa.paged_attention_plain(q, kp, vp, lengths, table, scale)
    monkeypatch.setattr(tpaged, "paged_attention_write", plain_step)
    ref_logits, _ = tpaged.decode_step_paged(card, tp, tok, ref_cache)
    monkeypatch.undo()

    fused = []
    real = kpa.paged_attention_write

    def write(*a):
        fused.append((a[3].data_ptr(), a[4].data_ptr()))
        return real(*a)

    def refuse(*a, **k):
        raise AssertionError("the paged decode step wrote or read the pages "
                             "outside its fused call")

    monkeypatch.setattr(tpaged, "paged_attention_write", write)
    for mod, name in ((ksw, "page_write_many"), (ksw, "page_write"),
                      (tpaged, "_page_write"),
                      (tpaged, "_paged_attention_ref"),
                      (tpaged, "_paged_attention")):
        monkeypatch.setattr(mod, name, refuse)
    logits, new = tpaged.decode_step_paged(card, tp, tok, cache)
    assert fused == [(k.data_ptr(), v.data_ptr())
                     for k, v in zip(cache.k_pages, cache.v_pages)]
    assert torch.equal(logits, ref_logits)
    for a, b in zip(cache.k_pages + cache.v_pages,
                    ref_cache.k_pages + ref_cache.v_pages):
        assert torch.equal(a, b)
    assert new.pos.tolist() == [PAGE + 1] * B


def _tpu_library_rounding(q, kp, vp, lengths, table, scale, block=4):
    """The math of the TPU library kernel as ``koifish_tpu/serve/paged.py``
    calls it (``pages_per_compute_block=4``), in numpy: q pre-scaled and
    rounded to bf16 (``:176``), logits and the running (m, l) in f32 over
    each 4-page block, the normalised O rounded to bf16 after every block
    (``paged_attention_kernel.py:285-287``)."""
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.float32).astype(
        jnp.bfloat16).astype(jnp.float32))
    q, kp, vp = (np.asarray(f32(a)) for a in (q, kp, vp))
    B, Hq, D = q.shape
    Hkv = kp.shape[0]
    g = Hq // Hkv
    qs = bf(q * np.float32(scale))
    out = np.zeros((B, Hq, D), np.float32)
    bk = block * PAGE
    mask_value = np.float32(-0.7 * np.finfo(np.float32).max)
    for b in range(B):
        n = int(lengths[b])
        for h in range(Hkv):
            qh = qs[b, h * g:(h + 1) * g]
            m = np.full((g,), -np.inf, np.float32)
            l = np.zeros((g,), np.float32)
            o = np.zeros((g, D), np.float32)
            for i in range(-(-table.shape[1] // block)):
                if i * bk >= n:
                    break
                ids = np.asarray(table[b, i * block:(i + 1) * block])
                k = kp[h, ids].reshape(-1, D)
                v = vp[h, ids].reshape(-1, D)
                qk = qh @ k.T
                live = i * bk + np.arange(k.shape[0]) < n
                qk = qk + np.where(live, np.float32(0), mask_value)
                m_cur = qk.max(-1)
                s = np.exp(qk - m_cur[:, None])
                m_next = np.maximum(m, m_cur)
                alpha, beta = np.exp(m - m_next), np.exp(m_cur - m_next)
                l_next = alpha * l + beta * s.sum(-1)
                o = bf(((l * alpha)[:, None] * o + beta[:, None] * (s @ v))
                       / l_next[:, None])
                m, l = m_next, l_next
            out[b, h * g:(h + 1) * g] = o
    return out


# the largest gap these cases find is 1.95e-3, one bf16 ulp in [0.25, 0.5)
# (ROADMAP.md queue 3)
GAP = 4e-3


@pytest.mark.parametrize("g,D,maxp", [(2, 128, 8), (8, 64, 8), (1, 128, 4)])
def test_gap_to_the_tpu_library_rounding(g, D, maxp):
    """A documented difference: the TPU library kernel pre-scales q in bf16
    and keeps O in bf16 between its 512-position blocks; the port (like the
    JAX package off the TPU) scales in f32 and rounds O once. The two
    differ, by at most two bf16 ulps of these outputs."""
    Hkv = 2
    lengths = [1, 129, 511, 512, min(513, maxp * PAGE), maxp * PAGE]
    _, (tq, tk, tv, tl, tt) = _inputs(g + D, g * Hkv, Hkv, D, maxp, lengths)
    sc = D ** -0.5
    tpu = _tpu_library_rounding(tq, tk, tv, tl.numpy(), tt.numpy(), sc)
    port = f32(kpa.paged_attention_plain(tq, tk, tv, tl, tt, sc))
    gap = float(np.abs(tpu - port).max())
    assert 0 < gap <= GAP
