"""The fused classifier CE's host plan and launch sequence, checked on the
CPU, and the kernel route at E 1600 against the JAX package.

The kernels run only on the card (``chip_smoke.py`` holds them against
their plain versions there). What the wrapper decides in Python is checked
here: the E range it admits, the forward's vocab splits and workspace, the
backward's vocab chunks and chunk buffer, and the order of the backward's
launches, run on the "meta" device with the kernels replaced by a recorder.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koifish_tpu.ops import cross_entropy as jce

from koifish_tpu_torch.ops.kernels import fused_ce as kc
from koifish_tpu_torch.utils import kernel_log

from torch_helpers import bf16_pair, f32

_EMPTY = torch.empty     # the recorder replaces torch.empty


def test_takes_admits_e_multiples_of_64_up_to_8192():
    """E from 64 to 8192 in steps of 64 (GPT2-1558M's 1600, Qwen3-4B's
    2560, Qwen3-32B's 5120 among them); not 8256, 1000 or 32."""
    assert all(kc.takes(8, e, 100) for e in range(64, 8193, 64))
    for e in (8256, 1000, 32, 96, 0, 1601):
        assert not kc.takes(8, e, 100)
    assert not kc.takes(0, 64, 100) and not kc.takes(8, 64, 0)


@pytest.mark.parametrize("m, v, want", [
    (8192, 151936, (16384, 10)),    # Qwen3-0.6B's step: 256 MiB of buffer
    (16384, 50304, (8192, 7)),      # GPT2-774M's
    (1024, 151936, (131072, 2)),    # Qwen3-4B at m 1024
    (100, 333, (512, 1)),           # the ragged case: one chunk
    (64, 2100, (2304, 1)),
    (1, 1, (256, 1)),
])
def test_chunk_plan_covers_v_once_in_order(m, v, want):
    """The backward's chunks cover [0, V) exactly once, in order; each fits
    the buffer, whose width is a whole number of 256-column vocab tiles and
    whose bytes stay within CHUNK_BYTES."""
    ldb, chunks = kc.chunk_plan(m, v)
    assert (ldb, len(chunks)) == want
    assert ldb % kc.BV == 0 and 2 * m * ldb <= kc.CHUNK_BYTES
    assert ldb <= kc.vocab_tiles(v) * kc.BV
    assert chunks[0][0] == 0 and all(1 <= vc <= ldb for _, vc in chunks)
    assert all(a + va == b for (a, va), (b, _) in zip(chunks, chunks[1:]))
    assert chunks[-1][0] + chunks[-1][1] == v


def test_chunk_buffer_never_exceeds_its_cap():
    """Over many shapes the buffer stays within its cap, unless one vocab
    tile's rows alone exceed it (then one tile wide)."""
    for m in (1, 7, 128, 1000, 8192, 16384, 65536, 2**20):
        for v in (1, 300, 2304, 50304, 151936):
            ldb, _ = kc.chunk_plan(m, v)
            assert 2 * m * ldb <= kc.CHUNK_BYTES or ldb == kc.BV


@pytest.mark.parametrize("m, tiles, want", [
    (8192, 594, 2),     # Qwen3's forward: 64 row tiles x 2 = 128 items
    (16384, 197, 1),    # GPT2-774M's: 128 row tiles fill the card alone
    (8192, 64, 2),      # a 16,384-column backward chunk at Qwen3's m
    (1024, 594, 33),    # 8 row tiles: the vocab split fills the card
    (100, 2, 2),
    (16384, 5, 1),
])
def test_splits_fill_the_card_with_no_empty_split(m, tiles, want):
    """Vocab splits of a logits launch on 132 SMs: every split takes at
    least one tile and the splits cover the tiles once."""
    s = kc.splits_for(m, tiles, 132)
    assert s == want
    per = -(-tiles // s)
    runs = [range(i * per, min(tiles, (i + 1) * per)) for i in range(s)]
    assert all(len(r) >= 1 for r in runs)
    assert [t for r in runs for t in r] == list(range(tiles))


def _recorder(monkeypatch, int8=False):
    """Run the wrappers' card branch on the "meta" device with the kernels
    replaced by a recorder: returns (calls as (entry, args), allocations)."""
    calls, allocs = [], []
    real_empty = torch.empty

    def empty(*a, **k):
        t = real_empty(*a, **k)
        allocs.append((tuple(t.shape), t.dtype))
        return t

    def rec(name):
        def fn(*args):
            calls.append((name, args))
            return 0
        return fn

    names = ("fwd", "dlogits", "dx", "dw")
    prefix = "koifish_fused_ce_int8_" if int8 else "koifish_fused_ce_"
    fns = {prefix + n: rec(n) for n in names}
    monkeypatch.setattr(kc, "_kernels8" if int8 else "_kernels",
                        lambda: (None, fns))
    monkeypatch.setattr(kc, "_check", lambda x, w, tgt, cols=(): (
        x.shape[0], x.shape[1], w.shape[1]))
    monkeypatch.setattr(kc, "_check8", lambda xq, sx, wq, sw, tgt, cols=(): (
        xq.shape[0], xq.shape[1], wq.shape[1], wq))
    monkeypatch.setattr(kc, "_w_strides", lambda w: w.stride())
    monkeypatch.setattr(kc, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(kc._build, "check", lambda lib, rc, what: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 7}))
    monkeypatch.setattr(torch, "empty", empty)
    return calls, allocs


def _meta(*shape, dtype=torch.bfloat16):
    return _EMPTY(shape, dtype=dtype, device="meta")


def _bwd_inputs(m, e, v):
    return (_meta(m, e), _meta(v, e).T, _meta(m, dtype=torch.int32),
            _meta(m, dtype=torch.float32), _meta(m, dtype=torch.float32))


@pytest.mark.parametrize("m, e, v", [(8192, 1024, 151936), (100, 64, 333),
                                     (16384, 1600, 50304)])
def test_forward_takes_a_workspace_only_when_the_vocab_splits(monkeypatch,
                                                              m, e, v):
    """The forward is one launch; with more than one vocab split it gets an
    f32 [splits, m, 3] workspace (the merge runs inside the launch)."""
    calls, allocs = _recorder(monkeypatch)
    x, w, tgt, _, _ = _bwd_inputs(m, e, v)
    before = kernel_log.LAUNCHES.get(kc.NAME_FWD, 0)
    lse, gold = kc.fused_ce_fwd(x, w, tgt)
    splits = kc.splits_for(m, kc.vocab_tiles(v), 132)
    assert lse.shape == gold.shape == (m,)
    ws = [((splits, m, 3), torch.float32)] if splits > 1 else []
    assert allocs == [((m,), torch.float32)] + ws
    assert [c[0] for c in calls] == ["fwd"]
    assert calls[0][1][-2:] == (splits, 7)
    assert (calls[0][1][5] is None) == (splits == 1)
    assert kernel_log.LAUNCHES[kc.NAME_FWD] == before + 1


def _sequence(calls):
    """(kernel, c0, vc[, first, last]) of each backward launch."""
    out = []
    for name, a in calls:
        if name == "dlogits":       # ..., c0, vc, splits, stream
            out.append((name, a[-4], a[-3]))
        elif name == "dx":          # ..., c0, vc, first, last, stream
            out.append((name, a[-5], a[-4], a[-3], a[-2]))
        else:                       # ..., c0, vc, sde, sdv, stream
            out.append((name, a[-5], a[-4]))
    return out


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dx_on, dw_on", [(True, True), (True, False),
                                          (False, True)])
def test_backward_launches_dlogits_then_gemms_per_chunk(monkeypatch, int8,
                                                        dx_on, dw_on):
    """Per vocab chunk, in order: the chunk's dlogits, then the dx GEMM
    (FIRST on the first chunk, LAST on the last: the f32 dx carried across
    the chunks in chunk order) and the dw GEMM; only dx, or only dw, when
    one input needs no gradient. One chunk buffer [m, ldb] bf16; the f32 dx
    only with dx and more than one chunk."""
    m, e, v = 16384, 1280, 50304
    calls, allocs = _recorder(monkeypatch, int8)
    x, w, tgt, lse, wtok = _bwd_inputs(m, e, v)
    if int8:
        xq, wq = _meta(m, e, dtype=torch.int8), _meta(v, e, dtype=torch.int8).T
        sx, sw = _meta(m, dtype=torch.float32), _meta(v, dtype=torch.float32)
        dx, dw = kc.fused_ce_bwd_int8(x, xq, sx, wq, sw, tgt, lse, wtok,
                                      dx_on, dw_on)
    else:
        dx, dw = kc.fused_ce_bwd(x, w, tgt, lse, wtok, dx_on, dw_on)
    ldb, chunks = kc.chunk_plan(m, v)
    want = []
    for i, (c0, vc) in enumerate(chunks):
        want.append(("dlogits", c0, vc))
        if dx_on:
            want.append(("dx", c0, vc, int(i == 0), int(i == len(chunks) - 1)))
        if dw_on:
            want.append(("dw", c0, vc))
    assert _sequence(calls) == want
    assert (dx is not None) == dx_on and (dw is not None) == dw_on
    if dx_on:
        assert dx.shape == (m, e) and dx.dtype == torch.bfloat16
    if dw_on:   # the tied head's gradient: a [V, E] tensor's [E, V] view
        assert dw.shape == (e, v) and dw.stride() == (1, e)
    want_allocs = ([((e, v)[::-1], torch.bfloat16)] if dw_on else []) \
        + [((m, ldb), torch.bfloat16)] \
        + ([((m, e), torch.bfloat16), ((m, e), torch.float32)] if dx_on
           else [])
    assert allocs == want_allocs
    splits = {kc.splits_for(m, kc.vocab_tiles(vc), 132) for _, vc in chunks}
    assert {a[-2] for n, a in calls if n == "dlogits"} == splits


def test_one_chunk_backward_has_no_f32_dx(monkeypatch):
    """With one chunk the dx GEMM is FIRST and LAST and takes no f32 dx."""
    calls, allocs = _recorder(monkeypatch)
    x, w, tgt, lse, wtok = _bwd_inputs(100, 64, 333)
    kc.fused_ce_bwd(x, w, tgt, lse, wtok, need_dw=False)
    assert [c[0] for c in calls] == ["dlogits", "dx"]
    assert calls[1][1][3] is None                       # dxf
    assert ((100, 64), torch.float32) not in allocs


def test_backward_refuses_a_buffer_off_the_plan(monkeypatch):
    """A chunk buffer handed in (to time or inspect the launches) must be
    the plan's bf16 [m, ldb]."""
    _recorder(monkeypatch)
    x, w, tgt, lse, wtok = _bwd_inputs(100, 64, 333)
    with pytest.raises(ValueError, match="dlogits buffer"):
        kc._bwd(x, w, tgt, lse, wtok, buf=_meta(100, 256))


def test_gemms_alone_reuse_the_buffer_handed_in(monkeypatch):
    """Timing the GEMMs alone: without "dlogits" the dx and dw GEMMs read
    the buffer handed in, chunk by chunk, and no new buffer is made."""
    calls, allocs = _recorder(monkeypatch)
    m, e, v = 8192, 1024, 151936
    x, w, tgt, lse, wtok = _bwd_inputs(m, e, v)
    ldb, chunks = kc.chunk_plan(m, v)
    buf = _meta(m, ldb)
    kc._bwd(x, w, tgt, lse, wtok, ("dx", "dw"), buf=buf)
    assert [c[0] for c in calls] == ["dx", "dw"] * len(chunks)
    assert all(a[0] == buf.data_ptr() for _, a in calls)
    assert ((m, ldb), torch.bfloat16) not in allocs


def test_fused_ce_backward_asks_only_for_the_gradients_needed(monkeypatch):
    """FusedCE's backward launches the dw GEMM only when the head needs a
    gradient, the dx GEMM only when x does."""
    seen = []

    def bwd(x, w, tgt, lse, wtok, need_dx=True, need_dw=True):
        seen.append((need_dx, need_dw))
        return (torch.zeros_like(x) if need_dx else None,
                torch.zeros_like(w) if need_dw else None)

    monkeypatch.setattr(kc, "fused_ce_bwd", bwd)
    rng = np.random.default_rng(0)
    for need_x, need_w in ((True, True), (True, False), (False, True)):
        x = torch.from_numpy(rng.standard_normal((8, 64)).astype(np.float32)
                             ).to(torch.bfloat16).requires_grad_(need_x)
        w = torch.from_numpy(rng.standard_normal((64, 40)).astype(np.float32)
                             ).to(torch.bfloat16).requires_grad_(need_w)
        tgt = torch.from_numpy(rng.integers(0, 40, 8).astype(np.int32))
        loss, _ = kc.FusedCE.apply(x, w, tgt, torch.ones(8), False)
        loss.backward()
    assert seen == [(True, True), (True, False), (False, True)]


@pytest.mark.parametrize("tied, masked", [(True, False), (False, True)])
def test_kernel_route_at_e1600_matches_jax(tied, masked):
    """GPT2-1558M's E 1600, which the kernels now take: the port's kernel
    route (FusedCE with the plain versions on the CPU, no chunk-scan
    fallback) against the JAX package's ``fused_ce_loss`` (its chunk scan
    on the CPU), m 64, V 2100. As test_torch_kernels' kernel-route-vs-scan
    check: loss 1e-5 relative, per-token 1e-4, dx and dw 2 % of their
    largest entry (the kernel route's gradients come from bf16 dlogits)."""
    B, T, E, V = 2, 32, 1600, 2100
    rng = np.random.default_rng(1600 + masked)
    jh, th = bf16_pair(rng.standard_normal((B, T, E)).astype(np.float32))
    jw, tw = bf16_pair((rng.standard_normal((E, V)) * 0.05
                        ).astype(np.float32))
    tgt = rng.integers(0, V, (B, T)).astype(np.int32)
    mask = ((rng.random((B, T)) > 0.3).astype(np.float32) if masked
            else None)
    jm = None if mask is None else jnp.asarray(mask)

    def jfn(h, w):
        return jce.fused_ce_loss(h, w, jnp.asarray(tgt), jm)

    (jloss, jtok), jvjp = jax.vjp(jfn, jh, jw)
    jdh, jdw = jvjp((jnp.float32(1.0), jnp.zeros_like(jtok)))

    assert kc.takes(B * T, E, V)
    before = dict(kernel_log.FALLBACKS)
    h = th.clone().requires_grad_(True)
    w_store = (tw.T.contiguous() if tied else tw.clone()).requires_grad_(True)
    w = w_store.T if tied else w_store
    out = kc.fused_ce_kernel_or_none(
        h, w, torch.from_numpy(tgt),
        None if mask is None else torch.from_numpy(mask))
    assert out is not None and kernel_log.FALLBACKS == before
    loss, per_tok = out
    assert type(loss.grad_fn).__name__ == "FusedCEBackward"
    dh, dw = torch.autograd.grad(loss, (h, w_store))
    dw = dw.T if tied else dw
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert np.abs(f32(per_tok) - f32(jtok)).max() <= 1e-4
    for t, j in ((dh, jdh), (dw, jdw)):
        err = np.abs(f32(t) - f32(j)).max()
        assert err <= 2e-2 * np.abs(f32(j)).max(), err
