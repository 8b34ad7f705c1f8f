"""The quantized-KV decode attention's split and its fused K/V write,
checked on the CPU.

The kernel (``csrc/decode_attn.cu``) runs only on the card, where
``chip_smoke.py`` holds it against its plain versions. Here: the fused
entry's plain version (``decode_attention_write_plain``: the KV quantizer,
the slot write of codes and scales, then the attention) against the JAX
package's composition of the same steps; the host's split plan and the
ranks' tiles; a plain emulation of the ranks' (m, l, o) merged in rank
order against the one-piece plain version; what the wrapper hands its one
launch (on the "meta" device, the kernel replaced by a recorder); and a
tiny model's quantized decode step, which writes and attends in one call
a layer.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koifish_tpu.dtypes import QFormat as JQFormat
from koifish_tpu.ops.attention import decode_attention as j_decode_attention
from koifish_tpu.ops.pallas import decode_attn as pda
from koifish_tpu.ops.pallas import slotwrite as psw
from koifish_tpu.serve import kvcache as jkvc

from koifish_tpu_torch.dtypes import QFormat
from koifish_tpu_torch.ops.kernels import decode_attn as kd
from koifish_tpu_torch.serve import kvcache as kvc
from koifish_tpu_torch.serve import layered
from koifish_tpu_torch.serve.layered import (decode_step_layered,
                                             init_layered_cache)
from koifish_tpu_torch.utils import kernel_log

from torch_helpers import bf16_pair, f32, tiny_models


@pytest.fixture
def interpret():
    """The JAX package's Pallas decode attention and slot write eligible and
    interpreted, as tests/test_torch_kernels.py runs them."""
    for mod in (pda, psw):
        mod.set_interpret(True)
    try:
        yield
    finally:
        for mod in (pda, psw):
            mod.set_interpret(False)


def _cache(B, Hkv, S, D, fmt, seed):
    """Codes and scales of a random cache, the same bytes in both packages."""
    x = np.random.default_rng(seed).standard_normal((B, Hkv, S, D)
                                                    ).astype(np.float32)
    jc, js = jkvc._quant_kv(jnp.asarray(x), JQFormat(fmt))
    return (jc, js), tuple(torch.from_numpy(np.array(a)) for a in (jc, js))


def _j_write_attend(q, k_new, v_new, kc, vc, ks, vs, slots, lengths, fmt,
                    scale):
    """The JAX package's decode-step composition (serve/layered.py:226-244):
    ``_quant_kv`` run eagerly, the ring write of codes and scales, then the
    interpreted Pallas decode attention, or the dequantized XLA attention
    where the kernel declines (g > 8)."""
    kq, ksc = jkvc._quant_kv(k_new, JQFormat(fmt))
    vq, vsc = jkvc._quant_kv(v_new, JQFormat(fmt))
    kc, vc = jkvc.ring_write(kc, kq, slots), jkvc.ring_write(vc, vq, slots)
    ks, vs = jkvc.ring_write(ks, ksc, slots), jkvc.ring_write(vs, vsc, slots)
    a = pda.decode_attention_quant_or_none(q, kc, vc, ks, vs, lengths, scale)
    if a is None:
        kd_, vd_ = kc, vc
        if fmt == "int4":
            kd_, vd_ = jkvc._unpack_int4(kc), jkvc._unpack_int4(vc)
        kf = (kd_.astype(jnp.float32) * ks[..., None]).astype(jnp.bfloat16)
        vf = (vd_.astype(jnp.float32) * vs[..., None]).astype(jnp.bfloat16)
        valid = jnp.arange(kc.shape[2])[None, :] < lengths[:, None]
        a = j_decode_attention(q, jnp.moveaxis(kf, 1, 2),
                               jnp.moveaxis(vf, 1, 2), valid, scale)
    return a, (kc, vc, ks, vs)


S_RING, SINKS = 256, 2
CASES = [  # (fmt, B, Hq, Hkv, D, Dv, positions)
    ("int8", 3, 4, 2, 128, 128, [100, 100, 100]),      # uniform, g 2
    ("int4", 3, 2, 2, 64, 64, [5, 77, 200]),           # per lane, g 1
    ("int8", 3, 16, 2, 64, 64, [300, 7, 600]),         # wrapped ring, g 8
    ("int4", 2, 16, 2, 128, 128, [257, 257]),          # wrapped + uniform
    ("int8", 2, 32, 2, 64, 64, [40, 255]),             # g 16 (XLA path)
    ("int4", 2, 32, 2, 64, 64, [90, 90]),              # g 16, uniform
    ("int8", 2, 4, 2, 192, 128, [31, 130]),            # MLA D 192, Dv 128
    ("int4", 2, 4, 2, 192, 128, [420, 63]),            # MLA, wrapped
]


@pytest.mark.parametrize("fmt,B,Hq,Hkv,D,Dv,pos", CASES)
def test_write_plain_matches_jax(interpret, fmt, B, Hq, Hkv, D, Dv, pos):
    """decode_attention_write_plain (quant_kv, slot_write_plain of codes and
    scales in place, decode_attention_plain) against the JAX composition at
    ring slots of a 256-row cache with 2 sinks: every cache byte equal, the
    output within 1e-2 (as test_decode_attention_matches_pallas). Both
    quantizers divide by qmax here: the JAX package's ``_quant_kv`` run
    eagerly (op by op) and the port's on a CPU tensor. (Under ``jit`` XLA
    may multiply by fl(1/qmax), and PyTorch does on a CUDA tensor, which
    the kernel matches: chip_smoke.py.)"""
    rng = np.random.default_rng(B * 100 + Hq + D)
    (jkc, jks), (tkc, tks) = _cache(B, Hkv, S_RING, D, fmt, seed=D + Hq)
    (jvc, jvs), (tvc, tvs) = _cache(B, Hkv, S_RING, Dv, fmt, seed=Dv + 7)
    jq, tq = bf16_pair(rng.standard_normal((B, Hq, D)).astype(np.float32))
    jkn, tkn = bf16_pair(rng.standard_normal((B, Hkv, D)).astype(np.float32)
                         * 3.0)
    jvn, tvn = bf16_pair(rng.standard_normal((B, Hkv, Dv)).astype(np.float32))
    jpos = jnp.asarray(pos, jnp.int32)
    jslots = jkvc.ring_slot(jpos, S_RING, SINKS)
    jlens = jnp.minimum(jpos + 1, S_RING).astype(jnp.int32)
    tslots = kvc.ring_slot(torch.tensor(pos, dtype=torch.int32), S_RING,
                           SINKS)
    tlens = torch.clamp(torch.tensor(pos) + 1, max=S_RING).to(torch.int32)
    assert tslots.tolist() == np.asarray(jslots).tolist()
    assert all(s < n for s, n in zip(tslots.tolist(), tlens.tolist()))
    sc = 1.0 / D ** 0.5
    ref, jbufs = _j_write_attend(jq, jkn, jvn, jkc, jvc, jks, jvs, jslots,
                                 jlens, fmt, sc)
    bufs = [t.clone() for t in (tkc, tvc, tks, tvs)]
    out = kd.decode_attention_write(tq, tkn, tvn, *bufs, tslots, tlens, sc)
    for name, t, j in zip(("k", "v", "k_scale", "v_scale"), bufs, jbufs):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)
    # the slot rows changed (the write is not a no-op)
    lane = torch.arange(B)
    assert not torch.equal(bufs[2][lane, :, tslots.long()],
                           tks[lane, :, tslots.long()])
    assert out.dtype == torch.bfloat16 and out.shape == (B, Hq, Dv)
    assert np.abs(f32(out) - f32(ref)).max() <= 1e-2


def test_quant_kv_is_one_definition():
    """serve/kvcache._quant_kv is the kernel module's quant_kv, and both
    give the eagerly run JAX quantizer's bytes (INT8 and packed INT4)."""
    x = np.random.default_rng(3).standard_normal((4, 3, 128)).astype(
        np.float32) * 5.0
    jx, tx = bf16_pair(x)
    for fmt in ("int8", "int4"):
        jq, js = jkvc._quant_kv(jx, JQFormat(fmt))
        for fn in (kd.quant_kv, kvc._quant_kv):
            q, s = fn(tx, QFormat(fmt))
            np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
            np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("B,Hq,Hkv,S", [
    (1, 16, 8, 1024), (1, 16, 8, 2048), (1, 16, 8, 128), (32, 16, 8, 1024),
    (32, 64, 8, 1024), (8, 64, 8, 4096), (3, 2, 2, 300), (1, 8, 8, 64),
    (64, 32, 4, 2048), (2, 28, 4, 256),
])
def test_split_plan_covers_live_tiles_once(B, Hq, Hkv, S):
    """1-8 splits, chosen from the grid and S alone, the grid within one
    block a SM where it splits at all; for every length 0..S+1 the ranks'
    tiles cover the live tiles exactly once, in rank order, with the live
    ranks first (the kernel's nlive formula); at B = 1 a kv head has >= 8
    blocks wherever S holds 8 tiles."""
    splits = kd.plan(B, Hq, Hkv, S)
    groups = -(-(Hq // Hkv) // kd.GROUP)
    assert 1 <= splits <= kd.MAX_SPLITS
    assert splits <= -(-S // kd.TILE)
    if B == 1 and S >= 8 * kd.TILE:
        assert splits * groups >= 8
    if splits > 1:
        assert B * Hkv * groups * splits <= 132
    for length in range(S + 2):
        ranges = kd.rank_tiles(length, S, splits)
        assert len(ranges) == splits
        live = -(-min(length, S) // kd.TILE)
        assert [t for t0, t1 in ranges for t in range(t0, t1)] \
            == list(range(live))
        per = max(1, -(-live // splits))
        nlive = min(splits, -(-live // per))
        assert [t1 > t0 for t0, t1 in ranges] \
            == [r < nlive for r in range(splits)]


def _rand_cache(B, Hq, Hkv, S, D, fmt, seed):
    g = torch.Generator().manual_seed(seed)
    kc, ks = kd.quant_kv(torch.randn((B, Hkv, S, D), generator=g), fmt)
    vc, vs = kd.quant_kv(torch.randn((B, Hkv, S, D), generator=g), fmt)
    q = torch.randn((B, Hq, D), generator=g).to(torch.bfloat16)
    return q, kc, vc, ks, vs


@pytest.mark.parametrize("fmt", [QFormat.INT8, QFormat.INT4])
@pytest.mark.parametrize("B,Hq,Hkv,S,lens", [
    (8, 64, 8, 1024, [1000, 70, 300, 513, 64, 65, 900, 1]),   # 2 splits
    (1, 16, 8, 1024, [1024]),         # 8 splits, every rank live
    (1, 4, 2, 512, [130]),            # 8 splits, 3 live
])
def test_rank_order_merge_matches_one_piece(fmt, B, Hq, Hkv, S, lens):
    """The ranks' (m, l, o) merged in rank order equal the one-piece
    softmax to f32 rounding when p·v_scale is kept in f32, and to the
    kernel's 2e-2 when it is rounded to bf16 against each rank's own max
    (the kernel's rounding); dropping the last live rank's partial (a
    planted fault chip_smoke.py must reject) moves it past 2e-2."""
    q, kc, vc, ks, vs = _rand_cache(B, Hq, Hkv, S, 128, fmt, seed=S + B)
    lengths = torch.tensor(lens, dtype=torch.int32)
    sc = 128 ** -0.5
    splits = kd.plan(B, Hq, Hkv, S)
    k, v = kd._unpacked(kc, vc)
    rows = torch.arange(S)[None, :] < lengths[:, None]
    one = kd._merge([kd._partial(q, k, v, ks, vs, rows, sc,
                                 torch.float32)]).reshape(B, Hq, -1)
    split32 = kd.decode_attention_splits_plain(
        q, kc, vc, ks, vs, lengths, sc, splits, pv_dtype=torch.float32)
    assert torch.allclose(split32, one, rtol=1e-5, atol=1e-6)
    plain = kd.decode_attention_plain(q, kc, vc, ks, vs, lengths, sc)
    split = kd.decode_attention_splits_plain(q, kc, vc, ks, vs, lengths, sc,
                                             splits)
    assert float((split - plain.float()).abs().max()) <= 2e-2
    dropped = kd.decode_attention_splits_plain(q, kc, vc, ks, vs, lengths,
                                               sc, splits, drop_last=True)
    assert float((dropped - plain.float()).abs().max()) > 2e-2


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

    monkeypatch.setattr(kd, "_check", lambda *a, **k: None)
    monkeypatch.setattr(kd, "_kernel", lambda: (None, fn))
    monkeypatch.setattr(kd, "_sm_count", lambda device: 132)
    monkeypatch.setattr(kd._build, "check", lambda lib, rc, what: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None:
                        types.SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(torch, "empty", empty)
    return calls, allocs


@pytest.mark.parametrize("write", [False, True])
@pytest.mark.parametrize("fmt,B,Hq,Hkv,S,D,Dv", [
    (QFormat.INT8, 32, 16, 8, 1024, 128, 128),
    (QFormat.INT4, 1, 16, 8, 1024, 128, 128),
    (QFormat.INT8, 4, 64, 4, 256, 192, 128),
])
def test_one_launch_no_workspace(monkeypatch, write, fmt, B, Hq, Hkv, S, D,
                                 Dv):
    """Each entry is one launch that allocates its bf16 output and nothing
    else; it gets the plan's split, the new K/V and slots only when it
    writes, and counts decode_attn (and kv_write when it writes)."""
    meta = dict(device="meta")
    cb = D // 2 if fmt is QFormat.INT4 else D
    vb = Dv // 2 if fmt is QFormat.INT4 else Dv
    dt = torch.uint8 if fmt is QFormat.INT4 else torch.int8
    q = torch.empty((B, Hq, D), dtype=torch.bfloat16, **meta)
    kc = torch.empty((B, Hkv, S, cb), dtype=dt, **meta)
    vc = torch.empty((B, Hkv, S, vb), dtype=dt, **meta)
    ks = torch.empty((B, Hkv, S), dtype=torch.float32, **meta)
    vs = torch.empty((B, Hkv, S), dtype=torch.float32, **meta)
    lengths = torch.empty((B,), dtype=torch.int32, **meta)
    kn = torch.empty((B, Hkv, D), dtype=torch.bfloat16, **meta)
    vn = torch.empty((B, Hkv, Dv), dtype=torch.bfloat16, **meta)
    slots = torch.empty((B,), dtype=torch.int32, **meta)
    calls, allocs = _fake_launch(monkeypatch)
    kernel_log.reset_launches()
    if write:
        out = kd.decode_attention_write(q, kn, vn, kc, vc, ks, vs, slots,
                                        lengths, 0.1)
    else:
        out = kd.decode_attention_quant(q, kc, vc, ks, vs, lengths, 0.1)
    assert out.shape == (B, Hq, Dv) and out.dtype == torch.bfloat16
    assert allocs == [((B, Hq, Dv), torch.bfloat16)]
    assert len(calls) == 1
    args = calls[0]
    assert len(args) == 20
    assert (args[7] is not None) == write and (args[9] is not None) == write
    splits = kd.plan(B, Hq, Hkv, S, 132)
    assert args[10:17] == (B, Hq, Hkv, S, D, Dv, int(fmt is QFormat.INT4))
    assert args[18:] == (splits, 7)
    want = {"decode_attn": 1, "kv_write": 1} if write \
        else {"decode_attn": 1}
    assert kernel_log.launches() == want


@pytest.mark.parametrize("fmt", [QFormat.INT8, QFormat.INT4])
@pytest.mark.parametrize("uniform", [True, False])
def test_decode_step_writes_and_attends_in_one_call(monkeypatch, fmt,
                                                    uniform):
    """A tiny model's quantized decode_step_layered makes one fused call a
    layer (write and attention), and nothing else writes the cache: no slot
    write, no index_copy_, no quantizer outside the fused call; the cache
    rows it wrote are the fused plain version's."""
    _, card, _, tp = tiny_models()
    B, S = 3, 32
    lc = init_layered_cache(card.n_layer, B, S, card.n_kv_head,
                            card.head_dim, fmt=fmt, uniform=uniform,
                            device="cpu")
    lc.pos.copy_(torch.tensor([5, 5, 5] if uniform else [5, 9, 30]))
    fused, outside = [], []
    inside = [False]
    real_write, real_q = kd.decode_attention_write, kd.quant_kv

    def write(*a):
        fused.append(a[3].data_ptr())
        inside[0] = True
        try:
            return real_write(*a)
        finally:
            inside[0] = False

    def quant(*a):
        if not inside[0]:
            outside.append(a[0].shape)
        return real_q(*a)

    def refuse(*a, **k):
        raise AssertionError("the quantized decode step wrote outside its "
                             "fused call")

    monkeypatch.setattr(layered, "decode_attention_write", write)
    monkeypatch.setattr(kd, "quant_kv", quant)
    monkeypatch.setattr(kvc, "quant_kv", quant)
    monkeypatch.setattr(layered, "slot_write_many", refuse)
    monkeypatch.setattr(torch.Tensor, "index_copy_", refuse)
    tok = torch.tensor([7, 8, 9], dtype=torch.int32)
    for _ in range(2):
        logits, lc = decode_step_layered(card, tp, tok, lc, streaming=False)
    assert torch.isfinite(logits).all()
    assert fused == [kc.data_ptr() for kc in lc.k] * 2
    assert outside == []
    assert lc.pos.tolist() == ([7, 7, 7] if uniform else [7, 11, 32])
