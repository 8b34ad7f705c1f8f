"""PyTorch port vs the JAX package: sequence parallelism over a ring.

The port's plain ring (``parallel/ring_attention.py``) and its kernel
ring's plain version (``ops/kernels/ring_attn.py``, row 13) on P virtual
CPU ranks are held against JAX's ``ppermute`` ring and the Pallas ring
kernel in interpret mode, run on the test run's virtual CPU devices, and
against one-piece causal attention. The kernel ring's schedule (its
launches, the chunk sends folded into them, copies between devices and
the CUDA events between them) is run on the "meta" device with the
kernel, the copy, the streams and the events replaced by recorders
(``ring_recorder.py``), and checked for races and for what each launch
reads; its work plan is tested in ``test_torch_ring_plan.py``. Inputs come from numpy seeds; each tolerance is stated with the
value measured beside it (on this CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from koifish_tpu.parallel.mesh import mesh_shape_for as j_mesh_shape_for
from koifish_tpu.parallel.ring_attention import \
    ring_attention_sharded as j_ring_sharded
from koifish_tpu.parallel.ring_pallas import fits_vmem as j_fits_vmem
from koifish_tpu.parallel.ring_pallas import \
    ring_attention_pallas_sharded as j_ring_pallas_sharded

from koifish_tpu_torch.ops.kernels import ring_attn as ra
from koifish_tpu_torch.parallel import mesh as tmesh
from koifish_tpu_torch.parallel import (fits_vmem, make_mesh, mesh_shape_for,
                                        ring_attention_pallas_sharded,
                                        ring_attention_sharded)
from koifish_tpu_torch.utils import kernel_log

import ring_recorder as rec
from torch_helpers import torch_threads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


TL = 128          # positions a rank: one of the kernel's 128-key tiles


def _inputs(n, g, D, seed=0):
    """q [1, n·TL, Hq, D], k/v [1, n·TL, Hkv, D] f32 of unit variance."""
    hkv = 2 if g < 8 else 1
    rng = np.random.default_rng(seed)
    T = n * TL
    return tuple(rng.standard_normal((1, T, h, D)).astype(np.float32)
                 for h in (g * hkv, hkv, hkv))


def _one_piece(q, k, v):
    """Causal attention over the whole sequence in f32 (numpy in, numpy
    out): the JAX test's oracle."""
    q, k, v = (torch.from_numpy(np.asarray(x, np.float32)) for x in (q, k, v))
    T, D = q.shape[1], q.shape[3]
    g = q.shape[2] // k.shape[2]
    kf, vf = k.repeat_interleave(g, 2), v.repeat_interleave(g, 2)
    s = torch.einsum("bthd,bshd->bhts", q, kf) / D ** 0.5
    s = s.masked_fill(~torch.tril(torch.ones(T, T, dtype=torch.bool)), -1e30)
    return torch.einsum("bhts,bshd->bthd", s.softmax(-1), vf).numpy()


def _bf16(x):
    """The same bf16 values for both packages: (jnp bf16, torch bf16)."""
    j = jnp.asarray(x, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, np.float32)).to(torch.bfloat16)


# every (n, g) pair once, each n and each g with both head dims (the JAX
# side takes ~4 s a case on the CPU, most of it the interpreted kernel)
@pytest.mark.parametrize("n,g,D", [(2, 1, 64), (2, 2, 128), (2, 8, 64),
                                   (4, 1, 128), (4, 2, 64), (4, 8, 128)])
def test_rings_match_jax_and_one_piece(n, g, D):
    """On n virtual ranks, f32 and bf16 inputs:
    - the plain ring against JAX's ppermute ring: f32 within 1e-5
      (measured <= 3.6e-7 on outputs up to ~3.5); bf16 outputs within one
      bf16 ulp, |Δ| <= 2^-7·|jax| + 1e-6 (measured <= 0.89 of it: both
      round an f32 result that differs in the last bits);
    - the kernel ring's plain version against the interpreted Pallas ring
      kernel (f32 inputs; both round q, K and p to bf16): within 4e-3,
      tighter than the JAX test's 2e-2 (measured <= 3.3e-4: the port
      updates the softmax once a 128-key tile, here once a chunk as the
      TPU kernel does, in base 2 where the TPU kernel takes exp);
    - both against one-piece causal attention at the JAX test's 2e-2 (the
      plain ring within 1e-5)."""
    jmesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
    tmesh = make_mesh({"sp": n}, devices="cpu")
    q, k, v = _inputs(n, g, D)
    ref = _one_piece(q, k, v)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))

    plain = ring_attention_sharded(tmesh, "sp")(tq, tk, tv).numpy()
    jring = np.asarray(j_ring_sharded(jmesh, "sp")(q, k, v))
    np.testing.assert_allclose(plain, jring, rtol=0, atol=1e-5)
    np.testing.assert_allclose(plain, ref, rtol=0, atol=1e-5)

    jb = [_bf16(x) for x in (q, k, v)]
    pb = ring_attention_sharded(tmesh, "sp")(*(t for _, t in jb))
    jrb = np.asarray(j_ring_sharded(jmesh, "sp")(*(j for j, _ in jb)),
                     np.float32)
    assert pb.dtype == torch.bfloat16
    excess = np.abs(pb.float().numpy() - jrb) / (np.abs(jrb) * 2 ** -7 + 1e-6)
    assert excess.max() <= 1.0, excess.max()

    kern = ring_attention_pallas_sharded(tmesh, "sp")(tq, tk, tv).numpy()
    jpal = np.asarray(j_ring_pallas_sharded(jmesh, "sp", interpret=True)(
        q, k, v))
    assert np.abs(kern - jpal).max() <= 4e-3, np.abs(kern - jpal).max()
    np.testing.assert_allclose(kern, ref, rtol=2e-2, atol=2e-2)


def test_kernel_plain_takes_bf16_q_and_keeps_its_dtype():
    """A bf16 q gives a bf16 output within one bf16 rounding of the f32 q's
    (the kernel rounds q to bf16 either way: the f32 results are equal
    before the final cast)."""
    tmesh = make_mesh({"sp": 4}, devices="cpu")
    q, k, v = (torch.from_numpy(x) for x in _inputs(4, 2, 64, seed=3))
    qb = q.to(torch.bfloat16)
    out32 = ring_attention_pallas_sharded(tmesh, "sp")(qb.float(), k, v)
    out16 = ring_attention_pallas_sharded(tmesh, "sp")(qb, k, v)
    assert out16.dtype == torch.bfloat16 and out32.dtype == torch.float32
    assert torch.equal(out16, out32.to(torch.bfloat16))


@pytest.mark.parametrize("n", [2, 3, 4])
def test_skipping_masked_chunks_is_exact(n):
    """Chunks wholly above the diagonal (src > my) change nothing once step
    0 has made m finite: the ring's (o, m, l) with them skipped is
    torch.equal to the ring that computes them."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(n, 2, 64, seed=5))
    ch = lambda x: list(x.chunk(n, dim=1))
    skip = ra.ring_states_plain(ch(q), ch(k), ch(v), skip_masked=True)
    full = ra.ring_states_plain(ch(q), ch(k), ch(v), skip_masked=False)
    for a, b in zip(skip, full):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_a_masked_first_chunk_is_washed_out():
    """From m = -1e30 a wholly masked chunk gives p = exp(0) = 1 at every
    entry (l = Tl, o = Σv), but the first chunk with a live key then
    rescales that state by exp(-1e30 - m) = 0: the result is torch.equal
    to the diagonal alone. The ring still starts on the diagonal: there
    ``first`` initialises the state, and rank r's live steps are 0..r."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(2, 1, 64, seed=6))
    tl = TL
    q0, k0, v0, k1, v1 = q[:, :tl], k[:, :tl], v[:, :tl], k[:, tl:], v[:, tl:]
    masked = ra.ring_step_plain(q0, k1, v1, None, 0, tl, 0.125)
    assert torch.equal(masked[2], torch.full_like(masked[2], tl))
    late = ra.ring_step_plain(q0, k0, v0, masked, 0, 0, 0.125)
    right = ra.ring_step_plain(q0, k0, v0, None, 0, 0, 0.125)
    for a, b in zip(late, right):
        assert torch.equal(a, b)


def test_kernel_ring_refuses_a_gradient_and_mixed_devices():
    q, k, v = (torch.from_numpy(x) for x in _inputs(2, 1, 64))
    ch = lambda x: list(x.chunk(2, dim=1))
    qs = ch(q.clone().requires_grad_(True))
    with pytest.raises(RuntimeError, match="forward-only"):
        ra.ring_attention(qs, ch(k), ch(v))
    with torch.no_grad():                      # no gradient asked: runs
        ra.ring_attention(qs, ch(k), ch(v))
    meta = [x.to("meta") for x in ch(k)]
    with pytest.raises(ValueError, match="lie on"):
        ra.ring_attention(ch(q), [ch(k)[0], meta[1]], ch(v))
    with pytest.raises(ValueError, match="D in"):
        ra.ring_attention([x[..., :32] for x in ch(q)],
                          [x[..., :32] for x in ch(k)],
                          [x[..., :32] for x in ch(v)])


def test_pallas_sharded_routes_one_rank_to_the_plain_ring():
    """n = 1: the plain ring, as JAX routes it (bit for bit equal here);
    n > 1 on the CPU: the kernel's plain version."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(2, 2, 64, seed=7))
    one = make_mesh({"sp": 1}, devices="cpu")
    assert torch.equal(ring_attention_pallas_sharded(one, "sp")(q, k, v),
                       ring_attention_sharded(one, "sp")(q, k, v))
    two = make_mesh({"sp": 2}, devices="cpu")
    want = torch.cat(ra.ring_plain(list(q.chunk(2, 1)), list(k.chunk(2, 1)),
                                   list(v.chunk(2, 1))), dim=1)
    assert torch.equal(ring_attention_pallas_sharded(two, "sp")(q, k, v),
                       want)


# ---------------------------------------------------------------------------
# fits_vmem, mesh_shape_for, make_mesh
# ---------------------------------------------------------------------------

def test_fits_vmem_and_mesh_shape_for_match_jax():
    for b in (1, 2, 8):
        for tl in (64, 1024, 2048, 4096, 8192):
            for hq, hkv in ((4, 2), (16, 8), (32, 4)):
                for d in (64, 128):
                    assert fits_vmem(b, tl, hq, hkv, d) == \
                        j_fits_vmem(b, tl, hq, hkv, d)
    for nd in range(1, 17):
        for tp in (None, 1, 2, 4):
            if tp is not None and nd % tp:
                continue
            assert mesh_shape_for(nd, tp) == dict(j_mesh_shape_for(nd, tp))
    # the card shape (Hq 16, Hkv 8, D 128, T 8192): the TPU kernel's guard
    # holds at sp 4 and 8, not at sp 2; the port's routing has no guard
    assert [fits_vmem(1, 8192 // n, 16, 8, 128) for n in (2, 4, 8)] == \
        [False, True, True]


def test_make_mesh_places_ranks_round_robin(monkeypatch):
    """Ranks take the devices in turn, in row-major order of the axes (the
    JAX make_mesh refuses a mesh larger than its device list)."""
    m = make_mesh({"dp": 1, "tp": 1, "sp": 4}, devices="cpu")
    assert m.shape == {"dp": 1, "tp": 1, "sp": 4} and m.devices.size == 4
    assert m.axis_devices("sp") == [torch.device("cpu")] * 4
    assert m.n_devices == 1
    monkeypatch.setattr(tmesh, "_device", torch.device)
    m = make_mesh({"dp": 2, "sp": 3}, devices=["cpu", "meta"])
    order = [d.type for d in m.devices.flat]
    assert order == ["cpu", "meta", "cpu", "meta", "cpu", "meta"]
    assert [d.type for d in m.axis_devices("sp")] == ["cpu", "meta", "cpu"]
    assert make_mesh(devices="cpu").shape == {"dp": 1, "tp": 1}


# ---------------------------------------------------------------------------
# the kernel ring's schedule, on the "meta" device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_kernel_ring_schedule(monkeypatch, n):
    """On one card: n step launches a ring (step s takes ranks s..n-1:
    each rank's diagonal with ``first`` at step 0, rank r's ``last`` at
    step r), n(n-1)/2 chunk sends folded into them (rank r < n-1 at its
    steps 0..r, into its neighbour's other slot) and no chunk copy; no slot
    is written while another op, or another rank of the same launch, reads
    or writes it; every launch reads the chunk its k_off names; everything
    is joined into the caller's stream."""
    ops, tr = rec.run(monkeypatch, ["meta"] * n, ra.LocalTransport)
    launches = [o for o in ops if o["kind"] == "launch"]
    assert len(launches) == n
    assert kernel_log.launches() == {"ring_attn": n}
    assert [o for o in ops if o["kind"] == "copy"] == []
    tl = rec.TL
    sends = [d for o in launches for d in o["ranks"] if d["send"] >= 0]
    assert len(sends) == n * (n - 1) // 2
    for s, o in enumerate(launches):
        assert o["args"] == (1, tl, 4, 2, 64, 64, 0, ra._sl2(0.125))
        ranks = [d["q_off"] // tl for d in o["ranks"]]
        assert ranks == list(range(s, n))
        for r, d in zip(ranks, o["ranks"]):
            assert d["k_off"] == (r - s) * tl
            assert (d["first"], d["last"]) == (int(s == 0), int(s == r))
            assert (d["send"] >= 0) == (r < n - 1)
            assert d["o"] and d["m"] and d["l"] and d["out"]
            assert d["slot"] == tr.row(r, s % 2)
    assert rec.check(ops, tr)[0] == []


def test_schedule_check_rejects_planted_faults(monkeypatch):
    """The checks above catch what they are for: a transport that folds a
    chunk into its neighbour's current slot (the one the neighbour reads in
    the same launch) races; one whose copy to a neighbour on another device
    skips the wait for that neighbour's previous launch races; one that
    sends to the wrong neighbour feeds launches the wrong chunk."""
    class SameSlot(ra.LocalTransport):
        def fold(self, r, c):
            if super().fold(r, c) is None:
                return None
            return self.row(self.peer(r), c)

    class NoAck(ra.LocalTransport):
        def send(self, r, c):
            mine, self._launch = self._launch, {
                k: e for k, e in self._launch.items() if k == self.key[r]}
            super().send(r, c)
            self._launch = mine

    class Skewed(ra.LocalTransport):
        def peer(self, r):
            return (r + 2) % self.n

    ops, tr = rec.run(monkeypatch, ["meta"] * 4, SameSlot)
    assert any("within op" in p for p in rec.check(ops, tr)[0])
    mesh = ["meta", "meta", "cpu", "cpu"]
    ops, tr = rec.run(monkeypatch, mesh, ra.LocalTransport, mixed=True)
    assert rec.check(ops, tr)[0] == []
    ops, tr = rec.run(monkeypatch, mesh, NoAck, mixed=True)
    assert any("race" in p for p in rec.check(ops, tr)[0])
    ops, tr = rec.run(monkeypatch, ["meta"] * 4, Skewed)
    assert any("chunk" in p for p in rec.check(ops, tr)[0])
