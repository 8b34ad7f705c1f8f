"""PyTorch port vs the JAX package: the int8 training path.

The quantize, qdgrad and int8 fused-CE kernels' plain versions (what the
port runs on a CPU tensor, and what the CUDA kernels compute) are held
against the Pallas kernels they replace, run in the interpreter as
tests/test_pallas.py runs them; ``int8_matmul``, the fused-CE loss and whole
int8 train steps against the JAX package on the same inputs, made with
numpy from fixed seeds. The JAX train step is jitted, so the JAX functions
are jitted here too where their rounding depends on it (XLA turns a
division by the constant 127 into a product with its reciprocal). Each
tolerance is stated with the value measured beside it (on this CPU)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koifish_tpu.config import CLIParams as JCLIParams
from koifish_tpu.config import ModelCard as JModelCard
from koifish_tpu.config import QuantCard as JQuantCard
from koifish_tpu.models import init_params as j_init_params
from koifish_tpu.ops import cross_entropy as jce
from koifish_tpu.ops import int8_train as ji8
from koifish_tpu.ops import tracectx as jtc
from koifish_tpu.ops.pallas import fused_ce as pfce
from koifish_tpu.ops.pallas import qdgrad as pqd
from koifish_tpu.ops.pallas import quantize as pq
from koifish_tpu.train import trainer as jtrainer

from koifish_tpu_torch.config import CLIParams, ModelCard, QuantCard, TrainCard
from koifish_tpu_torch.io.convert import params_from_numpy
from koifish_tpu_torch.ops import cross_entropy as tce
from koifish_tpu_torch.ops import int8_train as ti8
from koifish_tpu_torch.ops import tracectx as ttc
from koifish_tpu_torch.ops.kernels import fused_ce as kc
from koifish_tpu_torch.ops.kernels import qdgrad as kqd
from koifish_tpu_torch.ops.kernels import quantize as kq
from koifish_tpu_torch.ops.matmul import qmatmul
from koifish_tpu_torch.train import trainer as ttrainer

from torch_helpers import bf16_pair, f32, jax_tree_to_numpy


@pytest.fixture
def interpret():
    """Pallas kernels eligible + interpreted; reset afterwards."""
    for mod in (pq, pqd, pfce):
        mod.set_interpret(True)
    try:
        yield
    finally:
        for mod in (pq, pqd, pfce):
            mod.set_interpret(False)


def _heavy(shape, seed, scale=1.0):
    """Rows of very different ranges, so scales and codes vary widely."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale
            * (0.01 + 4 * rng.random((shape[0], 1)))).astype(np.float32)


# ---------------------------------------------------------------------------
# quantizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M,K", [(256, 384), (64, 1024)])
def test_rowquant_colquant_match_pallas_bit_for_bit(interpret, M, K):
    """rowquant / colquant (plain, "pallas" rounding) against the Pallas
    kernels in interpret mode: codes and scales bit for bit (measured 0
    differing entries), for a row-major x and for the transposed view of
    its storage (the tied head's wte.T)."""
    jx, tx = bf16_pair(_heavy((M, K), seed=M + K))
    for jfn, tfn in ((pq.rowquant, kq.rowquant), (pq.colquant, kq.colquant)):
        jqv, jsv = jfn(jx)
        tqv, tsv = tfn(tx)
        assert tqv.dtype == torch.int8 and tsv.dtype == torch.float32
        assert tsv.shape == jsv.shape
        np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
        np.testing.assert_array_equal(tsv.numpy(), np.asarray(jsv))
    # the transposed view: colquant of x.T is a row quantization of x
    tqt, tst = kq.colquant(tx.T)
    jqt, jst = pq.rowquant(jx)
    np.testing.assert_array_equal(tqt.T.numpy(), np.asarray(jqt))
    np.testing.assert_array_equal(tst.reshape(-1).numpy(),
                                  np.asarray(jst).reshape(-1))


@pytest.mark.parametrize("entry", ["eager", "jit"])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_int8_train_quantizers_match_jax(entry, dtype):
    """The int8 training quantizers ``_rowwise_q8`` / ``_colwise_q8`` in
    both JAX forms: eager (division by 127) and jitted (XLA multiplies by
    f32(1/127)); the port's ``rounding`` of the same name. Bit for bit
    (measured 0 differing codes and scales; the other rounding differs in
    ~1 % of the scales)."""
    x = _heavy((512, 384), seed=3)
    if dtype == "bf16":
        jx, tx = bf16_pair(x)
    else:
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for jfn, dim in ((ji8._rowwise_q8, 1), (ji8._colwise_q8, 0)):
        fn = jax.jit(jfn) if entry == "jit" else jfn
        jqv, jsv = fn(jx)
        tqv, tsv = kq.quantize(tx, dim, entry)
        np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
        np.testing.assert_array_equal(tsv.numpy(), np.asarray(jsv))
        other = "eager" if entry == "jit" else "jit"
        assert not torch.equal(kq.quantize(tx, dim, other)[1], tsv)


def test_int8_dot_is_exact():
    """int8_dot is the exact int32 product, sums beyond 2^24 included."""
    a = torch.full((4, 1280), 127, dtype=torch.int8)
    b = torch.full((1280, 3), -127, dtype=torch.int8)
    assert int(kq.int8_dot(a, b)[0, 0]) == -1280 * 127 * 127


# ---------------------------------------------------------------------------
# qdgrad
# ---------------------------------------------------------------------------

def _dgrad_inputs(M, N, K, seed):
    rng = np.random.default_rng(seed)
    jdy, tdy = bf16_pair(_heavy((M, N), seed, 1e-3))
    w = (rng.standard_normal((K, N)) * 0.02).astype(np.float32)
    jwq, jsw = jax.jit(ji8._colwise_q8)(jnp.asarray(w, jnp.bfloat16))
    return (jdy, jwq, jsw), (tdy, torch.from_numpy(np.asarray(jwq)),
                             torch.from_numpy(np.asarray(jsw)))


def test_qdgrad_matches_pallas(interpret):
    """dgrad_int8_tile (plain) against the Pallas kernel in interpret mode
    at M 512, N 2048, K 256: bf16 dx from the same int32 sums and the same
    fused multiply-add per tile (measured 0 differing entries; one bf16 ulp
    of the largest entry allowed, 2^-8 relative, for the f64 emulation's
    double rounding)."""
    (jdy, jwq, jsw), (tdy, twq, tsw) = _dgrad_inputs(512, 2048, 256, 11)
    jdx = pqd.dgrad_int8_tile_or_none(jdy, jwq, jsw)
    tdx = kqd.dgrad_int8_tile_or_none(tdy, twq, tsw)
    assert jdx is not None and tdx is not None
    assert tdx.dtype == torch.bfloat16 and tdx.shape == (512, 256)
    err = np.abs(f32(tdx) - f32(jdx)).max()
    assert err <= 2 ** -8 * np.abs(f32(jdx)).max(), err


def test_qdgrad_dispatch_falls_back_off_the_tile(interpret):
    """n = 1280 is not a multiple of the 1024-column scale tile: both
    packages decline (the caller runs the bf16 dequant dot)."""
    (jdy, jwq, jsw), (tdy, twq, tsw) = _dgrad_inputs(256, 1280, 128, 12)
    assert pqd.dgrad_int8_tile_or_none(jdy, jwq, jsw) is None
    assert kqd.dgrad_int8_tile_or_none(tdy, twq, tsw) is None


# ---------------------------------------------------------------------------
# int8_matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dgrad,wgrad", [(False, False), (True, False),
                                         ("tile", False), (False, True)])
def test_int8_matmul_matches_jax(interpret, dgrad, wgrad):
    """Value, dx and dw of int8_matmul (x [4, 64, 256] @ w [256, 1024], so
    the fc-like dgrad reaches the tile kernel) against the jitted JAX custom
    VJP. y: the same int32 sums and f32 scales, rounded to bf16 (measured
    0); dx, dw bf16: 1 % of the largest entry (measured 0 with the bf16
    dots: XLA and PyTorch sum in other orders)."""
    rng = np.random.default_rng(21)
    jx, tx = bf16_pair(rng.standard_normal((4, 64, 256)).astype(np.float32))
    jw, tw = bf16_pair((rng.standard_normal((256, 1024)) * 0.05
                        ).astype(np.float32))
    g = rng.standard_normal((4, 64, 1024)).astype(np.float32)
    jg, tg = bf16_pair(g)

    @jax.jit
    def jfn(x, w, g):
        y, vjp = jax.vjp(lambda a, b: ji8.int8_matmul(a, b, wgrad, dgrad),
                         x, w)
        return (y,) + vjp(g)

    jy, jdx, jdw = jfn(jx, jw, jg)
    x = tx.clone().requires_grad_(True)
    w = tw.clone().requires_grad_(True)
    y = ti8.int8_matmul(x, w, wgrad, dgrad)
    dx, dw = torch.autograd.grad(y, (x, w), tg)
    assert y.dtype == dx.dtype == dw.dtype == torch.bfloat16
    np.testing.assert_array_equal(f32(y), f32(jy))
    for t, j in ((dx, jdx), (dw, jdw)):
        err = np.abs(f32(t) - f32(j)).max()
        assert err <= 1e-2 * np.abs(f32(j)).max(), err


def test_qmatmul_takes_int8_under_the_policy():
    """qmatmul sends a plain weight through int8_matmul only inside an
    Int8Policy scope and only above the K*N gate, as the JAX package does."""
    x = torch.randn((8, 64), dtype=torch.float32).to(torch.bfloat16)
    w = (torch.randn((64, 128)) * 0.1).to(torch.bfloat16)
    dense = qmatmul(x, w)
    with ttc.int8_scope(ttc.Int8Policy(min_weight_elems=64 * 128)):
        y8 = qmatmul(x, w)
    with ttc.int8_scope(ttc.Int8Policy(min_weight_elems=64 * 128 + 1)):
        y16 = qmatmul(x, w)
    assert torch.equal(y16, dense) and not torch.equal(y8, dense)
    assert torch.equal(y8, ti8.int8_matmul(x, w))
    assert ttc.current_int8() is None


# ---------------------------------------------------------------------------
# fused CE, int8 flavour
# ---------------------------------------------------------------------------

def _ce_inputs(E, masked, seed, m=256, V=2304):
    rng = np.random.default_rng(seed)
    jh, th = bf16_pair(rng.standard_normal((2, m // 2, E)).astype(np.float32))
    jw, tw = bf16_pair((rng.standard_normal((E, V)) * 0.05).astype(np.float32))
    tgt = rng.integers(0, V, (2, m // 2)).astype(np.int32)
    mask = ((rng.random((2, m // 2)) > 0.3).astype(np.float32)
            if masked else None)
    return jh, th, jw, tw, tgt, mask


def _ce_port(th, tw, tgt, mask, tied, fn):
    """Port loss, per-token loss and (dhidden, dhead) of ``fn(h, w, tgt,
    mask)`` — the head given as [E, V] storage or as the wte.T view of
    [V, E] storage."""
    h = th.clone().requires_grad_(True)
    w_store = (tw.T.contiguous() if tied else tw.clone()).requires_grad_(True)
    w = w_store.T if tied else w_store
    loss, per_tok = fn(h, w, torch.from_numpy(tgt),
                       None if mask is None else torch.from_numpy(mask))
    dh, dw = torch.autograd.grad(loss, (h, w_store))
    return loss, per_tok, dh, (dw.T if tied else dw)


def _ce_jax(jh, jw, tgt, mask, fn):
    jm = None if mask is None else jnp.asarray(mask)

    @jax.jit
    def run(h, w):
        (loss, tok), vjp = jax.vjp(lambda a, b: fn(a, b, jnp.asarray(tgt), jm),
                                   h, w)
        return (loss, tok) + vjp((jnp.float32(1.0), jnp.zeros_like(tok)))
    return run(jh, jw)


def _ce_close(port, ref, rel):
    loss, per_tok, dh, dw = port
    jloss, jtok, jdh, jdw = ref
    assert abs(float(loss.detach()) - float(jloss)) \
        <= 1e-5 * abs(float(jloss))
    assert np.abs(f32(per_tok) - f32(jtok)).max() <= 1e-4
    for t, j in ((dh, jdh), (dw, jdw)):
        err = np.abs(f32(t) - f32(j)).max()
        assert err <= rel * np.abs(f32(j)).max(), err


@pytest.mark.parametrize("E,masked,tied", [(64, False, True),
                                           (128, True, False),
                                           (128, False, True)])
def test_fused_ce_int8_matches_pallas(interpret, E, masked, tied):
    """FusedCE(int8) — rowquant/colquant in the jitted step's rounding, then
    fused_ce_fwd/dx/dw_int8 (plain) — against the jitted Pallas ``_ce``
    with int8=True in interpret mode, at m 256, V 2304 (a ragged tail of the
    1024 tile). Loss 1e-5 relative (the same int32 logits, measured ~1e-7),
    per-token 1e-4; dx, dw bf16: 1 % of the largest entry (measured
    <= 0.4 %)."""
    jh, th, jw, tw, tgt, mask = _ce_inputs(E, masked, seed=E + 1)

    def jfn(h, w, t, m):
        out = pfce.fused_ce_pallas_or_none(h, w, t, m, int8=True)
        assert out is not None
        return out

    port = _ce_port(th, tw, tgt, mask, tied,
                    lambda h, w, t, m: kc.fused_ce_kernel_or_none(
                        h, w, t, m, int8=True))
    _ce_close(port, _ce_jax(jh, jw, tgt, mask, jfn), rel=1e-2)


def test_fused_ce_int8_kernels_match_pallas_calls(interpret):
    """The int8 entry points (the forward, the backward's dx and dw) against
    ``_fwd_call``, ``_dx_call`` and ``_dw_call(int8=True)`` on the same
    codes (E 128, m 256, V 2304, tied codes): lse/gold 1e-5 (measured
    ~5e-7: exp sums in another order), dx/dw 1 % of the largest entry
    (measured <= 0.4 %)."""
    jh, th, jw, tw, tgt, _ = _ce_inputs(128, False, seed=4)
    x2 = jh.reshape(256, 128)
    xq, sx = jax.jit(pfce._q8_row)(x2)
    wq, sw = jax.jit(ji8._colwise_q8)(jw)
    tcol = jnp.asarray(tgt.reshape(256, 1))
    lse, gold = pfce._fwd_call(xq, wq, tcol, sx, sw, int8=True)
    wtok = jnp.full((256, 1), 1.0 / 256, jnp.float32)
    jdx = pfce._dx_call(xq, wq, tcol, lse, wtok, sx, sw, int8=True)
    jdw = pfce._dw_call(x2, wq, tcol, lse, wtok, xq, sx, sw, int8=True)
    t = lambda a: torch.from_numpy(np.array(a))
    twq = t(wq).T.contiguous().T            # the tied head's storage order
    ttg = torch.from_numpy(tgt.reshape(-1))
    tlse, tgold = kc.fused_ce_fwd_int8(t(xq), t(sx), twq, t(sw), ttg)
    assert np.abs(tlse.numpy() - np.asarray(lse)[:, 0]).max() <= 1e-5
    assert np.abs(tgold.numpy() - np.asarray(gold)[:, 0]).max() <= 1e-5
    args = (t(xq), t(sx), twq, t(sw), ttg, t(lse)[:, 0], t(wtok)[:, 0])
    tdx, tdw = kc.fused_ce_bwd_int8(th.reshape(256, 128), *args)
    for a, j in ((tdx, jdx), (tdw, jdw)):
        assert a.dtype == torch.bfloat16
        err = np.abs(f32(a) - f32(j)).max()
        assert err <= 1e-2 * np.abs(f32(j)).max(), err


@pytest.mark.parametrize("masked", [False, True])
def test_fused_ce_int8_scan_matches_jax_scan(masked):
    """The chunk scan with use_int8=True (use_pallas=False, chunk 1000 < V:
    the clamped tail chunk overlaps) against the jitted JAX scan: int8
    logits per chunk through int8_matmul, bf16 grads. Loss 1e-5 relative
    (measured ~1e-7), grads 2 % of the largest entry (measured <= 0.8 %:
    bf16 dlogits rounded at other points)."""
    jh, th, jw, tw, tgt, mask = _ce_inputs(64, masked, seed=5)
    jfn = lambda h, w, t, m: jce.fused_ce_loss(h, w, t, m, chunk=1000,
                                               use_int8=True,
                                               use_pallas=False)
    port = _ce_port(th, tw, tgt, mask, False,
                    lambda h, w, t, m: tce.fused_ce_loss(
                        h, w, t, m, chunk=1000, use_int8=True,
                        use_pallas=False))
    _ce_close(port, _ce_jax(jh, jw, tgt, mask, jfn), rel=2e-2)


def test_fused_ce_kernel_route_follows_the_policy_not_use_int8(interpret):
    """The JAX quirk, mirrored: on the kernel route ``use_int8`` is ignored
    and the ambient Int8Policy decides the flavour."""
    _, th, _, tw, tgt, _ = _ce_inputs(64, False, seed=6)
    t = torch.from_numpy(tgt)
    bf = tce.fused_ce_loss(th, tw, t)[0]
    assert torch.equal(tce.fused_ce_loss(th, tw, t, use_int8=True)[0], bf)
    with ttc.int8_scope(ttc.Int8Policy(min_weight_elems=0)):
        i8 = tce.fused_ce_loss(th, tw, t, use_int8=False)[0]
    assert torch.equal(i8, kc.fused_ce_kernel_or_none(th, tw, t,
                                                      int8=True)[0])
    assert not torch.equal(i8, bf)


# ---------------------------------------------------------------------------
# int8 training, QAT, the GPT2-774M config
# ---------------------------------------------------------------------------

TINY_GPT2 = dict(vocab_size=2048, n_layer=2, n_embd=128, n_head=2,
                 n_kv_head=2, head_dim=64, n_ffn=1024, n_ctx=32, max_pos=64)


def test_int8_step_runs_the_int8_paths(monkeypatch):
    """An int8 step with remat sends the fc dgrad through the tile kernel
    and the head through the int8 fused CE, in the forward and in the
    recompute: the launch counters of the plain versions' callers."""
    calls = []
    for mod, name in ((kqd, "dgrad_int8_tile"), (kc, "fused_ce_fwd_int8"),
                      (kq, "quantize")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    card = ModelCard.from_arch("GPT2", **TINY_GPT2)
    tcard = TrainCard(batch=2, lr=1e-3, fused_ce=True, remat=True,
                      stochastic_round=False, int8_matmul=True,
                      int8_min_kn=0, int8_dgrad="tile")
    state = ttrainer.init_train_state(card, tcard, device="cpu")
    step = ttrainer.make_train_step(card, tcard, 10)
    tok = torch.randint(0, 2048, (1, 2, 17))
    step(state, {"tokens": tok})
    # 2 layers x 6 int8 weights x (forward + recompute) x (x and w quant)
    # + the head's x and w; fc's dgrad per layer through the tile kernel
    assert calls.count("dgrad_int8_tile") == 2
    assert calls.count("fused_ce_fwd_int8") == 1
    assert calls.count("quantize") == 2 * 6 * 2 * 2 + 2
    assert ttc.current_int8() is None


def test_qat_step_matches_jax():
    """compute_loss with a QuantCard of INT4 g128 rules (fake-quant QAT,
    straight-through grads) on the tiny GPT2: loss and gradients against
    the jitted JAX compute_loss(qcard=...). Loss 2e-5 relative (measured
    1.1e-5; QAT moves it by 4e-4); all gradients together 2e-2 in relative
    norm (measured ~1 %, as the bf16 step without QAT: bf16 activations
    round at other points; single leaves such as k's bias, whose gradient
    is zero up to rounding, are noise)."""
    rules = {"self_attn": {"bits": 4}, "mlp": {"bits": 4},
             "group_size": 128}
    jcard = JModelCard.from_arch("GPT2", **TINY_GPT2)
    card = ModelCard.from_arch("GPT2", **TINY_GPT2)
    jp = j_init_params(jcard, jax.random.PRNGKey(3))
    tp = params_from_numpy(jax_tree_to_numpy(jp), device="cpu")
    tok = np.random.default_rng(4).integers(0, 2048, (4, 33)).astype(np.int32)
    jq, tq = JQuantCard.from_json(rules), QuantCard.from_json(rules)

    @jax.jit
    def jgrad(p):
        return jax.value_and_grad(lambda q: jtrainer.compute_loss(
            jcard, q, jnp.asarray(tok), qcard=jq, fused_ce=False)[0])(p)

    jloss, jg = jgrad(jp)
    flat = _leaves(tp)
    for t in flat:
        t.requires_grad_(True)
    ttok = torch.from_numpy(tok).long()
    loss, _ = ttrainer.compute_loss(card, tp, ttok, qcard=tq, fused_ce=False)
    grads = torch.autograd.grad(loss, flat)
    loss = float(loss.detach())
    assert abs(loss - float(jloss)) <= 2e-5 * abs(float(jloss))
    plain = float(ttrainer.compute_loss(card, tp, ttok, fused_ce=False)[0])
    assert abs(plain - loss) > 1e-4
    g = np.concatenate([f32(t).ravel() for t in grads])
    j = np.concatenate([np.asarray(a, np.float32).ravel()
                        for a in _leaves(jax_tree_to_numpy(jg))])
    assert np.linalg.norm(g - j) <= 2e-2 * np.linalg.norm(j)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_gpt2_774m_config_parses_as_in_jax():
    """CLIParams.load("configs/gpt2_774m.json"): the port's model and train
    cards equal the JAX package's field for field."""
    path = "configs/gpt2_774m.json"
    jp, tp = JCLIParams.load(path), CLIParams.load(path)
    for jc, tc in ((jp.model, tp.model), (jp.train, tp.train)):
        jd = {f: getattr(jc, f) for f in jc.__dataclass_fields__}
        td = {f: getattr(tc, f) for f in tc.__dataclass_fields__}
        assert set(jd) == set(td)
        for f in jd:
            assert jd[f] == td[f], (f, jd[f], td[f])
    assert tp.train.int8_matmul and tp.train.int8_min_kn == 4194304
    assert tp.model.n_embd == 1280 and tp.model.n_layer == 36
    assert kc.takes(16384, tp.model.n_embd, tp.model.vocab_size)
    assert tp.seed == jp.seed == 42


def test_int8_wrappers_refuse_what_they_do_not_take():
    """The int8 wrappers' checks, run before any launch: E outside the
    kernels' range, a tensor off the card, a 3-D or fully strided x."""
    xq = torch.zeros((4, 96), dtype=torch.int8)
    with pytest.raises(ValueError, match="E=96"):
        kc._check8(xq, torch.zeros(4), torch.zeros((96, 8), dtype=torch.int8),
                   torch.zeros(8), torch.zeros(4, dtype=torch.int32))
    xq = torch.zeros((4, 128), dtype=torch.int8)
    with pytest.raises(ValueError, match="lies on cpu"):
        kc._check8(xq, torch.zeros(4), torch.zeros((128, 8), dtype=torch.int8),
                   torch.zeros(8), torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="2-D"):
        kq._storage(torch.zeros((2, 3, 4)))
    with pytest.raises(ValueError, match="unit stride"):
        kq._storage(torch.zeros((4, 6))[::2, ::2])
    wte = torch.zeros((100, 64))
    assert kq._storage(wte.T) == (True, 100, 64, 64)   # the tied head
    assert kq._storage(torch.zeros((8, 64))[:, 16:48]) == (False, 8, 32, 64)
    assert kc.takes(8, 1280, 100) and kc.takes(8, 1600, 100)
    assert not kc.takes(8, 8256, 100) and not kc.takes(8, 1000, 100)
