"""PyTorch port vs the JAX package: the bf16 training path.

The port's losses, schedules, optimizer, remat and train loop are held
against the JAX package's on the same inputs, made with numpy from fixed
seeds; the JAX side runs its XLA paths on the CPU. Each tolerance is stated
with the value measured beside it (on this CPU)."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koifish_tpu.config import ModelCard as JModelCard
from koifish_tpu.config import TrainCard as JTrainCard
from koifish_tpu.ops import cross_entropy as jce
from koifish_tpu.train import optimizer as jopt
from koifish_tpu.train import schedule as jsched
from koifish_tpu.train import trainer as jtrainer
from koifish_tpu.utils import mfu as jmfu

from koifish_tpu_torch.config import ModelCard, QuantCard, TrainCard
from koifish_tpu_torch.io.convert import (opt_state_from_numpy,
                                          params_from_numpy)
from koifish_tpu_torch.models import init_params
from koifish_tpu_torch.ops import cross_entropy as tce
from koifish_tpu_torch.train import optimizer as topt
from koifish_tpu_torch.train import schedule as tsched
from koifish_tpu_torch.train import trainer as ttrainer
from koifish_tpu_torch.utils import mfu as tmfu
from koifish_tpu_torch.utils.tree import leaves, tree_map

from torch_helpers import bf16_pair, f32, jax_tree_to_numpy

TINY = dict(vocab_size=256, n_layer=2, n_embd=128, n_head=2, n_ctx=32,
            max_pos=64, head_dim=64, n_ffn=256)
ARCH_KV = {"QWEN3": 1, "GPT2": 2}


# ---------------------------------------------------------------------------
# (c) cross_entropy_loss
# ---------------------------------------------------------------------------

def test_cross_entropy_value_and_dlogits_match_jax():
    """Value, per-token loss and dlogits (the recompute backward) with a
    mask and a per-token cotangent. Loss f32 (1e-5 measured ~1e-6); dlogits
    bf16 from the same f32 math (atol 1e-6 on entries up to ~0.01,
    measured 0)."""
    rng = np.random.default_rng(0)
    B, T, V = 2, 8, 300
    jl, tl = bf16_pair(rng.standard_normal((B, T, V)).astype(np.float32) * 3)
    tgt = rng.integers(0, V, (B, T)).astype(np.int32)
    mask = (rng.random((B, T)) > 0.3).astype(np.float32)
    g_loss = np.float32(0.7)
    g_tok = (rng.standard_normal((B, T)) * 0.01).astype(np.float32)

    (jloss, jtok), vjp = jax.vjp(
        lambda lg: jce.cross_entropy_loss(lg, jnp.asarray(tgt),
                                          jnp.asarray(mask)), jl)
    (jd,) = vjp((jnp.asarray(g_loss), jnp.asarray(g_tok)))

    tl = tl.requires_grad_(True)
    tloss, ttok = tce.cross_entropy_loss(tl, torch.from_numpy(tgt),
                                         torch.from_numpy(mask))
    (td,) = torch.autograd.grad((tloss, ttok), tl, (torch.tensor(g_loss),
                                                    torch.from_numpy(g_tok)))
    assert abs(float(tloss.detach()) - float(jloss)) < 1e-5
    np.testing.assert_allclose(f32(ttok), f32(jtok), atol=1e-5)
    assert td.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(td), f32(jd), atol=1e-6)


# ---------------------------------------------------------------------------
# (d) schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["static", "fix", "cosine", "cosine_epoch",
                                  "wsd", "tri_line"])
def test_lr_at_matches_jax(kind):
    """Every schedule at steps across warmup, the body and past the end.
    The JAX package computes in f32, the port in Python floats: rtol 1e-6
    (measured <= 3e-7)."""
    kw = dict(kind=kind, base_lr=6e-4, total_steps=100, warmup=10,
              min_ratio=0.1, epoch_steps=30)
    for step in (0, 1, 5, 10, 11, 29, 30, 47, 90, 99, 100, 150):
        j = float(jsched.lr_at(step, **kw))
        t = tsched.lr_at(step, **kw)
        assert t == pytest.approx(j, rel=1e-6, abs=1e-12), (step, t, j)
    with pytest.raises(ValueError):
        tsched.lr_at(0, kind="nope", base_lr=1.0, total_steps=1)


# ---------------------------------------------------------------------------
# (e) stochastic rounding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(257,), (33, 65)])
def test_stochastic_round_bit_exact_given_the_seed(shape):
    """The murmur3 bits are the same given the uint32 seed that
    ``jax.random.bits`` draws on the JAX side: bit for bit."""
    x = (np.random.default_rng(1).standard_normal(shape) * 0.3
         ).astype(np.float32)
    key = jax.random.PRNGKey(5)
    seed = int(jax.random.bits(key, (), jnp.uint32))
    j = np.asarray(jopt.stochastic_round(jnp.asarray(x), key, jnp.bfloat16))
    t = topt.stochastic_round(torch.from_numpy(x), seed, torch.bfloat16)
    assert np.array_equal(j.view(np.uint16),
                          t.view(torch.int16).numpy().view(np.uint16))
    # and it is not round-to-nearest everywhere
    rtn = torch.from_numpy(x).to(torch.bfloat16)
    assert not torch.equal(t, rtn)


# ---------------------------------------------------------------------------
# (f) AdamW / Muon updates, (g) orthogonalization
# ---------------------------------------------------------------------------

def _tiny_tree(rng):
    return {"w": rng.standard_normal((64, 96)).astype(np.float32) * 0.1,
            "layers": [{"ln": np.ones(96, np.float32),
                        "b": rng.standard_normal(96).astype(np.float32)}],
            "wte": rng.standard_normal((80, 64)).astype(np.float32) * 0.1}


@pytest.mark.parametrize("optimizer,moments", [("adamw", "f32"),
                                               ("adamw", "bf16"),
                                               ("muon", "f32")])
def test_apply_updates_match_jax(optimizer, moments):
    """One step over a tiny tree (bf16 params) from nonzero moments, step 3,
    with the global clip active and one entry forced over T_SPIKE.
    Params are bf16 after f32 math on both sides: 1 bf16 ulp of |p| (AdamW
    measured 0; Muon's bf16 Newton–Schulz differs by ~1e-3 in u, so 2e-3
    absolute on params of O(0.1) for Muon). Moments: f32 2e-6, bf16 1 ulp."""
    rng = np.random.default_rng(2)
    mdt = jnp.bfloat16 if moments == "bf16" else jnp.float32
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                    _tiny_tree(rng))
    grads = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a * 30, jnp.bfloat16), _tiny_tree(rng))
    opt = jopt.init_opt_state(params, optimizer, moments)
    m = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a * 0.01, mdt), _tiny_tree(rng))
    v = jax.tree_util.tree_map(
        lambda a, p: (jnp.asarray(np.abs(a) * 1e-3, mdt) if p.size
                      else p), _tiny_tree(rng), opt.v)
    m = jax.tree_util.tree_map(lambda a, p: a.at[(0,) * a.ndim].set(5.0)
                               if a.ndim == 1 and a.size == 96 else a, m,
                               params)
    v = jax.tree_util.tree_map(lambda a: a.at[(0,) * a.ndim].set(1e-12)
                               if a.ndim == 1 and a.size == 96 else a, v)
    opt = jopt.OptState(m=m, v=v, step=jnp.asarray(2, jnp.int32),
                        spikes=jnp.asarray(1, jnp.int32))
    kw = dict(optimizer=optimizer, lr=1e-2, grad_clip=1.0)
    jp, jo, jm = jopt.apply_updates(params, grads, opt, **kw)

    tp = params_from_numpy(jax_tree_to_numpy(params), device="cpu")
    tg = params_from_numpy(jax_tree_to_numpy(grads), device="cpu")
    to = opt_state_from_numpy(dict(m=jax_tree_to_numpy(opt.m),
                                   v=jax_tree_to_numpy(opt.v),
                                   step=np.asarray(opt.step),
                                   spikes=np.asarray(opt.spikes)),
                              device="cpu")
    tp, to, tm = topt.apply_updates(tp, tg, to, **kw)
    assert to.step == 3 and int(to.spikes) == int(jo.spikes)
    assert int(tm["spikes"]) == int(jm["spikes"]) >= 1
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-5)
    p_tol = 2e-3 if optimizer == "muon" else 0.0
    for a, b in zip(leaves(tp), jax.tree_util.tree_leaves(jp)):
        b = f32(b)
        ulp = np.abs(b) * 2.0 ** -7
        assert np.all(np.abs(f32(a) - b) <= ulp + p_tol)
    for tree_t, tree_j in ((to.m, jo.m), (to.v, jo.v)):
        for a, b in zip(leaves(tree_t), jax.tree_util.tree_leaves(tree_j)):
            a, b = f32(a), f32(b)
            tol = (np.maximum(np.abs(a), np.abs(b)) * 2.0 ** -7
                   + 1e-7 * np.abs(b).max() if moments == "bf16" else 2e-6)
            assert np.all(np.abs(a - b) <= tol)


def test_adamw_update_with_sr_seed_is_exactly_stochastic_round():
    """With a seed, the parameter writeback is ``stochastic_round`` of the
    f32 update (tag 0 stream); without, round-to-nearest."""
    rng = np.random.default_rng(3)
    p = torch.from_numpy(rng.standard_normal(500).astype(np.float32)
                         ).to(torch.bfloat16)
    g = torch.from_numpy(rng.standard_normal(500).astype(np.float32))
    m = torch.zeros(500)
    v = torch.zeros(500)
    kw = dict(lr=1e-3, beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.0,
              step=1)
    rtn, *_ = topt.adamw_update(p, g, m, v, **kw)
    sr, *_ = topt.adamw_update(p, g, m, v, sr_seed=1234, **kw)
    upd, *_ = topt.adamw_update(p.float(), g, m, v, **kw)    # f32 storage
    assert torch.equal(rtn, upd.to(torch.bfloat16))
    assert torch.equal(sr, topt.stochastic_round(
        upd, topt._tag_seed(1234, 0), torch.bfloat16))
    assert not torch.equal(sr, rtn)


@pytest.mark.parametrize("moments", ["f32", "bf16"])
def test_apply_updates_equals_the_per_leaf_update(moments):
    """apply_updates runs AdamW for all leaves at once with
    torch._foreach_*: the same bits as adamw_update leaf by leaf, SR on
    (clip inactive, so the grads are unscaled)."""
    rng = np.random.default_rng(6)
    def tree(scale):
        return tree_map(lambda a: torch.from_numpy(a * scale).to(
            torch.bfloat16), _tiny_tree(rng))

    params, grads = tree(1.0), tree(0.5)
    opt = topt.init_opt_state(params, "adamw", moments)
    for t in leaves(opt.m) + leaves(opt.v):
        t.copy_(torch.from_numpy(rng.standard_normal(t.shape)
                                 .astype(np.float32)).abs() * 1e-3)
    ref_p = [p.clone() for p in leaves(params)]
    ref_m = [m.clone() for m in leaves(opt.m)]
    ref_v = [v.clone() for v in leaves(opt.v)]
    seeds = list(range(100, 100 + len(ref_p)))
    spikes = 0
    for i, (p, g) in enumerate(zip(ref_p, leaves(grads))):
        p2, m2, v2, sp = topt.adamw_update(
            p, g.float(), ref_m[i], ref_v[i], lr=1e-2, beta1=0.9,
            beta2=0.95, eps=1e-8, weight_decay=0.1 if p.dim() >= 2 else 0.0,
            step=1, sr_seed=seeds[i])
        ref_p[i], ref_m[i], ref_v[i] = p2, m2, v2
        spikes += int(sp)
    _, opt2, met = topt.apply_updates(params, grads, opt, optimizer="adamw",
                                      lr=1e-2, grad_clip=1e9, sr_seeds=seeds)
    assert int(met["spikes"]) == spikes
    for got, ref in ((leaves(params), ref_p), (leaves(opt2.m), ref_m),
                     (leaves(opt2.v), ref_v)):
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("shape", [(96, 64), (64, 80)])
def test_orthogonalization_matches_jax(shape):
    """Newton–Schulz runs five bf16 iterations on both sides, and XLA fuses
    the elementwise chain (one rounding) where PyTorch rounds each op: the
    results differ by 7 % in Frobenius norm (measured 0.068), so they are
    held to 10 % and both must be near-orthogonal (singular values in the
    quintic's band, 0.6-1.25). Chebyshev runs in f32: 1e-4 (measured
    ~1e-6)."""
    G = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    j = f32(jopt.newton_schulz(jnp.asarray(G)))
    t = f32(topt.newton_schulz(torch.from_numpy(G)))
    assert np.linalg.norm(t - j) <= 0.1 * np.linalg.norm(j)
    sv = np.linalg.svd(t, compute_uv=False)
    assert 0.6 <= sv.min() and sv.max() <= 1.25, sv
    j = f32(jopt.chebyshev_orth(jnp.asarray(G)))
    t = f32(topt.chebyshev_orth(torch.from_numpy(G)))
    assert np.abs(t - j).max() <= 1e-4, np.abs(t - j).max()
    assert topt._cheb_cubic_schedule() == pytest.approx(
        jopt._cheb_cubic_schedule())


# ---------------------------------------------------------------------------
# model_forward remat, compute_loss dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [True, "dots"])
def test_remat_gives_the_same_grads(remat):
    """Recompute in the backward changes no value: loss and every gradient
    equal the remat=False run exactly (the same ops run again)."""
    card = ModelCard.from_arch("QWEN3", n_kv_head=1, **TINY)
    params = init_params(card, device="cpu", seed=1)
    for p in leaves(params):
        p.requires_grad_(True)
    tok = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (2, 17)))

    def grads(r):
        loss, _ = ttrainer.compute_loss(card, params, tok, remat=r,
                                        fused_ce=True)
        return [loss] + list(torch.autograd.grad(loss, leaves(params)))

    for a, b in zip(grads(False), grads(remat)):
        assert torch.equal(a, b)


def test_compute_loss_raises_for_unported_paths():
    """``compute_loss`` refuses nothing the JAX package takes any more.
    Sequence-parallel steps are ported: ``sp`` takes an ``SPPolicy``
    (anything else is a TypeError; ``tests/test_torch_sp_train.py`` holds
    the step to JAX's). SALMON and GUPPY training are ported (the model
    zoo): each gives a finite loss, SALMON's the diffusion ELBO and not
    the next-token CE (``tests/test_torch_zoo_guppy_salmon.py`` holds both
    to JAX). Scale-only (gama) QAT is ported: its QuantCard applies no fake
    quantization, so the loss of plain params is the loss without a
    QuantCard, bit for bit."""
    from koifish_tpu_torch.ops.tracectx import SPPolicy
    from koifish_tpu_torch.parallel import make_mesh
    card = ModelCard.from_arch("QWEN3", n_kv_head=1, **TINY)
    params = init_params(card, device="cpu")
    tok = torch.zeros((1, 5), dtype=torch.long)
    with pytest.raises(TypeError, match="SPPolicy"):
        ttrainer.make_train_step(card, TrainCard(), 10, sp=object())
    assert callable(ttrainer.make_train_step(
        card, TrainCard(), 10,
        sp=SPPolicy("sp", make_mesh({"sp": 2}, devices="cpu"))))
    ce = ttrainer.compute_loss(card, params, tok)[0]
    for arch in ("SALMON", "GUPPY"):
        zoo = dataclasses.replace(card, arch=arch)
        loss = ttrainer.compute_loss(zoo, params, tok)[0]
        assert bool(torch.isfinite(loss))
        assert (float(loss) != float(ce)) == (arch == "SALMON")
    gama = QuantCard.from_json({"self_attn": {"bits": 4},
                                "train_target": "gama"})
    loss, _ = ttrainer.compute_loss(card, params, tok, qcard=gama)
    assert torch.equal(loss, ttrainer.compute_loss(card, params, tok)[0])


# ---------------------------------------------------------------------------
# (h) loss curves, and the train loop's contracts
# ---------------------------------------------------------------------------

def _batches(n, B, T, V, seed=9):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, V, (1, B, T + 1)).astype(np.int32)
            for _ in range(n)]


@pytest.mark.parametrize("arch,fused_ce", [("QWEN3", True), ("QWEN3", False),
                                           ("GPT2", None)])
def test_loss_curve_matches_jax(arch, fused_ce):
    """20 AdamW steps, SR off, from the same init (the JAX init carried over
    with params_from_numpy) on the same 4 batches cycled. The JAX side runs
    its XLA paths; the port runs FlashAttention and (fused_ce=True) FusedCE
    through their plain versions. bf16 activations round at other points
    in the two packages, and the curves drift apart slowly: 1e-2 absolute
    on losses of 5.6 -> 3.8-4.1 (measured <= 2.2e-3)."""
    steps, B, T = 20, 4, 32
    card_kw = dict(TINY, n_kv_head=ARCH_KV[arch])
    jcard = JModelCard.from_arch(arch, **card_kw)
    card = ModelCard.from_arch(arch, **card_kw)
    tkw = dict(batch=B, lr=3e-3, warmup=2, fused_ce=fused_ce,
               stochastic_round=False, dump_every=0)
    jstate = jtrainer.init_train_state(jcard, JTrainCard(**tkw))
    params = params_from_numpy(jax_tree_to_numpy(jstate.params), device="cpu")
    data = _batches(4, B, T, card.vocab_size)
    _, jinfo = jtrainer.train_loop(
        jcard, JTrainCard(**tkw), jstate,
        iter([{"tokens": jnp.asarray(data[i % 4])} for i in range(steps)]),
        total_steps=steps, log_fn=None)
    tcard = TrainCard(**tkw)
    state = ttrainer.init_train_state(card, tcard, params=params)
    _, tinfo = ttrainer.train_loop(
        card, tcard, state,
        iter([{"tokens": torch.from_numpy(data[i % 4]).long()}
              for i in range(steps)]),
        total_steps=steps, log_fn=None)
    jl, tl = np.array(jinfo.losses), np.array(tinfo.losses)
    assert len(tl) == steps and tl[-1] < tl[0] - 1.0
    assert np.abs(tl - jl).max() <= 1e-2, np.abs(tl - jl).max()


def test_grad_accumulation_and_trainable_mask():
    """A = 2 micro-batches average their f32-summed grads: the same step as
    one batch of both halves' mean loss (equal-size halves), within bf16
    grad rounding; frozen leaves stay untouched."""
    card = ModelCard.from_arch("QWEN3", n_kv_head=1, **TINY)
    data = torch.from_numpy(_batches(1, 4, 16, 256)[0]).long()
    tcard = TrainCard(batch=2, lr=1e-3, warmup=0, scheduler="static",
                      stochastic_round=False, check_tensor_norm=True)
    base = init_params(card, device="cpu", seed=3)
    frozen_before = base["layers"][0]["q"].clone()

    def run(tokens, trainable=None):
        params = {k: ([{n: t.clone() for n, t in lp.items()} for lp in v]
                      if k == "layers" else v.clone())
                  for k, v in base.items()}
        st = ttrainer.init_train_state(card, tcard, params=params)
        step = ttrainer.make_train_step(card, tcard, 10, trainable=trainable)
        return step(st, {"tokens": tokens})

    _, m_acc = run(data.reshape(2, 2, 17))
    _, m_one = run(data)
    assert float(m_acc["loss"]) == pytest.approx(float(m_one["loss"]),
                                                 rel=1e-5)
    assert float(m_acc["grad_norm"]) == pytest.approx(
        float(m_one["grad_norm"]), rel=2e-2)
    trainable = {k: ([{n: not (i == 0 and n == "q") for n in lp}
                      for i, lp in enumerate(v)] if k == "layers" else True)
                 for k, v in base.items()}
    st, m = run(data, trainable)
    assert torch.equal(st.params["layers"][0]["q"], frozen_before)
    assert not torch.equal(st.params["layers"][1]["q"], base["layers"][1]["q"])
    assert m["leaf_norms"].shape == (len(leaves(base)),)


def test_train_loop_instability_saves_and_raises():
    """An absurd lr drives the loss out of (0, 100): the emergency save_fn
    runs and TrainingInstability is raised (gLLM.cpp:780)."""
    card = ModelCard.from_arch("QWEN3", n_kv_head=1, **TINY)
    tcard = TrainCard(batch=2, lr=1e4, warmup=0, grad_clip=1e9,
                      stochastic_round=False, scheduler="static", dump_every=0)
    state = ttrainer.init_train_state(card, tcard, device="cpu")
    saved = []
    batches = [{"tokens": torch.from_numpy(b).long()}
               for b in _batches(6, 2, 16, 256)]
    with pytest.raises(ttrainer.TrainingInstability):
        ttrainer.train_loop(card, tcard, state, iter(batches), 6,
                            log_fn=None,
                            save_fn=lambda s, it, why: saved.append(why))
    assert saved == ["emergency"]


def test_train_loop_cadences_and_mfu():
    """most_iter stops the loop; hook_fn runs every step; eval_fn at
    eval_every; the log line carries the loss. MFU: the same FLOP count as
    the JAX package, the H100 SXM peak by device name, None on the CPU."""
    card = ModelCard.from_arch("GPT2", n_kv_head=2, **TINY)
    tcard = TrainCard(batch=2, lr=1e-3, warmup=0, most_iter=3, eval_every=2,
                      dump_every=1, stochastic_round=True)
    state = ttrainer.init_train_state(card, tcard, device="cpu")
    hooks, evals, logs = [], [], []
    batches = [{"tokens": torch.from_numpy(b).long()}
               for b in _batches(5, 2, 16, 256)]
    _, info = ttrainer.train_loop(
        card, tcard, state, iter(batches), 10, log_fn=logs.append,
        eval_fn=lambda s, it: evals.append(it),
        hook_fn=lambda s, it, loss: hooks.append(it))
    assert len(info.rows) == 3 and hooks == [0, 1, 2] and evals == [2]
    assert all("loss=" in ln for ln in logs) and len(logs) == 3
    jcard = JModelCard.from_arch("GPT2", n_kv_head=2, **TINY)
    assert tmfu.train_step_flops(card, 1000) == jmfu.train_step_flops(
        jcard, 1000)
    assert tmfu.chip_peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert tmfu.chip_peak_flops("NVIDIA H100 PCIe") == 756e12
    if not torch.cuda.is_available():
        assert tmfu.chip_peak_flops() is None
        assert tmfu.step_mfu(card, 1000, 0.1) is None
    assert math.isclose(tmfu.step_mfu(card, 1000, 0.1, peak=1e12),
                        tmfu.train_step_flops(card, 1000) / 0.1 / 1e12)
