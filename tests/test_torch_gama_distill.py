"""Gama (scale-only) training and distillation in the port against the JAX
package, on the CPU at tiny sizes.

Gama: ``QMatmul``'s backward (dx, and dscales / dbook through ``dW =
x2ᵀ·dy``) against ``jax.vjp`` of the JAX ``qmatmul`` and against the port's
own CPU autograd through the plain version; a 12-step gama curve (SR off)
and the gama CLI against the JAX package's. Distillation: ``DistillSchedule``,
``kd_loss`` and ``distill_step_loss`` (values and the student's gradients).
Inputs are made with numpy from seeds and handed to both packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koifish_tpu.config import ModelCard as JModelCard
from koifish_tpu.config import QuantCard as JQuantCard
from koifish_tpu.config import TrainCard as JTrainCard
from koifish_tpu.models import init_params as j_init_params
from koifish_tpu.ops.matmul import qmatmul as j_qmatmul
from koifish_tpu.quant import cluster as jcl
from koifish_tpu.train import distill as jdistill
from koifish_tpu.train import lora as jlora
from koifish_tpu.train import trainer as jtrainer

from koifish_tpu_torch.config import QuantCard, TrainCard
from koifish_tpu_torch.io.convert import params_from_numpy, qtensor_from_numpy
from koifish_tpu_torch.ops.kernels import matmul as km
from koifish_tpu_torch.quant.qtensor import QTensor
from koifish_tpu_torch.train import distill as tdistill
from koifish_tpu_torch.train import lora as tlora
from koifish_tpu_torch.train import trainer as ttrainer
from koifish_tpu_torch.utils.tree import flatten_with_path, leaves

from helpers import make_hf_qwen3_dir
from torch_helpers import (INT4_RULES, bf16_pair, f32, jax_tree_to_numpy,
                           tiny_models, torch_threads)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


K, N, M = 256, 64, 24


def _weights(kind: str, seed: int):
    """(JAX QTensor, the same QTensor in the port): RTN INT4 / INT8 at g128,
    or a k-means / MINI book on an NF4 layout."""
    from koifish_tpu.dtypes import QFormat as JQFormat
    from koifish_tpu.quant.rtn import quantize as j_quantize
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((K, N)) * 0.02).astype(np.float32)
    if kind in ("kmeans", "mini"):
        q = jcl.quantize_kmeans if kind == "kmeans" else jcl.quantize_mini
        jw = q(jnp.asarray(w), bits=4)
    else:
        jw = j_quantize(jnp.asarray(w), JQFormat(kind), group=128)
    return jw, qtensor_from_numpy(jax_tree_to_numpy(jw), "cpu")


def _jax_vjp(jw, jx, jdy):
    """(dx, dscales, dbook) of the JAX ``qmatmul`` by ``jax.vjp``."""
    book = jw.codebook

    def f(x, s, b):
        return j_qmatmul(x, dataclasses.replace(jw, scales=s, codebook=b))
    _, vjp = jax.vjp(f, jx, jw.scales, book)
    return vjp(jdy)


def _port_grads(tw, tx, tdy, through_function: bool):
    """(dx, dscales, dbook) of the port's product: through ``QMatmul``
    called directly, or through ``qmatmul`` (on the CPU, the plain
    version's autograd for a weight gradient)."""
    x = tx.clone().requires_grad_(True)
    s = tw.scales.detach().clone().requires_grad_(True)
    b = (None if tw.codebook is None
         else tw.codebook.detach().clone().requires_grad_(True))
    w = dataclasses.replace(tw, scales=s, codebook=b)
    if through_function:
        y = km.QMatmul.apply(x, s, b, w)
    else:
        y = km.qmatmul(x, w)
        assert y.grad_fn is not None and not type(
            y.grad_fn).__name__.startswith("QMatmul")
    y.backward(tdy)
    return x.grad, s.grad, None if b is None else b.grad


def _rel(got, ref) -> float:
    got, ref = f32(got), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("kind", ["int4", "int8", "kmeans", "mini"])
def test_qmatmul_weight_grads_match_jax_vjp(kind):
    """``QMatmul`` called directly on CPU tensors: dx, dscales and (k-means
    [16] and MINI [K, 16] books) dbook against ``jax.vjp`` of the JAX
    ``qmatmul`` on the same bf16 x, dy and codes. Both round dW = x2ᵀ·dy
    to bf16 (f32 accumulation) and then sum in f32, so only a summation
    order may differ: 1e-4 of the largest entry (measured <= 1.3e-7)."""
    jw, tw = _weights(kind, seed=len(kind) + 20)
    assert km.takes(tw)
    rng = np.random.default_rng(11)
    jx, tx = bf16_pair(rng.standard_normal((M, K)).astype(np.float32))
    jdy, tdy = bf16_pair(rng.standard_normal((M, N)).astype(np.float32))
    jdx, jds, jdb = _jax_vjp(jw, jx, jdy)
    dx, ds, db = _port_grads(tw, tx, tdy, through_function=True)
    assert ds.shape == tw.scales.shape and ds.dtype == tw.scales.dtype
    assert _rel(dx, jdx) <= 1e-4
    assert _rel(ds, jds) <= 1e-4
    if kind in ("kmeans", "mini"):
        assert db.shape == tw.codebook.shape
        assert _rel(db, jdb) <= 1e-4
    else:
        assert jdb is None and db is None


@pytest.mark.parametrize("kind", ["int4", "kmeans", "mini"])
def test_qmatmul_weight_grads_match_the_cpu_autograd(kind):
    """The new backward against the port's CPU branch (the plain version's
    own autograd, which sums the group products in f32 without rounding
    dW to bf16): dscales and dbook within 2^-7 of the largest entry, one
    bf16 ulp at the top of dW's range (measured <= 3.9e-3)."""
    _, tw = _weights(kind, seed=len(kind) + 30)
    rng = np.random.default_rng(12)
    tx = torch.from_numpy(rng.standard_normal((M, K)).astype(
        np.float32)).to(torch.bfloat16)
    tdy = torch.from_numpy(rng.standard_normal((M, N)).astype(
        np.float32)).to(torch.bfloat16)
    fn = _port_grads(tw, tx, tdy, through_function=True)
    auto = _port_grads(tw, tx, tdy, through_function=False)
    for a, b in zip(fn[1:], auto[1:]):
        if b is not None:
            assert _rel(a, b) <= 2.0 ** -7


def test_trainable_mask_gama_matches_jax():
    """``trainable_mask(params, "gama")`` gives one flag for each leaf of a
    QTensor, all False as in the JAX package (scales train by the float
    rule when no mask is given, as the CLI runs gama)."""
    _, card, jp, tp = tiny_models()
    jm = jax.tree_util.tree_leaves(jlora.trainable_mask(jp, "gama"))
    tm = leaves(tlora.trainable_mask(tp, "gama"))
    assert tm == [bool(x) for x in jm] and not any(tm)
    assert len(tm) == len(leaves(tp)) == len(jax.tree_util.tree_leaves(jp))


def test_tree_flattens_a_qtensor_as_jax_does():
    """``utils.tree`` takes a QTensor's set tensor fields as leaves in JAX's
    order, keyed ".codes", ".scales"; unflatten rebuilds the QTensor."""
    _, _, jp, tp = tiny_models()
    jpaths = [jax.tree_util.keystr(p) for p, _ in
              jax.tree_util.tree_flatten_with_path(jp)[0]]
    tpaths = ["".join(f"[{k!r}]" if not str(k).startswith(".") else str(k)
                      for k in p) for p, _ in flatten_with_path(tp)]
    assert tpaths == jpaths
    from koifish_tpu_torch.utils.tree import unflatten_like
    back = unflatten_like(tp, leaves(tp))
    q = back["layers"][0]["q"]
    assert isinstance(q, QTensor) and q.codes is tp["layers"][0]["q"].codes


def test_gama_loss_curve_matches_jax():
    """The port's version of tests/test_sft_qat.py::test_gama_training on
    the tiny QWEN3 (E 128, INT4 g128 q/k/v/o/gate/up/down, so every layer
    product takes the kernel's plain version): 12 AdamW steps, SR off,
    from the JAX package's quantized init; the curve within 2e-2 (the QAT
    tolerance; measured 7.1e-4), codes bit for bit frozen, every scale
    moved, the loss falling."""
    jcard, card, jp, tp = tiny_models()
    steps, B, T = 12, 8, 32
    tkw = dict(batch=B, lr=3e-3, warmup=2, remat=False, fused_ce=False,
               stochastic_round=False, dump_every=0)
    jq, tq = (JQuantCard.from_json(dict(INT4_RULES, train_target="gama")),
              QuantCard.from_json(dict(INT4_RULES, train_target="gama")))
    rng = np.random.default_rng(9)
    s = rng.integers(0, 64, (steps, B, 1))
    data = [((s[i] + np.arange(T + 1)[None]) % 64)[None].astype(np.int32)
            for i in range(steps)]
    params = params_from_numpy(jax_tree_to_numpy(jp), device="cpu")
    # a copy: the JAX step donates its state, and ``jp`` is shared
    jstate = jtrainer.init_train_state(
        jcard, JTrainCard(**tkw), params=jax.tree_util.tree_map(jnp.array, jp))
    _, jinfo = jtrainer.train_loop(
        jcard, JTrainCard(**tkw), jstate,
        iter([{"tokens": jnp.asarray(d)} for d in data]), total_steps=steps,
        log_fn=None, qcard=jq)
    before = [(p, t.clone()) for p, t in flatten_with_path(params)]
    state = ttrainer.init_train_state(card, TrainCard(**tkw), params=params)
    state, tinfo = ttrainer.train_loop(
        card, TrainCard(**tkw), state,
        iter([{"tokens": torch.from_numpy(d).long()} for d in data]),
        total_steps=steps, log_fn=None, qcard=tq)
    jl, tl = np.array(jinfo.losses), np.array(tinfo.losses)
    assert len(tl) == steps and tl[-1] < tl[0]
    assert np.abs(tl - jl).max() <= 2e-2, np.abs(tl - jl).max()
    after = dict(flatten_with_path(state.params))
    n_scales = 0
    for path, t in before:
        if path[-1] == ".codes":
            assert torch.equal(after[path], t), path
        elif path[-1] == ".scales":
            n_scales += 1
            assert not torch.equal(after[path].detach(), t), path
    assert n_scales == 2 * 7


def test_gama_cli_matches_jax(tmp_path, capsys):
    """The port's version of tests/test_cli.py:248: a gama quantizer card
    (INT4 g32 on self_attn and mlp) through both ``koifish`` CLIs from one
    HF folder, 12 steps, SR off: each prints its QAT mode, the port's curve
    within 2e-2 of the JAX CLI's (measured 4.6e-3)."""
    from test_torch_cli_train import _both, _cfg, _losses, _pattern_shard
    hf = tmp_path / "hf"
    hf.mkdir()
    make_hf_qwen3_dir(hf, JModelCard.from_arch(
        "QWEN3", vocab_size=300, n_layer=2, n_embd=64, n_head=4,
        n_kv_head=2, head_dim=16, n_ffn=128, n_ctx=64, max_pos=256))
    pat = _pattern_shard(tmp_path, 30000)
    cfgp = _cfg(tmp_path, "gama", pat, quantizer={
        "self_attn": {"bits": 4}, "mlp": {"bits": 4}, "group_size": 32,
        "train_target": "gama"}, train={"learning-rate": 0.003,
                                         "warmup": 2}, debug={"most_iter": 12})
    outs = _both(tmp_path, capsys, cfgp, "--hf", str(hf))
    for out in outs.values():
        assert "QAT enabled: gama, " in out
    jl, tl = _losses(tmp_path / "jax"), _losses(tmp_path / "port")
    assert len(tl) == len(jl) == 12 and tl[-1] < tl[0]
    assert np.abs(tl - jl).max() <= 2e-2, np.abs(tl - jl).max()


# ---------------------------------------------------------------------------
# distillation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["cosine", "linear", "static"])
def test_distill_schedule_matches_jax(kind):
    js = jdistill.DistillSchedule(sigma0=0.8, sigma1=0.05, total_steps=37,
                                  kind=kind)
    ts = tdistill.DistillSchedule(sigma0=0.8, sigma1=0.05, total_steps=37,
                                  kind=kind)
    for step in (0, 1, 5, 18, 36, 37, 50):
        a, b = float(js.sigma(step)), float(ts.sigma(step))
        assert abs(a - b) <= 1e-7, (step, a, b)


@pytest.mark.parametrize("masked", [False, True])
def test_kd_loss_and_grad_match_jax(masked):
    """T²·KL(teacher ‖ student) and its gradient for the student logits,
    f32 [2, 5, 300] from a seed: the loss 1e-6 relative, the gradient 1e-5
    of its largest entry (measured 0 and 2.8e-7)."""
    rng = np.random.default_rng(21)
    s = (rng.standard_normal((2, 5, 300)) * 3).astype(np.float32)
    t = (rng.standard_normal((2, 5, 300)) * 3).astype(np.float32)
    m = (rng.random((2, 5)) > 0.4) if masked else None
    jl, jg = jax.value_and_grad(lambda a: jdistill.kd_loss(
        a, jnp.asarray(t), 1.7, None if m is None else jnp.asarray(m)))(
        jnp.asarray(s))
    ts = torch.from_numpy(s).requires_grad_(True)
    tl = tdistill.kd_loss(ts, torch.from_numpy(t), 1.7,
                          None if m is None else torch.from_numpy(m))
    tl.backward()
    tl = tl.detach()
    assert float(tl) > 0
    assert abs(float(tl) - float(jl)) <= 1e-6 * abs(float(jl))
    assert _rel(ts.grad, jg) <= 1e-5


def test_distill_step_loss_matches_jax():
    """``distill_step_loss`` of an INT4 g128 gama student (the tiny QWEN3)
    and its own bf16 teacher, on a masked batch: loss, ce, kd and σ against
    the JAX function, 1e-3 relative (bf16 activations round at other points;
    measured 3.9e-5); kd, the KL between two near-equal distributions (~8e-4
    here), 2e-3 relative (measured 3.5e-4); and the student's scale and embedding gradients
    against ``jax.grad`` within 3 % in norm (the QAT step's 2 %, plus the
    KD term's softmax differences; measured 0.9 %)."""
    jcard, card, jq, tq = tiny_models()
    jteach = j_init_params(jcard, jax.random.PRNGKey(0))
    tteach = params_from_numpy(jax_tree_to_numpy(jteach), device="cpu")
    rng = np.random.default_rng(22)
    tok = rng.integers(0, 256, (2, 17)).astype(np.int32)
    mask = (rng.random((2, 17)) > 0.2)
    sched = dict(sigma0=0.9, sigma1=0.1, total_steps=10, kind="cosine")

    jleaves, treedef = jax.tree_util.tree_flatten(jq)
    isf = [jnp.issubdtype(x.dtype, jnp.floating) for x in jleaves]

    def jf(diff):
        it = iter(diff)
        p = jax.tree_util.tree_unflatten(treedef, [
            next(it) if f else x for x, f in zip(jleaves, isf)])
        return jdistill.distill_step_loss(
            jcard, p, jcard, jteach, jnp.asarray(tok), 3,
            jdistill.DistillSchedule(**sched), temperature=2.0,
            loss_mask=jnp.asarray(mask))
    (jl, jaux), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(
        [x for x, f in zip(jleaves, isf) if f])
    student = params_from_numpy(jax_tree_to_numpy(jq), device="cpu")
    flat = [t for t in leaves(student) if t.is_floating_point()]
    for t in flat:
        t.requires_grad_(True)
    tl, aux = tdistill.distill_step_loss(
        card, student, card, tteach, torch.from_numpy(tok).long(), 3,
        tdistill.DistillSchedule(**sched), temperature=2.0,
        loss_mask=torch.from_numpy(mask))
    grads = torch.autograd.grad(tl, flat)
    for a, b, tol in ((tl, jl, 1e-3), (aux["ce"], jaux["ce"], 1e-3),
                      (aux["kd"], jaux["kd"], 2e-3),
                      (aux["sigma"], jaux["sigma"], 1e-6)):
        a, b = float(a.detach()), float(b)
        assert abs(a - b) <= tol * abs(b), (a, b)
    assert float(aux["kd"].detach()) > 0
    jflat = [np.asarray(x, np.float32) for x in jg]
    assert len(jflat) == len(grads)
    g = np.concatenate([f32(x).ravel() for x in grads])
    j = np.concatenate([x.ravel() for x in jflat])
    assert np.linalg.norm(g - j) <= 3e-2 * np.linalg.norm(j)
