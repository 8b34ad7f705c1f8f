"""PyTorch port vs the JAX package: Mamba (``models/mamba.py``), the block,
its scan, the model's causality, a loss curve and the ``koifish`` CLI.

Tiny cards (2 layers, E 64: Ei 128, dt_rank 4, N 16), inputs and weights
from seeds (JAX inits carried across with ``params_from_numpy``), one
intra-op torch thread. The JAX side runs on the CPU (its scan is XLA's
``associative_scan``); the port with ``device="cpu"``.

Tolerances. The scan is f32 on both sides and pairs the terms as XLA's
odd-even ``associative_scan`` does, though XLA may fuse a product and a
sum into one rounding: y agrees within 1e-5 of its largest entry
(measured 1.7e-7 at T 1024), and within 1e-5 of the step-by-step loop's,
gradients too. The block's output is bf16: the two packages' bf16 matmuls
round at other points, so it agrees within 2^-6 of the largest output
(two bf16 ulps; measured 8.4e-5), its gradients within 2 % of each leaf's
largest entry (measured 1.5e-2 on ``conv_w``, a bf16 gradient summed over
the B·T positions; 1.4e-4 or less on the projections)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koifish_tpu.config import ModelCard as JModelCard
from koifish_tpu.config import TrainCard as JTrainCard
from koifish_tpu.models import init_params as j_init_params
from koifish_tpu.models import model_forward as j_model_forward
from koifish_tpu.models.mamba import init_mamba_layer as j_init_mamba
from koifish_tpu.models.mamba import mamba_block as j_mamba_block
from koifish_tpu.train.trainer import init_train_state as j_init_state
from koifish_tpu.train.trainer import train_loop as j_train_loop

from koifish_tpu_torch.config import ModelCard, TrainCard
from koifish_tpu_torch.io.convert import (params_from_numpy,
                                          train_state_from_numpy)
from koifish_tpu_torch.models import mamba as tmamba
from koifish_tpu_torch.models.transformer import init_params, model_forward
from koifish_tpu_torch.train.trainer import train_loop

from torch_helpers import (bf16_pair, f32, jax_train_state_to_numpy,
                           jax_tree_to_numpy, torch_threads, zoo_cli_losses)

CARD = dict(vocab_size=128, n_layer=2, n_embd=64, n_head=4, n_kv_head=4,
            head_dim=16, n_ffn=128, n_ctx=32, max_pos=64)
SCAN_TOL = 1e-5
BLOCK_TOL = 2.0 ** -6
GRAD_TOL = 2e-2
LOGIT_TOL = 2e-2
CURVE_TOL = 1e-2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with torch_threads(1):
        yield


def _cards():
    return (JModelCard.from_arch("MAMBA", **CARD),
            ModelCard.from_arch("MAMBA", **CARD))


def _scan_inputs(B, T, ei, n, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    u, Bm, Cm = f(B, T, ei), f(B, T, n), f(B, T, n)
    dt = np.log1p(np.exp(f(B, T, ei) - 2.0)).astype(np.float32)   # > 0
    A = -np.exp(f(ei, n) * 0.5).astype(np.float32)                # < 0
    return u, dt, A, Bm, Cm


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("T", [1, 13, 64])
def test_selective_scan_matches_jax_scan_and_the_loop(T):
    """y = Σ_n h·C of the port's scan against JAX's ``associative_scan``
    (the combine of ``koifish_tpu/models/mamba.py``) on the same a, b, and
    against the port's step-by-step loop, forward and every gradient."""
    u, dt, A, Bm, Cm = _scan_inputs(2, T, 8, 4, seed=T)
    a = jnp.exp(jnp.asarray(dt)[..., None] * jnp.asarray(A)[None, None])
    b = (jnp.asarray(dt) * jnp.asarray(u))[..., None] \
        * jnp.asarray(Bm)[:, :, None, :]

    def combine(left, right):
        return left[0] * right[0], left[1] * right[0] + right[1]

    _, h = jax.lax.associative_scan(combine, (a, b), axis=1)
    jy = np.asarray(jnp.einsum("btun,btn->btu", h, jnp.asarray(Cm)))

    ts = [torch.from_numpy(x).requires_grad_(True)
          for x in (u, dt, A, Bm, Cm)]
    y = tmamba.selective_scan(*ts)
    assert _rel(y.detach(), jy) < SCAN_TOL
    gy = torch.from_numpy(_scan_inputs(2, T, 8, 4, seed=99)[0])
    g = torch.autograd.grad((y * gy).sum(), ts)
    ref = tmamba.scan_ref(*ts)
    assert _rel(y.detach(), ref.detach()) < SCAN_TOL
    g_ref = torch.autograd.grad((ref * gy).sum(), ts)
    for name, x, r in zip(("u", "dt", "A", "B", "C"), g, g_ref):
        assert _rel(x, r) < SCAN_TOL, name


@pytest.mark.parametrize("reverse", [False, True])
def test_scan_recursion_matches_the_loop(reverse):
    """The odd-even recursion against the step-by-step recurrence in f64,
    forward and reversed, for every T from 1 to 33 (even and odd lengths
    at every level of the recursion)."""
    rng = np.random.default_rng(5)
    for n in range(1, 34):
        a = torch.from_numpy(rng.uniform(0.05, 0.95, (2, n, 3, 2)))
        b = torch.from_numpy(rng.standard_normal((2, n, 3, 2)))
        h, ref = torch.zeros_like(b[:, 0]), torch.empty_like(b)
        for t in (range(n - 1, -1, -1) if reverse else range(n)):
            h = a[:, t] * h + b[:, t]
            ref[:, t] = h
        got = tmamba._scan(a, b, reverse=reverse)
        assert torch.allclose(got, ref, rtol=0, atol=1e-12), n


def test_selective_scan_keeps_no_state_sized_tensor():
    """The scan saves its inputs only: nothing of size [B, T, Ei, N] is
    kept for the backward, where autograd through the loop keeps a and b
    (and an h a step)."""
    B, T, ei, n = 2, 16, 8, 4
    ts = [torch.from_numpy(x).requires_grad_(True)
          for x in _scan_inputs(B, T, ei, n, seed=3)]
    for fn, want_big in ((tmamba.selective_scan, False),
                         (tmamba.scan_ref, True)):
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append(t.numel()) or t, lambda t: t):
            fn(*ts)
        assert (max(saved) >= B * T * ei * n) == want_big, (fn, max(saved))
        assert (max(saved) <= B * T * ei) != want_big


def test_mamba_block_matches_jax():
    """``mamba_block`` on the same bf16 input and the JAX init's layer:
    the output and the gradients of every leaf and of x (jax.grad of the
    same weighted sum)."""
    jcard, card = _cards()
    jlp = j_init_mamba(jcard, jax.random.PRNGKey(3))
    tlp = params_from_numpy(jax_tree_to_numpy(jlp), device="cpu")
    rng = np.random.default_rng(4)
    jx, tx = bf16_pair(rng.standard_normal((2, 16, 64)).astype(np.float32))
    cot = rng.standard_normal((2, 16, 64)).astype(np.float32)

    def jloss(lp, x):
        out = j_mamba_block(jcard, lp, x)
        return jnp.sum(out.astype(jnp.float32) * cot), out

    (_, jout), (jg_lp, jg_x) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jlp, jx)
    for t in tlp.values():
        t.requires_grad_(True)
    tx.requires_grad_(True)
    out = tmamba.mamba_block(card, tlp, tx)
    assert out.dtype == torch.bfloat16 and out.shape == tx.shape
    assert _rel(f32(out), f32(jout)) < BLOCK_TOL
    grads = torch.autograd.grad((out.float() * torch.from_numpy(cot)).sum(),
                                list(tlp.values()) + [tx])
    for (name, _), g in zip(list(tlp.items()) + [("x", None)], grads):
        jg = jg_x if name == "x" else jg_lp[name]
        assert _rel(f32(g), f32(jg)) < GRAD_TOL, name


def test_mamba_model_matches_jax_and_is_causal():
    """``init_params`` builds the JAX package's layers; logits agree; a
    later token does not move an earlier position's logits
    (``tests/test_models.py:170-205``)."""
    jcard, card = _cards()
    jp = j_init_params(jcard, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax_tree_to_numpy(jp), device="cpu")
    own = init_params(card, device="cpu")
    assert sorted(own) == sorted(jp)
    for ol, jl in zip(own["layers"], jp["layers"]):
        assert sorted(ol) == sorted(jl)
        for k in ol:
            assert tuple(ol[k].shape) == jl[k].shape, k
    tokens = np.random.default_rng(1).integers(0, 128, (2, 16))
    jl = f32(jax.jit(lambda p, x: j_model_forward(jcard, p, x))(
        jp, jnp.asarray(tokens, jnp.int32)))
    t = torch.from_numpy(tokens)
    l1 = f32(model_forward(card, tp, t))
    assert l1.shape == (2, 16, 128) and np.isfinite(l1).all()
    np.testing.assert_allclose(l1, jl, rtol=0, atol=LOGIT_TOL)
    t2 = t.clone()
    t2[0, 10] = (t2[0, 10] + 1) % 128
    l2 = f32(model_forward(card, tp, t2))
    np.testing.assert_allclose(l1[0, :10], l2[0, :10], rtol=1e-4, atol=1e-4)
    assert np.abs(l1[0, 10:] - l2[0, 10:]).max() > 0


def test_mamba_trains_like_jax():
    """5 steps of ``train_loop`` (SR off, bf16-logits CE: V < 65,536), the
    loss curve within 1e-2 of the JAX package's, with and without remat."""
    jcard, card = _cards()
    tkw = dict(batch=4, lr=1e-2, warmup=2, stochastic_round=False)
    rng = np.random.default_rng(7)
    batches = [rng.integers(0, 128, (1, 4, 17)).astype(np.int32)
               for _ in range(5)]
    jstate = j_init_state(jcard, JTrainCard(**tkw))
    jnp_state = jax_train_state_to_numpy(jstate)
    _, jinfo = j_train_loop(jcard, JTrainCard(**tkw), jstate,
                            [{"tokens": jnp.asarray(b)} for b in batches],
                            total_steps=5, log_fn=None)
    for remat in (False, True):
        tstate = train_state_from_numpy(jnp_state, device="cpu")
        _, tinfo = train_loop(card, TrainCard(remat=remat, **tkw), tstate,
                              [{"tokens": torch.from_numpy(b).long()}
                               for b in batches], total_steps=5,
                              log_fn=None)
        np.testing.assert_allclose(tinfo.losses, jinfo.losses, rtol=0,
                                   atol=CURVE_TOL, err_msg=str(remat))


@pytest.mark.parametrize("remat", [True, "dots"])
def test_mamba_remat_recomputes_around_the_scan(monkeypatch, remat):
    """Under remat a Mamba layer runs its scan once in the forward and
    twice in the backward (the state rebuilt, the adjoint), as without
    remat: the projections around it are recomputed, the scan is not. The
    loss and every gradient equal the run without remat exactly."""
    _, card = _cards()
    params = init_params(card, device="cpu", dtype=torch.float32)
    tokens = torch.from_numpy(
        np.random.default_rng(2).integers(0, 128, (2, 16)))
    calls = []
    scan = tmamba._scan
    monkeypatch.setattr(tmamba, "_scan",
                        lambda *a, **kw: calls.append(1) or scan(*a, **kw))
    leaves = [t for lp in params["layers"] for t in lp.values()]
    out = {}
    for r in (False, remat):
        calls.clear()
        for t in leaves:
            t.grad = None
            t.requires_grad_(True)
        loss = model_forward(card, params, tokens, remat=r).float().square(
            ).mean()
        assert len(calls) == card.n_layer
        grads = torch.autograd.grad(loss, leaves)
        assert len(calls) == 3 * card.n_layer, (r, len(calls))
        out[r] = (loss.detach(), grads)
    assert torch.equal(out[False][0], out[remat][0])
    for g0, g1 in zip(out[False][1], out[remat][1]):
        assert torch.equal(g0, g1)


def test_koifish_mamba_cli_matches_jax(tmp_path, monkeypatch):
    """``koifish`` on a tiny MAMBA config (``tests/test_cli.py``'s shape),
    the port from the JAX init: the loss curve within 1e-2 of the JAX
    CLI's, and falling."""
    jl, tl, res = zoo_cli_losses(tmp_path, monkeypatch, "MAMBA")
    assert res["card"].arch == "MAMBA"
    assert len(tl) == len(jl) == 6
    np.testing.assert_allclose(tl, jl, rtol=0, atol=CURVE_TOL)
    assert tl[-1] < tl[0]
