"""PyTorch port vs the JAX package: int8 training curves (moved out of
``tests/test_torch_int8.py``, whose time they set, each case unchanged).

Whole int8 train loops of a tiny GPT2 from the JAX init, the port on the
CPU (its kernels' plain versions) against the jitted JAX step with its
Pallas kernels in interpret mode, as tests/test_pallas.py runs them; the
inputs made with numpy from fixed seeds. Each tolerance is stated with the
value measured beside it (on this CPU)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koifish_tpu.config import ModelCard as JModelCard
from koifish_tpu.config import TrainCard as JTrainCard
from koifish_tpu.ops.pallas import fused_ce as pfce
from koifish_tpu.ops.pallas import qdgrad as pqd
from koifish_tpu.ops.pallas import quantize as pq
from koifish_tpu.train import trainer as jtrainer

from koifish_tpu_torch.config import ModelCard, TrainCard
from koifish_tpu_torch.io.convert import params_from_numpy
from koifish_tpu_torch.train import trainer as ttrainer

from torch_helpers import jax_tree_to_numpy


# tests/test_torch_int8.py's tiny GPT2
TINY_GPT2 = dict(vocab_size=2048, n_layer=2, n_embd=128, n_head=2,
                 n_kv_head=2, head_dim=64, n_ffn=1024, n_ctx=32, max_pos=64)


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


def _curves(jcard, card, tkw, steps, B, T, qcard=None, jqcard=None):
    """(JAX losses, port losses) of ``steps`` AdamW steps from the JAX init
    carried over with params_from_numpy, on 3 seeded batches cycled."""
    jstate = jtrainer.init_train_state(jcard, JTrainCard(**tkw))
    params = params_from_numpy(jax_tree_to_numpy(jstate.params), device="cpu")
    rng = np.random.default_rng(9)
    data = [rng.integers(0, card.vocab_size, (1, B, T + 1)).astype(np.int32)
            for _ in range(3)]
    _, jinfo = jtrainer.train_loop(
        jcard, JTrainCard(**tkw), jstate,
        iter([{"tokens": jnp.asarray(data[i % 3])} for i in range(steps)]),
        total_steps=steps, log_fn=None, qcard=jqcard)
    tcard = TrainCard(**tkw)
    state = ttrainer.init_train_state(card, tcard, params=params)
    _, tinfo = ttrainer.train_loop(
        card, tcard, state,
        iter([{"tokens": torch.from_numpy(data[i % 3]).long()}
              for i in range(steps)]),
        total_steps=steps, log_fn=None, qcard=qcard)
    return np.array(jinfo.losses), np.array(tinfo.losses)


@pytest.mark.parametrize("dgrad", [False, "fold", "tile"])
@pytest.mark.parametrize("remat", [False, True])
def test_int8_loss_curve_matches_jax(interpret, dgrad, remat):
    """8 int8 AdamW steps of a tiny GPT2 (E 128, FFN 1024 so fc's dgrad
    reaches the tile kernel, V 2048, B 8 x T 32) with int8_matmul,
    int8_min_kn 0 (every weight int8), the int8 fused CE and SR off,
    against the jitted JAX step with its Pallas kernels in interpret mode.
    remat=True shows the recompute runs int8 too. The int8 codes flip at
    rounding edges where bf16 activations differ by an ulp, so the curves
    drift a little more than bf16's: 2e-2 absolute on losses of 7.6 ->
    ~6 (measured <= 4e-3)."""
    steps, B, T = 8, 8, 32
    jcard = JModelCard.from_arch("GPT2", **TINY_GPT2)
    card = ModelCard.from_arch("GPT2", **TINY_GPT2)
    tkw = dict(batch=B, lr=3e-3, warmup=2, fused_ce=True, remat=remat,
               stochastic_round=False, dump_every=0, int8_matmul=True,
               int8_min_kn=0, int8_dgrad=dgrad if dgrad != "fold" else True)
    jl, tl = _curves(jcard, card, tkw, steps, B, T)
    assert len(tl) == steps and tl[-1] < tl[0] - 0.5
    assert np.abs(tl - jl).max() <= 2e-2, np.abs(tl - jl).max()
