"""PyTorch port vs the JAX package: ``configs/gpt2_1558m.json``, the
shipped GPT2-1558M card that slice 21 trains on the card.

- The config parses to the same model and train cards in both packages,
  field by field: int8 forward matmuls of weights of 4,194,304 elements
  or more (at E 1600 and F 6400: fc, proj and the tied head; q, k, v and
  o are 2,560,000 each and stay bf16), full remat, bf16 moments, and the
  CE by the auto rule (V 50,304 < 65,536: no fused CE).
- A 2-layer cut of that train card at widths the CPU runs (E 128, F 512,
  V 2048), its int8 gate scaled to keep the same weights int8 (fc, proj
  and the head, not the E x E projections), trains the JAX package's curve
  over 4 steps within 2e-2 absolute: the documented int8 drift
  (``tests/test_torch_int8_curves.py``), the JAX Pallas quantizers run in
  interpret mode.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koifish_tpu.config import CLIParams as JCLIParams
from koifish_tpu.ops.pallas import fused_ce as pfce
from koifish_tpu.ops.pallas import qdgrad as pqd
from koifish_tpu.ops.pallas import quantize as pq
from koifish_tpu.train import trainer as jtrainer

from koifish_tpu_torch.config import CLIParams
from koifish_tpu_torch.io.convert import params_from_numpy
from koifish_tpu_torch.ops import tracectx as ttc
from koifish_tpu_torch.train import trainer as ttrainer

from torch_helpers import jax_tree_to_numpy, torch_threads

PATH = "configs/gpt2_1558m.json"
CUT = dict(n_layer=2, n_embd=128, n_head=2, n_kv_head=2, head_dim=64,
           n_ffn=512, vocab_size=2048, n_ctx=32, max_pos=64)
# between the cut's E x E (16,384) and E x F (65,536), as 4,194,304 lies
# between GPT2-1558M's 2,560,000 and 10,240,000
CUT_INT8_MIN_KN = 32768
CURVE_TOL = 2e-2


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


def _fields(card) -> dict:
    return {f.name: getattr(card, f.name) for f in dataclasses.fields(card)}


def test_gpt2_1558m_config_parses_as_in_jax():
    jp, tp = JCLIParams.load(PATH), CLIParams.load(PATH)
    for jc, tc in ((jp.model, tp.model), (jp.train, tp.train)):
        assert _fields(jc) == _fields(tc)
    m, t = tp.model, tp.train
    assert (m.arch, m.n_layer, m.n_embd, m.n_head, m.head_dim, m.n_ffn,
            m.vocab_size) == ("GPT2", 48, 1600, 25, 64, 6400, 50304)
    assert (t.batch, t.remat, t.moment_dtype, t.int8_matmul, t.int8_min_kn,
            t.fused_ce) == (16, True, "bf16", True, 4194304, None)
    pol = ttc.Int8Policy(min_weight_elems=t.int8_min_kn)
    E, F, V = m.n_embd, m.n_ffn, m.vocab_size
    assert [pol.applies(s) for s in ((E, E), (E, F), (F, E), (E, V))] == \
        [False, True, True, True]
    assert tp.seed == jp.seed == 42


def test_gpt2_1558m_cut_curve_matches_jax(interpret):
    """4 steps of the shipped train card (warmup 2 in place of 700, so the
    learning rate moves the weights; SR off to compare curves) on the cut,
    from the JAX init, on 3 seeded batches of B 8 x T 32 cycled."""
    jp, tp = JCLIParams.load(PATH), CLIParams.load(PATH)
    over = dict(warmup=2, stochastic_round=False, dump_every=0, batch=8,
                int8_min_kn=CUT_INT8_MIN_KN)
    jt = dataclasses.replace(jp.train, **over)
    tt = dataclasses.replace(tp.train, **over)
    assert _fields(jt) == _fields(tt)
    jcard = dataclasses.replace(jp.model, **CUT)
    card = dataclasses.replace(tp.model, **CUT)
    jstate = jtrainer.init_train_state(jcard, jt)
    params = params_from_numpy(jax_tree_to_numpy(jstate.params),
                               device="cpu")
    rng = np.random.default_rng(1558)
    data = [rng.integers(0, CUT["vocab_size"], (1, 8, 33)).astype(np.int32)
            for _ in range(3)]
    steps = 4
    _, jinfo = jtrainer.train_loop(
        jcard, jt, jstate,
        iter([{"tokens": jnp.asarray(data[i % 3])} for i in range(steps)]),
        total_steps=steps, log_fn=None)
    with torch_threads(1):
        state = ttrainer.init_train_state(card, tt, params=params)
        _, tinfo = ttrainer.train_loop(
            card, tt, state,
            iter([{"tokens": torch.from_numpy(data[i % 3]).long()}
                  for i in range(steps)]),
            total_steps=steps, log_fn=None)
    jl, tl = np.array(jinfo.losses), np.array(tinfo.losses)
    print("JAX", jl, "port", tl, "gap", np.abs(tl - jl).max())
    assert len(tl) == steps and tl[-1] < tl[0]
    assert np.abs(tl - jl).max() <= CURVE_TOL
