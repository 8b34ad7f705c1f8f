"""PyTorch port vs the JAX package: the book-weight serving paths that
slice 21 runs on the card, at the tiny size.

- ``ContinuousBatcher`` over a BF16 cache with k-means NF4 weights (the
  batcher's per-lane slot writes): every request's tokens equal the JAX
  batcher's.
- ``generate`` over MINI NF3 per-row books and Sinkhorn INT4 weights
  (``quantize_params`` with MINI and SNQ rules, quantized by the JAX
  package and carried across): every step's logits within the book
  tolerance, 2 % of the step's largest logit (the port's book kernel
  scales f32 group partial sums where the JAX model path dequantizes to
  bf16: ROADMAP queue 3), the greedy tokens equal up to a JAX near-tie.
"""
import jax
import numpy as np
import pytest

from koifish_tpu.config import ModelCard as JModelCard
from koifish_tpu.config import QuantCard as JQuantCard
from koifish_tpu.config import SamplerCard as JSamplerCard
from koifish_tpu.dtypes import QFormat as JQFormat
from koifish_tpu.models import init_params as j_init_params
from koifish_tpu.quant.apply import quantize_params as j_quantize_params
from koifish_tpu.serve.batching import ContinuousBatcher as JBatcher
from koifish_tpu.serve.batching import Request as JRequest

from koifish_tpu_torch.config import ModelCard, SamplerCard
from koifish_tpu_torch.dtypes import QFormat
from koifish_tpu_torch.io.convert import params_from_numpy
from koifish_tpu_torch.serve import ContinuousBatcher, Request

from test_torch_slice21_serve import _generate_both, _greedy_up_to_a_near_tie
from torch_helpers import TINY_QWEN3, jax_tree_to_numpy, torch_threads

BOOK_REL = 2e-2      # of the largest logit (test_torch_kernels.py's rule)
RULES = {
    "kmeans": {"self_attn": {"quant_method": "KMEANS", "bits": 4},
               "mlp": {"quant_method": "KMEANS", "bits": 4}},
    "mini": {"self_attn": {"quant_method": "MINI", "bits": 3},
             "mlp": {"quant_method": "MINI", "bits": 3}},
    "sinkhorn": {"self_attn": {"quant_method": "SNQ", "bits": 4},
                 "mlp": {"quant_method": "SNQ", "bits": 4},
                 "group_size": 128},
}


def _quantized(rules: str):
    """(JAX card, port card, JAX params quantized by ``RULES[rules]``, the
    same params carried across)."""
    jcard = JModelCard.from_arch("QWEN3", **TINY_QWEN3)
    card = ModelCard.from_arch("QWEN3", **TINY_QWEN3)
    jp = j_quantize_params(j_init_params(jcard, jax.random.PRNGKey(0)),
                           JQuantCard.from_json(RULES[rules]), jcard)
    return jcard, card, jp, params_from_numpy(jax_tree_to_numpy(jp),
                                              device="cpu")


def test_bf16_batcher_matches_jax():
    """Both packages' ContinuousBatcher at temperature 0 over a BF16 pool
    (2 slots, decode_chunk 4) with k-means NF4 weights quantized by the
    JAX package, 5 requests of seeded lengths: every request's tokens
    are equal."""
    jcard, card, jp, tp = _quantized("kmeans")
    rng = np.random.default_rng(21)
    reqs = [(rng.integers(0, 256, int(n)).tolist(), int(m))
            for n, m in zip(rng.integers(3, 24, 5), rng.integers(4, 12, 5))]
    jb = JBatcher(jcard, jp, n_slots=2, cache_size=64, kv_fmt=JQFormat.BF16,
                  sampler=JSamplerCard(temperature=0.0), decode_chunk=4)
    tb = ContinuousBatcher(card, tp, n_slots=2, cache_size=64,
                           kv_fmt=QFormat.BF16,
                           sampler=SamplerCard(temperature=0.0),
                           decode_chunk=4, device="cpu")
    for i, (p, n) in enumerate(reqs):
        jb.submit(JRequest(rid=i, prompt=list(p), max_new=n, eos_id=-1))
        tb.submit(Request(rid=i, prompt=list(p), max_new=n, eos_id=-1))
    with torch_threads(1):
        tres = tb.run()
    jres = jb.run()
    assert sorted(tres) == sorted(jres) == list(range(len(reqs)))
    for i, (_, n) in enumerate(reqs):
        print(i, tres[i].tokens, jres[i].tokens)
        assert tres[i].tokens == jres[i].tokens and len(tres[i].tokens) == n


@pytest.mark.parametrize("rules", ["mini", "sinkhorn"])
def test_book_weights_generate_matches_jax(rules):
    """``generate`` (INT8 KV, 12 new) over MINI NF3 per-row books or
    Sinkhorn INT4 g128 weights: every teacher-forced step's logits within
    2 % of its largest logit."""
    jcard, card, jp, tp = _quantized(rules)
    w = tp["layers"][0]["q"]
    print(rules, w.fmt.name, None if w.codebook is None
          else tuple(w.codebook.shape),
          None if w.row_scale is None else tuple(w.row_scale.shape))
    jtoks, ttoks, _, jout, tout = _generate_both(jcard, card, jp, tp,
                                                 QFormat.INT8, 64, 12)
    worst = max(float(np.abs(t - j).max() / np.abs(j).max())
                for j, t in zip(jout, tout))
    print(f"{rules}: worst logit gap {worst:.3e} of the largest logit "
          f"(tol {BOOK_REL:g})")
    assert worst <= BOOK_REL
    tol = BOOK_REL * max(float(np.abs(j).max()) for j in jout)
    n = _greedy_up_to_a_near_tie(ttoks, jtoks, jout, tol)
    print(f"greedy tokens compared: {n} of {jtoks.size}")
