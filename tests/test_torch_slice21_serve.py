"""PyTorch port vs the JAX package: ``generate`` over a ring that wraps,
one of the serving paths that slice 21 runs on the card, at the tiny
size (the others: ``tests/test_torch_slice21_books.py``).

A ring of 16 slots with 2 sinks, a 6-token prompt and 20 new tokens, with
an INT4 and a BF16 cache: every step's logits teacher-forced on the JAX
tokens (INT4 within ``tests/test_torch_serve.py``'s INT4_KV_TOL, BF16
within LOGIT_TOL), the greedy tokens equal up to a JAX near-tie.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koifish_tpu.config import SamplerCard as JSamplerCard
from koifish_tpu.dtypes import QFormat as JQFormat
from koifish_tpu.serve import engine as jengine
from koifish_tpu.serve.kvcache import cache_for as j_cache_for

from koifish_tpu_torch.config import SamplerCard
from koifish_tpu_torch.dtypes import QFormat
from koifish_tpu_torch.serve import cache_for, generate

from test_torch_serve import INT4_KV_TOL, _teacher_forced
from torch_helpers import (LOGIT_TOL, tiny_models, tiny_prompt, top2_margin,
                           torch_threads)


def _greedy_up_to_a_near_tie(ttoks, jtoks, jout, tol):
    """The port's tokens equal the JAX tokens in each row up to the first
    step whose JAX top-2 margin is within 2·tol (a near-tie either side
    may take); returns how many were compared."""
    compared = 0
    for b in range(jtoks.shape[0]):
        for i in range(jtoks.shape[1]):
            if top2_margin(jout[i][b:b + 1])[0] <= 2 * tol:
                break
            assert ttoks[b, i] == jtoks[b, i], (b, i)
            compared += 1
    return compared


def _generate_both(jcard, card, jp, tp, fmt, size, new, B=3, P=6):
    prompt = tiny_prompt(B, P, seed=size + new)
    jc = j_cache_for(jcard, B, size, fmt=JQFormat(fmt.value), layered=True)
    jtoks, _ = jengine.generate(jcard, jp, jnp.asarray(prompt), jc,
                                sampler=JSamplerCard(temperature=0.0),
                                max_new_tokens=new, decode_chunk=4)
    tc = cache_for(card, B, size, fmt=fmt, layered=True, device="cpu")
    with torch_threads(1):
        ttoks, tc = generate(card, tp, torch.from_numpy(prompt), tc,
                             sampler=SamplerCard(temperature=0.0),
                             max_new_tokens=new, decode_chunk=4,
                             device="cpu")
        jout, tout = _teacher_forced(jcard, card, jp, tp, prompt,
                                     np.asarray(jtoks), fmt, size)
    assert ttoks.shape == (B, new)
    return np.asarray(jtoks), ttoks.numpy(), tc, jout, tout


@pytest.mark.parametrize("fmt", [QFormat.INT4, QFormat.BF16],
                         ids=["int4", "bf16"])
def test_generate_over_a_wrapping_ring_matches_jax(fmt):
    """S 16 with 2 sinks, a 6-token prompt and 20 new tokens: the ring
    wraps (the sink keys re-roped) in both packages."""
    jcard, card, jp, tp = tiny_models()
    size, new, P = 16, 20, 6
    jtoks, ttoks, tc, jout, tout = _generate_both(jcard, card, jp, tp, fmt,
                                                  size, new, P=P)
    assert int(tc.pos[0]) == P + new - 1 > tc.size        # wrapped
    tol = INT4_KV_TOL if fmt is QFormat.INT4 else LOGIT_TOL
    worst = max(float(np.abs(t - j).max()) for j, t in zip(jout, tout))
    print(f"{fmt.name} ring wrap: worst logit gap {worst:.3e} (tol {tol:g})")
    assert worst <= tol
    n = _greedy_up_to_a_near_tie(ttoks, jtoks, jout, tol)
    print(f"greedy tokens compared: {n} of {jtoks.size}")
