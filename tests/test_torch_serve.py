"""PyTorch port vs the JAX package: the serving slice as a whole.

A tiny QWEN3 card (2 layers, E=128, 2 q heads, 1 kv head, head_dim 64,
FFN 256, vocab 256) with INT4 RTN g128 weights. The JAX weights are carried
across with ``params_from_numpy``; both packages then run ``generate`` at
temperature 0 with INT8, INT4 and BF16 KV caches, and the logits of the
prefill and of every decode step are compared teacher-forced on the JAX
tokens (so a bf16 near-tie cannot derail the comparison). The JAX side runs
its plain paths on the CPU; the port runs its kernels' plain versions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koifish_tpu.config import SamplerCard as JSamplerCard
from koifish_tpu.dtypes import QFormat as JQFormat
from koifish_tpu.serve import engine as jengine
from koifish_tpu.serve.kvcache import cache_for as j_cache_for
from koifish_tpu.serve.layered import decode_step_layered as j_decode_step

from koifish_tpu_torch.config import SamplerCard
from koifish_tpu_torch.dtypes import QFormat
from koifish_tpu_torch.serve import (cache_for, decode_step_layered, generate,
                                     prefill)

from torch_helpers import LOGIT_TOL, f32, tiny_models, tiny_prompt

# An INT4 KV code step is absmax/7: a one-ulp bf16 difference in a k or v
# entry that sits on a rounding edge flips its 4-bit code (62 of 6144 bytes
# after a 20-token prefill). Fed the same cache, INT4 agrees within
# LOGIT_TOL (test_torch_convert.py::test_cache_from_numpy_continues_a_jax_cache);
# from each package's own prefill it measured <= 0.035, so 6e-2.
INT4_KV_TOL = 6e-2

_j_step = jax.jit(j_decode_step, static_argnames=("card", "streaming"))


def _teacher_forced(jcard, card, jp, tp, prompt, toks, fmt, size):
    """Prefill + one decode step per generated token, fed the JAX tokens.
    Returns ([jax logits], [port logits]) per step."""
    B = prompt.shape[0]
    jc = j_cache_for(jcard, B, size, fmt=JQFormat(fmt.value), layered=True)
    tc = cache_for(card, B, size, fmt=fmt, layered=True, device="cpu")
    jl, jc = jengine.prefill(jcard, jp, jnp.asarray(prompt), jc, fresh=True)
    tl, tc = prefill(card, tp, torch.from_numpy(prompt).long(), tc,
                     fresh=True, device="cpu")
    jout, tout = [f32(jl)], [f32(tl)]
    for i in range(toks.shape[1] - 1):
        tok = toks[:, i]
        jl, jc = _j_step(jcard, jp, jnp.asarray(tok), jc, streaming=True)
        tl, tc = decode_step_layered(card, tp, torch.tensor(tok), tc,
                                     streaming=True)
        jout.append(f32(jl))
        tout.append(f32(tl))
    return jout, tout


@pytest.mark.parametrize("fmt,size,new", [
    (QFormat.INT8, 64, 12), (QFormat.INT4, 64, 12), (QFormat.BF16, 64, 12),
    (QFormat.INT8, 16, 20),            # ring wrap: S=16, 2 sinks, re-rope
])
def test_generate_matches_jax(fmt, size, new):
    """Both packages' ``generate`` at temperature 0 (decode_chunk 4); every
    step's logits agree teacher-forced, and the port's greedy tokens equal
    the JAX tokens up to the first step whose JAX top-2 margin is within
    the tolerance (a near-tie either side may take)."""
    jcard, card, jp, tp = tiny_models()
    B, P = 3, 6
    prompt = tiny_prompt(B, P, seed=size + new)
    jc = j_cache_for(jcard, B, size, fmt=JQFormat(fmt.value), layered=True)
    jtoks, _ = jengine.generate(jcard, jp, jnp.asarray(prompt), jc,
                                sampler=JSamplerCard(temperature=0.0),
                                max_new_tokens=new, decode_chunk=4)
    jtoks = np.asarray(jtoks)
    tc = cache_for(card, B, size, fmt=fmt, layered=True, device="cpu")
    ttoks, tc = generate(card, tp, torch.from_numpy(prompt), tc,
                         sampler=SamplerCard(temperature=0.0),
                         max_new_tokens=new, decode_chunk=4, device="cpu")
    assert ttoks.shape == jtoks.shape == (B, new)
    assert int(tc.pos[0]) == P + new - 1
    if P + new - 1 > size:
        assert int(tc.pos[0]) > tc.size               # the ring wrapped

    tol = INT4_KV_TOL if fmt is QFormat.INT4 else LOGIT_TOL
    jout, tout = _teacher_forced(jcard, card, jp, tp, prompt, jtoks, fmt,
                                 size)
    for step, (jl, tl) in enumerate(zip(jout, tout)):
        err = np.abs(tl - jl).max()
        assert err <= tol, (step, err)
    ttoks = ttoks.numpy()
    for b in range(B):
        for i in range(new):
            if ttoks[b, i] != jtoks[b, i]:
                top2 = np.sort(jout[i][b])[-2:]
                assert top2[1] - top2[0] <= 2 * tol, (b, i)
                break
