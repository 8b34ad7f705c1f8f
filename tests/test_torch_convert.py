"""PyTorch port vs the JAX package: weights and KV caches carried across.

``params_from_numpy`` and ``cache_from_numpy`` turn the JAX package's
parameter tree and (layered) KV cache, handed over as numpy arrays, into the
port's; both packages must then compute the same logits. The tiny QWEN3
card has INT4 RTN g128 weights (tests/torch_helpers.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koifish_tpu.dtypes import QFormat as JQFormat
from koifish_tpu.models import model_forward as j_model_forward
from koifish_tpu.serve import engine as jengine
from koifish_tpu.serve.kvcache import cache_for as j_cache_for
from koifish_tpu.serve.layered import decode_step_layered as j_decode_step

from koifish_tpu_torch.dtypes import QFormat
from koifish_tpu_torch.io.convert import cache_from_numpy
from koifish_tpu_torch.models import model_forward
from koifish_tpu_torch.serve import decode_step_layered

from torch_helpers import (LOGIT_TOL, f32, jax_cache_to_numpy, tiny_models,
                           tiny_prompt)


def test_params_from_numpy_same_logits():
    """Converted INT4 weights: the full forward of both packages agrees
    within LOGIT_TOL."""
    jcard, card, jp, tp = tiny_models()
    toks = tiny_prompt(2, 24)
    jl = f32(j_model_forward(jcard, jp, jnp.asarray(toks)))
    tl = f32(model_forward(card, tp, torch.from_numpy(toks).long()))
    assert tl.shape == jl.shape == (2, 24, 256)
    assert np.abs(tl - jl).max() <= LOGIT_TOL


@pytest.mark.parametrize("fmt", [QFormat.INT8, QFormat.INT4])
def test_cache_from_numpy_continues_a_jax_cache(fmt):
    """A layered cache filled by the JAX prefill, carried across with
    ``cache_from_numpy``, decodes in the port like in the JAX package
    (within LOGIT_TOL) — the cache layouts are byte-compatible."""
    jcard, card, jp, tp = tiny_models()
    prompt = tiny_prompt(3, 20, seed=7)
    jc = j_cache_for(jcard, 3, 32, fmt=JQFormat(fmt.value), layered=True)
    _, jc = jengine.prefill(jcard, jp, jnp.asarray(prompt), jc, fresh=True)
    tc = cache_from_numpy(jax_cache_to_numpy(jc), device="cpu")
    assert tc.fmt is fmt and int(tc.pos[0]) == 20
    tok = prompt[:, -1]
    jl, _ = jax.jit(j_decode_step, static_argnames=("card", "streaming"))(
        jcard, jp, jnp.asarray(tok), jc, streaming=False)
    tl, _ = decode_step_layered(card, tp, torch.tensor(tok), tc,
                                streaming=False)
    assert np.abs(f32(tl) - f32(jl)).max() <= LOGIT_TOL
