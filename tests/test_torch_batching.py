"""PyTorch port vs the JAX package: multi-request serving — the per-lane
decode write (``kvcache.write_token``), ``decode_step`` over a ``KVCache``
with per-layer and layer-stacked params, ``decode_step_stacked``, and the
``ContinuousBatcher``.

Decode steps use the tiny INT4 QWEN3 card of ``torch_helpers`` with lanes
at different positions (one past the ring's window), so every write goes to
its own slot; the batcher uses ``tests/test_batching.py``'s tiny bf16 card
(weights from the JAX init, carried across) and its scenarios. The JAX side
runs its plain paths on the CPU; the port runs its kernels' plain
versions."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koifish_tpu.config import ModelCard as JModelCard
from koifish_tpu.config import SamplerCard as JSamplerCard
from koifish_tpu.dtypes import QFormat as JQFormat
from koifish_tpu.models import init_params as j_init_params
from koifish_tpu.serve import engine as jengine
from koifish_tpu.serve import kvcache as jkvc
from koifish_tpu.serve.batching import ContinuousBatcher as JBatcher
from koifish_tpu.serve.batching import Request as JRequest
from koifish_tpu.serve.stacked import stack_layers as j_stack_layers

from koifish_tpu_torch.config import ModelCard, SamplerCard
from koifish_tpu_torch.dtypes import QFormat
from koifish_tpu_torch.io.convert import cache_from_numpy, params_from_numpy
from koifish_tpu_torch.serve import (ContinuousBatcher, Request, cache_for,
                                     decode_step, decode_step_stacked,
                                     generate, prefill_chunked, stack_layers)
from koifish_tpu_torch.serve import kvcache as kvc
from koifish_tpu_torch.serve.batching import _bucket

from torch_helpers import (LOGIT_TOL, bf16_pair, f32, jax_cache_to_numpy,
                           jax_tree_to_numpy, tiny_models, tiny_prompt)

FMTS = ["int8", "int4", "bf16"]


def _lanes_apart(fmt: str, size: int, pos):
    """A JAX stacked cache after a 6-token prefill of the tiny card, with
    the lanes' positions set to ``pos`` (stale slots stay masked), and the
    same cache in the port."""
    jcard, card, jp, tp = tiny_models()
    prompt = tiny_prompt(3, 6, seed=3)
    jc = jkvc.cache_for(jcard, 3, size, fmt=JQFormat(fmt))
    _, jc = jengine.prefill(jcard, jp, jnp.asarray(prompt), jc, fresh=True)
    jc = dataclasses.replace(jc, pos=jnp.asarray(pos, jnp.int32))
    return jc, cache_from_numpy(jax_cache_to_numpy(jc), device="cpu")


@pytest.mark.parametrize("fmt", FMTS)
def test_write_token_matches_jax(fmt):
    """One token's K/V at per-lane slots (one lane past the 16-slot window,
    so its slot wraps past the sinks): every cache buffer equals the JAX
    package's bit for bit."""
    jc, tc = _lanes_apart(fmt, 16, [6, 3, 21])
    rng = np.random.default_rng(4)
    jk, tk = bf16_pair(rng.standard_normal((3, 1, 64)).astype(np.float32))
    jv, tv = bf16_pair(rng.standard_normal((3, 1, 64)).astype(np.float32))
    jc = jkvc.write_token(jc, 1, jk, jv)
    tc = kvc.write_token(tc, 1, tk, tv)
    for f in ("k", "v", "k_scale", "v_scale"):
        j, t = getattr(jc, f), getattr(tc, f)
        if j is None:
            assert t is None
            continue
        np.testing.assert_array_equal(f32(t), f32(j), err_msg=f)


# an INT4 code step is absmax/7: the token each package quantizes from its
# own bf16 activations may land on the other code of a rounding edge, so
# INT4 steps are held to the INT4 tolerance of tests/test_torch_serve.py
# (ROADMAP queue 3)
INT4_KV_TOL = 6e-2


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("stacked", [False, True])
def test_decode_step_matches_jax(fmt, stacked):
    """Two decode steps with per-layer and with layer-stacked params (the
    port's ``decode_step`` dispatches the latter to ``decode_step_stacked``,
    as the JAX package's does), lanes at positions 6, 3 and 21 of a 16-slot
    ring (the last streams: its sinks are re-roped): logits against the
    JAX package's."""
    jcard, card, jp, tp = tiny_models()
    if stacked:
        jp, tp = j_stack_layers(jp), stack_layers(tp)
        assert not isinstance(tp["layers"], list)
    jc, tc = _lanes_apart(fmt, 16, [6, 3, 21])
    tol = INT4_KV_TOL if fmt == "int4" else LOGIT_TOL
    for step, tok in enumerate(([7, 8, 9], [100, 3, 42])):
        jl, jc = jengine.decode_step(jcard, jp, jnp.asarray(tok, jnp.int32),
                                     jc)
        tl, tc = decode_step(card, tp, torch.tensor(tok, dtype=torch.int32),
                             tc)
        assert tl.dtype == torch.float32 and tl.shape == (3, 256)
        assert np.abs(f32(tl) - f32(jl)).max() <= tol, step
    assert tc.pos.tolist() == [8, 5, 23]


def test_prefill_chunked_matches_jax():
    """A 20-token prompt in chunks of 8: the padded tail chunk's logits at
    its last real token and the rolled-back position, against the JAX
    package's prefill_chunked (INT8 cache)."""
    jcard, card, jp, tp = tiny_models()
    prompt = tiny_prompt(2, 20, seed=5)
    jc = jkvc.cache_for(jcard, 2, 64, fmt=JQFormat.INT8)
    jl, jc = jengine.prefill_chunked(jcard, jp, jnp.asarray(prompt), jc,
                                     chunk=8)
    tc = cache_for(card, 2, 64, fmt=QFormat.INT8, device="cpu")
    tl, tc = prefill_chunked(card, tp, torch.from_numpy(prompt).long(), tc,
                             chunk=8, device="cpu")
    assert tc.pos.tolist() == np.asarray(jc.pos).tolist() == [20, 20]
    assert np.abs(f32(tl) - f32(jl)).max() <= LOGIT_TOL


def test_decode_step_stacked_is_the_layer_loop():
    """decode_step_stacked on stacked params gives the per-layer loop's
    logits and cache, bit for bit (the same ops in the same order)."""
    _, card, _, tp = tiny_models()
    _, a = _lanes_apart("int8", 32, [6, 3, 9])
    _, b = _lanes_apart("int8", 32, [6, 3, 9])
    tok = torch.tensor([1, 2, 3], dtype=torch.int32)
    la, a = decode_step(card, tp, tok, a)
    lb, b = decode_step_stacked(card, stack_layers(tp), tok, b)
    assert torch.equal(la, lb)
    for f in ("k", "v", "k_scale", "v_scale", "pos"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_stack_layers_refuses_heterogeneous_layers():
    """None for layers of other formats, as the JAX package returns."""
    _, card, _, tp = tiny_models()
    mixed = dict(tp, layers=[tp["layers"][0],
                             dict(tp["layers"][1], q=torch.zeros(
                                 (128, 128), dtype=torch.bfloat16))])
    assert stack_layers(mixed) is None
    s = stack_layers(tp)
    assert s["layers"]["q"].codes.shape[0] == card.n_layer


def test_generate_takes_stacked_decode_params():
    """generate(decode_params=stack_layers(params)) gives the tokens of the
    per-layer params (INT8 KV, greedy, decode_chunk 4)."""
    _, card, _, tp = tiny_models()
    prompt = torch.from_numpy(tiny_prompt(3, 6, seed=9))
    outs = []
    for dp in (None, stack_layers(tp)):
        c = cache_for(card, 3, 64, fmt=QFormat.INT8, layered=True,
                      device="cpu")
        toks, _ = generate(card, tp, prompt, c,
                           sampler=SamplerCard(temperature=0.0),
                           max_new_tokens=10, decode_chunk=4,
                           decode_params=dp, device="cpu")
        outs.append(toks)
    assert torch.equal(outs[0], outs[1])


# --- the continuous batcher -------------------------------------------------

BATCH_CARD = dict(vocab_size=256, n_layer=2, n_embd=64, n_head=4, n_kv_head=2,
                  head_dim=16, n_ffn=128, n_ctx=64, max_pos=128)


def _batch_models():
    jcard = JModelCard.from_arch("QWEN3", **BATCH_CARD)
    card = ModelCard.from_arch("QWEN3", **BATCH_CARD)
    jp = j_init_params(jcard, jax.random.PRNGKey(0))
    return jcard, card, jp, params_from_numpy(jax_tree_to_numpy(jp),
                                              device="cpu")


def _first_greedy(jcard, jp, prompt, n):
    jc = jkvc.init_cache(jcard.n_layer, 1, 64, jcard.n_kv_head,
                         jcard.head_dim)
    toks, _ = jengine.generate(jcard, jp, jnp.asarray([prompt], jnp.int32),
                               jc, JSamplerCard(temperature=0.0),
                               max_new_tokens=n)
    return np.asarray(toks)[0].tolist()


SCENARIOS = {
    # more requests than slots (slots are reused)
    "more_requests_than_slots": dict(
        slots=2, chunk=1, fmt="bf16",
        reqs=[([i + 1, i + 2, 3 * i + 5], 5, -1) for i in range(5)]),
    # decode_chunk > 1, prompts across two buckets
    "decode_chunk_4": dict(
        slots=2, chunk=4, fmt="bf16",
        reqs=[([5, 6, 7], 9, -1), ([9, 10, 11, 12], 9, -1),
              ([40] * 20, 7, -1)]),
    # a packed INT4 pool
    "int4_pool": dict(
        slots=2, chunk=4, fmt="int4",
        reqs=[([3, 5, 7 + r], 6, -1) for r in range(3)]),
    # eos frees a slot: request 0 stops at its second greedy token
    "eos_frees_a_slot": dict(slots=1, chunk=1, fmt="int8", reqs=None),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_batcher_matches_jax(name):
    """Both packages' ContinuousBatcher at temperature 0 on the same
    weights and requests: every request's tokens are equal (the INT4 pool
    too: in this scenario no code lands on another rounding edge)."""
    jcard, card, jp, tp = _batch_models()
    sc = SCENARIOS[name]
    reqs = sc["reqs"]
    if reqs is None:
        eos = _first_greedy(jcard, jp, [5, 6], 3)[1]
        reqs = [([5, 6], 10, eos), ([7, 8], 4, -1)]
    fmt = sc["fmt"]
    jb = JBatcher(jcard, jp, n_slots=sc["slots"], cache_size=64,
                  kv_fmt=JQFormat(fmt), sampler=JSamplerCard(temperature=0.0),
                  decode_chunk=sc["chunk"])
    tb = ContinuousBatcher(card, tp, n_slots=sc["slots"], cache_size=64,
                           kv_fmt=QFormat(fmt),
                           sampler=SamplerCard(temperature=0.0),
                           decode_chunk=sc["chunk"], device="cpu")
    for i, (p, n, eos) in enumerate(reqs):
        jb.submit(JRequest(rid=i, prompt=list(p), max_new=n, eos_id=eos))
        tb.submit(Request(rid=i, prompt=list(p), max_new=n, eos_id=eos))
    tb.warmup()
    jres, tres = jb.run(), tb.run()
    assert sorted(tres) == sorted(jres) == list(range(len(reqs)))
    for i, (_, n, eos) in enumerate(reqs):
        assert tres[i].tokens == jres[i].tokens, i
        assert tres[i].done and tres[i].ttft_s > 0 and not tres[i].ttft_cold
        assert len(tres[i].tokens) == n or tres[i].tokens[-1] == eos
    assert tb.aggregate_tokens_per_sec > 0
    if name == "eos_frees_a_slot":
        assert tres[0].tokens[-1] == reqs[0][2] and len(tres[0].tokens) <= 3
        assert len(tres[1].tokens) == 4


def test_batcher_matches_single_stream_generate():
    """Greedy continuous batching gives each request the tokens of the
    port's own single-stream generate, and decode_chunk 1 and 4 agree."""
    _, card, _, tp = _batch_models()
    prompts = [[5, 6, 7], [9, 10, 11, 12, 13], [40] * 20]
    singles = []
    for p in prompts:
        c = cache_for(card, 1, 64, device="cpu")
        toks, _ = generate(card, tp, torch.tensor([p]), c,
                           SamplerCard(temperature=0.0), max_new_tokens=8,
                           device="cpu")
        singles.append(toks[0].tolist())
    for chunk in (1, 4):
        eng = ContinuousBatcher(card, tp, n_slots=2, cache_size=64,
                                sampler=SamplerCard(temperature=0.0),
                                decode_chunk=chunk, device="cpu")
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=list(p), max_new=8))
        res = eng.run()
        assert [res[i].tokens for i in range(3)] == singles, chunk


def test_bucket():
    assert _bucket(5) == 16 and _bucket(16) == 16 and _bucket(17) == 32
