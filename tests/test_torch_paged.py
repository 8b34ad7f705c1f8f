"""PyTorch port vs the JAX package: the paged KV cache (``serve/paged.py``)
— the write path, the allocator's growth, the gather-based read, and
``generate_paged`` end to end against the JAX package's and against the
port's dense ``generate``.

``tests/test_paged.py``'s tiny card (vocab 64, 2 layers, E 64, 4/2 heads,
head_dim 16) with bf16 weights from the JAX init, carried across; inputs
from numpy with a fixed seed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koifish_tpu.config import ModelCard as JModelCard
from koifish_tpu.config import SamplerCard as JSamplerCard
from koifish_tpu.models import init_params as j_init_params
from koifish_tpu.serve import paged as jpaged

from koifish_tpu_torch.config import ModelCard, SamplerCard
from koifish_tpu_torch.dtypes import QFormat
from koifish_tpu_torch.io.convert import params_from_numpy
from koifish_tpu_torch.serve import cache_for, generate, generate_paged
from koifish_tpu_torch.serve import paged as tpaged
from koifish_tpu_torch.serve.paged import PAGE, init_paged_cache

from torch_helpers import bf16_pair, f32, jax_tree_to_numpy

PAGED_CARD = dict(vocab_size=64, n_layer=2, n_embd=64, n_head=4, n_kv_head=2,
                  head_dim=16, n_ffn=128, n_ctx=256, max_pos=1024)


def _models(seed: int):
    jcard = JModelCard.from_arch("QWEN3", **PAGED_CARD)
    card = ModelCard.from_arch("QWEN3", **PAGED_CARD)
    jp = j_init_params(jcard, jax.random.PRNGKey(seed))
    return jcard, card, jp, params_from_numpy(jax_tree_to_numpy(jp),
                                              device="cpu")


def test_page_write_places_rows():
    """Each lane's row lands at (page_ids[b], rows[b]); nothing else moves
    (the JAX package's test_page_write_ref_places_rows, on both writes)."""
    H, NP, D, B = 2, 6, 16, 3
    pages = torch.zeros((H, NP, PAGE, D), dtype=torch.bfloat16)
    val = (torch.arange(B * H * D, dtype=torch.float32).reshape(B, H, D) + 1
           ).to(torch.bfloat16)
    pids = torch.tensor([0, 2, 5], dtype=torch.int32)
    rows = torch.tensor([0, 7, PAGE - 1], dtype=torch.int32)
    ref = tpaged._page_write_ref(pages, val, pids, rows)
    out = tpaged._page_write(pages.clone(), val, pids, rows)
    assert torch.equal(ref, out)
    mask = torch.zeros((H, NP, PAGE), dtype=torch.bool)
    for b in range(B):
        assert torch.equal(out[:, int(pids[b]), int(rows[b])], val[b])
        mask[:, int(pids[b]), int(rows[b])] = True
    assert bool((out[~mask] == 0).all())


def test_allocator_grows_pool_on_demand():
    """One page per lane at first; a position past the first page doubles
    the pool and hands every lane a distinct second page; a covered
    position changes nothing."""
    cache, alloc = init_paged_cache(2, batch=4, n_kv_heads=2, head_dim=16,
                                    max_pages=16, device="cpu")
    assert cache.n_pages == 4
    cache = alloc.ensure(cache, PAGE + 1)
    assert cache.n_pages == 8 and alloc.used == 8
    ids = cache.page_table[:, :2].reshape(-1).tolist()
    assert sorted(ids) == list(range(8))
    c2 = alloc.ensure(cache, PAGE + 5)
    assert c2 is cache
    with pytest.raises(ValueError, match="table capacity"):
        alloc.ensure(cache, 17 * PAGE)


def test_paged_attention_matches_jax():
    """The gather + masked decode attention against the JAX package's
    ``_paged_attention_ref`` on the same pages and table (f32 softmax of
    bf16 inputs: 1e-2 absolute on O(1) outputs)."""
    rng = np.random.default_rng(0)
    Hkv, NP, D, B, maxp, Hq = 2, 8, 16, 2, 4, 4
    jk, tk = bf16_pair(rng.standard_normal((Hkv, NP, PAGE, D)
                                           ).astype(np.float32) * 0.5)
    jv, tv = bf16_pair(rng.standard_normal((Hkv, NP, PAGE, D)
                                           ).astype(np.float32))
    jq, tq = bf16_pair(rng.standard_normal((B, Hq, D)).astype(np.float32))
    table = np.asarray([[3, 1, 6, 0], [2, 7, 4, 5]], np.int32)
    lengths = np.asarray([200, 450], np.int32)
    ref = jpaged._paged_attention_ref(jq, jk, jv, jnp.asarray(lengths),
                                      jnp.asarray(table), 0.25)
    out = tpaged._paged_attention_ref(tq, tk, tv, torch.from_numpy(lengths),
                                      torch.from_numpy(table), 0.25)
    assert np.abs(f32(out) - f32(ref)).max() <= 1e-2


@pytest.mark.parametrize("T,new", [(6, 12), (PAGE - 4, 16)])
def test_generate_paged_matches_jax_and_dense(T, new):
    """Greedy generate_paged gives the JAX package's tokens and the port's
    dense generate's (BF16 ring cache); the second case walks across a page
    boundary, so the allocator hands out the second page mid-stream."""
    jcard, card, jp, tp = _models(3 if T < PAGE else 0)
    prompt = (np.arange(2 * T, dtype=np.int32).reshape(2, T) * 7 + 1) % 64
    jt = np.asarray(jpaged.generate_paged(
        jcard, jp, jnp.asarray(prompt), sampler=JSamplerCard(temperature=0.0),
        max_new_tokens=new, decode_chunk=4, max_pages=8))
    greedy = SamplerCard(temperature=0.0)
    tt, cache = generate_paged(card, tp, torch.from_numpy(prompt),
                               sampler=greedy, max_new_tokens=new,
                               decode_chunk=4, max_pages=8,
                               return_cache=True, device="cpu")
    dc = cache_for(card, 2, 256, fmt=QFormat.BF16, device="cpu")
    dense, _ = generate(card, tp, torch.from_numpy(prompt), dc,
                        sampler=greedy, max_new_tokens=new, decode_chunk=4,
                        device="cpu")
    np.testing.assert_array_equal(tt.numpy(), jt)
    np.testing.assert_array_equal(dense.numpy(), jt)
    assert int(cache.pos[0]) == T + new - 1
    assert cache.n_pages == 2 * -(-(T + new) // PAGE)
