"""Paged KV cache — block tables over a shared page pool.

The JAX package's ``serve/paged.py``: K/V live in per-layer pools of fixed
size pages (``[Hkv, NP, PAGE, D]`` bf16), each lane owns a page table
(``[B, max_pages]`` int32) shared by all layers, and the pool grows by
doubling as lanes need pages, so KV memory tracks the tokens resident, not
B x max_len. Prefill feeds the prompt one token at a time through the paged
decode step, as the JAX package's v1 does.

Each layer of the decode step writes and reads in one launch of the paged
decode attention (``ops/kernels/paged_attn.py``, ``csrc/paged_attn.cu``):
it writes the layer's new K and V rows at (page_ids[b], rows[b]) and
attends over each lane's pages through the table, skipping pages past the
lane's length. It is the port's counterpart of the library kernel the JAX
package calls on the TPU (``jax.experimental.pallas.ops.tpu.
paged_attention``) and of the page write before it. On a CPU tensor it runs
the plain versions: the page write's masked select, then the gather of each
lane's whole table into a dense view and the plain decode attention, which
is what the JAX package runs off the TPU (``_page_write_ref``,
``_paged_attention_ref``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from koifish_tpu_torch.config import ModelCard, SamplerCard
from koifish_tpu_torch.models.transformer import (
    Params, _linear_l, _norm, gather_embed, lm_head, mlp, qkv_project)
from koifish_tpu_torch.ops.kernels.paged_attn import (
    PAGE, paged_attention, paged_attention_plain, paged_attention_write)
from koifish_tpu_torch.ops.kernels.slotwrite import (page_write,
                                                     page_write_plain)
from koifish_tpu_torch.ops.rope import rope_cos_sin_at
from koifish_tpu_torch.ops.sampling import sample_logits
from koifish_tpu_torch.serve.stacked import unstack_layers
from koifish_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class PagedKVCache:
    """Per-layer page pools + one page table shared by all layers (every
    layer writes the same (lane, position) structure)."""
    k_pages: Tuple[torch.Tensor, ...]     # L x [Hkv, NP, PAGE, D] bf16
    v_pages: Tuple[torch.Tensor, ...]
    page_table: torch.Tensor              # [B, MAXP] int32 (pool page ids)
    pos: torch.Tensor                     # [B] int32

    @property
    def n_layers(self) -> int:
        return len(self.k_pages)

    @property
    def n_pages(self) -> int:
        return self.k_pages[0].shape[1]

    @property
    def max_pages(self) -> int:
        return self.page_table.shape[1]


class PageAllocator:
    """Host-side page count. Grows the device pools by doubling when the
    handed-out pages run out; assigns page ids into the table as lanes
    grow (uniform batches: every lane shares one position)."""

    def __init__(self, cache: PagedKVCache, used: int):
        self.used = used                      # pages handed out so far

    def ensure(self, cache: PagedKVCache, new_pos: int) -> PagedKVCache:
        """Make every lane's table cover positions [0, new_pos). Returns
        the cache, with new pools after a growth and a new table when pages
        were handed out."""
        B = cache.page_table.shape[0]
        need_pages = -(-new_pos // PAGE)          # per lane
        have_pages = self.used // B
        if need_pages <= have_pages:
            return cache
        if need_pages > cache.max_pages:
            raise ValueError(f"sequence needs {need_pages} pages > table "
                             f"capacity {cache.max_pages}")
        total_needed = need_pages * B
        np_ = cache.n_pages
        while np_ < total_needed:
            np_ *= 2
        if np_ != cache.n_pages:
            grow = lambda p: torch.cat(
                [p, torch.zeros((p.shape[0], np_ - p.shape[1]) + p.shape[2:],
                                dtype=p.dtype, device=p.device)], dim=1)
            cache = dataclasses.replace(
                cache, k_pages=tuple(grow(p) for p in cache.k_pages),
                v_pages=tuple(grow(p) for p in cache.v_pages))
        # hand out ids lane-major, so a lane's pages stay near each other
        table = cache.page_table.clone()
        lanes = torch.arange(B, dtype=torch.int32, device=table.device)
        for p in range(have_pages, need_pages):
            table[:, p] = self.used + lanes
            self.used += B
        return dataclasses.replace(cache, page_table=table)


def init_paged_cache(n_layers: int, batch: int, n_kv_heads: int,
                     head_dim: int, initial_pages: Optional[int] = None,
                     max_pages: int = 64, device=None
                     ) -> Tuple[PagedKVCache, PageAllocator]:
    """The pool starts at ``initial_pages`` (default: one page per lane)
    and grows on demand."""
    dev = resolve_device(device)
    np_ = initial_pages or batch
    mk = lambda: tuple(
        torch.zeros((n_kv_heads, np_, PAGE, head_dim), dtype=torch.bfloat16,
                    device=dev) for _ in range(n_layers))
    cache = PagedKVCache(
        k_pages=mk(), v_pages=mk(),
        page_table=torch.zeros((batch, max_pages), dtype=torch.int32,
                               device=dev),
        pos=torch.zeros((batch,), dtype=torch.int32, device=dev))
    return cache, PageAllocator(cache, used=0)


# --- write path ------------------------------------------------------------

# the JAX package's names: the masked-select oracle (a new tensor) and the
# dispatching writer (in place: the kernel on the card)
_page_write_ref = page_write_plain
_page_write = page_write


# --- read path ---------------------------------------------------------------

# the JAX package's names: the gather oracle and the dispatching reader (the
# kernel on the card)
_paged_attention_ref = paged_attention_plain
_paged_attention = paged_attention


# --- decode step -------------------------------------------------------------

def decode_step_paged(card: ModelCard, params: Params, token: torch.Tensor,
                      cache: PagedKVCache
                      ) -> Tuple[torch.Tensor, PagedKVCache]:
    """One decode step over the paged cache: token [B] -> logits [B, V]
    (bf16). The allocator must have covered ``pos`` before the call."""
    params = unstack_layers(card, params)
    B = token.shape[0]
    positions = cache.pos[:, None]
    cos = sin = None
    if card.pos_embed == "rope":
        cos, sin = rope_cos_sin_at(card.head_dim, positions, card.rope_theta,
                                   card.rope_scaling_dict())
    x = gather_embed(params["wte"], token[:, None])
    if card.pos_embed == "learned":
        wpe_pos = torch.clamp(positions[:, 0], max=card.max_pos - 1).long()
        x = x + params["wpe"][wpe_pos][:, None]

    page_ids = torch.gather(cache.page_table, 1,
                            (cache.pos // PAGE).long()[:, None])[:, 0]
    rows = cache.pos % PAGE
    lengths = cache.pos + 1
    att_scale = 1.0 / (card.head_dim ** 0.5)
    for li, lp in enumerate(params["layers"]):
        h = _norm(card, x, lp["ln1"], lp.get("ln1_b"))
        q, k, v = qkv_project(card, lp, h, cos, sin, None)
        a = paged_attention_write(q[:, 0].to(torch.bfloat16), k[:, 0],
                                  v[:, 0], cache.k_pages[li],
                                  cache.v_pages[li], lengths,
                                  cache.page_table, page_ids, rows, att_scale)
        x = x + _linear_l(a.reshape(B, 1, -1), lp, "o")
        h = _norm(card, x, lp["ln2"], lp.get("ln2_b"))
        x = x + mlp(card, lp, h)

    x = _norm(card, x, params["ln_f"], params.get("ln_f_b"))
    logits = lm_head(card, params, x, out_dtype=torch.bfloat16)[:, 0]
    return logits, dataclasses.replace(cache, pos=cache.pos + 1)


def _sample(gen, logits, sampler: SamplerCard) -> torch.Tensor:
    return sample_logits(gen, logits, sampler.temperature, sampler.top_k,
                         sampler.top_p, sampler.min_p, sampler.approx_top_k,
                         sampler.method)


def generate_paged(card: ModelCard, params: Params, prompt: torch.Tensor,
                   sampler: Optional[SamplerCard] = None,
                   max_new_tokens: int = 64, eos_id: int = -1,
                   generator: Optional[torch.Generator] = None,
                   decode_chunk: int = 8, max_pages: int = 64,
                   return_cache: bool = False, device=None):
    """Paged-cache generation of a uniform batch: the prompt is fed token
    by token through the paged decode step, then ``decode_chunk`` decode +
    sample steps per host eos check. Returns the new tokens [B, <=max_new]
    (and the final cache with ``return_cache``)."""
    dev = resolve_device(device)
    sampler = sampler or SamplerCard()
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(sampler.seed)
    params = unstack_layers(card, params)
    prompt = prompt.to(device=dev, dtype=torch.int64)
    B, T = prompt.shape
    cache, alloc = init_paged_cache(card.n_layer, B, card.n_kv_head,
                                    card.head_dim, max_pages=max_pages,
                                    device=dev)
    cache = alloc.ensure(cache, T)
    logits = None
    for t in range(T):                      # prompt feed (uniform)
        logits, cache = decode_step_paged(card, params, prompt[:, t], cache)
    tok = _sample(generator, logits, sampler)
    out = [tok]
    done = tok == eos_id
    pos = T
    remaining = max_new_tokens - 1
    while remaining > 0 and not bool(done.all()):
        k = min(decode_chunk, remaining)
        cache = alloc.ensure(cache, pos + k + 1)
        steps = []
        t = tok
        for _ in range(k):
            step_logits, cache = decode_step_paged(card, params, t, cache)
            t = _sample(generator, step_logits, sampler)
            steps.append(t)
        for t in steps:
            tok = torch.where(done, torch.full_like(t, eos_id), t)
            done = done | (tok == eos_id)
            out.append(tok)
        pos += k
        remaining -= k
    toks = torch.stack(out, dim=1)
    return (toks, cache) if return_cache else toks
