"""Decode engine: batched prefill + chunked decode with sampling.

The host loop of the JAX package's ``serve/engine.py`` (``prefill`` with the
``fresh`` path, ``prefill_chunked``, ``decode_step`` over a ``KVCache``,
``generate`` with ``decode_chunk`` and layer-stacked ``decode_params``, the
host eos check each chunk and the pre-wrap / streaming rule), run eagerly: a
decode chunk is ``decode_chunk`` steps of ``decode_step_layered`` + sampling
with no host sync inside, and eos is checked on the host once per chunk.
The JAX package's jitted decode+sample executables are plain functions here
(``decode_sample``, ``decode_sample_layered``, ``decode_sample_layered_k``,
``decode_sample_k``, and ``decode_probs_k`` for speculative decoding); a
``torch.Generator`` takes the place of the rng key.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from koifish_tpu_torch.config import ModelCard, SamplerCard
from koifish_tpu_torch.models.guppy import inject_rows
from koifish_tpu_torch.models.transformer import (
    Params, _linear_l, _norm, embed_tokens, lm_head, mlp, qkv_project)
from koifish_tpu_torch.ops.attention import causal_attention
from koifish_tpu_torch.ops.rope import rope_freqs
from koifish_tpu_torch.ops.sampling import (_categorical, filtered_probs,
                                             sample_logits)
from koifish_tpu_torch.ops.tracectx import current_tp
from koifish_tpu_torch.parallel import comm
from koifish_tpu_torch.serve import kvcache as kvc
from koifish_tpu_torch.serve.kvcache import KVCache
from koifish_tpu_torch.serve.layered import (LayeredKVCache,
                                             decode_step_layered, join_cache,
                                             split_cache)
from koifish_tpu_torch.serve.stacked import unstack_layers
from koifish_tpu_torch.utils.device import check_on, resolve_device


def _rope_tables(card: ModelCard, device):
    # an MLA card ropes its decoupled slice inside models/mla.mla_qkv
    if card.pos_embed != "rope" or card.attn == "mla":
        return None, None
    return rope_freqs(card.head_dim, card.max_pos, card.rope_theta,
                      card.rope_scaling_dict(), device=device)


def _sample(gen, logits, sampler: SamplerCard) -> torch.Tensor:
    """Sample the next tokens. Under TP every rank holds the whole logits;
    the group's first rank samples and broadcasts its tokens."""
    tp = current_tp()
    if tp is not None and tp.rank != 0:
        tok = torch.empty(logits.shape[:-1], dtype=torch.int32,
                          device=logits.device)
    else:
        tok = sample_logits(gen, logits, sampler.temperature, sampler.top_k,
                            sampler.top_p, sampler.min_p,
                            sampler.approx_top_k, sampler.method)
    if tp is not None:
        tok = comm.broadcast_(tok.to(torch.int32).contiguous(), tp.src,
                              tp.group)
    return tok


def _check_inputs(params: Params, tokens: torch.Tensor, cache, dev):
    check_on(tokens, dev, "tokens")
    check_on(cache.pos, dev, "cache")
    wte = params["wte"]
    check_on(wte if isinstance(wte, torch.Tensor) else wte.codes, dev,
             "params")


def prefill(card: ModelCard, params: Params, tokens: torch.Tensor, cache,
            return_all_logits: bool = False, fresh: bool = False,
            device=None):
    """Run a [B, T] prompt chunk, filling the cache in place. Returns
    last-position logits [B, V] f32 (or [B, T, V]) and the advanced cache.
    Requires pos + T <= cache.size. ``fresh``: the cache is empty (pos == 0)
    — attention runs in-chunk through the flash kernel."""
    dev = resolve_device(device)
    _check_inputs(params, tokens, cache, dev)
    # a GUPPY card serves its fixed evaluation sample; a no-op where the
    # caller injected the rows already
    params = inject_rows(card, params, None)
    if card.gau_layers:
        raise NotImplementedError(
            "GAU blocks are train/forward only: serving needs a v-gate "
            "cache (the reference cannot build GAU at all — models/gau.py)")
    if card.brown_layers:
        raise NotImplementedError(
            "BROWN layers are train/forward only: the learned attention "
            "is bounded at n_ctx and the reference never serves it "
            "(models/brown.py)")
    B, T = tokens.shape
    start = int(cache.pos[0])                  # uniform-start batch
    if start + T > cache.size:
        raise ValueError(f"prefill of {T} tokens at pos {start} would wrap "
                         f"the {cache.size}-slot cache")
    positions = torch.clamp(
        start + torch.arange(T, dtype=torch.int64, device=dev),
        max=card.max_pos - 1)
    cos, sin = _rope_tables(card, dev)
    S = cache.size

    x = embed_tokens(card, params, tokens)
    if card.pos_embed == "learned":
        x = x + params["wpe"][positions]

    # slot s holds absolute position s in the un-wrapped region; q token i
    # sits at start + i and attends slots s <= start + i
    slot_ids = torch.arange(S, device=dev)[None, :]
    qpos = (start + torch.arange(T, device=dev))[:, None]
    allowed = slot_ids <= qpos                                  # [T, S]

    for li, lp in enumerate(params["layers"]):
        h = _norm(card, x, lp["ln1"], lp.get("ln1_b"))
        q, k, v = qkv_project(card, lp, h, cos, sin, positions)
        kvc.write_prefill(cache, li, k, v, start)
        if fresh:   # empty cache: attention is purely in-chunk (flash)
            a = causal_attention(q, k, v, window=card.window)
        else:
            kc, vc, _ = kvc.read_layer(cache, li, extra=T)
            a = causal_attention(q, kc, vc, mask=allowed, causal=False)
        x = x + _linear_l(a.reshape(B, T, -1), lp, "o")
        h = _norm(card, x, lp["ln2"], lp.get("ln2_b"))
        x = x + mlp(card, lp, h)

    x = _norm(card, x, params["ln_f"], params.get("ln_f_b"))
    if return_all_logits:
        logits = lm_head(card, params, x)
    else:
        logits = lm_head(card, params, x[:, -1:])[:, 0]
    return logits, kvc.advance(cache, T)


def decode_step(card: ModelCard, params: Params, token: torch.Tensor,
                cache: KVCache, streaming: bool = True
                ) -> Tuple[torch.Tensor, KVCache]:
    """One decode step over a ``KVCache`` ([L, ...] leaves): token [B] ->
    logits [B, V] f32 and the cache (written in place, ``pos`` advanced).
    Takes per-layer-list or layer-stacked params (``stack_layers``). Each
    lane writes its own slot: the step runs ``decode_step_layered`` on
    per-layer views of the cache with per-lane writes. ``streaming=False``
    skips the sink re-rope — sound when no lane reaches the window in this
    step."""
    lc = split_cache(cache, uniform=False)
    logits, lc = decode_step_layered(card, params, token, lc, streaming,
                                     logits_dtype=torch.float32)
    return logits, dataclasses.replace(cache, pos=lc.pos)


def prefill_chunked(card: ModelCard, params: Params, tokens: torch.Tensor,
                    cache, chunk: int = 512, device=None):
    """Prefill an arbitrarily long prompt in fixed-size chunks (bounded
    activation memory); every chunk attends the whole cache. The tail chunk
    is right-padded with its last token to the chunk size and ``pos``
    rolled back past the padding, as the JAX package does to keep one
    executable per chunk size; the logits are those of the last real
    token."""
    dev = resolve_device(device)
    B, T = tokens.shape
    logits = None
    for s in range(0, T, chunk):
        piece = tokens[:, s: s + chunk]
        if piece.shape[1] < chunk and s > 0:
            pad = chunk - piece.shape[1]
            piece = torch.cat([piece, piece[:, -1:].expand(B, pad)], dim=1)
            all_l, cache = prefill(card, params, piece, cache,
                                   return_all_logits=True, device=dev)
            logits = all_l[:, chunk - pad - 1]
            cache = kvc.advance(cache, -pad)
        else:
            logits, cache = prefill(card, params, piece, cache, device=dev)
    return logits, cache


def decode_sample(card: ModelCard, params: Params, token: torch.Tensor,
                  cache: KVCache, gen: Optional[torch.Generator],
                  sampler: SamplerCard, streaming: bool = True):
    """``decode_step`` + sampling -> (next token [B], cache, generator);
    the JAX package's ``jit_decode_sample``."""
    logits, cache = decode_step(card, params, token, cache, streaming)
    return _sample(gen, logits, sampler), cache, gen


def decode_sample_layered(card: ModelCard, params: Params,
                          token: torch.Tensor, lc: LayeredKVCache,
                          gen: Optional[torch.Generator],
                          sampler: SamplerCard, streaming: bool = True):
    """``decode_step_layered`` + sampling -> (next token [B], cache,
    generator); the JAX package's ``jit_decode_sample_layered``."""
    logits, lc = decode_step_layered(card, params, token, lc, streaming)
    return _sample(gen, logits, sampler), lc, gen


def decode_sample_layered_k(card: ModelCard, params: Params,
                            token: torch.Tensor, lc: LayeredKVCache,
                            gen: Optional[torch.Generator],
                            sampler: SamplerCard, k: int,
                            streaming: bool = True):
    """``k`` layered decode+sample steps with no host sync -> (tokens
    [k, B], cache, generator); the JAX package's
    ``jit_decode_sample_layered_k``."""
    params = unstack_layers(card, params)
    toks = []
    for _ in range(k):
        token, lc, gen = decode_sample_layered(card, params, token, lc, gen,
                                               sampler, streaming)
        toks.append(token)
    return torch.stack(toks), lc, gen


def decode_probs_k(card: ModelCard, params: Params, token: torch.Tensor,
                   lc: LayeredKVCache, gen: Optional[torch.Generator],
                   sampler: SamplerCard, k: int, streaming: bool = True):
    """``k`` layered decode steps with no host sync that return both the
    sampled tokens and the dense filtered distribution each was drawn from
    (what speculative rejection sampling needs) -> (tokens [k, B], qs
    [k, B, V] f32, cache, generator); the JAX package's
    ``jit_decode_probs_k``. Each token is drawn from log(max(q, 1e-30))."""
    params = unstack_layers(card, params)
    toks, qs = [], []
    for _ in range(k):
        logits, lc = decode_step_layered(card, params, token, lc, streaming)
        q = filtered_probs(logits, sampler.temperature, sampler.top_k,
                           sampler.top_p, sampler.min_p, sampler.approx_top_k,
                           sampler.method)
        token = _categorical(gen, torch.log(torch.clamp(q, min=1e-30))
                             ).to(torch.int32)
        toks.append(token)
        qs.append(q)
    return torch.stack(toks), torch.stack(qs), lc, gen


def decode_sample_k(card: ModelCard, params: Params, token: torch.Tensor,
                    cache: KVCache, gen: Optional[torch.Generator],
                    sampler: SamplerCard, k: int, streaming: bool = True):
    """``k`` decode+sample steps over a ``KVCache`` with no host sync ->
    (tokens [k, B], cache, generator); the JAX package's
    ``jit_decode_sample_k``."""
    toks = []
    for _ in range(k):
        token, cache, gen = decode_sample(card, params, token, cache, gen,
                                          sampler, streaming)
        toks.append(token)
    return torch.stack(toks), cache, gen


def generate(card: ModelCard, params: Params, prompt: torch.Tensor, cache,
             sampler: Optional[SamplerCard] = None, max_new_tokens: int = 64,
             eos_id: int = -1, generator: Optional[torch.Generator] = None,
             decode_params: Optional[Params] = None, decode_chunk: int = 1,
             device=None) -> Tuple[torch.Tensor, object]:
    """Prefill + chunked decode. Returns (generated tokens [B, <=max_new]
    int32, cache) — NEW tokens only. ``decode_chunk``: decode+sample steps
    between host eos checks. ``generator`` seeds sampling (default: one
    seeded with ``sampler.seed``). ``decode_params``: params for the decode
    steps, e.g. layer-stacked (``serve/stacked.stack_layers``)."""
    dev = resolve_device(device)
    if card.arch == "GUPPY":
        # inject the evaluation sample's rows once, for every step
        params = inject_rows(card, params, None)
        if decode_params is None:
            decode_params = params
    dparams = unstack_layers(card, decode_params if decode_params is not None
                             else params)
    sampler = sampler or SamplerCard()
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(sampler.seed)
    prompt = prompt.to(device=dev, dtype=torch.int64)
    _check_inputs(params, prompt, cache, dev)

    was_layered = isinstance(cache, LayeredKVCache)
    pos_host = int(cache.pos[0])        # host mirror of the uniform pos
    logits, cache = prefill(card, params, prompt, cache,
                            fresh=pos_host == 0, device=dev)
    pos_host += prompt.shape[1]
    tok = _sample(generator, logits, sampler)
    out = [tok]
    done = tok == eos_id
    lc = cache if was_layered else split_cache(cache, uniform=True)
    remaining = max_new_tokens - 1
    while remaining > 0:
        if bool(done.all()):
            break
        k = min(decode_chunk, remaining)
        # pre-wrap chunks (every step below the window) skip the re-rope
        streaming = pos_host + k > lc.size
        steps, lc, generator = decode_sample_layered_k(
            card, dparams, tok, lc, generator, sampler, k, streaming)
        pos_host += k
        for t in steps:
            tok = torch.where(done, torch.full_like(t, eos_id), t)
            done = done | (tok == eos_id)
            out.append(tok)
        remaining -= k
    return torch.stack(out, dim=1), (lc if was_layered else join_cache(lc))
