"""Speculative decoding — draft-model lookahead, target-model verify.

The JAX package's ``serve/speculative.py``: a small draft model proposes
``k`` tokens (``engine.decode_probs_k``, which also returns the dense
distribution each was drawn from); the target verifies all of them in one
(k+1)-token prefill. Acceptance is the Leviathan et al. rejection test —
accept ``d_i`` with probability ``min(1, p_i(d_i)/q_i(d_i))``; on rejection
resample from ``norm(max(0, p_i - q_i))``; on full acceptance draw the bonus
token from ``p_k`` — so emitted tokens follow the target's own sampling
distribution (greedy is the one-hot special case: the output equals the
target's greedy tokens). The acceptance, residual and bonus draws come from
the JAX package's host generator, ``np.random.default_rng(seed)``, so given
the same p and q both packages make the same decisions; the draft's own
draws come from a ``torch.Generator``.

Rollback is free: attention masks validity by ``pos``, so rejected slots are
rewritten by later tokens; ``_rollback`` replaces ``pos`` and keeps the
buffers. Both caches are sized to hold the prompt + max_new + k and never
wrap, so every speculative dispatch runs with ``streaming=False``.

Under tensor parallelism (``tp``, a ``TPPolicy``) the target's forwards run
on the rank's shard with the policy's collectives, and every rank reads the
gathered logits; the draft runs whole on every rank without collectives.
Each rank draws from the same seeded generators, so all take the same
decisions: the first token and every round's tokens are checked across
the group (one small all-gather), and a rank that took other tokens stops
every rank with a ``RuntimeError`` before the next collective.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from koifish_tpu_torch.config import ModelCard, SamplerCard
from koifish_tpu_torch.ops.sampling import filtered_probs
from koifish_tpu_torch.ops.tracectx import tp_scope
from koifish_tpu_torch.serve.engine import (decode_probs_k,
                                            decode_sample_layered, prefill)
from koifish_tpu_torch.serve.layered import LayeredKVCache, split_cache
from koifish_tpu_torch.utils.device import resolve_device


_HASH_MOD = (1 << 61) - 1


def _agree(tp, seq: List[int], what: str, device) -> None:
    """Raise on every rank of ``tp.group`` unless all hold ``seq``: its
    length and a polynomial hash, gathered over the group."""
    from koifish_tpu_torch.parallel import comm
    h = 0
    for t in seq:
        h = (h * 1000003 + t + 1) % _HASH_MOD
    every = [x.cpu() for x in comm.all_gather(torch.tensor(
        [len(seq), h], dtype=torch.int64, device=device), tp.group)]
    bad = [r for r, x in enumerate(every) if not torch.equal(x, every[0])]
    if bad:
        raise RuntimeError(
            f"speculative decoding under tensor parallelism: rank(s) {bad} "
            f"of the group took other tokens than rank 0 {what}")


def _rollback(cache, pos: int):
    """The cache (``KVCache`` or ``LayeredKVCache``) with every lane's
    ``pos`` set to ``pos``; the buffers are shared, not copied."""
    return dataclasses.replace(cache, pos=torch.full_like(cache.pos, pos))


def speculative_generate(
    card: ModelCard, params,
    draft_card: ModelCard, draft_params,
    prompt: torch.Tensor,                  # [1, T] int
    cache,                                 # target cache (>= T+max_new+k)
    draft_cache,
    k: int = 4,
    max_new_tokens: int = 64,
    eos_id: int = -1,
    sampler: Optional[SamplerCard] = None,
    seed: int = 0,
    device=None,
    tp=None,
) -> Tuple[torch.Tensor, dict]:
    """Speculative decoding (B=1). Returns (tokens [1, <=max_new] int32,
    stats). Emitted tokens follow the target's sampling distribution; with
    temperature 0 they are the target's greedy tokens. ``tp``: the target's
    ``TPPolicy`` (``card``, ``params`` and ``cache`` this rank's), or
    None."""
    if prompt.shape[0] != 1:
        raise ValueError("speculative decoding is single-stream (B=1)")
    dev = resolve_device(device)
    sampler = sampler or SamplerCard(temperature=0.0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    host_rng = np.random.default_rng(seed)
    prompt = prompt.to(device=dev, dtype=torch.int64)

    def _p_dist(logits2d):                  # [N, V] -> filtered probs
        # the draft side samples with the same method: mixing distributions
        # would break the exact-target guarantee
        return filtered_probs(
            logits2d, sampler.temperature, sampler.top_k, sampler.top_p,
            sampler.min_p, method=sampler.method).cpu().numpy()

    def _tok(ids):
        return torch.tensor(ids, dtype=torch.int32, device=dev)

    # prefill both models on the prompt; t0 ~ target distribution
    with tp_scope(tp):
        logits, cache = prefill(card, params, prompt, cache, fresh=True,
                                device=dev)
    p0 = _p_dist(logits)[0]
    t0 = int(host_rng.choice(len(p0), p=p0 / p0.sum()))
    if tp is not None:
        _agree(tp, [t0], "at the first token", dev)
    _, draft_cache = prefill(draft_card, draft_params, prompt, draft_cache,
                             fresh=True, device=dev)
    dlc = (draft_cache if isinstance(draft_cache, LayeredKVCache)
           else split_cache(draft_cache, uniform=True))

    seq: List[int] = [t0]
    prompt_len = prompt.shape[1]
    c_drf = prompt_len                     # tokens fed through the draft
    rounds = accepted_total = 0

    while len(seq) < max_new_tokens and seq[-1] != eos_id:
        len_old = len(seq)
        # --- draft: catch up on unconsumed tokens, then propose k ----------
        pend_d = seq[c_drf - prompt_len:]          # emitted, not yet fed
        if len(pend_d) == 2:                       # after an all-accept round
            _, dlc, gen = decode_sample_layered(
                draft_card, draft_params, _tok(pend_d[0:1]), dlc, gen,
                sampler, streaming=False)
            c_drf += 1
            pend_d = pend_d[1:]
        toks, qs, dlc, gen = decode_probs_k(
            draft_card, draft_params, _tok(pend_d[-1:]), dlc, gen, sampler,
            k, streaming=False)
        drafts = [int(t) for t in toks[:, 0].tolist()]      # d1..dk
        q = qs[:, 0].cpu().numpy()                          # [k, V]
        c_drf += k                                  # consumed pend + d1..dk-1

        # --- target: verify [t_last, d1..dk] in one forward ----------------
        feed = torch.tensor([[seq[-1]] + drafts], dtype=torch.int64,
                            device=dev)                     # [1, k+1]
        with tp_scope(tp):
            all_logits, cache = prefill(card, params, feed, cache,
                                        return_all_logits=True, device=dev)
        p = _p_dist(all_logits[0])                          # [k+1, V]

        # --- rejection sampling (greedy = one-hot special case) ------------
        a = 0
        emitted: List[int] = []
        while a < k:
            d = drafts[a]
            ratio = p[a, d] / max(q[a, d], 1e-30)
            if host_rng.random() < min(1.0, ratio) and p[a, d] > 0:
                emitted.append(d)
                if d == eos_id:
                    break
                a += 1
            else:
                resid = np.maximum(p[a] - q[a], 0.0)
                z = resid.sum()
                dist = resid / z if z > 1e-12 else p[a] / p[a].sum()
                emitted.append(int(host_rng.choice(len(dist), p=dist)))
                break
        else:
            bonus = p[k] / p[k].sum()
            emitted.append(int(host_rng.choice(len(bonus), p=bonus)))
        for t in emitted:
            seq.append(t)
            if t == eos_id or len(seq) >= max_new_tokens:
                break
        rounds += 1
        accepted_total += a
        if tp is not None:
            _agree(tp, seq, f"in round {rounds}", dev)

        # --- rollback both models to the accepted prefix -------------------
        cache = _rollback(cache, prompt_len + len_old + a)  # seq + d1..da
        c_drf_valid = prompt_len + len_old + min(a, k - 1)
        if c_drf > c_drf_valid:
            c_drf = c_drf_valid
            dlc = _rollback(dlc, c_drf)

    stats = {"rounds": rounds,
             "accept_rate": accepted_total / max(rounds * k, 1),
             "tokens": len(seq)}
    return torch.tensor([seq], dtype=torch.int32), stats
