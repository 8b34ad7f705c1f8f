"""Continuous batching — multi-request decode over a fixed pool of slots.

The JAX package's ``serve/batching.py``:

- a fixed pool of ``n_slots`` decode lanes shares one per-layer cache
  (``LayeredKVCache`` with ``uniform=False``); requests are admitted into
  free lanes and leave when they finish, so the decode step's shape never
  changes;
- each request is prefilled alone, on its prompt right-padded to the next
  power of two (``_bucket``) with its last token, into a one-lane cache;
  ``pos`` is rolled back past the padding so the padded K/V stay masked,
  the logits are read at the last real token, and the lane is copied into
  its pool slot (``merge_lane``) — the cache holds what the JAX package's
  holds;
- every lane sits at its own position, so each decode step writes K/V at
  per-lane slots: inside the decode attention's launch on a quantized
  cache, the slot-write kernel on a BF16 one; one launch per layer either
  way.

Reports TTFT per request and the exact aggregate decode rate.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import torch

from koifish_tpu_torch.config import ModelCard, SamplerCard
from koifish_tpu_torch.dtypes import QFormat
from koifish_tpu_torch.serve import kvcache as kvc
from koifish_tpu_torch.serve.engine import (_sample, decode_sample_layered,
                                            decode_sample_layered_k, prefill)
from koifish_tpu_torch.serve.kvcache import KVCache, init_cache
from koifish_tpu_torch.serve.layered import LayeredKVCache, init_layered_cache
from koifish_tpu_torch.serve.stacked import unstack_layers
from koifish_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int = 64
    eos_id: int = -1
    # filled by the engine:
    tokens: List[int] = dataclasses.field(default_factory=list)
    ttft_s: Optional[float] = None
    ttft_cold: bool = False   # its prefill bucket ran for the first time
    decode_s: float = 0.0     # approximate (shared batch wall time, prorated)
    done: bool = False

    @property
    def tokens_per_sec(self) -> float:
        n = max(len(self.tokens) - 1, 0)
        return n / self.decode_s if self.decode_s > 0 else 0.0


def _bucket(n: int, lo: int = 16) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def merge_lane(pool: LayeredKVCache, lane: KVCache, slot: int
               ) -> LayeredKVCache:
    """Copy a one-lane [L, 1, ...] cache into pool lane ``slot`` (a host
    int), in place; the lane's position too (on the device)."""
    def put(dst, src):
        if dst is not None:
            for li, d in enumerate(dst):
                d[slot].copy_(src[li, 0])
    put(pool.k, lane.k)
    put(pool.v, lane.v)
    put(pool.k_scale, lane.k_scale)
    put(pool.v_scale, lane.v_scale)
    pool.pos[slot] = lane.pos[0]
    return pool


class ContinuousBatcher:
    """Admit -> prefill -> batched decode -> complete, over one fixed pool."""

    def __init__(self, card: ModelCard, params, n_slots: int = 8,
                 cache_size: int = 1024, kv_fmt: QFormat = QFormat.BF16,
                 sampler: Optional[SamplerCard] = None,
                 generator: Optional[torch.Generator] = None,
                 decode_params=None, decode_chunk: int = 1, device=None):
        self.card, self.params = card, params
        self.device = resolve_device(device)
        self.decode_params = unstack_layers(
            card, decode_params if decode_params is not None else params)
        # tokens generated per host round-trip (eos checked every chunk)
        self.decode_chunk = max(1, decode_chunk)
        self.n_slots = n_slots
        self.cache_size = cache_size
        self.kv_fmt = kv_fmt
        self.sampler = sampler or SamplerCard()
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(self.sampler.seed)
        self.gen = generator
        # per-layer buffers, per-lane slots (uniform=False: slot writes)
        self.pool = init_layered_cache(
            card.n_layer, n_slots, cache_size, card.n_kv_head,
            card.head_dim, fmt=kv_fmt, uniform=False, device=self.device)
        self.slots: List[Optional[Request]] = [None] * n_slots
        self.waiting: List[Request] = []
        self.cur_tok = torch.zeros((n_slots,), dtype=torch.int32,
                                   device=self.device)
        self.results: Dict[int, Request] = {}
        self._warm_buckets: set = set()      # prefill bucket lengths run
        # exact aggregate serving metrics (per-request decode_s is prorated
        # batch wall time)
        self.decode_wall_s = 0.0
        self.decoded_tokens = 0

    @property
    def aggregate_tokens_per_sec(self) -> float:
        """Exact: total decoded tokens / total decode wall time."""
        return self.decoded_tokens / self.decode_wall_s \
            if self.decode_wall_s > 0 else 0.0

    def _lane(self) -> KVCache:
        return init_cache(self.card.n_layer, 1, self.cache_size,
                          self.card.n_kv_head, self.card.head_dim,
                          fmt=self.kv_fmt, device=self.device)

    def _decode(self, token, pool, streaming: bool):
        """One dispatch: ``decode_chunk`` decode+sample steps -> (tokens
        [k, B], pool)."""
        if self.decode_chunk > 1:
            toks, pool, self.gen = decode_sample_layered_k(
                self.card, self.decode_params, token, pool, self.gen,
                self.sampler, self.decode_chunk, streaming=streaming)
            return toks, pool
        tok, pool, self.gen = decode_sample_layered(
            self.card, self.decode_params, token, pool, self.gen,
            self.sampler, streaming=streaming)
        return tok[None], pool

    def warmup(self, max_prompt_len: int = 0) -> None:
        """Run the prefill of every bucket up to ``max_prompt_len`` (default:
        the longest waiting prompt) and one decode dispatch once, so the
        reported TTFTs are warm (first launches load the kernels)."""
        if max_prompt_len <= 0:
            max_prompt_len = max((len(r.prompt) for r in self.waiting),
                                 default=16)
        b = 16
        while True:
            if b not in self._warm_buckets:
                prefill(self.card, self.params,
                        torch.zeros((1, b), dtype=torch.int64,
                                    device=self.device),
                        self._lane(), return_all_logits=True, fresh=True,
                        device=self.device)
                self._warm_buckets.add(b)
            if b >= max_prompt_len:
                break
            b *= 2
        # the decode writes its cache in place: warm up on a copy
        cp = lambda t: None if t is None else tuple(x.clone() for x in t)
        pool = dataclasses.replace(
            self.pool, k=cp(self.pool.k), v=cp(self.pool.v),
            k_scale=cp(self.pool.k_scale), v_scale=cp(self.pool.v_scale),
            pos=self.pool.pos.clone())
        gen_state = self.gen.get_state()
        toks, _ = self._decode(self.cur_tok, pool, streaming=False)
        toks.tolist()                     # waits for the device
        self.gen.set_state(gen_state)
        del pool

    # -- admission ----------------------------------------------------------

    def submit(self, req: Request) -> None:
        self.waiting.append(req)

    def _admit(self) -> None:
        for slot in range(self.n_slots):
            if self.slots[slot] is not None or not self.waiting:
                continue
            req = self.waiting.pop(0)
            t0 = time.perf_counter()
            # bucket the prompt to the next power of two: right-pad with the
            # last token, roll ``pos`` back so the padded K/V stay masked,
            # and read the logits at the last REAL position
            blen = _bucket(len(req.prompt))
            req.ttft_cold = blen not in self._warm_buckets
            self._warm_buckets.add(blen)
            pad = blen - len(req.prompt)
            ids = req.prompt + [req.prompt[-1]] * pad
            all_logits, lane = prefill(
                self.card, self.params,
                torch.tensor([ids], dtype=torch.int64, device=self.device),
                self._lane(), return_all_logits=True, fresh=True,
                device=self.device)
            logits = all_logits[:, len(req.prompt) - 1]
            lane = kvc.advance(lane, -pad)
            self.pool = merge_lane(self.pool, lane, slot)
            tok = _sample(self.gen, logits, self.sampler)
            first = int(tok[0])               # waits for the device
            req.ttft_s = time.perf_counter() - t0
            req.tokens.append(first)
            self.cur_tok[slot] = tok[0]
            self.slots[slot] = req
            if first == req.eos_id or req.max_new <= 1:
                self._finish(slot)

    def _finish(self, slot: int) -> None:
        req = self.slots[slot]
        req.done = True
        self.results[req.rid] = req
        self.slots[slot] = None
        # free the lane: zero pos so the mask hides stale KV
        self.pool.pos[slot] = 0

    # -- main loop ----------------------------------------------------------

    def step(self) -> bool:
        """One engine step (admissions + one batched decode dispatch).
        Returns True while work remains."""
        self._admit()
        active = [s for s, r in enumerate(self.slots) if r is not None]
        if not active:
            return bool(self.waiting)
        t0 = time.perf_counter()
        # host-side streaming rule (see engine.generate): every lane's pos is
        # known on the host (prompt + emitted tokens), so pre-wrap dispatches
        # skip the sink re-rope
        max_pos = max(len(self.slots[s].prompt) + len(self.slots[s].tokens)
                      for s in active)
        streaming = max_pos + self.decode_chunk > self.cache_size
        toks, self.pool = self._decode(self.cur_tok, self.pool, streaming)
        steps = toks.tolist()                       # [k, B] — one sync
        self.cur_tok = toks[-1]
        dt = time.perf_counter() - t0
        self.decode_wall_s += dt
        for slot in active:
            req = self.slots[slot]
            req.decode_s += dt / len(steps) * min(
                len(steps), req.max_new - len(req.tokens)) \
                if req.max_new > len(req.tokens) else 0.0
            for row in steps:
                if req.done:
                    break
                req.tokens.append(int(row[slot]))
                self.decoded_tokens += 1
                if int(row[slot]) == req.eos_id or \
                        len(req.tokens) >= req.max_new:
                    self._finish(slot)
        return True

    def run(self) -> Dict[int, Request]:
        while self.step():
            pass
        return self.results
