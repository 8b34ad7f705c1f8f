"""Token-shard datasets, in the JAX package's shard format byte for byte
(``data/tokenset.py`` there; the reference's PreTokenizer.py:159-246 and
TokenSet.cpp:225-271).

Shard layout:

- 1024-byte header = 256 × int32:
  [0] magic  — 20240520 GPT2 (uint16 tokens), 20250520 Qwen2.5,
               20251218 Qwen3 (uint32), 20240522 HellaSwag
  [1] version = 1
  [2] token count (tokens) or sample count (hellaswag)
  [3] bytes per token (or longest-example-bytes for hellaswag)
  [9] vocab size   [10] has_masks
- token payload (uint16 / uint32)
- optional SFT loss-mask bits (np.packbits little-endian) after tokens

Batches are numpy arrays on the host, drawn in the JAX package's order
(one ``np.random.default_rng(seed)`` permutation of the windows an epoch),
so the same shards and seed give the same batches element for element.
Unmasked shards are served, as in the JAX package, by the native prefetch
server (``native.NativeBatchServer``: a C++ thread gathers the same
schedule ahead of the consumer); masked (SFT) shards, or a native library
that cannot be had (logged through ``utils/kernel_log``), take the Python
path with the same permutations.
"""
from __future__ import annotations

import glob as globlib
import logging
from typing import Iterator, List, Optional, Tuple

import numpy as np

MAGIC_GPT2 = 20240520
MAGIC_QWEN25 = 20250520
MAGIC_QWEN3 = 20251218
MAGIC_HELLASWAG = 20240522
HEADER_INTS = 256


def write_shard(path: str, tokens: np.ndarray, magic: int = MAGIC_QWEN3,
                vocab_size: int = 0, masks: Optional[np.ndarray] = None,
                ) -> None:
    header = np.zeros(HEADER_INTS, dtype=np.int32)
    header[0] = magic
    header[1] = 1
    header[2] = len(tokens)
    bpt = 2 if magic == MAGIC_GPT2 else 4
    header[3] = bpt
    header[9] = vocab_size
    header[10] = 0 if masks is None else 1
    dt = np.uint16 if bpt == 2 else np.uint32
    if masks is not None and len(masks) != len(tokens):
        raise ValueError(f"{len(masks)} mask bits for {len(tokens)} tokens")
    with open(path, "wb") as f:
        f.write(header.tobytes())
        f.write(np.asarray(tokens, dtype=dt).tobytes())
        if masks is not None:
            f.write(np.packbits(np.asarray(masks, bool),
                                bitorder="little").tobytes())


def read_shard(path: str) -> Tuple[np.ndarray, Optional[np.ndarray], dict]:
    """Returns (tokens, loss_mask or None, info). The tokens are a read-only
    memmap view."""
    header = np.fromfile(path, dtype=np.int32, count=HEADER_INTS)
    magic, version, count, bpt = (int(header[0]), int(header[1]),
                                  int(header[2]), int(header[3]))
    if version != 1:
        raise ValueError(f"bad shard version {version} in {path}")
    if magic not in (MAGIC_GPT2, MAGIC_QWEN25, MAGIC_QWEN3):
        raise ValueError(f"bad shard magic {magic} in {path}")
    dt = np.uint16 if magic == MAGIC_GPT2 else np.uint32
    off = HEADER_INTS * 4
    tokens = np.memmap(path, dtype=dt, mode="r", offset=off, shape=(count,))
    mask = None
    if int(header[10]):
        moff = off + count * dt().itemsize
        bits = np.fromfile(path, dtype=np.uint8, offset=moff,
                           count=(count + 7) // 8)
        mask = np.unpackbits(bits, bitorder="little")[:count].astype(bool)
    info = dict(magic=magic, vocab_size=int(header[9]), count=count, bpt=bpt)
    return tokens, mask, info


class TokenDataset:
    """Glob'd shard collection with deterministic batch sampling (the
    reference's DataTokenSet + SampLoader, TokenSet.hpp:116,
    DataLoader.hpp:139)."""

    def __init__(self, pattern: str, most: int = -1):
        files = sorted(globlib.glob(pattern))
        if 0 < most < len(files):
            files = files[:most]
        if not files:
            raise FileNotFoundError(f"no shards match {pattern}")
        self.files = files
        self.shards: List[Tuple[np.ndarray, Optional[np.ndarray]]] = []
        self.total = 0
        for f in files:
            toks, mask, _ = read_shard(f)
            self.shards.append((toks, mask))
            self.total += len(toks)

    def batches(self, batch: int, seq_len: int, seed: int = 42,
                epochs: int = 1, accum: int = 1) -> Iterator[dict]:
        """Yields {"tokens": [A, B, T+1] int32 (+ "loss_mask" bool)}: the
        windows of T+1 tokens at stride T, shuffled once an epoch."""
        need = seq_len + 1
        windows: List[Tuple[int, int]] = []   # (shard, offset)
        for si, (toks, _) in enumerate(self.shards):
            for off in range(0, len(toks) - need, seq_len):
                windows.append((si, off))
        rng = np.random.default_rng(seed)
        group = batch * accum
        dropped = len(windows) % group
        if dropped:
            logging.getLogger("koifish_tpu_torch").info(
                "TokenDataset.batches: dropping %d trailing windows per epoch "
                "(%d windows %% group %d)", dropped, len(windows), group)
        if not any(m is not None for _, m in self.shards):
            try:
                from koifish_tpu_torch.native import NativeBatchServer
                warr = np.asarray(windows, np.int64).reshape(-1, 2)
                scheds = []
                for _ in range(epochs):
                    order = rng.permutation(len(windows))
                    scheds.append(warr[order[:(len(order) // group)
                                             * group]])
                sched = np.concatenate(scheds, axis=0)
                srv = NativeBatchServer(self.files,
                                        sched[:, 0].astype(np.int32),
                                        sched[:, 1], group, need)
            except (RuntimeError, OSError) as e:
                from koifish_tpu_torch.utils import kernel_log
                kernel_log.fallback("native_batchserver",
                                    f"{type(e).__name__}: "
                                    f"{str(e).splitlines()[0]}")
                rng = np.random.default_rng(seed)   # replay identically
            else:
                try:
                    for tok in srv:
                        yield {"tokens": tok.reshape(accum, batch, need)}
                finally:
                    srv.close()
                return
        for _ in range(epochs):
            order = rng.permutation(len(windows))
            for i in range(0, len(order) - group + 1, group):
                sel = [windows[j] for j in order[i: i + group]]
                tok = np.stack([np.asarray(self.shards[s][0][o: o + need])
                                for s, o in sel]).astype(np.int32)
                out = {"tokens": tok.reshape(accum, batch, need)}
                if any(self.shards[s][1] is not None for s, _ in sel):
                    msk = np.stack([
                        self.shards[s][1][o: o + need]
                        if self.shards[s][1] is not None
                        else np.ones(need, bool) for s, o in sel])
                    out["loss_mask"] = msk.reshape(accum, batch, need)
                yield out


# ---------------------------------------------------------------------------
# HellaSwag — llm.c-style eval shards
# ---------------------------------------------------------------------------

def read_hellaswag_shard(path: str):
    """Yields (label, [4 x (context+completion tokens, completion_mask)]).

    Record layout (the reference's TokenSet.cpp:456-516, llm.c): uint16
    triplets <START=65535, EXAMPLE_BYTES, EXAMPLE_INDEX>, then <label,
    n_ctx_tokens, 4 x (n_comp_tokens, tokens...)> — all uint16.
    """
    header = np.fromfile(path, dtype=np.int32, count=HEADER_INTS)
    if int(header[0]) != MAGIC_HELLASWAG:
        raise ValueError(f"not a hellaswag shard: {path}")
    n_samples = int(header[2])
    data = np.fromfile(path, dtype=np.uint16, offset=HEADER_INTS * 4)
    pos = 0
    for idx in range(n_samples):
        start, ex_bytes, ex_idx = data[pos], data[pos + 1], data[pos + 2]
        if start != 65535 or ex_idx != idx:
            raise ValueError(f"hellaswag shard {path}: bad record {idx} at "
                             f"word {pos}")
        body = data[pos + 3: pos + ex_bytes // 2]
        label = int(body[0])
        n_ctx = int(body[1])
        ctx = body[2: 2 + n_ctx]
        p = 2 + n_ctx
        options = []
        for _ in range(4):
            n_comp = int(body[p])
            p += 1
            comp = body[p: p + n_comp]
            p += n_comp
            toks = np.concatenate([ctx, comp]).astype(np.int32)
            mask = np.zeros(len(toks), bool)
            mask[len(ctx):] = True
            options.append((toks, mask))
        yield label, options
        pos += ex_bytes // 2
