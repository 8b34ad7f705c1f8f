"""SFT datasets: JSONL conversations -> masked token batches (the JAX
package's ``data/sft.py``; the reference's Tokenset_JSONL -> ChatML samples
with label masks, TokenSet.hpp:172-215).

Accepts "OAI_message" JSONL, ``{"messages": [{"role", "content"}, ...]}``
per line or a bare list of messages per line. Samples are padded to
``seq_len + 1`` with ``pad_id`` and batches are drawn in the JAX package's
``np.random.default_rng(seed)`` order, as numpy arrays.
"""
from __future__ import annotations

import json
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from koifish_tpu_torch.data.chat_template import sft_sample_to_tokens


def load_jsonl_conversations(path: str) -> List[List[dict]]:
    convs = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            msgs = obj.get("messages", obj) if isinstance(obj, dict) else obj
            if isinstance(msgs, list) and msgs:
                convs.append(msgs)
    return convs


class SFTDataset:
    """Tokenized conversations packed into fixed-length masked samples; a
    sample with no masked (trained) token is dropped."""

    def __init__(self, conversations: Sequence[List[dict]], tokenizer,
                 seq_len: int, pad_id: int = 0, multi_turn: bool = True):
        self.samples: List[Tuple[np.ndarray, np.ndarray]] = []
        for msgs in conversations:
            if not multi_turn:   # first user/assistant exchange only
                msgs = msgs[:2]
            toks, mask = sft_sample_to_tokens(tokenizer, msgs)
            if not toks:
                continue
            toks = np.asarray(toks[: seq_len + 1], np.int32)
            mask = np.asarray(mask[: seq_len + 1], bool)
            if len(toks) < seq_len + 1:
                pad = seq_len + 1 - len(toks)
                toks = np.concatenate([toks, np.full(pad, pad_id, np.int32)])
                mask = np.concatenate([mask, np.zeros(pad, bool)])
            if mask.any():
                self.samples.append((toks, mask))

    @classmethod
    def from_jsonl(cls, path: str, tokenizer, seq_len: int, **kw):
        return cls(load_jsonl_conversations(path), tokenizer, seq_len, **kw)

    def __len__(self) -> int:
        return len(self.samples)

    def batches(self, batch: int, seed: int = 42, epochs: int = 1,
                accum: int = 1) -> Iterator[dict]:
        """Yields {"tokens": [A, B, T+1] int32, "loss_mask": [A, B, T+1]}."""
        rng = np.random.default_rng(seed)
        group = batch * accum
        for _ in range(epochs):
            order = rng.permutation(len(self.samples))
            for i in range(0, len(order) - group + 1, group):
                sel = order[i: i + group]
                toks = np.stack([self.samples[j][0] for j in sel])
                mask = np.stack([self.samples[j][1] for j in sel])
                T = toks.shape[-1]
                yield {"tokens": toks.reshape(accum, batch, T),
                       "loss_mask": mask.reshape(accum, batch, T)}
