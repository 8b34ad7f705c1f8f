"""``pretokenize`` — offline text -> token-shard converter (the JAX
package's ``cli/pretokenize.py``; the reference's PreTokenizer.py: HF
tokenizer -> 100M-token .bin shards with the 256-int32 header). Reads
plain-text and JSONL files, tokenizes with the model's tokenizer.json and
writes shards byte for byte as the JAX CLI does for the same inputs.

    python -m koifish_tpu_torch.cli.pretokenize --hf <model_dir> \\
        --input "data/*.txt" --out shards/ [--tokens-per-shard 100000000] \\
        [--val-frac 0.01] [--arch qwen3|qwen25|gpt2]
"""
from __future__ import annotations

import argparse
import glob as globlib
import json
import os
import sys

import numpy as np


def build_argparser():
    ap = argparse.ArgumentParser(prog="pretokenize")
    ap.add_argument("--hf", required=True, help="model dir with tokenizer.json")
    ap.add_argument("--input", required=True, help="glob of .txt/.jsonl files")
    ap.add_argument("--out", required=True)
    ap.add_argument("--name", default="data")
    ap.add_argument("--tokens-per-shard", type=int, default=100_000_000)
    ap.add_argument("--val-frac", type=float, default=0.01)
    ap.add_argument("--text-key", default="text", help="JSONL text field")
    ap.add_argument("--arch", default="qwen3",
                    choices=["qwen3", "qwen25", "gpt2"])
    ap.add_argument("--eos", default="<|endoftext|>")
    return ap


def iter_documents(files, text_key):
    for path in files:
        with open(path, encoding="utf-8", errors="replace") as f:
            if path.endswith(".jsonl"):
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        obj = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    txt = obj.get(text_key) if isinstance(obj, dict) else None
                    if txt:
                        yield txt
            else:
                yield f.read()


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    from koifish_tpu_torch.data import BPETokenizer, write_shard
    from koifish_tpu_torch.data.tokenset import (MAGIC_GPT2, MAGIC_QWEN3,
                                                 MAGIC_QWEN25)

    magic = {"qwen3": MAGIC_QWEN3, "qwen25": MAGIC_QWEN25,
             "gpt2": MAGIC_GPT2}[args.arch]
    tok = BPETokenizer.from_file(args.hf)
    eos = tok.token_id(args.eos)
    files = sorted(globlib.glob(args.input))
    if not files:
        print(f"pretokenize: no files match {args.input}", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)

    buf: list = []
    shard_idx = 0
    total = 0

    def flush(split):
        nonlocal buf, shard_idx
        if not buf:
            return
        path = os.path.join(
            args.out, f"{args.name}_{split}_{shard_idx:06d}.bin")
        write_shard(path, np.asarray(buf, np.uint32), magic,
                    vocab_size=tok.vocab_size)
        print(f"[pretokenize] wrote {path} ({len(buf)/1e6:.2f}M tokens)")
        buf = []
        shard_idx += 1

    n_docs = 0
    for doc in iter_documents(files, args.text_key):
        ids = tok.encode(doc)
        if eos is not None:
            ids.append(eos)
        buf.extend(ids)
        total += len(ids)
        n_docs += 1
        if len(buf) >= args.tokens_per_shard:
            flush("train")
    # the last shard becomes val when asked and more than one shard exists
    flush("val" if args.val_frac > 0 and shard_idx > 0 else "train")
    print(f"[pretokenize] {n_docs} docs, {total/1e6:.2f}M tokens, "
          f"{shard_idx} shards")
    return 0


if __name__ == "__main__":
    sys.exit(main())
