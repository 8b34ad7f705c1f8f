"""``pangpi`` — the evaluation CLI: HellaSwag accuracy and perplexity (the
JAX package's ``cli/pangpi.py``; the reference's eval binary, pangpi.cpp:
8-11, ``--hellaswag`` flag CLI_params.cpp:1494-1500).

    python -m koifish_tpu_torch.cli.pangpi --hf <model_dir> \\
        --hellaswag <shard.bin> [--max N] [--device cpu|cuda]
    python -m koifish_tpu_torch.cli.pangpi --hf <model_dir> \\
        --ppl "<shards_glob>" [--bits 4] [--batch 8]

``--bits`` quantizes the attention and MLP weights at load through
``quantize_params`` (RTN, group 128).
"""
from __future__ import annotations

import argparse
import sys
import time


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="pangpi")
    ap.add_argument("--hf", required=True)
    ap.add_argument("--hellaswag", default=None, help="hellaswag shard .bin")
    ap.add_argument("--ppl", default=None, help="token-shard glob for ppl")
    ap.add_argument("--bits", type=int, default=0)
    ap.add_argument("--max", type=int, default=0, help="cap samples/batches")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default=None, choices=["cpu", "cuda"],
                    help="default: the CUDA device (raises without one)")
    return ap


def main(argv=None, result=None) -> int:
    """Evaluate. ``result``: a dict that receives ``acc`` and/or ``ce`` and
    ``ppl``."""
    args = build_argparser().parse_args(argv)
    from koifish_tpu_torch.config import QuantCard
    from koifish_tpu_torch.data import TokenDataset, read_hellaswag_shard
    from koifish_tpu_torch.evaluate import hellaswag_accuracy, perplexity
    from koifish_tpu_torch.io import load_hf_model
    from koifish_tpu_torch.quant.apply import quantize_params
    from koifish_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    card, params = load_hf_model(args.hf, device=dev)
    if args.bits:
        qc = QuantCard.from_json({
            "self_attn": {"bits": args.bits}, "mlp": {"bits": args.bits}})
        params = quantize_params(params, qc, card, device=dev)
    out = {} if result is None else result

    ran = False
    if args.hellaswag:
        t0 = time.time()
        out["acc"] = hellaswag_accuracy(card, params,
                                        read_hellaswag_shard(args.hellaswag),
                                        max_samples=args.max)
        print(f"hellaswag acc={out['acc']:.4f} ({time.time()-t0:.0f}s)")
        ran = True
    if args.ppl:
        ds = TokenDataset(args.ppl)
        out["ce"], out["ppl"] = perplexity(
            card, params, ds.batches(args.batch, card.n_ctx),
            max_batches=args.max)
        print(f"ppl={out['ppl']:.4f} ce={out['ce']:.4f}")
        ran = True
    if not ran:
        print("pangpi: nothing to do (--hellaswag or --ppl)", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
