"""``bubble`` — chat/inference CLI of the port.

Usage: python -m koifish_tpu_torch.cli.bubble --hf <model_dir>
           [--prompts "..." ...] [--bits 8] [--kv-bits 8] [--max-new 256]
           [--config cfg.json] [--draft-hf <dir>] [--device cpu|cuda]

The JAX package's ``cli/bubble.py``, flag for flag: quantize-at-load,
chat-template prompt render, decode with per-turn tokens/s, answers
appended to a CSV, and speculative decoding with ``--draft-hf`` (the draft
loaded bf16 with a BF16 cache). It runs on the card unless ``--device cpu``
is given. ``--hf`` also takes a reference ``.kun``/``.ckp`` model file: its
embedded config makes the card, the folder's ``tokenizer.dat`` (else its
``tokenizer.json``) the tokenizer, and chat-template paths are relative to
the file's folder. With a draft, every turn starts a fresh conversation.

``--tp N`` serves tensor-parallel, one rank a process
(``parallel/multihost.py``: a launcher's group, or N local ranks started
here, round-robin over the cards). Each rank holds its shard: with
``--bits`` streamed and quantized shard by shard from the safetensors mmap
(``io/stream_load.py``; GPT2/MoE load whole, quantize and keep their
shard), else loaded whole and sliced (``parallel/sharding.shard_params``).
The model runs on each rank's card of ``n_head/N`` heads with the
row-parallel sums and the vocab-parallel embedding and head of
``ops/tracectx.TPPolicy``; rank 0 samples and broadcasts every token,
reads the ``--interactive`` input and does the printing and the CSV.
With ``--draft-hf`` under ``--tp`` the draft loads whole on every rank
with its own BF16 cache and runs without collectives; the target's verify
forwards run on the rank's shard, and every rank takes the same
accept/reject decisions from the same seeded generators, checked each
round (``serve/speculative.py``).
"""
from __future__ import annotations

import argparse
import csv
import os
import sys
import time
from typing import List, Optional

import torch

from koifish_tpu_torch.config import CLIParams, QuantCard, SamplerCard
from koifish_tpu_torch.data import BPETokenizer, ScoreTokenizer, render
from koifish_tpu_torch.dtypes import QFormat, qformat_from_bits
from koifish_tpu_torch.io.hf_loader import load_hf_model, load_kun_model
from koifish_tpu_torch.ops.tracectx import tp_scope
from koifish_tpu_torch.quant.apply import quantize_params
from koifish_tpu_torch.serve import cache_for, generate
from koifish_tpu_torch.serve.speculative import speculative_generate
from koifish_tpu_torch.serve.stacked import stack_layers
from koifish_tpu_torch.utils.device import resolve_device


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="bubble")
    ap.add_argument("--hf", required=False, help="HF model dir")
    ap.add_argument("--config", default=None, help="JSON config")
    ap.add_argument("--prompts", nargs="*", default=None)
    ap.add_argument("--bits", type=int, default=0,
                    help="weight-only quant bits at load (0 = bf16)")
    ap.add_argument("--kv-bits", type=int, default=0, choices=[0, 4, 8])
    ap.add_argument("--max-new", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.6)
    ap.add_argument("--top-k", type=int, default=50)
    ap.add_argument("--top-p", type=float, default=0.95)
    ap.add_argument("--metropolis", action="store_true",
                    help="GOPT_Metropolis sampling: CDF over the full "
                         "softmax of the raw logits")
    ap.add_argument("--approx-topk", action="store_true",
                    help="accepted for parity with the JAX package; the "
                         "port's top-k is always exact")
    ap.add_argument("--ctx", type=int, default=1024)
    ap.add_argument("--device", default=None, choices=["cpu", "cuda"],
                    help="default: the CUDA device")
    ap.add_argument("--csv", default="chat.csv")
    ap.add_argument("--decode-chunk", type=int, default=8,
                    help="decode steps between host eos checks")
    ap.add_argument("--think", action="store_true", help="enable thinking mode")
    ap.add_argument("--interactive", action="store_true",
                    help="multi-turn REPL on stdin (cache persists across turns)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel ways (one process a rank)")
    ap.add_argument("--draft-hf", default=None,
                    help="draft model dir -> speculative decoding (exact "
                         "target distribution via rejection sampling)")
    ap.add_argument("--draft-k", type=int, default=4,
                    help="draft tokens per verify round")
    return ap


#: the kernel libraries a serving rank loads (built once, before the ranks
#: start, so they do not race on ``build/``)
SERVE_KERNELS = ("flash_fwd", "qmatmul", "qmm", "decode_attn", "slotwrite")


def _weight_qcard(bits: int) -> QuantCard:
    return QuantCard.from_json({"self_attn": {"bits": bits},
                                "mlp": {"bits": bits}})


def _rank_main(argv) -> None:
    """One rank of a run whose local ranks this process started."""
    rc = main(argv)
    if rc:
        raise SystemExit(rc)


def main(argv=None, turns: Optional[List[dict]] = None) -> int:
    """Run the CLI. ``turns``, when given, receives one record per chat
    turn: prompt, answer, prompt and generated token ids, tokens/s and, with
    a draft, the speculative stats."""
    args = build_argparser().parse_args(argv)
    from koifish_tpu_torch.parallel import multihost
    if args.tp > 1 and multihost.env_rank() is None:
        # no launcher: start the tp ranks here, one command in all
        if args.device != "cpu":
            from koifish_tpu_torch.ops.kernels import _build
            _build.build(SERVE_KERNELS)
        multihost.spawn(_rank_main, args.tp, (argv,), device=args.device)
        return 0
    mesh = tp = None
    if args.tp > 1:
        from koifish_tpu_torch.ops.tracectx import TPPolicy
        from koifish_tpu_torch.parallel import make_process_mesh
        multihost.init_distributed(device=args.device)
        mesh = make_process_mesh({"tp": args.tp}, args.device)
        dev = mesh.device
    else:
        dev = resolve_device(args.device)
    main_rank = mesh is None or mesh.is_main
    say = print if main_rank else (lambda *a, **k: None)
    if mesh is not None:
        say(f"[bubble] tensor-parallel over {args.tp} ranks, backend "
            f"{multihost.backend_choice()}")
    p = CLIParams.load(args.config) if args.config else CLIParams.from_json({})
    hf_dir = args.hf or p.hf_card
    if not hf_dir:
        print("bubble: --hf <model_dir> required", file=sys.stderr)
        return 2
    prompts = args.prompts if args.prompts is not None else p.prompts
    if not prompts:
        prompts = ["hello"]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    say(f"[bubble] loading {hf_dir} ...")
    t0 = time.perf_counter()
    streamed = False
    if mesh is not None and args.bits and not hf_dir.endswith((".kun",
                                                                ".ckp")):
        # the big-model path: each rank streams its shard mmap -> quantize
        from koifish_tpu_torch.io.stream_load import \
            load_hf_sharded_quantized
        try:
            card, params = load_hf_sharded_quantized(
                hf_dir, mesh, _weight_qcard(args.bits))
            streamed = True
            say(f"[bubble] streamed sharded quantize-at-load "
                f"({args.bits}-bit, tp={args.tp})")
        except NotImplementedError:     # GPT2/MoE: load whole below
            pass
        tokenizer = BPETokenizer.from_file(hf_dir)
    if streamed:
        pass         # card, params and tokenizer are this rank's already
    elif hf_dir.endswith((".kun", ".ckp")):
        # reference single-file model (config embedded as a msgpack tensor)
        card, params, _ = load_kun_model(hf_dir, device=dev)
        hf_dir = os.path.dirname(hf_dir) or "."   # chat-template paths
        tk = os.path.join(hf_dir, "tokenizer.dat")
        tokenizer = (ScoreTokenizer.from_tokenizer_dat(tk)
                     if os.path.exists(tk) else BPETokenizer.from_file(hf_dir))
    else:
        card, params = load_hf_model(hf_dir, device=dev)
        tokenizer = BPETokenizer.from_file(hf_dir)
    sync()
    say(f"[bubble] {card.arch} {card.n_layer}L loaded in "
        f"{time.perf_counter() - t0:.1f}s on {dev.type}")

    draft_card = draft_params = None
    if args.draft_hf:
        draft_card, draft_params = load_hf_model(args.draft_hf, device=dev)
        say(f"[bubble] draft {draft_card.arch} {draft_card.n_layer}L "
            f"(k={args.draft_k}, greedy/lossless)")

    if args.bits and not streamed:
        t0 = time.perf_counter()
        params = quantize_params(params, _weight_qcard(args.bits), card,
                                 device=dev)
        sync()
        say(f"[bubble] quantize-at-load {args.bits}-bit in "
            f"{time.perf_counter() - t0:.1f}s")
    if mesh is not None:
        from koifish_tpu_torch.parallel.sharding import (local_card,
                                                         shard_params)
        if not streamed:
            params = shard_params(params, mesh)
        tp = TPPolicy(group=mesh.group("tp"), rank=mesh.index("tp"),
                      size=args.tp, vocab=card.vocab_size,
                      src=mesh.ranks("tp")[0])
        run_card = local_card(card, args.tp, check=False)
    else:
        run_card = card

    kv_fmt = QFormat.BF16 if not args.kv_bits else qformat_from_bits(args.kv_bits)
    sampler = SamplerCard(temperature=args.temperature, top_k=args.top_k,
                          top_p=args.top_p, max_new_tokens=args.max_new,
                          approx_top_k=args.approx_topk,
                          method="metropolis" if args.metropolis else "topk")
    eos = tokenizer.token_id("<|im_end|>") or tokenizer.token_id("<|endoftext|>") or -1
    dparams = stack_layers(params)   # layer-stacked decode params

    rows = []

    def one_turn(prompt, cache):
        """Run one chat turn; returns (answer, cache) — the cache carries
        the conversation for multi-turn REPL use."""
        text = render([{"role": "user", "content": prompt}], hf_dir, card.arch,
                      enable_thinking=args.think)
        card_ = run_card
        ids = tokenizer.encode(text)
        size = max(args.ctx, len(ids) + args.max_new)
        prompt_t = torch.tensor([ids], dtype=torch.int64, device=dev)
        stats = None
        t0 = time.perf_counter()
        if args.draft_hf:
            tc = cache_for(card_, 1, size + args.draft_k, fmt=kv_fmt,
                           device=dev)
            dc = cache_for(draft_card, 1, size + args.draft_k,
                           fmt=QFormat.BF16, device=dev)
            toks, stats = speculative_generate(
                card_, params, draft_card, draft_params, prompt_t, tc, dc,
                k=args.draft_k, max_new_tokens=args.max_new, eos_id=eos,
                sampler=sampler, device=dev, tp=tp)
            cache = None
            say(f"[bubble] speculative: {stats['rounds']} rounds, "
                f"accept_rate={stats['accept_rate']:.2f}")
        else:
            if cache is not None and int(cache.pos[0]) + len(ids) > cache.size:
                # the carried conversation cannot take this prompt: answer
                # it on a fresh cache (the JAX package's clamped write
                # would overwrite the last turn's slots; ROADMAP queue 3)
                say(f"[bubble] context full ({int(cache.pos[0])} + "
                      f"{len(ids)} > {cache.size} slots): this turn starts "
                      f"a fresh context")
                cache = None
            if cache is None:
                cache = cache_for(card_, 1, size, fmt=kv_fmt, device=dev)
            with tp_scope(tp):
                toks, cache = generate(card_, params, prompt_t, cache,
                                       sampler, max_new_tokens=args.max_new,
                                       eos_id=eos, decode_params=dparams,
                                       decode_chunk=args.decode_chunk,
                                       device=dev)
        sync()
        dt = time.perf_counter() - t0
        new_ids = toks[0].tolist()
        out_ids = [t for t in new_ids if t != eos]
        answer = tokenizer.decode(out_ids)
        tks = len(out_ids) / dt if dt > 0 else 0.0
        say(f"\n>>> {prompt}\n{answer}\n[{tks:.2f} tk/s, "
            f"{len(ids)} prompt + {len(out_ids)} new]")
        rows.append((prompt, answer, f"{tks:.2f}"))
        if turns is not None:
            turns.append(dict(prompt=prompt, answer=answer, prompt_ids=ids,
                              tokens=new_ids, tk_s=tks, seconds=dt,
                              stats=stats))
        return answer, cache

    def read_prompt() -> str:
        """The next line of input, read by rank 0 and sent to every rank."""
        prompt = ""
        if main_rank:
            try:
                prompt = input("you> ").strip()
            except EOFError:
                prompt = ""
        if mesh is not None:
            box = [prompt]
            import torch.distributed as dist
            dist.broadcast_object_list(box, src=mesh.ranks("tp")[0],
                                       group=mesh.group("tp"))
            prompt = box[0]
        return prompt

    if args.interactive:
        cache = None
        say("[bubble] interactive mode — empty line to exit")
        while True:
            prompt = read_prompt()
            if not prompt:
                break
            try:
                _, cache = one_turn(prompt, cache)
            except Exception as e:  # cache overflow etc: restart conversation
                if mesh is not None:
                    raise        # the ranks cannot agree on a recovery
                print(f"[bubble] {type(e).__name__}: {e}; resetting context")
                cache = None
    else:
        for prompt in prompts:
            one_turn(prompt, None)

    if args.csv and main_rank:
        new = not os.path.exists(args.csv)
        with open(args.csv, "a", newline="") as f:
            w = csv.writer(f)
            if new:
                w.writerow(["prompt", "answer", "tokens_per_sec"])
            w.writerows(rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
