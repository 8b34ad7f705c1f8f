"""``koifish`` — the training / SFT / QAT CLI (the JAX package's
``cli/koifish.py``; the reference's train binary, koifish.cpp:29-60 ->
Fish::Train -> Optimizer::Search).

    python -m koifish_tpu_torch.cli.koifish <config.json> [--most-iter N]
        [--hf DIR] [--device cpu|cuda] [--out-dir DIR] [--resume CKPT]

One JSON config in the reference's schema is the product surface. It runs
on one device, the card unless ``--device cpu`` is given: pretraining from
token shards, SFT on ChatML jsonl (LoRA or another trainable mask),
checkpoints and ``--resume``, the in-training perplexity eval with its
``Eval.csv``, the ``gpt-every`` sample, the ``nn_structure`` dump and the
Fuyou swarm, and QAT from the config's quantizer card: fake-quant (STE),
or gama (scale-only) training, which quantizes the initial params and
trains their scales with the codes frozen. ``--sp N`` trains sequence-
parallel: a dp=1 tp=1 sp=N mesh over the run's devices (its ranks round-
robin where the devices are fewer, ``parallel/mesh.py``) and the model's
attention a ring over the sp axis.

``--dp/--tp/--pp > 1`` and ``--fsdp`` train on a process mesh, one rank a
process (``parallel/multihost.py``): the run joins a group set up by a
launcher, or starts its dp·tp·sp·pp local ranks itself, round-robin over
the cards (all on the CPU under ``--device cpu``). ``--sp`` beside them
adds an ``sp`` axis to that mesh, as the JAX CLI's one ``{dp, tp, sp}``
mesh has: attention is the plain ring over the sp ranks (each a process),
everything else runs on the whole sequence, and batches are cut over
``dp`` only. Each rank builds the whole
initial state from the seed and keeps its shard
(``train/sharded.shard_train_state``) and its rows of every batch; rank 0
does the run's I/O (prints, CSVs, evals, checkpoints of the gathered
state, the same file a one-rank run writes). ``--pp N`` runs the pipeline
alone (``parallel/pipeline.py``; ``--n-micro``, ``--pp-schedule``), fed
the tokens only as the JAX pipeline loop is (no loss mask, no trainable
mask). Gama (FSDP over its codes and scales too), LARS and the Fuyou swarm
(its draws whole, sliced to each rank's shards) train on the mesh. The
zoo's cards train under ``--tp`` and ``--pp`` where the JAX package's do;
LoRA adapters and LLAMA_VAE on a mesh of dp·tp·sp > 1 ranks, GUPPY and the
GAU/BROWN hybrids under ``--pp`` raise, as they fail in the JAX package
(ROADMAP.md queue 3).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="koifish")
    ap.add_argument("config", help="JSON config (reference schema)")
    ap.add_argument("--most-iter", type=int, default=None,
                    help="cap training iterations (debug.most_iter)")
    ap.add_argument("--hf", default=None, help="HF model dir (load weights)")
    ap.add_argument("--device", default=None, choices=["cpu", "cuda"],
                    help="default: the CUDA device (raises without one)")
    ap.add_argument("--out-dir", default=".", help="loss CSV / checkpoint dir")
    ap.add_argument("--dp", type=int, default=1, help="data-parallel ways")
    ap.add_argument("--tp", type=int, default=1, help="tensor-parallel ways")
    ap.add_argument("--sp", type=int, default=1,
                    help="sequence-parallel ways")
    ap.add_argument("--pp", type=int, default=1,
                    help="pipeline stages (one process a stage)")
    ap.add_argument("--n-micro", type=int, default=0,
                    help="pipeline microbatches (default: 2*pp)")
    ap.add_argument("--pp-schedule", default="1f1b",
                    choices=["1f1b", "gpipe"],
                    help="pipeline schedule: 1f1b (O(P) activation "
                         "memory, default) or gpipe")
    ap.add_argument("--fsdp", action="store_true",
                    help="shard params+moments over dp (ZeRO-3 analog)")
    ap.add_argument("--resume", default=None,
                    help="checkpoint to resume from (params+moments+step)")
    ap.add_argument("--wandb", default=None, metavar="PROJECT",
                    help="log to Weights & Biases when it is installed")
    return ap


#: the kernel libraries a training rank loads (built once, before the
#: ranks start, so they do not race on ``build/``)
TRAIN_KERNELS = ("flash_fwd", "flash_bwd", "fused_ce")


def _rank_main(argv) -> None:
    """One rank of a run whose local ranks this process started."""
    rc = main(argv)
    if rc:
        raise SystemExit(rc)


def _parallel_args(args) -> int:
    """The rank count of the run's process mesh; raises on the
    combinations the port does not take."""
    if args.pp > 1 and (args.dp > 1 or args.tp > 1 or args.sp > 1
                        or args.fsdp):
        raise ValueError("--pp runs the pipeline alone (as the JAX "
                         "package's pipeline loop does): drop --dp/--tp/"
                         "--sp/--fsdp")
    n = args.dp * args.tp * args.pp
    # --sp alone: the ranks of one controller (slice 14's path); beside
    # --dp/--tp/--fsdp: one more axis of the process mesh
    return n * args.sp if n > 1 or args.fsdp else n


def _on_device(batches, dev, mesh=None):
    """Numpy batches -> int64 token / bool mask tensors on ``dev``; with a
    process mesh, this rank's rows along ``dp`` only."""
    import torch
    for b in batches:
        if mesh is not None:
            from koifish_tpu_torch.train.sharded import shard_batch
            b = shard_batch(b, mesh)
        yield {k: torch.from_numpy(np.ascontiguousarray(v)).to(
            dev, torch.int64 if k == "tokens" else torch.bool)
            for k, v in b.items()}


def main(argv=None, result=None) -> int:
    """Train as the config says. ``result``: a dict that receives the run's
    ``card``, final ``state``, ``infos`` (its loss curve) and the last
    step's ``metrics`` (``leaf_norms`` among them when the config sets
    ``debug.check_tensor_norm``)."""
    args = build_argparser().parse_args(argv)
    n_ranks = _parallel_args(args)
    from koifish_tpu_torch.parallel import multihost
    if n_ranks > 1 and multihost.env_rank() is None:
        # no launcher: start this host's ranks here, one command in all
        if args.device != "cpu":
            from koifish_tpu_torch.ops.kernels import _build
            _build.build(TRAIN_KERNELS)
        multihost.spawn(_rank_main, n_ranks, (argv,), device=args.device)
        return 0
    multihost.init_distributed(device=args.device)
    import torch

    from koifish_tpu_torch.config import CLIParams
    from koifish_tpu_torch.data import TokenDataset
    from koifish_tpu_torch.evaluate import perplexity
    from koifish_tpu_torch.io import load_hf_model, save_train_state
    from koifish_tpu_torch.train.trainer import init_train_state, train_loop
    from koifish_tpu_torch.utils.device import resolve_device
    from koifish_tpu_torch.utils.tree import leaves

    mesh = None
    if n_ranks > 1 or args.fsdp:
        from koifish_tpu_torch.parallel import make_process_mesh
        mesh = make_process_mesh({"pp": args.pp, "dp": args.dp,
                                  "tp": args.tp, "sp": args.sp}, args.device)
        dev = mesh.device
    else:
        dev = resolve_device(args.device)
    main_rank = mesh is None or mesh.is_main
    say = print if main_rank else (lambda *a, **k: None)
    if mesh is not None:
        sp = f"sp={args.sp} " if args.sp > 1 else ""
        say(f"[koifish] process mesh dp={args.dp} tp={args.tp} {sp}"
            f"pp={args.pp} fsdp={args.fsdp}: {mesh.world} rank(s), backend "
            f"{multihost.backend_choice()}")
    p = CLIParams.load(args.config)
    if args.hf:
        p.hf_card = args.hf
    if args.most_iter is not None:
        p.train.most_iter = args.most_iter
    card, tcard = p.model, p.train
    qcard = p.quant if p.quant.rules else None

    params = None
    if p.hf_card:
        say(f"[koifish] loading HF weights from {p.hf_card}")
        card, params = load_hf_model(p.hf_card, card, device=dev)

    # SFT method wiring (LoRA adapters / trainable masks; SFT_CARD analog)
    trainable = None
    if p.sft is not None and params is not None:
        from koifish_tpu_torch.train.lora import add_lora, trainable_mask
        if p.sft.method == "lora":
            params = add_lora(params, p.sft,
                              torch.Generator().manual_seed(p.seed))
        if p.sft.method != "full":
            trainable = trainable_mask(params, p.sft.method)
        say(f"[koifish] SFT method={p.sft.method}")

    state = init_train_state(card, tcard, params=params, device=dev)
    resume_path = args.resume or p.checkpoint_in
    if resume_path:
        from koifish_tpu_torch.io import load_train_state
        state, _ = load_train_state(resume_path, state)
        say(f"[koifish] resumed from {resume_path} "
            f"(step {int(state.opt.step)})")
    n_params = sum(x.numel() for x in leaves(state.params))
    say(f"[koifish] arch={card.arch} layers={card.n_layer} "
        f"params={n_params/1e6:.1f}M device={dev.type}")
    if tcard.nn_structure:    # DUMP_SWITCH.nn_structure
        from koifish_tpu_torch.utils.dump import model_structure
        say(model_structure(state.params))

    train_ds = p.datasets.get("train")
    if train_ds is None or not train_ds.glob:
        print("[koifish] no train dataset in config", file=sys.stderr)
        return 2
    if train_ds.kind in ("OAI_message", "jsonl", "ChatML") and \
            train_ds.glob.endswith(".jsonl"):
        from koifish_tpu_torch.data import BPETokenizer
        from koifish_tpu_torch.data.sft import SFTDataset
        tok = BPETokenizer.from_file(p.hf_card)
        sds = SFTDataset.from_jsonl(train_ds.glob, tok, card.n_ctx)
        total_steps = max(len(sds) // tcard.batch, 1) * tcard.epochs
        batches = sds.batches(tcard.batch, seed=p.seed, epochs=tcard.epochs,
                              accum=tcard.grad_accum)
        say(f"[koifish] SFT: {len(sds)} conversations, {total_steps} steps")
    else:
        ds = TokenDataset(train_ds.glob, most=train_ds.most)
        steps_per_epoch = max(ds.total // (tcard.batch * card.n_ctx), 1)
        total_steps = steps_per_epoch * tcard.epochs
        batches = ds.batches(tcard.batch, card.n_ctx, seed=p.seed,
                             epochs=tcard.epochs, accum=tcard.grad_accum)
        say(f"[koifish] {ds.total/1e6:.1f}M tokens, {total_steps} steps "
            f"(B={tcard.batch}, ctx={card.n_ctx}, accum={tcard.grad_accum})")

    eval_cards = [d for k, d in p.datasets.items() if k.startswith("eval")]
    eval_csv = os.path.join(args.out_dir, "Eval.csv")
    eval_state = {"best": float("inf"), "last": float("inf"),
                  "no_improve": 0}

    def whole(st):
        """The whole state from the ranks' shards (every rank takes
        part); the state itself without a mesh."""
        if mesh is None:
            return st
        from koifish_tpu_torch.train.sharded import gather_train_state
        return gather_train_state(st)

    def eval_fn(st, it):
        st = whole(st)
        if not main_rank:
            return {}
        for d in eval_cards:
            if d.kind == "hellaswag":
                continue  # pangpi handles hellaswag
            try:
                eds = TokenDataset(d.glob, most=max(d.most, 1))
            except FileNotFoundError:
                continue
            ce, ppl = perplexity(card, st.params,
                                 eds.batches(tcard.batch, card.n_ctx),
                                 max_batches=max(int(8 * d.samp * 10), 2))
            # overfit / no-improvement heuristics (UpdateStepInfos,
            # TokenSet.cpp:603-619, Optimizer.hpp:69)
            best = eval_state["best"]
            overfit = (ce > eval_state["last"]
                       and abs(ce - best) > best / 10)
            if ce < best:
                eval_state["best"] = ce
                eval_state["no_improve"] = 0
            else:
                eval_state["no_improve"] += 1
            eval_state["last"] = ce
            flagmsg = " !OVERFIT!" if overfit else ""
            if eval_state["no_improve"] >= 3:
                flagmsg += f" (no improvement x{eval_state['no_improve']})"
            print(f"[eval {d.name}@{it}] ce={ce:.4f} ppl={ppl:.2f}{flagmsg}")
            new = not os.path.exists(eval_csv)
            with open(eval_csv, "a") as f:
                if new:
                    f.write("iter,dataset,ce,ppl\n")
                f.write(f"{it},{d.name},{ce:.6f},{ppl:.4f}\n")
        return {}

    # in-training chat sample every gpt_every iters (Optimizer::Evaluate's
    # chat hook, Optimizer.cpp:717-749; config train.gpt-every)
    gpt_tok = None
    if tcard.gpt_every > 0 and p.hf_card:
        from koifish_tpu_torch.data import BPETokenizer
        try:
            gpt_tok = BPETokenizer.from_file(p.hf_card)
        except (OSError, ValueError, KeyError) as e:
            print(f"[koifish] gpt-every disabled (no tokenizer): {e}")

    def gpt_sample(st, it):
        st = whole(st)
        if not main_rank:
            return
        from koifish_tpu_torch.config import SamplerCard
        from koifish_tpu_torch.serve import generate, init_cache
        prompt_text = (p.prompts[0] if p.prompts else "Once upon a time")
        ids = gpt_tok.encode(prompt_text)[: card.n_ctx // 2] or [0]
        cache = init_cache(card.n_layer, 1, min(card.n_ctx, 256),
                           card.n_kv_head, card.head_dim, device=dev)
        with torch.no_grad():
            toks, _ = generate(card, st.params,
                               torch.tensor([ids], dtype=torch.int64), cache,
                               SamplerCard(temperature=0.0),
                               max_new_tokens=24, device=dev)
        print(f"[gpt@{it}] {prompt_text!r} -> "
              f"{gpt_tok.decode([int(t) for t in toks[0]])!r}")

    ckpt_dir = (p.checkpoint_out.path if p.checkpoint_out else args.out_dir)
    os.makedirs(ckpt_dir or ".", exist_ok=True)

    def save_fn(st, it, tag):
        # rank 0 writes the gathered state: the file a one-rank run writes
        st = whole(st)
        if not main_rank:
            return
        path = os.path.join(ckpt_dir, f"koifish_{tag}_{it}.safetensors")
        save_train_state(path, st, card, extra_meta={"iter": it})
        print(f"[koifish] saved {tag} checkpoint -> {path}")

    # sequence parallelism: the ring over the sp axis (JAX
    # cli/koifish.py:213-239): of the process mesh beside --dp/--tp/--fsdp,
    # else of a dp=1 tp=1 mesh whose ranks one controller drives (with dp =
    # tp = 1 the JAX state and batch sharding only replicate)
    sp_policy = None
    if args.sp > 1 and mesh is not None:
        from koifish_tpu_torch.ops.tracectx import SPPolicy
        sp_policy = SPPolicy("sp", mesh)
    elif args.sp > 1:
        from koifish_tpu_torch.ops.tracectx import SPPolicy
        from koifish_tpu_torch.parallel import make_mesh
        sp_mesh = make_mesh({"dp": args.dp, "tp": args.tp, "sp": args.sp},
                            devices=None if args.device is None else [dev])
        sp_policy = SPPolicy("sp", sp_mesh)
        print(f"[koifish] mesh dp={args.dp} tp={args.tp} sp={args.sp} on "
              f"{sp_mesh.n_devices} device(s)")

    if mesh is not None and (args.tp > 1 or args.pp > 1):
        from koifish_tpu_torch.parallel.sharding import check_parallel_card
        check_parallel_card(card, "tensor parallelism" if args.tp > 1
                            else "pipeline parallelism")
    if mesh is not None and args.pp > 1:
        # before the QAT block: the JAX CLI's pipeline loop takes no
        # quantizer card (ROADMAP.md queue 3, known quirks)
        return _run_pipeline(args, mesh, card, tcard, state,
                             _on_device(batches, dev), total_steps, say,
                             result)
    if qcard is not None:
        mode = "gama" if qcard.train_target == "gama" else "fake-quant (STE)"
        say(f"[koifish] QAT enabled: {mode}, {len(qcard.rules)} rules")
        if qcard.train_target == "gama":
            from koifish_tpu_torch.quant.apply import quantize_params
            with torch.no_grad():
                qparams = quantize_params(state.params, qcard, card,
                                          device=dev)
            state = init_train_state(card, tcard, params=qparams, device=dev)

    if mesh is not None:
        from koifish_tpu_torch.train.sharded import shard_train_state
        state = shard_train_state(state, mesh,
                                  fsdp="dp" if args.fsdp else None)
        sl = multihost.per_host_batch_slice(tcard.batch, mesh)
        print(f"[koifish] rank {mesh.rank}/{mesh.world}: batch rows "
              f"{sl.start}:{sl.stop} of {tcard.batch}", flush=True)

    hooks = []
    if gpt_tok is not None:
        def gpt_hook(st, it, loss):
            if it and it % tcard.gpt_every == 0:
                gpt_sample(st, it)
            return None
        hooks.append(gpt_hook)

    # Fuyou EOE swarm: rotate branches every `switch` iters (the reference's
    # ExploreOptimization hook, gLLM.cpp:673-677; config model.fuyou)
    if p.fuyou:
        from koifish_tpu_torch.train.fuyou import Fuyou, FuyouConfig
        fcfg = FuyouConfig.from_json(p.fuyou)
        # on a mesh: this rank's shards of the swarm, each draw taken whole
        # from a generator seeded alike on every rank
        fy = Fuyou(fcfg, state.params, layout=state.layout)
        state = dataclasses.replace(state, params=fy.inject(state.params))
        fy_losses = []
        fy_gen = torch.Generator(device=dev)
        fy_gen.manual_seed(p.seed + 1)

        def fuyou_hook(st, it, loss):
            fy_losses.append(loss)
            if (it + 1) % fcfg.switch:
                return None
            recent = (sum(fy_losses[-fcfg.switch:])
                      / min(len(fy_losses), fcfg.switch))
            new_params = fy.rotate(st.params, recent, fy_gen)
            say(f"[fuyou] iter {it}: rotate -> branch {fy.cur} "
                f"(best={fy.best}, score={recent:.4f})")
            return dataclasses.replace(st, params=new_params)
        hooks.append(fuyou_hook)
        say(f"[koifish] fuyou swarm: {fcfg.branches} branches, "
            f"switch={fcfg.switch}, method={fcfg.method}")

    hook_fn = None
    if hooks:
        def hook_fn(st, it, loss):
            for h in hooks:
                new = h(st, it, loss)
                if new is not None:
                    st = new
            return st

    wandb_run = None
    if args.wandb and main_rank:
        try:
            import wandb
            wandb_run = wandb.init(project=args.wandb,
                                   config={"arch": card.arch,
                                           "batch": tcard.batch,
                                           "lr": tcard.lr})
        except Exception as e:   # an optional logger: report and go on
            print(f"[koifish] wandb unavailable: {e}")

    def log_fn(msg):
        print(msg)
        if wandb_run is not None and msg.startswith("["):
            parts = dict(kv.split("=", 1) for kv in
                         msg.partition("]")[2].split() if "=" in kv)
            vals = {}
            for k in ("loss", "lr", "gnorm"):
                try:
                    vals[k] = float(parts[k])
                except (KeyError, ValueError):
                    pass
            wandb_run.log(vals)

    t0 = time.time()
    state, infos = train_loop(
        card, tcard, state, _on_device(batches, dev, mesh),
        total_steps=total_steps, log_fn=log_fn if main_rank else None,
        eval_fn=eval_fn,
        save_fn=save_fn, qcard=qcard, trainable=trainable, hook_fn=hook_fn,
        sp=sp_policy)
    csv = tcard.train_csv_path or os.path.join(args.out_dir,
                                               "koifish_loss.csv")
    if main_rank:
        infos.save_csv(csv)
    if infos.rows:
        say(f"[koifish] done: {len(infos.rows)} iters in "
            f"{time.time()-t0:.0f}s, final loss {infos.losses[-1]:.4f}, "
            f"curve -> {csv}")
        if not main_rank:
            print(f"[koifish] rank {mesh.rank}/{mesh.world} done: final "
                  f"loss {infos.losses[-1]:.6f}", flush=True)
    if tcard.save_every or p.checkpoint_out:
        save_fn(state, len(infos.rows), "final")
    if result is not None:
        result.update(card=card, state=state, infos=infos,
                      metrics=infos.metrics,
                      fuyou=fy if p.fuyou else None)
    return 0


def _run_pipeline(args, mesh, card, tcard, state, batches, total_steps,
                  say, result) -> int:
    """The pipeline loop (``koifish --pp N``): this rank is stage
    ``mesh.index("pp")`` and holds its layers only; rank 0 logs and writes
    the loss curve."""
    from koifish_tpu_torch.parallel.pipeline import (make_pp_train_step,
                                                     stack_for_pipeline)
    from koifish_tpu_torch.train.optimizer import init_opt_state
    from koifish_tpu_torch.train.trainer import StepInfo

    n_micro = args.n_micro or 2 * args.pp
    if any(k.endswith("_lora") for lp in state.params["layers"] for k in lp):
        say("[koifish] pipeline: every leaf trains, adapters and base, on "
            "every token, as the JAX pipeline loop trains them (it takes "
            "no trainable mask and no loss mask)")
    stage_layers, other = stack_for_pipeline(state.params, args.pp,
                                             stage=mesh.index("pp"))
    del state
    opt = init_opt_state({"stages": stage_layers, "other": other},
                         tcard.optimizer, tcard.moment_dtype)
    step = make_pp_train_step(card, tcard, mesh, n_micro, total_steps,
                              schedule=args.pp_schedule)
    say(f"[koifish] pipeline: pp={args.pp} n_micro={n_micro} "
        f"schedule={args.pp_schedule} "
        f"(bubble {(args.pp - 1) / (n_micro + args.pp - 1):.0%})")
    infos = StepInfo()
    for it, batch in enumerate(batches):
        if 0 <= tcard.most_iter <= it or it >= total_steps:
            break
        # the tokens only, as the JAX pipeline loop feeds its step: no loss
        # mask (ROADMAP.md queue 3, known quirks)
        tokens = batch["tokens"].reshape(-1, batch["tokens"].shape[-1])
        t0 = time.perf_counter()
        stage_layers, other, opt, m = step(stage_layers, other, opt, tokens)
        loss = float(m["loss"])
        dt = time.perf_counter() - t0
        infos.add(it, loss, float(m["lr"]), dt, tokens.numel() / dt)
        infos.metrics = m
        infos.grad_norms.append(float(m["grad_norm"]))
        if tcard.dump_every and it % tcard.dump_every == 0:
            say(f"[{it}] loss={loss:.4f} gnorm={float(m['grad_norm']):.3f} "
                f"T={dt:.2f}s (pp)")
    csv = tcard.train_csv_path or os.path.join(args.out_dir,
                                               "koifish_loss.csv")
    if mesh.is_main:
        infos.save_csv(csv)
    if infos.rows:
        say(f"[koifish] pp done: {len(infos.rows)} iters, "
            f"final loss {infos.losses[-1]:.4f}")
    if result is not None:
        result.update(card=card, stages=stage_layers, other=other,
                      infos=infos, metrics=infos.metrics)
    return 0


if __name__ == "__main__":
    sys.exit(main())
