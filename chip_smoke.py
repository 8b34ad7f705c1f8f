#!/usr/bin/env python3
"""Drive the koifish_tpu_torch serving and training paths on one NVIDIA GPU
and check them.

    python3 chip_smoke.py

Phases, in order; any failed check exits non-zero before the last line:

1. build   — compile every CUDA kernel of both paths from
             ``koifish_tpu_torch/csrc`` (one nvcc per source, in parallel)
             and print the times.
2. card    — print the card's name and power limit (nvidia-smi) and turn
             TF32 off for matmuls and cuDNN.
3. kernels — each kernel against its plain PyTorch version on the card, at
             the shapes of its path and at ragged ones, with the tolerance
             stated; kernel, plain, library and bound times. Serving: flash
             forward (also timed at the Qwen3-0.6B and GPT2-124M training
             shapes beside SDPA), dequant-fused GEMM/GEMV (the GEMV at m =
             1, 5, 8, 17, 32 for every format, N on and off its tiles, K
             256-3072; timed at m = 32 INT4 and at chat's m = 1 INT8 codes),
             quantized-KV decode attention and its fused K/V write (INT8
             and INT4, one to eight splits, g 1-16, D 64-256 and MLA's 192
             / 128, one case with q along the new key; the write's cache
             bytes bit for bit, a repeat launch bit for bit, two planted
             faults rejected: the stale row read, the last split dropped;
             timed at the slice's, the batcher's, chat's and a g = 8
             shape, beside SDPA on the dequantized cache); the paged
             decode attention and its fused page write (D 64, 128 and
             256, g 1-16, one to eight splits, MAXP 4, 5, 8 and 64,
             lengths to 8192 on scattered tables with stale ids past each
             length; the written pages bit for bit, a repeat launch bit
             for bit, three planted faults rejected: two table entries
             swapped, the last live page dropped, the new row's write
             skipped; timed at the paged run's, chat's and a g = 8 shape,
             beside SDPA on a dense view gathered outside the timed call).
             Training: flash backward (dK/dV and dQ kernels, at the Qwen3
             and GPT2 shapes, ragged T and windows; times at both) and the
             fused classifier CE (forward, the backward's dlogits kernel and
             its dx and dw GEMMs; E 64-2560, ragged V, untied; a repeat of
             every launch bit for bit; the backward's extra memory at most
             512 MiB); flash forward and backward at one row of the LoRA
             SFT step (T 8192) and the fused CE at its 131,072 rows, 95 %
             masked, all timed. Int8 training, at GPT2-774M's shapes:
             rowquant/colquant (bit for bit), the per-tile int8 dgrad (its
             quantize pass and wgmma GEMM; bit for bit at the fc shape and
             at M 1100, K 330, a repeat launch too, and two planted faults
             rejected: one row scale over all of N, the last tile dropped)
             and the int8 fused CE (and the bf16 one) at E 1280, 1600 and
             2560, with the library's products timed beside both flavours.
             Multi-request serving: the
             KV slot and page writes (bit for bit) and the learned-codebook
             GEMV/GEMM (k-means and MINI books, NF4 and NF3, m 1-4097).
             Chat: the int8
             GEMV with in-kernel activation quantization (row 5) at Qwen3's
             projections, m = 1, 5 and 32 (a repeat launch bit for bit; two
             planted faults rejected: the next group's sx, the last K split
             dropped; one kernel a call under the profiler), timed beside
             the row-4 GEMV at m = 32 and 1. The
             GEMM shape (m > 32) also at m and N off its 128 x 128 tiles
             (m = 33, 65, 129, 4097; N = 132, 200, 520, 1000).
   grad    — dx through a kernel-covered QTensor (GEMM and GEMV shapes, RTN
             INT4/INT8, k-means and MINI books) against the gradient through
             the dequantized weight; with the scales and the book requiring
             a gradient too (gama), one kernel launch forward and dx,
             dscales and dbook against autograd through the dequantized
             weight (1 % of the largest entry); row 5 with x requiring a
             gradient must raise.
4. serving — Qwen3-0.6B at full width (configs/qwen3_0.6b.json, random
             weights from a seed), INT4 RTN g128 weights, a layered INT8 KV
             cache (B=32, S=1024): ``generate`` on 32 prompts of 128 tokens
             (64 new tokens, decode_chunk 16, T 0.6 / top-k 50 / top-p 0.95),
             three rounds, then a greedy B=1 call. Prints warm TTFT, decode
             tok/s and ms/step (each round and the median), peak device
             memory and each kernel's launches in that run, which must all
             be > 0.
             A torch.profiler window over a fresh prefill and one decode
             chunk prints device time by kernel and the idle share. A tiny
             model's card run is held against the CPU run of the same
             weights.
   batcher — the same model with k-means NF4 weights behind a
             ContinuousBatcher (INT8 KV, 32 slots of 1024, decode_chunk 8)
             serving 96 seeded requests (prompts 16-512, 16-128 new tokens):
             requests completed, aggregate decode tok/s, warm TTFT p50/p90,
             launches (the book GEMV/GEMM, the fused K/V write, flash
             forward and decode attention must all be > 0), and the idle
             share and device launches a step over one decode chunk. Then
             ``generate_paged`` on the same params (B=32, 128-token
             prompts, 64 new): tok/s, page-pool growth; fails unless each
             layer of each of the 191 steps made one paged_attn_write
             launch, with no standalone page write and no gather; then the
             idle share and device launches a step over one paged decode
             chunk. A tiny k-means model's batcher and paged runs on the
             card are held against the CPU.
   chat    — a Qwen3-0.6B HF folder (the config's dims, seeded bf16 weights,
             a byte-level tokenizer) written under build/ and served
             through ``koifish_tpu_torch.cli.bubble.main`` with --bits 8
             --kv-bits 8 and the "mxu" INT8 GEMV: three chat prompts, 64
             greedy tokens each, plain and with a bf16 self-draft
             (speculative, k = 4). Fails unless qmv_int8 launched in both
             runs, flash_fwd, qmm and decode_attn in the plain one, no
             qmatmul fallback was logged and the speculative tokens agree
             with the plain ones at >= 75 % of positions. Then a profiled
             B=1 chat turn (device time by kernel, idle share), the INT8
             decode A/B ("mxu" vs "dot", B=32 x 128, 64 new) and a tiny
             folder's bubble run on the card against the CPU.
5. training — a tiny QWEN3 ``make_train_step`` on the card against the CPU
             (loss, every gradient norm, updated params; SR off). Then
             ``train_loop`` at ``bench.py``'s train settings (lr 6e-4,
             warmup 10, AdamW, no remat, SR and fused CE auto) on one fixed
             random batch of 1024-token rows: Qwen3-0.6B at full width
             and DEPTH layers, B=8, then GPT2-124M
             (configs/gpt2_124m.json), B=32, 8 steps each. Prints per-step
             losses, median ms/step and tok/s over the steps after the
             first two, MFU, peak device memory and kernel launches;
             fails unless every loss is finite, the last is below the
             first, Qwen3's first loss is within 0.5 of ln 151936,
             and flash_fwd, flash_bwd_dkv, flash_bwd_dq and (Qwen3)
             fused_ce_fwd/_dlogits/_dx/_dw were launched. A torch.profiler window
             over one step of each model prints device time by kernel and
             the idle share.
             Int8: a tiny GPT2 int8 step (tile dgrad, int8 fused CE) and a
             tiny QAT step on the card against the CPU; then GPT2-774M from
             configs/gpt2_774m.json at full width and DEPTH layers (E
             1280, B=16 x 1024), its train card as shipped with warmup 10:
             (a) int8 as shipped, 8 steps and a profiled step, (b)
             int8_dgrad "tile", (c) int8_matmul off; fails unless the losses
             are finite, (a)'s fall from within 0.5 of ln 50304, bench.py's
             gate holds and each run's kernels launched.
   koifish — the training CLI, ``koifish_tpu_torch.cli.koifish.main``,
             on inputs written under build/koifish from seeds: a Qwen3-0.6B
             HF folder (the config's widths and DEPTH layers,
             max_position_embeddings 40960,
             so n_ctx 8192) and 48 ChatML conversations run through
             configs/qwen3_sft_lora.json with only its paths changed (LoRA
             r 16 on q/k/v/o, B 16, every sample padded to 8193 tokens),
             3 steps; it fails unless the losses are finite, every base
             weight is bit for bit unchanged, every adapter's b moved and
             the flash forward / dK/dV / dQ and fused-CE forward / dlogits
             / dx launches are the counts 3 steps x the layers imply, with
             no dW launch for the frozen head and no fallback. Prints step
             ms, tok/s, MFU and peak memory; the final state is saved,
             loaded back bit for bit, profiled for one step (device time by
             kernel, idle share) and resumed for one step ("step 3"). Then
             configs/gpt2_124m.json (paths changed) for 4 steps from seeded
             uint16 shards (flash kernels launched), ``pangpi --bits 4
             --ppl`` on the Qwen3 folder (qmm and flash launched, CE within
             0.5 of ln V), and tiny folders on the card against the CPU: a
             LoRA SFT run of 2 steps through ``koifish.main`` (losses
             1e-2, step 2's adapter grad norms 2 %, the adapters' b
             ‖Δ‖/‖b_cpu‖ 0.25) and ``pangpi --bits 4 --ppl`` (mean CE
             1e-2).
   slice13 — under build/slice13, at Qwen3-0.6B's full width and DEPTH
             layers:
             (a) configs/qwen3_0.6b.json with ``"train_target": "gama"``
             through ``koifish.main``, 4 steps of B 16 x 1024 on a seeded
             shard (one 1024-token sequence repeated); fails unless the
             losses are finite and fall, every code tensor is bit for bit
             the initial quantization's, every scale moved and the
             launches are exactly the counts 4 steps imply (row 3 in
             every projection, twice with remat); then the gama
             backward's plain work timed against bf16's products, a
             profiled step, and a tiny gama CLI run on the card against
             the CPU (losses 2e-2, scale grad norms 5 %). (b) an INT4 g128
             gama student distilled from its bf16 teacher by
             ``distill_step_loss``, 3 AdamW steps at B 4 x 1024 (reckoned
             and measured peak memory; kd > 0 at step 0, σ the
             schedule's, codes frozen, scales moved), and a tiny step card
             vs CPU (loss 1e-2). (c) a seeded ``.kun`` and
             ``tokenizer.dat`` from the port's writers: ``load_kun_model``
             gives every tensor back ``torch.equal``, then ``bubble.main
             --bits 8 --kv-bits 8 --temperature 0 --max-new 64`` ("mxu")
             on it launches rows 5, 7 (with its write) and 1a. (d)
             ``generate`` at B 32 x 128, 64 new, INT4 g128 and a QJL
             cache: TTFT and decode tok/s, rows 1a, 3, 4 launched and no
             row 7; a profiled decode chunk; a tiny QJL model card vs CPU
             (logits 5e-2, greedy tokens 75 %).
   slice14 — sequence parallelism, its ranks virtual ranks of the one
             card (they share its SMs; a chunk travels through HBM, not
             NVLink). (a) ``ring_phase``: row 13, the kernel ring
             (``csrc/ring_attn.cu``: one launch a step for all the ranks,
             each chunk's send in it) through
             ``parallel.ring_attention_pallas_sharded``, at Qwen3-0.6B's
             attention and the SFT config's context (B 1 x T 8192, Hq 16,
             Hkv 8, D 128, bf16) at sp 4 (the main run, its launches
             counted: sp a ring), 2 and 8, and at four smaller shapes
             (ragged Tl, f32 q, g 1-8); each against the kernel's plain
             version entry by entry and one-piece attention (2e-2), a
             repeat bit for bit, and two planted faults rejected (ranks
             sending to the wrong neighbour; every launch past the
             diagonal starting from a fresh state); ptxas's registers and
             spills of each instantiation (a spill fails); the ring timed
             by graph replay and eagerly (CUDA events around all ranks),
             beside its plain version and SDPA on the whole sequence, its
             TFLOP/s on the causal pairs. (b) ``sp_train_phase``:
             ``koifish.main --sp 4`` on configs/qwen3_0.6b.json as shipped
             (paths changed; fake-quant INT4, remat, B 16 x 1024) for 4
             steps on a seeded shard: the mesh line, finite falling losses,
             step 0 within 1e-2 of ``--sp 1``'s, no flash forward (the ring
             takes the attention); ms a step and peak memory; a tiny sp-2
             step card vs CPU. (``chip_ab.py --sp`` profiles an sp step.)
   zoo     — the model zoo's MoE and MLA serving paths, each model built
             from its published config.json values (``QWEN3_30B_A3B``,
             ``DEEPSEEK_V2_LITE``) through ``ModelCard.from_hf`` with
             seeded weights drawn on the card, INT4 RTN g128 where the
             rules match (the 3-D expert stacks stay bf16), an INT8 KV
             cache, ``generate`` at B 8 x 128-token prompts, 32 greedy new
             tokens: warm TTFT, decode tok/s, peak memory, a profiled
             decode step (idle share, top device operations) and the
             launches of rows 1a, 3, 4 and 7's fused write, each exactly
             the count the layer count and shapes give. (a) Qwen3-30B-A3B
             at full width and DEPTH layers (of its 48; 128 experts):
             the (token, expert) assignments the capacity drops,
             recomputed from the router logits, in the prefill and the
             decode; then ``bubble.main --bits 4 --kv-bits 8
             --temperature 0 --max-new 32`` on a seeded 2-layer folder of
             its width (3.7 GB). (b) DeepSeek-V2-Lite as the JAX package
             reads it (DEPTH of its 27 layers, MLA with d 192 / dv 128, a
             dense FFN: no flash forward, a logged fallback a layer), then
             the latent cache (``mla_prefill`` / ``mla_decode_step``): its
             times, its bytes against the standard cache's, and its
             greedy tokens fed the standard path's held against them
             (75 %). Then a 2-layer MoE,
             a hybrid-backbone MoE and a 2-layer MLA card on the card
             against the CPU (logits 5e-2, greedy tokens 75 %). Row 7 is
             also checked and timed at both decode shapes in
             ``decode_attn_phase``.
   slice17 — the rest of the model zoo at published widths, every weight
             seeded, each training run 3 steps through ``koifish.main``
             (remat, SR on, as the CLI defaults): (a) GUPPY at Qwen3-0.6B's
             width and DEPTH layers (configs/qwen3_0.6b.json, arch changed,
             bf16,
             B 8 x 1024), then ``generate`` on its evaluation sample (INT8
             KV, B 8 x 128, 32 greedy new); (b) LLAMA_VAE likewise with
             ``token_embeds [192]``; (c) configs/gpt2_124m.json with 12
             layers cycling QKV FFN, GAU and BROWN FFN (B 16 x 1024; 24
             logged GAU fallbacks; serving must raise); (d) mamba-130m's
             published config (24 layers, d 768, V 50,280, B 8 x 1024), a
             step profiled; (e) SALMON at the qwen2.5-0.5b preset's widths
             ("SCORE", B 8 x 1024), then greedy ``diffusion_generate`` (B 8,
             prompt 64, total 128, 16 steps); (f) HotPick on slice 1's INT4
             g128 Qwen3-0.6B: calibration on 8 x 512 tokens, ``pick_hot
             (keep=0.5)`` (n_ffn 1536), served as slice 1 serves. Each
             run's launches must be exactly the counts its shapes give
             (none for Mamba and Salmon); rows 3 and 4 at the picked
             down's K 1536 against their plain versions, timed; tiny cards
             of each family on the card against the CPU (train steps: loss
             1e-2, grad norms 2 %; logits 5e-2; greedy tokens 75 %).
   parallel — data, tensor, FSDP and pipeline parallelism, one rank a
             process (``parallel_phase``): two ranks started by
             ``parallel/multihost.spawn`` share the one card over gloo
             (NCCL refuses two ranks on one GPU), so the phase shows the
             sharded paths right with the kernels at shard shapes and
             measures no interconnect. The ranks try on CUDA tensors the
             collectives the comm layer hands gloo unstaged (it fails if
             gloo refuses one), then (a) ``bubble --tp 2 --bits 4
             --kv-bits 8`` through the streamed load on a seeded
             full-width Qwen3-0.6B folder of DEPTH layers: prefill logits
             against one process's run of the tp-2 arithmetic (each
             product through the kernels as its two halves, the K halves'
             f32 outputs summed and rounded once) allclose at rtol and
             atol 2e-2, as the JAX package holds its sharded serving, and
             against the one-rank run within ``PAR_TP_GAP`` (0.1 over
             atol: random layers amplify any change of f32 order, the
             one-rank run through the plain versions reads as far), a
             limit a wrong shard (the K halves paired with the other
             rank's weights) must exceed; greedy agreement with the
             one-rank run, tok/s, TTFT, launches a rank a step; (b) the
             streamed load at Qwen3-32B's widths, 2 layers, written from
             a seed and deleted after: every shard bit for bit the
             one-rank ``quantize_params``'s slice, the bytes each rank
             read (at most 0.505 of the checkpoint: its half and the
             norms), peak host RssAnon and device bytes a rank, a prefill
             (the same gates); (c) ``koifish`` on
             configs/qwen3_0.6b.json at full width (B 4 x 1024, every row
             its own tokens, QAT rules off, 4 layers): ``--dp 2``, ``--tp
             2``, ``--dp 2 --fsdp``, ``--pp 2`` with 1f1b and gpipe, 3
             steps each, every step's loss within 1e-3 and
             grad norm within 1e-2 relative of one rank's, and a
             one-rank run at learning rate 0 that these limits must
             refuse. A logged fallback or any rank's failure fails the
             run. Then rows 3 and 4 at Qwen3-32B's tp-2 shard shapes
             (``down`` K 13824) against their plain versions, bf16 and
             f32 out, timed.
   slice19 — the zoo and sequence parallelism on the process mesh
             (``slice19_phase``), the ranks processes sharing the one card
             over gloo (no interconnect measured), every run 3 steps at 4
             layers and slice 17's widths, each against one rank (losses
             1e-3 relative, grad norms 1e-2) with a learning-rate-0
             control the gates must refuse: (a) row 13 across processes,
             ``ring_attention_pallas_sharded`` on a ``ProcessMesh`` at sp
             2 and 4 (B 1 x T 8192, Hq 16, Hkv 8, D 128), each rank's chunk
             ``torch.equal`` to the in-process kernel ring's, within
             RING_ABS of the kernel's plain version and RING_FULL_TOL of
             one-piece attention, a planted transport (the last rank's
             first chunk its own again) refused by both, launches r + 1
             on rank r, timed on the host clock and by CUDA events; (b)
             ``koifish --dp 2 --sp 2`` and ``--tp 2 --sp 2`` (4 ranks,
             Qwen3-0.6B widths, B 2 x 4096) against ``--sp 1``, row 10's
             launches exact; (c) ``koifish --tp 2`` on GUPPY, the
             GPT2-124M QKV/GAU/BROWN hybrid, mamba-130m, SALMON (B cut to
             4) and the DeepSeek-V2-Lite-width MLA card (through the
             training API), launches exact; (d) ``--pp 2`` (1F1B) on
             MAMBA, SALMON, LLAMA_VAE and MLA against the pipeline on one
             rank (the JAX package's pipeline loss); (e) a Qwen3-0.6B
             train step captured through ``utils.profiler.trace``, whose
             ``utils.xprof.op_profile`` top rows must name the flash and
             fused-CE kernels.
   slice20 — the last method combinations on the process mesh
             (``slice20_phase``), ranks sharing the one card over gloo:
             (a) ``bubble --tp 2 --bits 8 --kv-bits 8 --draft-hf`` on a
             seeded full-width, full-depth Qwen3-0.6B folder as its own
             draft, 16 greedy tokens, against the plain ``--tp 2`` run's
             (75 %), rounds, accept rate and tok/s, every rank's tokens
             the same; at Qwen3-0.6B's widths, 4 layers, B 4 x 1024, 3
             steps each against one rank (losses 1e-3 relative, grad
             norms 1e-2) with learning-rate-0 controls: (b) ``koifish
             --dp 2 --fsdp`` on the shipped quantizer card as gama, (c)
             ``--dp 2`` and ``--tp 2`` with a Fuyou swarm rotating every
             step, (d) LARS 0.5 under ``--dp 2 --tp 2 --fsdp`` (4 ranks)
             and ``--pp 2``, (e) ``--pp 2`` with SR on, QWEN3 and
             LLAMA_VAE, their grad norms within S20_SR_GNORM_RTOL of the
             one-rank pipeline, a limit the stage-local SR index,
             planted, must exceed; (f) every run took the native batch
             server and the bubble runs the native BPE engine, whose
             batches and ids equal the Python paths' (host ms both ways).
   mesh    — the ranks of parallel, slice19 and slice20 run in one group
             of 2 processes and one of 4 (``mesh_groups``), each started
             once: the three phases write their inputs first and check
             their ranks' results after.
   Each phase's seconds, and the script's so far, print as ``[time]``.
6. result  — one JSON line with every kernel's numbers (launches from its
             path's run: the serving run for the slice-1 kernels and the
             decode attention's fused K/V write (``decode_attn_write``,
             with the write's own ``write_ms``), the Qwen3 train_loop for
             the training kernels, the batcher run for the book kernels
             and the slot writes (the standalone kernel's launches plus
             the fused ones), the paged run for the paged attention, its
             fused write and the page write (the standalone kernel's
             launches plus the fused ones), GPT2-774M run (a) for the
             int8 fused CE and the quantizers, run (b) for qdgrad (its
             quantize pass and its GEMM, each line timing its own launch),
             the plain bubble run for the int8 GEMV, the sp-4 ring for
             row 13 (with its ``eager_ms`` and ``by_sp``); each row's
             ``launches_by_path`` gives slice 13's runs: gama, distill,
             kun_bubble, qjl, slice 14's ``koifish_sp4`` and slice 16's
             zoo runs and slice 17's runs; the rows ``decode_attn_write_mla``
             and ``decode_attn_write_qwen3_moe`` are row 7's fused entry at
             the zoo's decode shapes, launched by its generate runs, and
             ``qmm_k1536`` / ``qmv_k1536`` rows 3 and 4 at HotPick's picked
             down, their launches those the wrappers counted at K 1536 in
             its serving run; ``qmm_k13824`` / ``qmv_k13824`` rows 3 and 4
             at Qwen3-32B's tp-2 ``down``, launched by the streamed model
             on rank 0; ``launches_by_path`` also gives rank 0's launches
             in each parallel run: ``tp2_bubble``, ``tp2_stream32b``,
             ``koifish_dp2``, ``koifish_tp2``, ``koifish_dp2_fsdp``,
             ``koifish_pp2_1f1b``, ``koifish_pp2_gpipe``), and slice 19's
             (``koifish_dp2_sp2``, ``koifish_tp2_sp2``, ``koifish_tp2_*``
             and ``koifish_pp2_*`` of the zoo) and slice 20's
             (``s20_*``); row 13's ``process`` path
             is the launches of every rank of the sp-4 ring across
             processes, with ``process_by_sp``; then the
             last line
             ``{"ok": true, "device": {...}}``.

It needs a CUDA device and the repository around it; without either it
fails before printing any result.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (dense): bf16 and int8 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12

#: layers of the single-process runs of Qwen3-0.6B (published 28),
#: GPT2-124M (12), GPT2-774M (36), Qwen3-30B-A3B (48) and DeepSeek-V2-Lite
#: (27), at their published widths. Their serving and training loops are
#: bound by the host's kernel launches, so their time goes with the depth:
#: at the published depths the script took 927-1041 s of its 1200 s limit
#: on an H100 and outran the limit on a slower host. The mesh runs of
#: slices 18 and 19 run 4 layers too. Slice 5's chat, slice 19's profiled
#: train step and slice 20's ``bubble --tp 2`` keep Qwen3-0.6B's 28: at 4
#: layers the chat's speculative tokens met the plain run's at 75.0 % on
#: one prompt, the edge of their 75 % gate, where 28 layers give 100 %.
DEPTH = 4


def cut_card(card):
    """A ``ModelCard`` with at most DEPTH layers."""
    import dataclasses
    return dataclasses.replace(card, n_layer=min(card.n_layer, DEPTH))


def cut_config(cfg: dict) -> dict:
    """A config file's JSON with at most DEPTH layers (in place)."""
    par = cfg["model"]["parameter"]
    par["Layer"] = min(par["Layer"], DEPTH)
    return cfg


def load_config(name: str):
    """``configs/<name>`` as ``CLIParams``, its model cut to DEPTH layers."""
    import dataclasses
    from koifish_tpu_torch.config import CLIParams
    p = CLIParams.load(os.path.join(ROOT, "configs", name))
    return dataclasses.replace(p, model=cut_card(p.model))


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(nbytes: float, flops: float, int8_ops: float = 0.0):
    """The larger of the bytes' and the operations' time (bf16 flops and
    int8 operations each at their peak), and which one it is."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = (flops / PEAK_BF16_FLOPS + int8_ops / PEAK_INT8_OPS) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, iters: int = 20, warm: int = 3) -> float:
    """Mean device time of one ``fn()`` call. ``iters`` calls are captured
    in one CUDA graph and the replay is timed with CUDA events, so the
    host's launch overhead (Python, the wrapper's checks, ctypes) is not
    counted: a loop of eager launches of a kernel of a few microseconds
    measures the host, not the kernel."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warm):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()                       # warm replay
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    graph.replay()
    e1.record()
    e1.synchronize()
    del graph
    return e0.elapsed_time(e1) / iters


def time_cold_ms(torch, fn, inputs, iters: int = 48) -> float:
    """``time_ms`` of ``fn(*args)`` cycling through ``inputs``, copies whose
    bytes together exceed the 50 MB L2: each launch finds its data cold, as
    one layer of a decode step does after the other layers' caches."""
    turn = [0]

    def cycle():
        args = inputs[turn[0] % len(inputs)]
        turn[0] += 1
        return fn(*args)
    return time_ms(torch, cycle, iters=iters, warm=len(inputs))


def host_us(torch, fn, iters: int = 200) -> float:
    """Host time of one eager ``fn()`` call: a loop of ``iters`` calls ends in
    a synchronise, so for calls whose device work is a few microseconds the
    wall time per call is the host's (Python, checks, the launch)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e6


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def bits_differ(a, b) -> float:
    """The number of entries of two bf16 tensors whose bits differ."""
    import torch
    return float((a.view(torch.int16) != b.view(torch.int16)).sum())


def check(name: str, err: float, tol: float) -> None:
    ok = err <= tol
    say(f"  check {name}: max_abs_err={err:.3e} tol={tol:.1e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{name} disagrees with its plain version")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def flash_phase(torch, gen):
    from koifish_tpu_torch.ops.kernels import flash as kf
    F = torch.nn.functional
    say("[kernels] flash_fwd (koifish_tpu_torch/csrc/flash_fwd.cu)")
    # o: bf16 outputs of O(1); the kernel's online softmax rounds p to bf16
    # against the running max (the plain version: the final max), so the
    # two differ by a few bf16 ulps. lse is f32 throughout.
    tol_o, tol_lse = 2e-2, 1e-3

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(torch.bfloat16)

    cases = [  # (label, B, T, Hq, Hkv, D, window, head-major view)
        ("slice B32 T128 Hq16 Hkv8 D128", 32, 128, 16, 8, 128, 0, False),
        # the training shapes of Qwen3-0.6B and GPT2-124M (timed too)
        ("qwen3 B8 T1024 Hq16 Hkv8 D128", 8, 1024, 16, 8, 128, 0, False),
        ("gpt2 B32 T1024 Hq12 Hkv12 D64", 32, 1024, 12, 12, 64, 0, False),
        ("head-major B2 T256 Hq16 Hkv8 D128", 2, 256, 16, 8, 128, 0, True),
        ("ragged B3 T300 Hq8 Hkv2 D64 window100", 3, 300, 8, 2, 64, 100,
         False),
        ("ragged B1 T77 Hq4 Hkv4 D256", 1, 77, 4, 4, 256, 0, False),
        ("long B1 T1500 Hq4 Hkv2 D128", 1, 1500, 4, 2, 128, 0, False),
        # one row of the Qwen3 LoRA SFT step (configs/qwen3_sft_lora.json
        # pads every sample to n_ctx 8192); timed too
        ("sft B1 T8192 Hq16 Hkv8 D128", 1, 8192, 16, 8, 128, 0, False),
        # T off the 128-row q tiles and 64-row kv tiles; windows that start
        # inside a tile
        ("ragged B2 T77 Hq4 Hkv1 D128", 2, 77, 4, 1, 128, 0, False),
        ("ragged B1 T200 Hq6 Hkv2 D64 window64", 1, 200, 6, 2, 64, 64, False),
        ("ragged B1 T1500 Hq4 Hkv2 D128 window256", 1, 1500, 4, 2, 128, 256,
         False),
        ("ragged B1 T1 Hq2 Hkv1 D128", 1, 1, 2, 1, 128, 0, False),
        # zoo_phase's Qwen3-30B-A3B prefill (g 8)
        ("zoo B8 T128 Hq32 Hkv4 D128", 8, 128, 32, 4, 128, 0, False),
    ]
    slice_err = None
    res = {}

    def times(q, k, v, sc):
        """(kernel ms, SDPA ms, bound ms, bound by) at q, k, v's shape."""
        B, T, Hq, D = q.shape
        Hkv = k.shape[2]
        kms = time_ms(torch, lambda: kf.flash_attention_fwd(q, k, v, scale=sc))
        g = Hq // Hkv
        qh = q.transpose(1, 2).contiguous()
        kh = k.transpose(1, 2).repeat_interleave(g, dim=1).contiguous()
        vh = v.transpose(1, 2).repeat_interleave(g, dim=1).contiguous()
        lms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True, scale=sc))
        nbytes = 2 * (2 * B * T * Hq * D + 2 * B * T * Hkv * D) \
            + 4 * B * Hq * T
        bms, by = bound_ms(nbytes, 4.0 * B * Hq * causal_pairs(T, 0) * D)
        return kms, lms, bms, by

    for label, B, T, Hq, Hkv, D, win, hm in cases:
        if hm:   # [B, H, T, D] storage seen as [B, T, H, D]
            q = rnd(B, Hq, T, D).transpose(1, 2)
            k = rnd(B, Hkv, T, D).transpose(1, 2)
            v = rnd(B, Hkv, T, D).transpose(1, 2)
        else:
            q, k, v = rnd(B, T, Hq, D), rnd(B, T, Hkv, D), rnd(B, T, Hkv, D)
        sc = 1.0 / D ** 0.5
        o, lse = kf.flash_attention_fwd(q, k, v, scale=sc, window=win)
        po, plse = kf.flash_attention_plain(q, k, v, scale=sc, window=win)
        torch.cuda.synchronize()
        e_o, e_l = max_err(o, po), max_err(lse, plse)
        check(f"flash_fwd {label} o", e_o, tol_o)
        check(f"flash_fwd {label} lse", e_l, tol_lse)
        if slice_err is None:
            slice_err = e_o
            kms, lms, bms, by = times(q, k, v, sc)
            pms = time_ms(torch, lambda: kf.flash_attention_plain(
                q, k, v, scale=sc), iters=5)
            say(f"  time flash_fwd slice: kernel_ms={kms:.4f} "
                f"plain_ms={pms:.4f} library_ms(SDPA)={lms:.4f} "
                f"bound_ms={bms:.5f} ({by})")
            res.update(ms=kms, plain_ms=pms, library_ms=lms, bound_ms=bms,
                       bound_by=by)
        elif label.startswith(("qwen3", "gpt2", "sft")):
            kms, lms, bms, by = times(q, k, v, sc)
            tag = label.split()[0]
            pstr = ""
            if tag == "sft":
                pstr = " plain_ms={:.4f}".format(event_ms(
                    torch, lambda: kf.flash_attention_plain(q, k, v, scale=sc),
                    iters=2, warm=1))
            say(f"  time flash_fwd {label}: kernel_ms={kms:.4f}{pstr} "
                f"library_ms(SDPA)={lms:.4f} bound_ms={bms:.5f} ({by})")
            res.update({f"{tag}_ms": kms, f"{tag}_sdpa_ms": lms,
                        f"{tag}_bound_ms": bms})
        del q, k, v, o, lse, po, plse
    res["max_abs_err"] = slice_err
    return res


# the seven projections of one Qwen3-0.6B layer: (name, K, N)
QWEN3_PROJ = [("q", 1024, 2048), ("k", 1024, 1024), ("v", 1024, 1024),
              ("o", 2048, 1024), ("gate", 1024, 3072), ("up", 1024, 3072),
              ("down", 3072, 1024)]
# the projections zoo_phase quantizes (INT4 g128): Qwen3-30B-A3B's q, k and
# v, o, then DeepSeek-V2-Lite's o, gate and up (its down, K 10944, is off
# the 128-row groups and stays bf16)
ZOO_PROJ = [("Qwen3-30B-A3B q", 2048, 4096), ("Qwen3-30B-A3B k/v", 2048, 512),
            ("Qwen3-30B-A3B o", 4096, 2048), ("DeepSeek o", 2048, 2048),
            ("DeepSeek gate/up", 2048, 10944)]


def qmatmul_phase(torch, gen):
    from koifish_tpu_torch.dtypes import QFormat
    from koifish_tpu_torch.ops.kernels import matmul as km
    from koifish_tpu_torch.quant.rtn import quantize
    say("[kernels] qmatmul GEMM/GEMV (koifish_tpu_torch/csrc/qmm.cu, "
        "qmatmul.cu)")

    def tol(ref):
        # bf16 outputs: the kernel and the plain version sum the same f32
        # products in another order, then round; allow ~1 bf16 ulp of the
        # largest output
        return 1e-2 * float(ref.float().abs().max()) + 1e-3

    def weight(K, N, fmt):
        w = torch.randn((K, N), generator=gen, device="cuda") * 0.02
        return quantize(w, fmt, group=128)

    def act(m, K):
        return torch.randn((m, K), generator=gen, device="cuda"
                           ).to(torch.bfloat16)

    # every format, both launch shapes, plus ragged shapes: m and N off the
    # GEMM's 128 x 128 tiles (N = 520 takes its 4-byte code loads); the GEMV
    # at m = 1, 5, 8, 17, 32 (1-4 m8 tiles of x), N on and off its 64-column
    # tiles and 16-byte code rows, K 256-3072 (1-8 blocks of a cluster, 1-3
    # groups a block)
    gemv = [(m, K, N) for m in (1, 5, 8, 17, 32)
            for K, N in ((256, 132), (3072, 1024), (384, 200), (1024, 520),
                         (2048, 1000), (1024, 2048))]
    for fmt in km.FORMATS:
        for m, K, N in gemv + [
                (256, 1024, 1024), (40, 384, 1000), (33, 256, 200),
                (65, 384, 132), (129, 1024, 1000), (4097, 1024, 520)]:
            w, x = weight(K, N, fmt), act(m, K)
            y = km.qmatmul(x, w)
            ref = km.qmatmul_plain(x, w.codes, w.scales, w.fmt, w.group)
            torch.cuda.synchronize()
            check(f"qmatmul {fmt.name} m{m} K{K} N{N}", max_err(y, ref),
                  tol(ref))
    # the zoo's projections at its prefill's m = B·P and its decode's m = B;
    # K 4096 gives the GEMV 4 groups a block of its 8-block cluster
    for pname, K, N in ZOO_PROJ:
        w = weight(K, N, QFormat.INT4)
        for m in (ZOO_B * ZOO_P, ZOO_B):
            x = act(m, K)
            y = km.qmatmul(x, w)
            ref = km.qmatmul_plain(x, w.codes, w.scales, w.fmt, w.group)
            torch.cuda.synchronize()
            check(f"qmatmul zoo {pname} m{m} K{K} N{N} INT4", max_err(y, ref),
                  tol(ref))

    out = {}
    for kind, m in (("qmm", 4096), ("qmv", 32)):
        # one layer's projections at the slice's m, INT4; 12 layers' worth
        # of weights are cycled so the codes come from device memory
        n_layers = 12
        ws = [[weight(K, N, QFormat.INT4) for _, K, N in QWEN3_PROJ]
              for _ in range(n_layers)]
        xs = {K: act(m, K) for K in (1024, 2048, 3072)}
        err = 0.0
        for (pname, K, N), w in zip(QWEN3_PROJ, ws[0]):
            y = km.qmatmul(xs[K], w)
            ref = km.qmatmul_plain(xs[K], w.codes, w.scales, w.fmt, w.group)
            torch.cuda.synchronize()
            e = max_err(y, ref)
            check(f"{kind} slice {pname} m{m} K{K} N{N} INT4", e, tol(ref))
            err = max(err, e)
        deq = [[w.dequantize(torch.bfloat16) for w in layer]
               for layer in ws[:4]]

        def run_kernel():
            for layer in ws:
                for (_, K, _n), w in zip(QWEN3_PROJ, layer):
                    km.qmatmul(xs[K], w)

        def run_plain():
            for (_, K, _n), w in zip(QWEN3_PROJ, ws[0]):
                km.qmatmul_plain(xs[K], w.codes, w.scales, w.fmt, w.group)

        def run_lib():
            for layer in deq:
                for (_, K, _n), wd in zip(QWEN3_PROJ, layer):
                    torch.matmul(xs[K], wd)

        kms = time_ms(torch, run_kernel, iters=5) / n_layers
        pms = time_ms(torch, run_plain, iters=3)
        lms = time_ms(torch, run_lib, iters=5) / len(deq)
        nbytes = sum(m * K * 2 + K * N // 2 + (K // 128) * N * 4 + m * N * 2
                     for _, K, N in QWEN3_PROJ)
        flops = sum(2.0 * m * K * N for _, K, N in QWEN3_PROJ)
        bms, by = bound_ms(nbytes, flops)
        say(f"  time {kind} one layer's 7 projections (m={m}, INT4): "
            f"kernel_ms={kms:.4f} plain_ms={pms:.4f} "
            f"library_ms(matmul on dequantized bf16)={lms:.4f} "
            f"bound_ms={bms:.5f} ({by})")
        out[kind] = dict(ms=kms, plain_ms=pms, library_ms=lms, bound_ms=bms,
                         bound_by=by, max_abs_err=err)
        del ws, deq
    # chat's default route: INT8 codes at m = 1 through the GEMV ("dot")
    n_layers = 12
    ws = [[weight(K, N, QFormat.INT8) for _, K, N in QWEN3_PROJ]
          for _ in range(n_layers)]
    xs = {K: act(1, K) for K in (1024, 2048, 3072)}
    deq = [w.dequantize(torch.bfloat16) for w in ws[0]]
    kms = time_ms(torch, lambda: [km.qmatmul(xs[K], w) for layer in ws
                                  for (_, K, _n), w in zip(QWEN3_PROJ, layer)],
                  iters=5) / n_layers
    lms = time_ms(torch, lambda: [torch.matmul(xs[K], wd) for (_, K, _n), wd
                                  in zip(QWEN3_PROJ, deq)], iters=5)
    bms, by = bound_ms(sum(K * 2 + K * N + (K // 128) * N * 4 + N * 2
                           for _, K, N in QWEN3_PROJ), 0.0)
    say(f"  time qmv one layer's 7 projections (m=1, INT8 codes, chat's "
        f"\"dot\" route): kernel_ms={kms:.4f} library_ms(matmul on "
        f"dequantized bf16)={lms:.4f} bound_ms={bms:.5f} ({by})")
    out["qmv"].update(m1_int8_ms=kms, m1_int8_library_ms=lms,
                      m1_int8_bound_ms=bms)
    del ws, deq
    # the GEMM wrapper's host cost at a batcher bucket (m = 128), where the
    # device time is a few microseconds (its TMA map is encoded each call)
    w0, x0 = weight(1024, 1024, QFormat.INT4), act(128, 1024)
    say(f"  host per eager call (m=128, K=1024, N=1024, INT4): qmm "
        f"{host_us(torch, lambda: km.qmatmul(x0, w0)):.1f} us")
    return out


# decode attention cases: (label, B, Hq, Hkv, S, D, Dv, lengths [lo, hi));
# the first DECODE_TIMED are timed (INT8). Together they reach every branch
# of the split plan: one split, eight, a head group past the first (g 16),
# D 192 with Dv 128, and (each case runs INT8 and INT4) packed INT4.
DECODE_CASES = [
    ("slice B32 Hq16 Hkv8 S1024 D128 len129-192", 32, 16, 8, 1024, 128, 128,
     (129, 193)),
    ("batcher B32 Hq16 Hkv8 S1024 D128 len16-640", 32, 16, 8, 1024, 128,
     128, (16, 641)),
    ("chat B1 Hq16 Hkv8 S1024 D128 len100-1024", 1, 16, 8, 1024, 128, 128,
     (100, 1025)),
    ("Qwen3-32B g8 B8 Hq64 Hkv8 S1024 D128 len256-1024", 8, 64, 8, 1024, 128,
     128, (256, 1025)),
    ("ragged B5 Hq16 Hkv8 S1024 D128 len1-1024", 5, 16, 8, 1024, 128, 128,
     (1, 1025)),
    ("ragged g16 B3 Hq64 Hkv4 S300 D64 len1-300", 3, 64, 4, 300, 64, 64,
     (1, 301)),
    ("mla B2 Hq8 Hkv8 S512 D192 Dv128", 2, 8, 8, 512, 192, 128, (100, 513)),
    ("B4 Hq28 Hkv4 S256 D256", 4, 28, 4, 256, 256, 256, (200, 257)),
    ("one split B64 Hq8 Hkv8 S512 D64 len1-512", 64, 8, 8, 512, 64, 64,
     (1, 513)),
    # the zoo's decode shapes (zoo_phase: B 8, 128-token prompts, 32 new)
    ("zoo MLA B8 Hq16 Hkv16 S256 D192 Dv128 len129-160", 8, 16, 16, 256,
     192, 128, (129, 161)),
    ("zoo Qwen3-30B-A3B B8 Hq32 Hkv4 S256 D128 len129-160", 8, 32, 4, 256,
     128, 128, (129, 161)),
]
DECODE_TIMED = 4        # the first four cases, and the zoo's, are timed


def _kv_quant_rounding(torch, gen) -> None:
    """Which rounding the KV quantizer gets on the card (the fused write
    reproduces it): PyTorch's CUDA division by a Python scalar multiplies by
    its f32 reciprocal, so the scale is max(absmax · fl(1/qmax), 1e-12)."""
    import numpy as np
    from koifish_tpu_torch.dtypes import QFormat
    from koifish_tpu_torch.ops.kernels import decode_attn as kd
    x = (torch.randn((8192, 128), generator=gen, device="cuda") * 3
         ).to(torch.bfloat16)
    xf = x.float()
    am = xf.abs().amax(dim=-1)
    for fmt, qmax in ((QFormat.INT8, 127.0), (QFormat.INT4, 7.0)):
        _, s = kd.quant_kv(x, fmt)
        recip = float(np.float32(1.0) / np.float32(qmax))
        s_mul = torch.clamp(am * recip, min=1e-12)
        s_div = torch.clamp(am / torch.full_like(am, qmax), min=1e-12)
        n_mul, n_div = int((s != s_mul).sum()), int((s != s_div).sum())
        say(f"  quant_kv {fmt.name} scale on the card: differs from "
            f"absmax·fl(1/{qmax:g}) in {n_mul} and from absmax/{qmax:g} in "
            f"{n_div} of {s.numel()} rows")
        if n_mul:
            fail("quant_kv's scale on the card is not absmax·fl(1/qmax), "
                 "the rounding the fused write reproduces")


def _bytes_differ(torch, a, b) -> int:
    return int((a.contiguous().view(torch.uint8)
                != b.contiguous().view(torch.uint8)).sum())


def decode_attn_phase(torch, gen):
    """Row 7 (decode attention over INT8 / INT4 codes) and its fused entry
    (the new token's K/V quantized and written at each lane's slot in the
    same launch) against their plain versions: every case through both
    entries, a repeat launch bit for bit, the fused entry's cache bytes bit
    for bit, and two planted faults each check must reject: the stale row
    read in place of the new one, and the last split's partial dropped."""
    from koifish_tpu_torch.dtypes import QFormat
    from koifish_tpu_torch.ops.kernels import decode_attn as kd
    F = torch.nn.functional
    say("[kernels] decode_attn (koifish_tpu_torch/csrc/decode_attn.cu): "
        "attention, and attention with the fused K/V write")
    # bf16 outputs of O(0.1-1); p·v_scale is rounded to bf16 against each
    # warp's running max in the kernel and the final max in the plain version
    tol = 2e-2
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    _kv_quant_rounding(torch, gen)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    seen = set()
    res, shapes = {}, []
    for fmt in (QFormat.INT8, QFormat.INT4):
        for i, (label, B, Hq, Hkv, S, D, Dv, (lo, hi)) in enumerate(
                DECODE_CASES):
            kc, ks = kd.quant_kv(rnd(B, Hkv, S, D), fmt)
            vc, vs = kd.quant_kv(rnd(B, Hkv, S, Dv), fmt)
            q = rnd(B, Hq, D).to(torch.bfloat16)
            kn = (rnd(B, Hkv, D) * 2).to(torch.bfloat16)
            vn = rnd(B, Hkv, Dv).to(torch.bfloat16)
            lengths = torch.randint(lo, hi, (B,), generator=gen,
                                    device="cuda", dtype=torch.int32)
            slots = (torch.rand((B,), generator=gen, device="cuda")
                     * lengths).to(torch.int32)      # a live row each lane
            sc = 1.0 / D ** 0.5
            splits = kd.plan(B, Hq, Hkv, S, sms)
            groups = -(-(Hq // Hkv) // kd.GROUP)
            seen.update({f"splits {splits}", f"groups {groups}", fmt.name,
                         f"D{D} Dv{Dv}"})
            tag = f"{fmt.name} {label} (splits {splits})"
            # attention alone
            o = kd.decode_attention_quant(q, kc, vc, ks, vs, lengths, sc)
            o2 = kd.decode_attention_quant(q, kc, vc, ks, vs, lengths, sc)
            ref = kd.decode_attention_plain(q, kc, vc, ks, vs, lengths, sc)
            torch.cuda.synchronize()
            err = max_err(o, ref)
            check(f"decode_attn {tag}", err, tol)
            check(f"decode_attn {tag} repeat launch", bits_differ(o, o2), 0.0)
            # planted fault: the last live split's partial dropped
            live = [sum(t1 > t0 for t0, t1 in kd.rank_tiles(n, S, splits))
                    for n in lengths.tolist()]
            if max(live) >= 2:
                drop = kd.decode_attention_splits_plain(
                    q, kc, vc, ks, vs, lengths, sc, splits, drop_last=True)
                derr = max_err(o, drop)
                say(f"    fault (last split dropped): output err {derr:.3e}")
                seen.add("split dropped")
                if derr <= tol:
                    fail(f"decode_attn {tag}: the check does not reject the "
                         f"last split's partial dropped")
            # the fused write, and (first case) q along k_new: the new row
            # carries the softmax and the output is about its V row, kept
            # O(1) (the tolerance's premise: 1 bf16 ulp in [4, 8) is 3.1e-2)
            variants = [("", q, vn)]
            if i == 0:
                q_new = kn.float().repeat_interleave(Hq // Hkv, dim=1) * 4
                variants.append((" q along k_new", q_new.to(torch.bfloat16),
                                 vn * 0.25))
            for vlabel, qv, vnv in variants:
                fused = [t.clone() for t in (kc, vc, ks, vs)]
                plain = [t.clone() for t in (kc, vc, ks, vs)]
                again = [t.clone() for t in (kc, vc, ks, vs)]
                ow = kd.decode_attention_write(qv, kn, vnv, *fused, slots,
                                               lengths, sc)
                rw = kd.decode_attention_write_plain(qv, kn, vnv, *plain,
                                                     slots, lengths, sc)
                ow2 = kd.decode_attention_write(qv, kn, vnv, *again, slots,
                                                lengths, sc)
                torch.cuda.synchronize()
                e = max_err(ow, rw)
                werr = e if not vlabel else werr
                check(f"decode_attn_write {tag}{vlabel}", e, tol)
                nb = sum(_bytes_differ(torch, a, b)
                         for a, b in zip(fused, plain))
                check(f"decode_attn_write {tag}{vlabel} cache bytes",
                      float(nb), 0.0)
                rep = bits_differ(ow, ow2) + sum(
                    _bytes_differ(torch, a, b) for a, b in zip(fused, again))
                check(f"decode_attn_write {tag}{vlabel} repeat launch", rep,
                      0.0)
                # planted fault: the stale row read in place of the new one
                # (the cache left unwritten)
                stale = kd.decode_attention_plain(qv, kc, vc, ks, vs,
                                                  lengths, sc)
                sb = sum(_bytes_differ(torch, a, b)
                         for a, b in zip(fused, (kc, vc, ks, vs)))
                serr = max_err(ow, stale)
                say(f"    fault (stale row): {sb} cache bytes differ, "
                    f"output err {serr:.3e}")
                if sb == 0 or (vlabel and serr <= tol):
                    fail(f"decode_attn_write {tag}{vlabel}: the checks do "
                         f"not reject the stale row")
            if fmt is not QFormat.INT8 or (i >= DECODE_TIMED
                                           and not label.startswith("zoo")):
                continue
            g = Hq // Hkv
            fused = [t.clone() for t in (kc, vc, ks, vs)]
            kms = time_ms(torch, lambda: kd.decode_attention_quant(
                q, kc, vc, ks, vs, lengths, sc), iters=50)
            wms = time_ms(torch, lambda: kd.decode_attention_write(
                q, kn, vn, *fused, slots, lengths, sc), iters=50)
            pms = time_ms(torch, lambda: kd.decode_attention_plain(
                q, kc, vc, ks, vs, lengths, sc), iters=10)
            wpms = time_ms(torch, lambda: kd.decode_attention_write_plain(
                q, kn, vn, *fused, slots, lengths, sc), iters=10)
            # cold: 8 copies of the cache (>= 64 MB at these shapes)
            copies = [(q, kc, vc, ks, vs)] + [
                (q, t.clone(), u.clone(), v.clone(), w.clone())
                for t, u, v, w in [(kc, vc, ks, vs)] * 7]
            kcold = time_cold_ms(torch, lambda q_, a, b_, c, d: (
                kd.decode_attention_quant(q_, a, b_, c, d, lengths, sc)),
                copies)
            wcold = time_cold_ms(torch, lambda q_, a, b_, c, d: (
                kd.decode_attention_write(q_, kn, vn, a, b_, c, d, slots,
                                          lengths, sc)), copies)
            del copies
            kf = (kc.float() * ks[..., None]).to(torch.bfloat16)
            vf = (vc.float() * vs[..., None]).to(torch.bfloat16)
            kf = kf.repeat_interleave(g, dim=1)
            vf = vf.repeat_interleave(g, dim=1)
            mask = (torch.arange(S, device="cuda")[None, :]
                    < lengths[:, None])[:, None, None, :]
            q4 = q[:, :, None, :]
            lms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                q4, kf, vf, attn_mask=mask, scale=sc), iters=50)
            del kf, vf
            live = int(lengths.sum())
            nbytes = (B * Hq * D * 2 + live * Hkv * (D + Dv)
                      + live * Hkv * 8 + B * 4 + B * Hq * Dv * 2)
            flops = 2.0 * g * Hkv * (D + Dv) * live
            bms, by = bound_ms(nbytes, flops)
            # the write: the new rows' codes and scales are written, not
            # read (each lane's slot is one of its live rows); their bf16
            # K/V and the slots are read
            rbytes = B * Hkv * (D + Dv + 8)
            wbytes = B * Hkv * (D + Dv) * 2 + rbytes + B * 4
            wbms, wby = bound_ms(nbytes - rbytes + wbytes, flops)
            say(f"  time decode_attn INT8 {label} (one layer, splits "
                f"{splits}, {live} live rows): kernel_ms={kms:.4f} "
                f"fused_ms={wms:.4f} "
                f"(write {wms - kms:+.4f}) cold: kernel_ms={kcold:.4f} "
                f"fused_ms={wcold:.4f}; plain_ms={pms:.4f} "
                f"fused_plain_ms={wpms:.4f} library_ms(SDPA on dequantized "
                f"cache)={lms:.4f} bound_ms={bms:.5f} ({by}) "
                f"fused_bound_ms={wbms:.5f} ({wby})")
            shapes.append(dict(label=label, splits=splits, ms=kms,
                               fused_ms=wms, cold_ms=kcold,
                               fused_cold_ms=wcold, plain_ms=pms,
                               fused_plain_ms=wpms, library_ms=lms,
                               bound_ms=bms, fused_bound_ms=wbms,
                               fused_bound_by=wby, max_abs_err=err,
                               fused_max_abs_err=werr))
            if i == 0:
                res["decode_attn"] = dict(
                    ms=kms, plain_ms=pms, library_ms=lms, bound_ms=bms,
                    bound_by=by, max_abs_err=err)
                res["decode_attn_write"] = dict(
                    ms=wms, plain_ms=wpms, library_ms=None, bound_ms=wbms,
                    bound_by=wby, max_abs_err=werr, write_ms=wms - kms)
    want = {"splits 1", f"splits {kd.MAX_SPLITS}", "groups 2", "INT4",
            "D192 Dv128", "split dropped"}
    if not want <= seen:
        fail(f"decode_attn: no check reached {sorted(want - seen)}")
    res["shapes"] = shapes
    return res


# paged decode attention cases: (label, B, Hq, Hkv, D, MAXP, lengths [lo,
# hi)); the first PAGED_TIMED are timed. Together they reach one split and
# eight, a head group past the first (g 16), D 64, 128 and 256, and a MAXP
# that is not a multiple of 4.
PAGED_CASES = [
    ("slice B32 Hq16 Hkv8 D128 MAXP4 len129-192", 32, 16, 8, 128, 4,
     (129, 193)),
    ("chat B1 Hq16 Hkv8 D128 MAXP64 len100-8192", 1, 16, 8, 128, 64,
     (100, 8193)),
    ("Qwen3-32B g8 B8 Hq64 Hkv8 D128 MAXP64 len256-8192", 8, 64, 8, 128, 64,
     (256, 8193)),
    ("slice B32 Hq16 Hkv8 D128 MAXP64 len129-192", 32, 16, 8, 128, 64,
     (129, 193)),
    ("GPT2 B16 Hq12 Hkv12 D64 MAXP8 len1-1024", 16, 12, 12, 64, 8, (1, 1025)),
    ("g16 B3 Hq64 Hkv4 D256 MAXP5 len1-640", 3, 64, 4, 256, 5, (1, 641)),
]
PAGED_TIMED = 3
#: the paged attention's output check, entry by entry: |Δ| ≤ 2^-7·|plain| +
#: PAGED_ABS. The kernel and the plain version each round their f32 output
#: to bf16 once, so an entry may land one bf16 ulp apart (≤ 2^-7 of the
#: entry); PAGED_ABS covers the f32 sums' own difference, which shows only
#: at entries near 0: the kernel carries p as a bf16 hi and lo pair (~16
#: bits, ≤ 2^-17·max|v| ≈ 4e-5 for randn V rows) and sums in another order.
#: A limit of 2e-2 absolute would be as large as a typical output of the
#: long lanes (|o| ~ sqrt(e/len), 0.02-0.04 at 4-8k positions).
PAGED_ULP, PAGED_ABS = 2.0 ** -7, 1e-4


def paged_rel(a, ref, floor: float = PAGED_ABS) -> float:
    """max over entries of |a − ref| / (2^-7·|ref| + floor): ≤ 1 within
    the limit."""
    r = ref.float()
    return float(((a.float() - r).abs() / (PAGED_ULP * r.abs() + floor)
                  ).max())


def _paged_gate(name: str, a, ref, floor: float = PAGED_ABS) -> float:
    """``paged_rel(a, ref, floor)`` ≤ 1, or fail; returns the max abs
    error."""
    rel, err = paged_rel(a, ref, floor), max_err(a, ref)
    ok = rel <= 1.0
    say(f"  check {name}: |Δ|/(2^-7·|plain| + {floor:.0e})="
        f"{rel:.3e} (max_abs_err={err:.3e}) limit 1 {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return err


def _paged_inputs(torch, gen, B, Hq, Hkv, D, maxp, lo, hi):
    """Seeded pools, q, new K/V, lengths and a scattered, non-monotone
    table: each lane's live pages are distinct ids from a permutation of the
    pool, its entries past its length stale ids drawn from the whole pool
    (never the id of its last live page); the write goes to position
    lengths[b] - 1."""
    from koifish_tpu_torch.ops.kernels.paged_attn import PAGE
    dev = "cuda"
    lengths = torch.randint(lo, hi, (B,), generator=gen, device=dev,
                            dtype=torch.int32)
    live = (lengths.long() + PAGE - 1) // PAGE
    NP = B * -(-(hi - 1) // PAGE) + 4
    perm = torch.randperm(NP, generator=gen, device=dev).to(torch.int32)
    table = torch.randint(0, NP, (B, maxp), generator=gen, device=dev,
                          dtype=torch.int32)
    taken = 0
    for b, n in enumerate(live.tolist()):       # live ids: distinct
        table[b, :n] = perm[taken:taken + n]
        taken += n
    last = table.gather(1, (live - 1)[:, None])
    stale = torch.arange(maxp, device=dev)[None, :] >= live[:, None]
    table = torch.where(stale & (table == last), (table + 1) % NP, table)
    pages = lambda: torch.randn((Hkv, NP, PAGE, D), generator=gen,
                                device=dev).to(torch.bfloat16)
    kp, vp = pages(), pages()
    q = torch.randn((B, Hq, D), generator=gen, device=dev).to(torch.bfloat16)
    kn = (torch.randn((B, Hkv, D), generator=gen, device=dev) * 2
          ).to(torch.bfloat16)
    vn = torch.randn((B, Hkv, D), generator=gen, device=dev
                     ).to(torch.bfloat16)
    pos = (lengths - 1).long()
    page_ids = table.gather(1, (pos // PAGE)[:, None])[:, 0].contiguous()
    rows = (pos % PAGE).to(torch.int32)
    return q, kp, vp, kn, vn, lengths, table.contiguous(), page_ids, rows


def paged_attn_phase(torch, gen):
    """Row 14, the paged decode attention (``csrc/paged_attn.cu``), and its
    fused page write against their plain versions: every case through both
    entries, a repeat launch bit for bit, the written pages bit for bit, and
    three planted faults the checks must reject: two entries of one lane's
    table swapped, the last live page dropped, and the new row's write
    skipped while q lies along the new key. Outputs are held entry by entry
    to ``paged_rel`` ≤ 1, and each fault must read > 1."""
    from koifish_tpu_torch.ops.kernels import paged_attn as kpa
    F = torch.nn.functional
    say("[kernels] paged_attn (koifish_tpu_torch/csrc/paged_attn.cu): "
        "attention through the page table, and with the page write")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    seen = set()
    res, shapes = {}, []
    for i, (label, B, Hq, Hkv, D, maxp, (lo, hi)) in enumerate(PAGED_CASES):
        q, kp, vp, kn, vn, lengths, table, pids, rows = _paged_inputs(
            torch, gen, B, Hq, Hkv, D, maxp, lo, hi)
        sc = 1.0 / D ** 0.5
        splits = kpa.plan(B, Hq, Hkv, maxp, sms)
        groups = -(-(Hq // Hkv) // kpa.GROUP)
        seen.update({f"splits {splits}", f"groups {groups}", f"D{D}"})
        tag = f"{label} (splits {splits})"
        o = kpa.paged_attention(q, kp, vp, lengths, table, sc)
        o2 = kpa.paged_attention(q, kp, vp, lengths, table, sc)
        ref = kpa.paged_attention_plain(q, kp, vp, lengths, table, sc)
        torch.cuda.synchronize()
        err = _paged_gate(f"paged_attn {tag}", o, ref)
        check(f"paged_attn {tag} repeat launch", bits_differ(o, o2), 0.0)
        # planted faults, each probed by a lane whose q lies along the key at
        # one live position, so that the softmax rests on the row the fault
        # takes away; the probe's own output is checked too. Each fault's
        # reading against the case's own q is printed beside it.
        g = Hq // Hkv
        live = ((lengths.long() + kpa.PAGE - 1) // kpa.PAGE).tolist()

        def probed(lane, pos, faulty):
            pid, row = int(table[lane, pos // kpa.PAGE]), pos % kpa.PAGE
            qf = q.clone()
            qf[lane] = (kp[:, pid, row].float().repeat_interleave(g, 0) * 4
                        ).to(torch.bfloat16)
            of = kpa.paged_attention(qf, kp, vp, lengths, table, sc)
            _paged_gate(f"paged_attn {tag} q along lane {lane}'s key {pos}",
                        of, kpa.paged_attention_plain(qf, kp, vp, lengths,
                                                      table, sc))
            return paged_rel(of, faulty(qf)), paged_rel(o, faulty(q))
        # two entries of one lane's table swapped: its last live page with a
        # stale entry (the probe at its last position), or, where every
        # entry is live, with its first page when the last one is partial
        # (the probe at row 127 of the first page, which then goes unread)
        lane = next((b for b, n in enumerate(live) if n < maxp), None)
        other, pos = (None, 0) if lane is None \
            else (live[lane], int(lengths[lane]) - 1)
        if lane is None:
            lane = next((b for b, n in enumerate(live) if n >= 2
                         and int(lengths[b]) % kpa.PAGE), None)
            other, pos = 0, kpa.PAGE - 1
        if lane is not None:
            ft = table.clone()
            a_, b_ = live[lane] - 1, other
            ft[lane, a_], ft[lane, b_] = table[lane, b_], table[lane, a_]
            serr, sown = probed(lane, pos, lambda qf: (
                kpa.paged_attention_plain(qf, kp, vp, lengths, ft, sc)))
            say(f"    fault (table entries {a_} and {b_} of lane {lane} "
                f"swapped): probe reads {serr:.3e}, the case's q {sown:.3e}")
            seen.add("swap")
            if serr <= 1.0:
                fail(f"paged_attn {tag}: the check does not reject two "
                     f"swapped table entries")
        # the last live page dropped (the probe at lane 0's last position)
        short = ((lengths - 1) // kpa.PAGE * kpa.PAGE).to(torch.int32)
        derr, down = probed(0, int(lengths[0]) - 1, lambda qf: (
            kpa.paged_attention_plain(qf, kp, vp, short, table, sc)))
        say(f"    fault (last live page dropped): probe reads {derr:.3e}, "
            f"the case's q {down:.3e}")
        if derr <= 1.0:
            fail(f"paged_attn {tag}: the check does not reject the last "
                 f"live page dropped")
        # the fused write, and (first case) q along k_new: the new row
        # carries the softmax and the output is about its V row, kept O(1)
        variants = [("", q, vn)]
        if i == 0:
            q_new = kn.float().repeat_interleave(Hq // Hkv, dim=1) * 4
            variants.append((" q along k_new", q_new.to(torch.bfloat16),
                             vn * 0.25))
        for vlabel, qv, vnv in variants:
            fused = [kp.clone(), vp.clone()]
            plain = [kp.clone(), vp.clone()]
            again = [kp.clone(), vp.clone()]
            ow = kpa.paged_attention_write(qv, kn, vnv, *fused, lengths,
                                           table, pids, rows, sc)
            rw = kpa.paged_attention_write_plain(qv, kn, vnv, *plain,
                                                 lengths, table, pids, rows,
                                                 sc)
            ow2 = kpa.paged_attention_write(qv, kn, vnv, *again, lengths,
                                            table, pids, rows, sc)
            torch.cuda.synchronize()
            e = _paged_gate(f"paged_attn_write {tag}{vlabel}", ow, rw)
            werr = e if not vlabel else werr
            nb = sum(_bytes_differ(torch, a, b) for a, b in zip(fused, plain))
            check(f"paged_attn_write {tag}{vlabel} page bytes", float(nb),
                  0.0)
            rep = bits_differ(ow, ow2) + sum(
                _bytes_differ(torch, a, b) for a, b in zip(fused, again))
            check(f"paged_attn_write {tag}{vlabel} repeat launch", rep, 0.0)
            # planted fault: the new row's write skipped (the stale row read)
            stale = kpa.paged_attention_plain(qv, kp, vp, lengths, table, sc)
            sb = sum(_bytes_differ(torch, a, b)
                     for a, b in zip(fused, (kp, vp)))
            serr = paged_rel(ow, stale)
            say(f"    fault (write skipped): {sb} page bytes differ, output "
                f"reads {serr:.3e}")
            if sb == 0 or (vlabel and serr <= 1.0):
                fail(f"paged_attn_write {tag}{vlabel}: the checks do not "
                     f"reject the skipped write")
        if i >= PAGED_TIMED:
            continue
        fused = [kp.clone(), vp.clone()]
        kms = time_ms(torch, lambda: kpa.paged_attention(
            q, kp, vp, lengths, table, sc), iters=50)
        wms = time_ms(torch, lambda: kpa.paged_attention_write(
            q, kn, vn, *fused, lengths, table, pids, rows, sc), iters=50)
        pms = time_ms(torch, lambda: kpa.paged_attention_plain(
            q, kp, vp, lengths, table, sc), iters=10)
        wpms = time_ms(torch, lambda: kpa.paged_attention_write_plain(
            q, kn, vn, *fused, lengths, table, pids, rows, sc), iters=10)
        # cold: 8 copies of the pools (> 50 MB together at these shapes)
        copies = [(kp.clone(), vp.clone()) for _ in range(8)]
        kcold = time_cold_ms(torch, lambda a, b_: kpa.paged_attention(
            q, a, b_, lengths, table, sc), copies)
        wcold = time_cold_ms(torch, lambda a, b_: kpa.paged_attention_write(
            q, kn, vn, a, b_, lengths, table, pids, rows, sc), copies)
        del copies
        # the library's call on a dense view gathered outside the timed call
        kd_ = kpa.gather_pages(kp, table)
        vd_ = kpa.gather_pages(vp, table)
        mask = (torch.arange(maxp * kpa.PAGE, device="cuda")[None, :]
                < lengths[:, None])[:, None, None, :]
        q4 = q[:, :, None, :]
        sdpa = lambda: F.scaled_dot_product_attention(
            q4, kd_, vd_, attn_mask=mask, scale=sc, enable_gqa=True)
        lms = time_ms(torch, sdpa, iters=50)
        lerr = max_err(sdpa()[:, :, 0], ref)
        del kd_, vd_
        nlive = int(lengths.sum())
        # live K/V rows, q and out, the live table entries and the lengths
        nbytes = (nlive * Hkv * D * 2 * 2 + 2 * B * Hq * D * 2
                  + sum(live) * 4 + B * 4)
        flops = 4.0 * g * Hkv * D * nlive
        bms, by = bound_ms(nbytes, flops)
        # the write: each lane's new K/V row (its last live row) is read from
        # k_new/v_new in place of its page and written once; page ids and
        # rows read
        rbytes = B * Hkv * D * 2 * 2
        wbms, wby = bound_ms(nbytes - rbytes + 2 * rbytes + B * 8, flops)
        hk = host_us(torch, lambda: kpa.paged_attention(
            q, kp, vp, lengths, table, sc))
        hw = host_us(torch, lambda: kpa.paged_attention_write(
            q, kn, vn, *fused, lengths, table, pids, rows, sc))
        say(f"  time paged_attn {label} (one layer, splits {splits}, {nlive} "
            f"live rows): kernel_ms={kms:.4f} fused_ms={wms:.4f} (write "
            f"{wms - kms:+.4f}) cold: kernel_ms={kcold:.4f} "
            f"fused_ms={wcold:.4f}; plain_ms={pms:.4f} "
            f"fused_plain_ms={wpms:.4f} library_ms(SDPA enable_gqa on a "
            f"dense view gathered outside the timed call)={lms:.4f} "
            f"(its err {lerr:.3e}) bound_ms={bms:.5f} ({by}) "
            f"fused_bound_ms={wbms:.5f} ({wby}); host per eager call "
            f"{hk:.1f} us, fused {hw:.1f} us")
        shapes.append(dict(label=label, splits=splits, ms=kms, fused_ms=wms,
                           cold_ms=kcold, fused_cold_ms=wcold, plain_ms=pms,
                           fused_plain_ms=wpms, library_ms=lms,
                           bound_ms=bms, fused_bound_ms=wbms))
        if i == 0:
            res["paged_attn"] = dict(
                ms=kms, cold_ms=kcold, plain_ms=pms, library_ms=lms,
                bound_ms=bms, bound_by=by, max_abs_err=err)
            res["paged_attn_write"] = dict(
                ms=wms, cold_ms=wcold, plain_ms=wpms, library_ms=None,
                bound_ms=wbms, bound_by=wby, max_abs_err=werr,
                write_ms=wms - kms)
    want = {"splits 1", f"splits {kpa.MAX_SPLITS}", "groups 2", "D64",
            "D128", "D256", "swap"}
    if not want <= seen:
        fail(f"paged_attn: no check reached {sorted(want - seen)}")
    res["shapes"] = shapes
    return res


def event_ms(torch, fn, iters: int = 5, warm: int = 2) -> float:
    """Mean time of one ``fn()`` call from CUDA events around an eager loop:
    for calls that autograd runs (a graph capture cannot hold them) and that
    take milliseconds, where the host's launch overhead is small."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def causal_pairs(T: int, window: int) -> int:
    """(query, key) pairs a causal (+ window) attention row set computes."""
    if window <= 0 or window >= T:
        return T * (T + 1) // 2
    return window * (window + 1) // 2 + (T - window) * window


def flash_bwd_phase(torch, gen):
    """flash_bwd_dkv and flash_bwd_dq against the plain backward on the card,
    from the forward kernel's o and lse; times at the Qwen3 slice shape."""
    from koifish_tpu_torch.ops.kernels import flash as kf
    F = torch.nn.functional
    say("[kernels] flash_bwd_dkv / flash_bwd_dq "
        "(koifish_tpu_torch/csrc/flash_bwd.cu)")
    # bf16 grads: kernel and plain sum the same products in another order
    # and may round a p or ds entry to the neighbouring bf16 value; allow
    # 1 % of the largest gradient entry (a bf16 ulp is 0.4-0.8 %)
    rel = 1e-2

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(torch.bfloat16)

    cases = [  # (label, B, T, Hq, Hkv, D, window, head-major view)
        ("slice B8 T1024 Hq16 Hkv8 D128", 8, 1024, 16, 8, 128, 0, False),
        ("gpt2 B32 T1024 Hq12 Hkv12 D64", 32, 1024, 12, 12, 64, 0, False),
        # one row of the Qwen3 LoRA SFT step (n_ctx 8192); timed too
        ("sft B1 T8192 Hq16 Hkv8 D128", 1, 8192, 16, 8, 128, 0, False),
        ("ragged B1 T1500 Hq4 Hkv2 D128 window256", 1, 1500, 4, 2, 128, 256,
         False),
        ("head-major B2 T300 Hq8 Hkv2 D64 window100", 2, 300, 8, 2, 64, 100,
         True),
        ("ragged B1 T77 Hq4 Hkv4 D256", 1, 77, 4, 4, 256, 0, False),
        # T off the 128-row kv tiles and 64/128-row q tiles of the kernels
        ("ragged B2 T77 Hq4 Hkv1 D128", 2, 77, 4, 1, 128, 0, False),
        ("ragged B1 T200 Hq6 Hkv2 D64 window64", 1, 200, 6, 2, 64, 64, False),
        ("ragged B1 T1 Hq2 Hkv1 D128", 1, 1, 2, 1, 128, 0, False),
        # zoo_phase's Qwen3-30B-A3B prefill (g 8)
        ("zoo B8 T128 Hq32 Hkv4 D128", 8, 128, 32, 4, 128, 0, False),
    ]
    out = {}
    for label, B, T, Hq, Hkv, D, win, hm in cases:
        if hm:
            q = rnd(B, Hq, T, D).transpose(1, 2)
            k = rnd(B, Hkv, T, D).transpose(1, 2)
            v = rnd(B, Hkv, T, D).transpose(1, 2)
        else:
            q, k, v = rnd(B, T, Hq, D), rnd(B, T, Hkv, D), rnd(B, T, Hkv, D)
        do = rnd(B, T, Hq, D)
        sc = 1.0 / D ** 0.5
        o, lse = kf.flash_attention_fwd(q, k, v, scale=sc, window=win)
        dk, dv = kf.flash_bwd_dkv(q, k, v, o, lse, do, scale=sc, window=win)
        dq = kf.flash_bwd_dq(q, k, v, o, lse, do, scale=sc, window=win)
        pq, pk, pv = kf.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                  scale=sc, window=win)
        torch.cuda.synchronize()
        errs = {}
        for name, a, ref in (("dq", dq, pq), ("dk", dk, pk), ("dv", dv, pv)):
            errs[name] = max_err(a, ref)
            check(f"flash_bwd {label} {name}", errs[name],
                  rel * float(ref.float().abs().max()) + 1e-3)
        if label.startswith(("gpt2", "sft")):   # times only
            dl = kf._bwd_launch(0, q, k, v, o, lse, do, sc, win)[1]
            g_dkv = time_ms(torch, lambda: kf.flash_bwd_dkv(
                q, k, v, o, lse, do, scale=sc), iters=10)
            g_dq = time_ms(torch, lambda: kf.flash_bwd_dq(
                q, k, v, o, lse, do, scale=sc, delta=dl), iters=10)
            pairs = B * Hq * causal_pairs(T, win)
            g = Hq // Hkv
            qh = q.transpose(1, 2).detach().clone().requires_grad_(True)
            kh = k.transpose(1, 2).repeat_interleave(g, dim=1).detach() \
                .requires_grad_(True)
            vh = v.transpose(1, 2).repeat_interleave(g, dim=1).detach() \
                .requires_grad_(True)
            oh = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                                scale=sc)
            lms = event_ms(torch, lambda: torch.autograd.grad(
                oh, (qh, kh, vh), do.transpose(1, 2), retain_graph=True),
                iters=10)
            pstr = "" if not label.startswith("sft") else \
                " plain_ms(whole backward)={:.4f}".format(event_ms(
                    torch, lambda: kf.flash_attention_bwd_plain(
                        q, k, v, o, lse, do, scale=sc), iters=1, warm=1))
            say(f"  time flash_bwd {label}: dkv kernel_ms={g_dkv:.4f} dq "
                f"kernel_ms={g_dq:.4f}{pstr} bound_ms(dkv, dq)="
                f"{bound_ms(0, 8.0 * D * pairs)[0]:.5f}, "
                f"{bound_ms(0, 6.0 * D * pairs)[0]:.5f} (operations) "
                f"library_ms(SDPA backward)={lms:.4f}")
            del qh, kh, vh, oh
        if out:
            continue
        # timing at the Qwen3 slice shape: dkv with its delta pass, dq on
        # the delta dkv made (as flash_attention_bwd runs them)
        dl = kf._bwd_launch(0, q, k, v, o, lse, do, sc, win)[1]
        dkv_ms = time_ms(torch, lambda: kf.flash_bwd_dkv(
            q, k, v, o, lse, do, scale=sc), iters=10)
        dq_ms = time_ms(torch, lambda: kf.flash_bwd_dq(
            q, k, v, o, lse, do, scale=sc, delta=dl), iters=10)
        small = [t[:1, :128].contiguous() for t in (q, k, v, o)] \
            + [lse[:1, :, :128].contiguous(), do[:1, :128].contiguous()]
        h_dkv = host_us(torch, lambda: kf.flash_bwd_dkv(*small, scale=sc))
        h_dq = host_us(torch, lambda: kf.flash_bwd_dq(*small, scale=sc))
        say(f"  host per eager call (B1 T128 Hq16 D128): flash_bwd_dkv "
            f"{h_dkv:.1f} us, flash_bwd_dq {h_dq:.1f} us")
        pms = event_ms(torch, lambda: kf.flash_attention_bwd_plain(
            q, k, v, o, lse, do, scale=sc), iters=3)
        g = Hq // Hkv
        qh = q.transpose(1, 2).detach().clone().requires_grad_(True)
        kh = k.transpose(1, 2).repeat_interleave(g, dim=1).detach() \
            .requires_grad_(True)
        vh = v.transpose(1, 2).repeat_interleave(g, dim=1).detach() \
            .requires_grad_(True)
        oh = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                            scale=sc)
        doh = do.transpose(1, 2)
        lms = event_ms(torch, lambda: torch.autograd.grad(
            oh, (qh, kh, vh), doh, retain_graph=True), iters=10)
        pairs = B * Hq * causal_pairs(T, win)
        in_bytes = 2 * (3 * B * T * Hq * D + 2 * B * T * Hkv * D) \
            + 4 * B * Hq * T
        b_dkv = bound_ms(in_bytes + 2 * 2 * B * T * Hkv * D,
                         4 * 2.0 * D * pairs)
        b_dq = bound_ms(in_bytes + 2 * B * T * Hq * D, 3 * 2.0 * D * pairs)
        say(f"  time flash_bwd slice: dkv kernel_ms={dkv_ms:.4f} "
            f"bound_ms={b_dkv[0]:.5f} ({b_dkv[1]}); dq kernel_ms={dq_ms:.4f} "
            f"bound_ms={b_dq[0]:.5f} ({b_dq[1]}); plain_ms(whole backward)="
            f"{pms:.4f} library_ms(SDPA backward)={lms:.4f}")
        common = dict(plain_ms=pms, library_ms=lms)
        out["flash_bwd_dkv"] = dict(common, ms=dkv_ms, bound_ms=b_dkv[0],
                                    bound_by=b_dkv[1],
                                    max_abs_err=max(errs["dk"], errs["dv"]))
        out["flash_bwd_dq"] = dict(common, ms=dq_ms, bound_ms=b_dq[0],
                                   bound_by=b_dq[1], max_abs_err=errs["dq"])
        del qh, kh, vh, oh
    return out


#: the fused CE's cases (label, m, E, V, tied [V, E] storage, share of the
#: rows masked); the first, the Qwen3 slice shape, is timed, and the SFT
#: step's shape (16 x 8192 rows, most of them padding) is timed too
CE_CASES = [
    ("slice m8192 E1024 V151936 tied", 8192, 1024, 151936, True, 0.0),
    ("ragged m1000 E768 V50304 untied masked", 1000, 768, 50304, False, 0.3),
    ("ragged m100 E64 V333 tied masked", 100, 64, 333, True, 0.3),
    ("sft m131072 E1024 V151936 tied 95% masked", 131072, 1024, 151936,
     True, 0.95),
    ("GPT2-1558M head m16384 E1600 V50304 tied", 16384, 1600, 50304, True,
     0.0),
    ("Qwen3-4B head m1024 E2560 V151936 tied", 1024, 2560, 151936, True,
     0.0),
]


def _ce_rows(torch, gen, m, E, V, tied):
    """x [m, E], a head [E, V] (the tied wte.T view or untied), targets."""
    x = torch.randn((m, E), generator=gen, device="cuda").to(torch.bfloat16)
    if tied:
        w = (torch.randn((V, E), generator=gen, device="cuda") * 0.02
             ).to(torch.bfloat16).T
    else:
        w = (torch.randn((E, V), generator=gen, device="cuda") * 0.02
             ).to(torch.bfloat16)
    tgt = torch.randint(0, V, (m,), generator=gen, device="cuda",
                        dtype=torch.int32)
    return x, w, tgt


def _chunk_dlogits(torch, logits, tgt, lse, wtok, c0, p_scale=1.0):
    """The plain dlogits bf16((exp(logits − lse) − onehot)·wtok) of vocab
    columns [c0, c0 + n) from their f32 logits [m, n]; ``p_scale`` scales p
    (a planted fault: 2 doubles it, 0 leaves the one-hot term only)."""
    cols = torch.arange(c0, c0 + logits.shape[1], device=logits.device)
    p = torch.exp(logits - lse[:, None]) * p_scale
    p = p - (cols[None, :] == tgt.long()[:, None]).to(torch.float32)
    return (p * wtok[:, None]).to(torch.bfloat16)


#: the fused CE's checks that see a wrong softmax term (each also fails on
#: the planted faults "p doubled" and "one-hot term only"): dlogits entry by
#: entry within one bf16 ulp (2^-7 of the plain entry; the kernels keep the
#: plain version's roundings), dx as ‖Δ‖/‖plain‖ (its softmax term is ~2 %
#: of its norm at these widths; the sound kernels read up to 8.3e-4, the
#: tensor cores' f32 sums over a 131,072-column chunk, and the faults
#: 2.0e-2 to 5.7e-2), dw as ‖Δ‖/‖plain‖ over the vocab columns that are no
#: row's target (the softmax term alone: sound up to 4.3e-4, faults 1.0)
CE_DLOGITS_ULP, CE_DLOGITS_ABS = 2.0 ** -7, 1e-12
CE_DX_NORM, CE_DW_NT_NORM = 4e-3, 1e-2


def _ce_gate(name, err, lim, faults):
    """``err`` within ``lim``; each planted fault's error beyond it."""
    check(name, err, lim)
    for kind, ferr in faults.items():
        ok = ferr > lim
        say(f"  check {name} sees a planted fault ({kind}): err={ferr:.3e} "
            f"> {lim:.1e} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{name} does not see a planted fault ({kind})")


def _ce_softmax_checks(torch, sfx, label, out, refs, plain, tgt, wtok, lse,
                       c0):
    """The checks of ``CE_DLOGITS_ULP`` ... on the kernels' (dlogits of the
    last chunk, dx, dw), each with the planted faults built from the plain
    outputs: dx = A − B and dw = A' − B' with B, B' the one-hot terms
    (wtok·w[:, tgt]ᵀ and x·wtok scattered into the target columns), so p
    doubled gives 2·plain + B and the one-hot term only gives −B."""
    f32, bf16 = torch.float32, torch.bfloat16
    tl = tgt.long()

    def ulps(d, ref):
        return float(((d.float() - ref.float()).abs()
                      / (CE_DLOGITS_ULP * ref.float().abs() + CE_DLOGITS_ABS)
                      ).max())

    def norm_rel(d, ref, cols=None):
        diff = d.float() - ref.float()
        r = ref.float()
        if cols is not None:
            diff, r = diff[:, cols], r[:, cols]
        return float(diff.norm() / r.norm().clamp_min(1e-30))

    logits = plain["logits"](c0, out["dlogits"].shape[1])
    faults = {k: ulps(_chunk_dlogits(torch, logits, tgt, lse, wtok, c0, s),
                      refs["dlogits"])
              for k, s in (("p doubled", 2.0), ("one-hot only", 0.0))}
    del logits
    _ce_gate(f"fused_ce_dlogits{sfx} {label} per entry, |Δ| / (2^-7·|plain| "
             f"+ 1e-12)", ulps(out["dlogits"], refs["dlogits"]), 1.0, faults)
    b = wtok[:, None] * plain["w_cols"](tl).T                   # [m, E]
    ref = refs["dx"].float()
    faults = {"p doubled": norm_rel((2 * ref + b).to(bf16), ref),
              "one-hot only": norm_rel((-b).to(bf16), ref)}
    del b
    _ce_gate(f"fused_ce_dx{sfx} {label} ‖Δ‖/‖plain‖",
             norm_rel(out["dx"], ref), CE_DX_NORM, faults)
    del ref
    ref = refs["dw"].float()
    b = torch.zeros_like(ref).index_add_(
        1, tl, (plain["x_dw"].float() * wtok[:, None]).T)     # [E, V]
    nt = torch.ones(ref.shape[1], dtype=torch.bool, device=ref.device)
    nt[tl] = False
    faults = {"p doubled": norm_rel((2 * ref + b).to(bf16), ref, nt),
              "one-hot only": norm_rel((-b).to(bf16), ref, nt)}
    del b
    _ce_gate(f"fused_ce_dw{sfx} {label} ‖Δ‖/‖plain‖ over the {int(nt.sum())} "
             f"non-target columns", norm_rel(out["dw"], ref, nt),
             CE_DW_NT_NORM, faults)


def _ce_check(torch, kc, sfx, label, m, V, tgt, wtok, run, plain, tol_fwd,
              rel=1e-2):
    """One fused-CE flavour (kernel names ending ``sfx``) against its plain
    versions: lse/gold within ``tol_fwd(plain lse)``; the dlogits kernel's
    last vocab chunk (the chunk buffer after the backward), dx and dw within
    ``rel`` of their largest entry, and the checks of
    ``_ce_softmax_checks``; then a repeat of every launch must give the same
    bits. ``run``: "fwd" () -> (lse, gold), "bwd" (lse, buf) -> (dx, dw);
    ``plain``: "fwd", "dx" (lse), "dw" (lse), "logits" (c0, vc) -> f32
    logits [m, vc], "w_cols" (idx) -> f32 [E, len(idx)] head columns as the
    dx GEMM reads them, "x_dw": the bf16 x the dw GEMM reads. Returns
    (max_abs_err by kernel, plain lse)."""
    lse, gold = run["fwd"]()
    plse, pgold = plain["fwd"]()
    ldb, chunks = kc.chunk_plan(m, V)
    c0, vc = chunks[-1]
    buf = torch.empty((m, ldb), dtype=torch.bfloat16, device="cuda")
    dx, dw = run["bwd"](plse, buf)
    refs = dict(dlogits=_chunk_dlogits(torch, plain["logits"](c0, vc), tgt,
                                       plse, wtok, c0),
                dx=plain["dx"](plse), dw=plain["dw"](plse))
    torch.cuda.synchronize()
    errs = dict(fwd=max(max_err(lse, plse), max_err(gold, pgold)),
                dlogits=max_err(buf[:, :vc], refs["dlogits"]),
                dx=max_err(dx, refs["dx"]), dw=max_err(dw, refs["dw"]))
    check(f"fused_ce_fwd{sfx} {label} lse/gold", errs["fwd"], tol_fwd(plse))
    for key, ref in refs.items():
        check(f"fused_ce_{key}{sfx} {label}", errs[key],
              rel * float(ref.float().abs().max()) + 1e-8)
    _ce_softmax_checks(torch, sfx, label,
                       dict(dlogits=buf[:, :vc], dx=dx, dw=dw), refs, plain,
                       tgt, wtok, plse, c0)
    del refs
    lse2, gold2 = run["fwd"]()
    buf2 = torch.empty_like(buf)
    dx2, dw2 = run["bwd"](plse, buf2)
    torch.cuda.synchronize()
    differ = sum(int(not torch.equal(a, b)) for a, b in (
        (lse, lse2), (gold, gold2), (buf[:, :vc], buf2[:, :vc]), (dx, dx2),
        (dw, dw2)))
    check(f"fused_ce{sfx} {label} repeat: outputs not equal bit for bit",
          float(differ), 0.0)
    return errs, plse


def _ce_times(torch, rows, errs, out, tag):
    """Time each (name, kernel, plain, library or None, bytes, bf16 flops,
    int8 ops, what) row into out[name] with its max_abs_err."""
    for name, kern, plain, lib, nbytes, fl, i8, what in rows:
        kms = time_ms(torch, kern, iters=3, warm=1)
        pms = event_ms(torch, plain, iters=1, warm=1)
        lms = None if lib is None else time_ms(torch, lib, iters=3, warm=1)
        bms, by = bound_ms(nbytes, fl, i8)
        lstr = "null" if lms is None else f"{lms:.4f}"
        say(f"  time {name} {tag}: kernel_ms={kms:.4f} plain_ms={pms:.4f} "
            f"library_ms({what})={lstr} bound_ms={bms:.5f} ({by})")
        out[name] = dict(ms=kms, plain_ms=pms, library_ms=lms, bound_ms=bms,
                         bound_by=by, max_abs_err=errs.get(
                             name.split("_")[2], max(errs.values())))


def _ce_memory_gate(torch, label, bwd):
    """The backward's device memory beyond its dx and dw: at most 512 MiB."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    dx, dw = bwd()
    torch.cuda.synchronize()
    extra = (torch.cuda.max_memory_allocated() - before
             - 2 * dx.numel() - 2 * dw.numel()) / 2**20
    ok = extra <= 512.0
    say(f"  check fused_ce backward {label} extra device memory beyond dx and "
        f"dw: {extra:.1f} MiB (limit 512) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"the fused CE backward took {extra:.1f} MiB beyond its outputs")


def fused_ce_phase(torch, gen):
    """The fused CE's kernels against their plain versions on the card: the
    forward (lse, gold), the backward's dlogits kernel (its last chunk) and
    its dx and dw GEMMs through ``fused_ce_bwd``, at the Qwen3 slice shape,
    ragged shapes and E 1600 and 2560; a repeat of each launch equals the
    first bit for bit; the backward's extra device memory at the slice
    shape; times there (m = 8192, tied [V, E] head): fwd, dlogits, dx and
    dw alone (over all vocab chunks) and the whole backward; at E 1600 and
    2560 the forward and the whole backward."""
    from koifish_tpu_torch.ops.kernels import fused_ce as kc
    say("[kernels] fused_ce_fwd / fused_ce_dlogits / fused_ce_dx / "
        "fused_ce_dw (koifish_tpu_torch/csrc/fused_ce.cu)")
    # lse and gold are f32 (|lse| ~ 12): only the f32 summation order
    # differs: 2e-3, and at E 1600 and 2560 1e-5 of the largest |lse| (the
    # int8 phase's limit at E 1280); dlogits, dx and dw are bf16: 1 % of
    # the largest entry (about one ulp)
    tol_f32 = 2e-3
    out = {}
    for label, m, E, V, tied, masked in CE_CASES:
        x, w, tgt = _ce_rows(torch, gen, m, E, V, tied)
        mask = torch.ones((m,), device="cuda")
        if masked:
            mask[torch.rand((m,), generator=gen, device="cuda") < masked] = 0.0
        wtok = (mask / mask.sum().clamp_min(1.0)).contiguous()
        run = dict(fwd=lambda: kc.fused_ce_fwd(x, w, tgt),
                   bwd=lambda lse, buf: kc._bwd(x, w, tgt, lse, wtok,
                                                buf=buf))
        plain = dict(fwd=lambda: kc.fused_ce_fwd_plain(x, w, tgt),
                     dx=lambda lse: kc.fused_ce_dx_plain(x, w, tgt, lse, wtok),
                     dw=lambda lse: kc.fused_ce_dw_plain(x, w, tgt, lse, wtok),
                     logits=lambda c0, vc: kc._logits(x, w[:, c0:c0 + vc]),
                     w_cols=lambda idx: w[:, idx].float(), x_dw=x)
        errs, plse = _ce_check(
            torch, kc, "", label, m, V, tgt, wtok, run, plain,
            (lambda p: 1e-5 * float(p.abs().max())) if E > 1280
            else (lambda _: tol_f32))
        if out:
            if label.startswith("sft"):   # the SFT step's launches, timed
                # two bounds: the rows the masked loss needs (wtok > 0; a
                # masked row's lse, dlogits and dx row are not needed, its
                # dx row is written as zeros) and every row, as the kernels
                # take them (they skip no row)
                mu = int(mask.sum())
                bounds = {}
                for rows, tag in ((mu, "needed rows"), (m, "all rows")):
                    fl = 2.0 * rows * E * V
                    xE = 2 * rows * E + 2 * E * V
                    bounds[tag] = (
                        (xE + 12 * rows, fl),
                        (xE + 2 * m * E + 12 * m, 2 * fl))
                for j, (name, kern, plain_fn) in enumerate((
                        ("fused_ce_fwd", run["fwd"], plain["fwd"]),
                        ("fused_ce_bwd dlogits+dx", lambda: kc.fused_ce_bwd(
                            x, w, tgt, plse, wtok, need_dw=False),
                         lambda: plain["dx"](plse)))):
                    kms = time_ms(torch, kern, iters=2, warm=1)
                    pms = event_ms(torch, plain_fn, iters=1, warm=0)
                    txt = []
                    for tag, b in bounds.items():
                        bms, by = bound_ms(*b[j])
                        txt.append(f"bound_ms({tag})={bms:.5f} ({by})")
                    say(f"  time {name} {label}: kernel_ms={kms:.4f} "
                        f"plain_ms={pms:.4f} {' '.join(txt)}; {mu} of {m} "
                        f"rows unmasked")
            if E > 1280:    # GPT2-1558M's and Qwen3-4B's heads: timed too
                fl = 2.0 * m * E * V
                xE = 2 * m * E + 2 * E * V
                dlog = kc._dlogits(x, w, tgt, plse, wtok)    # [m, V] bf16
                for name, kern, lib, nbytes, ops in (
                        ("fused_ce_fwd", run["fwd"],
                         lambda: torch.matmul(x, w), xE + 12 * m, fl),
                        ("fused_ce_bwd", lambda: kc.fused_ce_bwd(
                            x, w, tgt, plse, wtok),
                         lambda: (torch.matmul(dlog, w.T),
                                  torch.matmul(x.T, dlog)),
                         2 * xE + 12 * m, 3 * fl)):
                    kms = time_ms(torch, kern, iters=3, warm=1)
                    lms = time_ms(torch, lib, iters=3, warm=1)
                    bms, by = bound_ms(nbytes, ops)
                    what = ("matmul x·w" if name == "fused_ce_fwd" else
                            "matmuls dlogits·wᵀ and xᵀ·dlogits")
                    say(f"  time {name} E{E} M{m} V{V}: kernel_ms={kms:.4f} "
                        f"library_ms({what})={lms:.4f} "
                        f"bound_ms={bms:.5f} ({by})")
                del dlog
            continue
        _ce_memory_gate(torch, label, lambda: kc.fused_ce_bwd(
            x, w, tgt, plse, wtok))
        buf = torch.empty((m, kc.chunk_plan(m, V)[0]), dtype=torch.bfloat16,
                          device="cuda")
        dlog = kc._dlogits(x, w, tgt, plse, wtok)        # [m, V] bf16

        def bwd(kernels):
            return lambda: kc._bwd(x, w, tgt, plse, wtok, kernels, buf=buf)
        xE = 2 * m * E + 2 * E * V
        fl = 2.0 * m * E * V
        _ce_times(torch, (
            ("fused_ce_fwd", lambda: kc.fused_ce_fwd(x, w, tgt),
             lambda: kc.fused_ce_fwd_plain(x, w, tgt),
             lambda: torch.matmul(x, w), xE + 12 * m, fl, 0.0, "matmul x·w"),
            ("fused_ce_dlogits", bwd(("dlogits",)),
             lambda: kc._dlogits(x, w, tgt, plse, wtok),
             lambda: torch.matmul(x, w), xE + 12 * m + 2 * m * V, fl, 0.0,
             "matmul x·w"),
            ("fused_ce_dx", bwd(("dx",)),
             lambda: (dlog.float() @ w.float().T).to(torch.bfloat16),
             lambda: torch.matmul(dlog, w.T),
             2 * m * V + 2 * E * V + 2 * m * E, fl, 0.0,
             "matmul dlogits·wᵀ"),
            ("fused_ce_dw", bwd(("dw",)),
             lambda: (x.float().T @ dlog.float()).to(torch.bfloat16),
             lambda: torch.matmul(x.T, dlog),
             2 * m * V + 2 * m * E + 2 * E * V, fl, 0.0,
             "matmul xᵀ·dlogits"),
            ("fused_ce_bwd", bwd(kc.BWD_KERNELS),
             lambda: (kc.fused_ce_dx_plain(x, w, tgt, plse, wtok),
                      kc.fused_ce_dw_plain(x, w, tgt, plse, wtok)),
             None, 2 * xE + 12 * m, 3 * fl, 0.0,
             "no single call: dlogits, dx and dw"),
        ), errs, out, "slice")
        del dlog, buf
    torch.cuda.empty_cache()
    return out


# GPT2-774M (configs/gpt2_774m.json) at B = 16 x T = 1024
G774_M, G774_E, G774_F, G774_V = 16384, 1280, 5120, 50304
#: the int8 phase's fused-CE shapes (tag, m, E, V), tied heads: GPT2-774M's
#: (timed), GPT2-1558M's at the same batch, Qwen3-4B's at m 1024
CE8_CASES = [("E1280", G774_M, G774_E, G774_V),
             ("E1600", G774_M, 1600, G774_V), ("E2560", 1024, 2560, 151936)]


def int8_phase(torch, gen):
    """The int8 training kernels against their plain versions on the card
    at GPT2-774M's shapes: quantize (bit for bit), qdgrad (the fc dgrad),
    the int8 fused CE and the bf16 fused CE at E 1280; kernel, plain,
    library and bound times."""
    from koifish_tpu_torch.ops.kernels import fused_ce as kc
    from koifish_tpu_torch.ops.kernels import qdgrad as kqd
    from koifish_tpu_torch.ops.kernels import quantize as kq
    say("[kernels] rowquant / colquant (koifish_tpu_torch/csrc/quantize.cu), "
        "qdgrad_int8_tile (csrc/qdgrad.cu), fused_ce_*_int8 "
        "(csrc/fused_ce_int8.cu) at GPT2-774M's shapes")
    M, E, F, V = G774_M, G774_E, G774_F, G774_V
    out = {}

    def rnd(*shape, s=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * s
                ).to(torch.bfloat16)

    # quantize: codes and scales bit for bit, every layout the path sends
    x = rnd(M, E)
    h = rnd(M, F)
    w_fc = rnd(E, F, s=0.02)
    wte = rnd(V, E, s=0.02)
    cases = [("rowquant x", x, 1), ("rowquant fc out", h, 1),
             ("colquant fc w", w_fc, 0), ("colquant proj w", w_fc.T.contiguous(), 0),
             ("colquant tied head wte.T", wte.T, 0),
             ("rowquant of a transposed view", w_fc.T, 1)]
    for label, t, dim in cases:
        for rounding in ("jit", "pallas"):
            q, sc = kq.quantize(t, dim, rounding)
            pq_, psc = kq.quantize_plain(t, dim, rounding)
            torch.cuda.synchronize()
            err = float((q != pq_).sum()) + float((sc != psc).sum())
            check(f"quantize {label} ({rounding}) differing codes+scales",
                  err, 0.0)
    for name, t, dim in (("rowquant", x, 1), ("colquant", wte.T, 0)):
        kms = time_ms(torch, lambda: kq.quantize(t, dim, "jit"))
        pms = time_ms(torch, lambda: kq.quantize_plain(t, dim, "jit"),
                      iters=5)
        n = t.numel()
        lines = t.shape[0] if dim == 1 else t.shape[1]
        bms, by = bound_ms(2 * n + n + 4 * lines, 0.0)
        say(f"  time {name} {tuple(t.shape)}: kernel_ms={kms:.4f} "
            f"plain_ms={pms:.4f} library_ms=null (no single PyTorch call "
            f"quantizes) bound_ms={bms:.5f} ({by})")
        out[name] = dict(ms=kms, plain_ms=pms, library_ms=None, bound_ms=bms,
                         bound_by=by, max_abs_err=0.0)
    fc_ms = time_ms(torch, lambda: kq.quantize(w_fc, 0, "jit"))
    say(f"  time colquant fc w {tuple(w_fc.shape)} (72 a step): "
        f"kernel_ms={fc_ms:.4f}")
    del h

    # qdgrad: the fc dgrad, dy [M, F], wq [E, F], and a ragged shape (M off
    # the 128-row tile, 9 row tiles, K not a multiple of 8), bit for bit against the
    # plain version; a repeat launch bit for bit; two planted faults built
    # from the plain outputs that the check must reject
    for label, Md, Nd, Kd in (("fc M16384 N5120 K1280", M, F, E),
                              ("ragged M1100 N2048 K330", 1100, 2048, 330)):
        dy = rnd(Md, Nd)
        wq, sw = kq.quantize(rnd(Kd, Nd, s=0.02), 0, "jit")
        sw1 = sw.reshape(-1).contiguous()
        dx = kqd.dgrad_int8_tile(dy, wq, sw1)
        dx2 = kqd.dgrad_int8_tile(dy, wq, sw1)
        pdx = kqd.dgrad_int8_tile_plain(dy, wq, sw)
        torch.cuda.synchronize()
        check(f"qdgrad_int8_tile {label} differing bf16 entries",
              bits_differ(dx, pdx), 0.0)
        check(f"qdgrad_int8_tile {label} repeat launch differing entries",
              bits_differ(dx, dx2), 0.0)
        # faults: one row scale over all of N instead of one per tile; the
        # last 1024-column tile dropped
        q1, s1 = kq.quantize_plain(dy.float() * sw1, 1, "jit")
        one_scale = (kq.int8_dot(q1, wq.T).double() * s1.double()
                     ).float().to(torch.bfloat16)
        last = kqd.dgrad_int8_tile_plain(dy[:, :-kqd.BN].contiguous(),
                                         wq[:, :-kqd.BN].contiguous(),
                                         sw1[:-kqd.BN].contiguous())
        for fname, fdx in (("one row scale over N", one_scale),
                           ("last tile dropped", last)):
            reading = bits_differ(fdx, pdx)
            say(f"  fault qdgrad_int8_tile {label} {fname}: differing bf16 "
                f"entries {reading:.0f} of {pdx.numel()}, max_abs_err "
                f"{max_err(fdx, pdx):.3e} (the check must reject it)")
            if reading <= 0.0:
                fail(f"the qdgrad check passes the planted fault {fname}")
        del one_scale, last, q1, s1, dx2
        if Md != M:
            del dy, dx, pdx
            continue
        wd = (wq.float() * sw).to(torch.bfloat16)
        q, sx = kqd.dgrad_quant_plain(dy, sw1)
        kms = time_ms(torch, lambda: kqd.dgrad_int8_tile(dy, wq, sw1),
                      iters=10)
        pms = event_ms(torch, lambda: kqd.dgrad_int8_tile_plain(dy, wq, sw),
                       iters=2, warm=1)
        lms = time_ms(torch, lambda: torch.matmul(dy, wd.T), iters=10)
        bms, by = bound_ms(2 * M * F + E * F + 4 * F + 2 * M * E, 0.0,
                           2.0 * M * F * E)
        # each launch alone, each a row of the kernels line: the quantize
        # pass against dgrad_quant_plain, the GEMM against dgrad_gemm_plain
        # on the plain codes and scales
        lib, quant, gemm = kqd._kernel()
        qk, sxk = torch.empty_like(q), torch.empty_like(sx)
        dxk = torch.empty_like(dx)

        def stream():   # the capturing stream under time_ms's graph
            return torch.cuda.current_stream().cuda_stream
        qms = time_ms(torch, lambda: quant(dy.data_ptr(), sw1.data_ptr(),
                                           qk.data_ptr(), sxk.data_ptr(), M,
                                           F, stream()), iters=10)
        gms = time_ms(torch, lambda: gemm(q.data_ptr(), wq.data_ptr(),
                                          sx.data_ptr(), dxk.data_ptr(), M,
                                          F, E, stream()), iters=10)
        qpms = event_ms(torch, lambda: kqd.dgrad_quant_plain(dy, sw1),
                        iters=2, warm=1)
        gpms = event_ms(torch, lambda: kqd.dgrad_gemm_plain(q, wq, sx),
                        iters=2, warm=1)
        # the library's int8 GEMM on the same codes, without the per-tile
        # scales: the GEMM's yardstick
        ims = time_ms(torch, lambda: torch._int_mm(q, wq.T), iters=10)
        qbms, qby = bound_ms(2 * M * F + 4 * F + M * F + 4 * M * (F // 1024),
                             0.0)
        gbms, gby = bound_ms(M * F + E * F + 4 * M * (F // 1024) + 2 * M * E,
                             0.0, 2.0 * M * F * E)
        torch.cuda.synchronize()
        qerr = max(float((qk.int() - q.int()).abs().max()),
                   float((sxk - sx).abs().max()))
        check("qdgrad_quant fc differing codes+scales",
              float((qk != q).sum()) + float((sxk != sx).sum()), 0.0)
        check("qdgrad GEMM alone fc differing bf16 entries",
              bits_differ(dxk, pdx), 0.0)
        say(f"  time qdgrad fc, both launches: kernel_ms={kms:.4f} "
            f"plain_ms={pms:.4f} library_ms(bf16 dy·wdᵀ)={lms:.4f} "
            f"bound_ms={bms:.5f} ({by})")
        say(f"  time qdgrad_quant fc: kernel_ms={qms:.4f} plain_ms="
            f"{qpms:.4f} bound_ms={qbms:.5f} ({qby}) max_abs_err={qerr:.3e}")
        say(f"  time qdgrad_int8_tile fc (the GEMM): kernel_ms={gms:.4f} "
            f"plain_ms={gpms:.4f} library_ms(_int_mm q·wqᵀ, no scales)="
            f"{ims:.4f} bound_ms={gbms:.5f} ({gby}) max_abs_err="
            f"{max_err(dxk, pdx):.3e}")
        out["qdgrad_int8_tile"] = dict(ms=gms, plain_ms=gpms, library_ms=ims,
                                       bound_ms=gbms, bound_by=gby,
                                       max_abs_err=max_err(dxk, pdx))
        out["qdgrad_quant"] = dict(ms=qms, plain_ms=qpms, library_ms=None,
                                   bound_ms=qbms, bound_by=qby,
                                   max_abs_err=qerr)
        del dy, dx, pdx, wd, q, sx, qk, sxk, dxk

    # the int8 fused CE, tied head, at E 1280 (GPT2-774M's head, timed; the
    # bf16 flavour too, at the same inputs), E 1600 (GPT2-1558M's at B 16 x
    # 1024) and E 2560 (Qwen3-4B's, m 1024; the bf16 flavour at these two is
    # fused_ce_phase's). lse / gold f32 of O(10): the int32 logits are exact,
    # only the order of the exp sums differs (1e-5 relative); dlogits, dx,
    # dw bf16: 1 % of the largest entry
    del wte
    torch.cuda.empty_cache()
    rel5 = lambda plse: 1e-5 * float(plse.abs().max())   # noqa: E731
    for tag, m, Ec, Vc in CE8_CASES:
        xs, w, tgt = _ce_rows(torch, gen, m, Ec, Vc, True)
        wtok = torch.full((m,), 1.0 / m, device="cuda")
        xq, sx = kq.rowquant(xs, "jit")
        wq, sw = kq.colquant(w, "jit")
        sx, sw = sx.reshape(-1).contiguous(), sw.reshape(-1).contiguous()
        label = f"{tag} m{m} V{Vc}"
        run8 = dict(
            fwd=lambda: kc.fused_ce_fwd_int8(xq, sx, wq, sw, tgt),
            bwd=lambda lse, buf: kc._bwd_int8(
                xs, xq, sx, wq, sw, tgt, lse, wtok, buf=buf))
        plain8 = dict(
            fwd=lambda: kc.fused_ce_fwd_int8_plain(xq, sx, wq, sw, tgt),
            dx=lambda lse: kc.fused_ce_dx_int8_plain(xq, sx, wq, sw, tgt,
                                                     lse, wtok),
            dw=lambda lse: kc.fused_ce_dw_int8_plain(xs, xq, sx, wq, sw, tgt,
                                                     lse, wtok),
            logits=lambda c0, vc: kc._logits8(xq, sx, wq[:, c0:c0 + vc],
                                              sw[c0:c0 + vc]),
            w_cols=lambda idx: (wq[:, idx].float() * sw[idx]).to(
                torch.bfloat16).float(), x_dw=xs)
        errs8, plse = _ce_check(torch, kc, "_int8", label, m, Vc, tgt, wtok,
                                run8, plain8, rel5)
        buf = torch.empty((m, kc.chunk_plan(m, Vc)[0]), dtype=torch.bfloat16,
                          device="cuda")

        def bwd8(kernels):
            return lambda: kc._bwd_int8(xs, xq, sx, wq, sw, tgt, plse, wtok,
                                        kernels, buf=buf)
        fl = 2.0 * m * Ec * Vc
        codes = m * Ec + Ec * Vc + 4 * Vc + 4 * m * 3
        times = [("fused_ce_fwd_int8", run8["fwd"], codes, (0.0, fl)),
                 ("fused_ce_bwd_int8", bwd8(kc.BWD_KERNELS),
                  codes + 4 * m * Ec + 2 * Ec * Vc, (2 * fl, fl))]
        if tag == "E1280":
            run16 = dict(
                fwd=lambda: kc.fused_ce_fwd(xs, w, tgt),
                bwd=lambda lse, buf: kc._bwd(xs, w, tgt, lse, wtok, buf=buf))
            plain16 = dict(
                fwd=lambda: kc.fused_ce_fwd_plain(xs, w, tgt),
                dx=lambda lse: kc.fused_ce_dx_plain(xs, w, tgt, lse, wtok),
                dw=lambda lse: kc.fused_ce_dw_plain(xs, w, tgt, lse, wtok),
                logits=lambda c0, vc: kc._logits(xs, w[:, c0:c0 + vc]),
                w_cols=lambda idx: w[:, idx].float(), x_dw=xs)
            _, pblse = _ce_check(torch, kc, "", label, m, Vc, tgt, wtok,
                                 run16, plain16, rel5)
            times += [("fused_ce_fwd", run16["fwd"], 2 * m * Ec + 2 * Ec * Vc
                       + 12 * m, (fl, 0.0)),
                      ("fused_ce_bwd", lambda: kc._bwd(
                          xs, w, tgt, pblse, wtok, buf=buf),
                       4 * m * Ec + 4 * Ec * Vc + 12 * m, (3 * fl, 0.0))]
        # the forward and whole backward at this width (bf16 at E 1280)
        libs = {}
        if tag != "E1280":   # row 10-int8's yardsticks at these widths
            wq_c = wq.contiguous()
            wd = (wq.float() * sw).to(torch.bfloat16)
            dlog = kc._dlogits8(xq, sx, wq, sw, tgt, plse, wtok)
            libs = {"fused_ce_fwd_int8": (
                        lambda: torch._int_mm(xq, wq_c), "_int_mm logits"),
                    "fused_ce_bwd_int8": (
                        lambda: (torch.matmul(dlog, wd.T),
                                 torch.matmul(xs.T, dlog)),
                        "matmuls dlogits·bf16(wq·sw)ᵀ and xᵀ·dlogits")}
        for name, kern, nbytes, ops in times:
            kms = time_ms(torch, kern, iters=3, warm=1)
            bms, by = bound_ms(nbytes, *ops)
            lstr = ""
            if name in libs:
                lib, what = libs[name]
                lstr = (f" library_ms({what})="
                        f"{time_ms(torch, lib, iters=3, warm=1):.4f}")
            say(f"  time {name} {tag} M{m} V{Vc}: kernel_ms={kms:.4f}{lstr} "
                f"bound_ms={bms:.5f} ({by})")
        if tag != "E1280":
            del xs, w, xq, wq, buf, libs, wq_c, wd, dlog
            torch.cuda.empty_cache()
            continue
        wq_c = wq.contiguous()                     # [E, V] codes, row-major
        wd = (wq.float() * sw).to(torch.bfloat16)  # [E, V]: bf16(wq·sw)
        dlog = kc._dlogits8(xq, sx, wq, sw, tgt, plse, wtok)   # [m, V] bf16
        _ce_times(torch, (
            ("fused_ce_fwd_int8", lambda: kc.fused_ce_fwd_int8(
                xq, sx, wq, sw, tgt),
             lambda: kc.fused_ce_fwd_int8_plain(xq, sx, wq, sw, tgt),
             lambda: torch._int_mm(xq, wq_c), codes, 0.0, fl,
             "_int_mm logits"),
            ("fused_ce_dlogits_int8", bwd8(("dlogits",)),
             lambda: kc._dlogits8(xq, sx, wq, sw, tgt, plse, wtok),
             lambda: torch._int_mm(xq, wq_c), codes + 2 * m * Vc, 0.0, fl,
             "_int_mm logits"),
            ("fused_ce_dx_int8", bwd8(("dx",)),
             lambda: (dlog.float() @ wd.float().T).to(torch.bfloat16),
             lambda: torch.matmul(dlog, wd.T),
             2 * m * Vc + Ec * Vc + 4 * Vc + 2 * m * Ec, fl, 0.0,
             "matmul dlogits·bf16(wq·sw)ᵀ"),
            ("fused_ce_dw_int8", bwd8(("dw",)),
             lambda: (xs.float().T @ dlog.float()).to(torch.bfloat16),
             lambda: torch.matmul(xs.T, dlog),
             2 * m * Vc + 2 * m * Ec + 2 * Ec * Vc, fl, 0.0,
             "matmul xᵀ·dlogits"),
            ("fused_ce_bwd_int8", bwd8(kc.BWD_KERNELS),
             lambda: (kc.fused_ce_dx_int8_plain(xq, sx, wq, sw, tgt, plse,
                                                wtok),
                      kc.fused_ce_dw_int8_plain(xs, xq, sx, wq, sw, tgt, plse,
                                                wtok)),
             None, codes + 4 * m * Ec + 2 * Ec * Vc, 2 * fl, fl,
             "no single call: dlogits, dx and dw"),
        ), errs8, out, tag)
        del xs, w, xq, wq, wq_c, wd, dlog, buf
    torch.cuda.empty_cache()
    return out


def slotwrite_phase(torch, gen):
    """slot_write and page_write against their plain versions (bit for bit)
    at the batcher's shapes; times of one layer's writes in one launch."""
    from koifish_tpu_torch.ops.kernels import slotwrite as ks
    say("[kernels] slot_write / page_write "
        "(koifish_tpu_torch/csrc/slotwrite.cu)")
    B, H, S, D, P = 32, 8, 1024, 128, 128
    dev = "cuda"

    def codes(shape, dtype):
        if dtype == torch.bfloat16:
            return torch.randn(shape, generator=gen, device=dev).to(dtype)
        if dtype == torch.float32:
            return torch.rand(shape, generator=gen, device=dev)
        return torch.randint(0, 120, shape, generator=gen, device=dev
                             ).to(dtype)

    edges = torch.tensor([0, 31, 32, 63, 64, 95, 96, 1023] * 4,
                         dtype=torch.int32, device=dev)
    same = torch.tensor([5] * 16 + [511] * 16, dtype=torch.int32, device=dev)
    rand = torch.randint(0, S, (B,), generator=gen, device=dev,
                         dtype=torch.int32)
    err = 0.0
    # int8 codes, packed-INT4 bytes, bf16, and the f32 scales [B, H, S]
    for label, shape, dtype in (("int8", (B, H, S, D), torch.int8),
                                ("int4 bytes", (B, H, S, D // 2),
                                 torch.uint8),
                                ("bf16", (B, H, S, D), torch.bfloat16),
                                ("f32 scales", (B, H, S), torch.float32)):
        buf = codes(shape, dtype)
        val = codes((B, H) + shape[3:], dtype)
        for pname, slots in (("block edges", edges), ("same slots", same),
                             ("random", rand)):
            got = buf.clone()
            ks.slot_write(got, val, slots)
            want = ks.slot_write_plain(buf, val, slots)
            torch.cuda.synchronize()
            e = max_err(got, want)
            check(f"slot_write {label} B{B} H{H} S{S} {pname}", e, 0.0)
            err = max(err, e)
    # a decode layer's four writes in one launch (INT8 KV: codes + scales)
    kc, vc = codes((B, H, S, D), torch.int8), codes((B, H, S, D), torch.int8)
    ksc, vsc = codes((B, H, S), torch.float32), codes((B, H, S),
                                                      torch.float32)
    kv, vv = codes((B, H, D), torch.int8), codes((B, H, D), torch.int8)
    ksv, vsv = codes((B, H), torch.float32), codes((B, H), torch.float32)
    four = [(kc, kv), (vc, vv), (ksc, ksv), (vsc, vsv)]
    snap = [b.clone() for b, _ in four]
    ks.slot_write_many(four, rand)
    torch.cuda.synchronize()
    for (b, v), old in zip(four, snap):
        e = max_err(b, ks.slot_write_plain(old, v, rand))
        check(f"slot_write 4 buffers in one launch {tuple(b.shape)}", e, 0.0)
        err = max(err, e)
    del snap
    lanes = torch.arange(B, device=dev)
    sl = rand.long()

    def lib_slot():
        for b, v in four:
            b[lanes, :, sl] = v
    sms = time_ms(torch, lambda: ks.slot_write_many(four, rand), iters=50)
    spms = time_ms(torch, lambda: [ks.slot_write_plain(b, v, rand)
                                   for b, v in four], iters=10)
    slms = time_ms(torch, lib_slot, iters=50)
    nbytes = 2 * 2 * (B * H * D + B * H * 4) + B * 4
    sbms, sby = bound_ms(nbytes, 0.0)
    say(f"  time slot_write one layer (4 buffers, INT8 KV, one launch): "
        f"kernel_ms={sms:.5f} plain_ms={spms:.4f} "
        f"library_ms(index_put_)={slms:.5f} bound_ms={sbms:.6f} ({sby})")
    say(f"  host per eager call: slot_write_many (4 buffers) "
        f"{host_us(torch, lambda: ks.slot_write_many(four, rand)):.1f} us, "
        f"4 x index_put_ {host_us(torch, lib_slot):.1f} us")
    slot = dict(ms=sms, plain_ms=spms, library_ms=slms, bound_ms=sbms,
                bound_by=sby, max_abs_err=err)

    # page write: pages [H, NP, P, D] bf16, distinct page ids, K and V
    NP = 2 * B
    kp = codes((H, NP, P, D), torch.bfloat16)
    vp = codes((H, NP, P, D), torch.bfloat16)
    kval, vval = codes((B, H, D), torch.bfloat16), codes((B, H, D),
                                                         torch.bfloat16)
    pids = torch.randperm(NP, generator=gen, device=dev)[:B].to(torch.int32)
    rows = torch.randint(0, P, (B,), generator=gen, device=dev,
                         dtype=torch.int32)
    rows[0], rows[1] = 0, P - 1
    perr = 0.0
    for dtype in (torch.bfloat16, torch.int8, torch.float32):
        pg = kp.to(dtype) if dtype != torch.int8 else codes((H, NP, P, D),
                                                            dtype)
        val = kval.to(dtype) if dtype != torch.int8 else codes((B, H, D),
                                                               dtype)
        got = pg.clone()
        ks.page_write(got, val, pids, rows)
        want = ks.page_write_plain(pg, val, pids, rows)
        torch.cuda.synchronize()
        e = max_err(got, want)
        check(f"page_write {dtype} H{H} NP{NP} P{P} D{D}", e, 0.0)
        perr = max(perr, e)
    pl_ = pids.long()
    rl = rows.long()

    def lib_page():
        kp[:, pl_, rl] = kval.transpose(0, 1)
        vp[:, pl_, rl] = vval.transpose(0, 1)
    pair = [(kp, kval), (vp, vval)]
    pms = time_ms(torch, lambda: ks.page_write_many(pair, pids, rows),
                  iters=50)
    ppms = time_ms(torch, lambda: [ks.page_write_plain(p, v, pids, rows)
                                   for p, v in pair], iters=10)
    plms = time_ms(torch, lib_page, iters=50)
    pbms, pby = bound_ms(2 * 2 * B * H * D * 2 + 2 * B * 4, 0.0)
    say(f"  time page_write one layer (K and V, one launch): "
        f"kernel_ms={pms:.5f} plain_ms={ppms:.4f} "
        f"library_ms(index_put_)={plms:.5f} bound_ms={pbms:.6f} ({pby})")
    page = dict(ms=pms, plain_ms=ppms, library_ms=plms, bound_ms=pbms,
                bound_by=pby, max_abs_err=perr)
    return {"slot_write": slot, "page_write": page}


# the book kernels' checks: Qwen3-0.6B's (K, N) and one N off the GEMM's
# 128-column tiles, GEMV and GEMM rows (m off its 128-row tiles too)
BOOK_SHAPES = ((1024, 2048), (1024, 1024), (1024, 3072), (3072, 1024),
               (384, 200))
BOOK_MS = (1, 5, 8, 17, 32, 33, 128, 129, 512, 4096, 4097)


def book_phase(torch, gen):
    """The learned-codebook GEMV/GEMM against qmatmul_book_plain at
    Qwen3-0.6B's projection shapes: per-tensor (k-means) and per-row (MINI)
    books, NF4 and NF3; times of one layer's 7 k-means NF4 projections."""
    from koifish_tpu_torch.ops.kernels import matmul as km
    from koifish_tpu_torch.quant.cluster import quantize_kmeans, quantize_mini
    say("[kernels] qmv_book / qmm_book (koifish_tpu_torch/csrc/qmatmul.cu, "
        "qmm.cu)")

    def tol(ref):   # the qmatmul phase's: ~1 bf16 ulp of the largest output
        return 1e-2 * float(ref.float().abs().max()) + 1e-3

    def weight(K, N, kind, bits):
        w = torch.randn((K, N), generator=gen, device="cuda") * 0.02
        q = quantize_kmeans if kind == "kmeans" else quantize_mini
        return q(w, bits=bits, group=128)

    def act(m, K):
        return torch.randn((m, K), generator=gen, device="cuda"
                           ).to(torch.bfloat16)

    def run(x, w):
        return km.qmatmul(x, w), km.qmatmul_book_plain(
            x, w.codes, w.scales, w.codebook, w.fmt, w.group)

    errs = {"qmv_book": 0.0, "qmm_book": 0.0}
    for K, N in BOOK_SHAPES:
        for kind in ("kmeans", "mini"):
            for bits in (4, 3):
                w = weight(K, N, kind, bits)
                for m in BOOK_MS:
                    x = act(m, K)
                    y, ref = run(x, w)
                    torch.cuda.synchronize()
                    e = max_err(y, ref)
                    check(f"book {kind} NF{bits} m{m} K{K} N{N}", e, tol(ref))
                    name = "qmv_book" if m <= km.GEMV_MAX_M else "qmm_book"
                    errs[name] = max(errs[name], e)
    out = {}
    for kind, m in (("qmm_book", 4096), ("qmv_book", 32)):
        n_layers = 12
        ws = [[weight(K, N, "kmeans", 4) for _, K, N in QWEN3_PROJ]
              for _ in range(n_layers)]
        xs = {K: act(m, K) for _, K, _n in QWEN3_PROJ}
        deq = [[w.dequantize(torch.bfloat16) for w in layer]
               for layer in ws[:4]]

        def run_kernel():
            for layer in ws:
                for (_, K, _n), w in zip(QWEN3_PROJ, layer):
                    km.qmatmul(xs[K], w)

        def run_plain():
            for (_, K, _n), w in zip(QWEN3_PROJ, ws[0]):
                km.qmatmul_book_plain(xs[K], w.codes, w.scales, w.codebook,
                                      w.fmt, w.group)

        def run_lib():
            for layer in deq:
                for (_, K, _n), wd in zip(QWEN3_PROJ, layer):
                    torch.matmul(xs[K], wd)

        kms = time_ms(torch, run_kernel, iters=5) / n_layers
        pms = time_ms(torch, run_plain, iters=3)
        lms = time_ms(torch, run_lib, iters=5) / len(deq)
        nbytes = sum(m * K * 2 + K * N // 2 + (K // 128) * N * 4 + 16 * 4
                     + m * N * 2 for _, K, N in QWEN3_PROJ)
        flops = sum(2.0 * m * K * N for _, K, N in QWEN3_PROJ)
        bms, by = bound_ms(nbytes, flops)
        say(f"  time {kind} one layer's 7 projections (m={m}, k-means "
            f"NF4): kernel_ms={kms:.4f} plain_ms={pms:.4f} "
            f"library_ms(matmul on dequantized bf16)={lms:.4f} "
            f"bound_ms={bms:.5f} ({by})")
        if m <= km.GEMV_MAX_M:   # the decode wrappers' host cost per call
            from koifish_tpu_torch.quant.rtn import quantize
            w0 = ws[0][0]
            rtn = quantize(w0.dequantize(torch.float32), w0.fmt)
            x0 = xs[w0.shape[0]]
            say(f"  host per eager call (m={m}, K={w0.shape[0]}, "
                f"N={w0.shape[1]}): qmv_book "
                f"{host_us(torch, lambda: km.qmatmul(x0, w0)):.1f} us, "
                f"qmv (NF4 constants) "
                f"{host_us(torch, lambda: km.qmatmul(x0, rtn)):.1f} us")
        out[kind] = dict(ms=kms, plain_ms=pms, library_ms=lms, bound_ms=bms,
                         bound_by=by, max_abs_err=errs[kind])
        del ws, deq
    return out


def _qmv8_variant(torch, x, w, gps, shift_sx=0, drop=None):
    """qmv_int8_plain's arithmetic with a planted fault: each group's codes
    scaled by the sx of group g + shift_sx, or split ``drop``'s partial left
    out of the sum (neither: the plain output)."""
    from koifish_tpu_torch.ops.kernels.quantize import int8_dot, quantize_plain
    m, K = x.shape
    ng = K // 128
    s = w.scales.float()
    qs = [quantize_plain(x[:, g * 128:(g + 1) * 128], 1, "jit")
          for g in range(ng)]
    y = None
    for r, g0 in enumerate(range(0, ng, gps)):
        acc = torch.zeros((m, w.codes.shape[1]), device=x.device)
        for g in range(g0, min(ng, g0 + gps)):
            d = int8_dot(qs[g][0], w.codes[g * 128:(g + 1) * 128]).float()
            t = (d * qs[(g + shift_sx) % ng][1]).double()
            acc = (t * s[g].double() + acc.double()).float()
        if r != drop:
            y = acc if y is None else y + acc
    return y.to(torch.bfloat16)


def qmv_int8_phase(torch, gen):
    """The int8 GEMV (row 5) against qmv_int8_plain at Qwen3-0.6B's seven
    projections at m = 1, 5 and 32 and a ragged shape; times of one layer's
    7 INT8 projections at m = 32, beside the row-4 GEMV on the same INT8
    weights."""
    from koifish_tpu_torch.dtypes import QFormat
    from koifish_tpu_torch.ops.kernels import matmul as km
    from koifish_tpu_torch.ops.kernels import qmv_int8 as kq
    from koifish_tpu_torch.quant.rtn import quantize
    from koifish_tpu_torch.utils import kernel_log
    say("[kernels] qmv_int8 (koifish_tpu_torch/csrc/qmv_int8.cu)")

    def tol(ref):
        # the same int8 codes and exact int32 group sums on both sides, the
        # f32 epilogue in the kernel's order (its K split): only a rare
        # double rounding of the f64-emulated FMA can move a bf16 output
        return 1e-3 * float(ref.float().abs().max())

    def weight(K, N):
        w = torch.randn((K, N), generator=gen, device="cuda") * 0.02
        return quantize(w, QFormat.INT8, group=128)

    def act(m, K):
        return torch.randn((m, K), generator=gen, device="cuda"
                           ).to(torch.bfloat16)

    def plain(x, w):
        gps, _ = kq._plan(x.shape[0], w.shape[0], w.shape[1])
        return kq.qmv_int8_plain(x, w.codes, w.scales, gps=gps)

    err = 0.0
    # the Qwen3 projections and the ragged shape split K across a cluster;
    # K 128 (one group) and N 33792 (256 column tiles) take no split
    shapes = [(n, K, N) for n, K, N in QWEN3_PROJ] + [
        ("ragged", 384, 100), ("one split K128", 128, 1024),
        ("one split N33792", 1024, 33792)]
    for pname, K, N in shapes:
        w = weight(K, N)
        for m in (1, 5, 32):
            if pname.startswith("one split") and kq._plan(m, K, N)[1] != 1:
                fail(f"qmv_int8 {pname} m{m}: the plan splits K "
                     f"({kq._plan(m, K, N)})")
            x = act(m, K)
            y, ref = kq.qmv_int8(x, w.codes, w.scales), plain(x, w)
            y2 = kq.qmv_int8(x, w.codes, w.scales)
            torch.cuda.synchronize()
            e = max_err(y, ref)
            check(f"qmv_int8 {pname} m{m} K{K} N{N}", e, tol(ref))
            # the plan's split order, summed as qmv_int8_plain(gps=...)
            # sums it: every entry equal
            check(f"qmv_int8 {pname} m{m} differing bf16 entries",
                  bits_differ(y, ref), 0.0)
            check(f"qmv_int8 {pname} m{m} repeat launch differing entries",
                  bits_differ(y, y2), 0.0)
            err = max(err, e)
            if pname != "down" or m == 5:
                continue
            # planted faults built from the plain arithmetic, which the
            # check must reject: each group's codes scaled by the next
            # group's sx; the last split's partial dropped
            gps, splits = kq._plan(m, K, N)
            same = _qmv8_variant(torch, x, w, gps)
            check(f"qmv_int8 down m{m} fault arithmetic with no fault "
                  f"planted, differing entries", bits_differ(same, ref), 0.0)
            for fname, fy in (
                    ("sx of the next group", _qmv8_variant(torch, x, w, gps,
                                                           shift_sx=1)),
                    ("last split dropped", _qmv8_variant(
                        torch, x, w, gps, drop=splits - 1))):
                reading = max_err(fy, ref)
                say(f"  fault qmv_int8 down m{m} {fname}: max_abs_err="
                    f"{reading:.3e} tol={tol(ref):.1e} (the check must "
                    f"reject it)")
                if reading <= tol(ref):
                    fail(f"the qmv_int8 check passes the planted fault "
                         f"{fname}")

    # one launch a call: the profiler sees one kernel on the card. A
    # capture that recorded no device activity at all measured nothing
    # (CUPTI missed it once on the card machine); it is taken again, up to
    # three captures, and any capture that sees kernels must see one
    from torch.profiler import ProfilerActivity, profile
    w = weight(3072, 1024)
    for m in (1, 32):
        x = act(m, 3072)
        kq.qmv_int8(x, w.codes, w.scales)
        torch.cuda.synchronize()
        for _ in range(3):
            before = kernel_log.launches().get("qmv_int8", 0)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                kq.qmv_int8(x, w.codes, w.scales)
                torch.cuda.synchronize()
            kern = [(e.key, e.count) for e in prof.key_averages()
                    if str(e.device_type).endswith("CUDA")
                    and getattr(e, "self_device_time_total", 0) > 0]
            n = sum(c for _, c in kern)
            counted = kernel_log.launches().get("qmv_int8", 0) - before
            if n:
                break
            say(f"  the profiler recorded no device activity for qmv_int8 "
                f"m{m}: captured again")
        say(f"  check qmv_int8 m{m} K3072 N1024 launches a call: {n} on the "
            f"card ({', '.join(k[:40] for k, _ in kern)}), {counted} "
            f"counted {'ok' if n == 1 == counted else 'FAIL'}")
        if not n == 1 == counted:
            fail("a qmv_int8 call is not one launch")

    m, n_layers = 32, 12
    ws = [[weight(K, N) for _, K, N in QWEN3_PROJ] for _ in range(n_layers)]
    xs = {K: act(m, K) for _, K, _n in QWEN3_PROJ}
    deq = [[w.dequantize(torch.bfloat16) for w in layer] for layer in ws[:4]]

    def run(fn):
        def go():
            for layer in ws:
                for (_, K, _n), w in zip(QWEN3_PROJ, layer):
                    fn(xs[K], w)
        return go

    def run_plain():
        for (_, K, _n), w in zip(QWEN3_PROJ, ws[0]):
            plain(xs[K], w)

    def run_lib():
        for layer in deq:
            for (_, K, _n), wd in zip(QWEN3_PROJ, layer):
                torch.matmul(xs[K], wd)

    kms = time_ms(torch, run(lambda x, w: kq.qmv_int8(x, w.codes, w.scales)),
                  iters=5) / n_layers
    row4 = time_ms(torch, run(km.qmatmul), iters=5) / n_layers
    pms = time_ms(torch, run_plain, iters=3)
    lms = time_ms(torch, run_lib, iters=5) / len(deq)
    nbytes = sum(m * K * 2 + K * N + (K // 128) * N * 4 + m * N * 2
                 for _, K, N in QWEN3_PROJ)
    ops = sum(2.0 * m * K * N for _, K, N in QWEN3_PROJ)
    bms, by = bound_ms(nbytes, 0.0, ops)
    # chat's shape: m = 1
    xs = {K: act(1, K) for _, K, _n in QWEN3_PROJ}
    kms1 = time_ms(torch, run(lambda x, w: kq.qmv_int8(x, w.codes,
                                                       w.scales)),
                   iters=5) / n_layers
    row4_1 = time_ms(torch, run(km.qmatmul), iters=5) / n_layers
    say(f"  time qmv_int8 one layer's 7 projections (m={m}, INT8): "
        f"kernel_ms={kms:.4f} plain_ms={pms:.4f} "
        f"library_ms(matmul on dequantized bf16)={lms:.4f} "
        f"bound_ms={bms:.5f} ({by}); row-4 GEMV (qmv) on the same INT8 "
        f"weights {row4:.4f} ms; at m=1 {kms1:.4f} ms, row 4 {row4_1:.4f} ms")
    return dict(ms=kms, plain_ms=pms, library_ms=lms, bound_ms=bms,
                bound_by=by, max_abs_err=err, row4_ms=row4, m1_ms=kms1,
                row4_m1_ms=row4_1)


def _reaches(node, name: str, depth: int = 4) -> bool:
    """Whether an autograd node named ``name`` is ``node`` or lies within
    ``depth`` steps below it."""
    if node is None:
        return False
    if name in type(node).__name__:
        return True
    return depth > 0 and any(_reaches(n, name, depth - 1)
                             for n, _ in node.next_functions)


def gama_grad_check(torch, km, name: str, w, x, dy) -> None:
    """``km.qmatmul`` with x, the scales and (for a learned book) the book
    requiring a gradient: the graph goes through ``QMatmul``, whose forward
    launches the kernel (its counter moves), and dx, dscales and dbook
    agree with autograd through the dequantized bf16 weight (the JAX
    package's chain: dW = bf16(xᵀ·dy), then f32 sums) within 1 % of each
    one's largest entry."""
    import dataclasses
    from koifish_tpu_torch.utils import kernel_log
    m = x.shape[0]
    out = {}
    for tag in ("kernel", "plain"):
        xk = x.clone().requires_grad_(True)
        s = w.scales.detach().clone().requires_grad_(True)
        b = (None if w.codebook is None
             else w.codebook.detach().clone().requires_grad_(True))
        wk = dataclasses.replace(w, scales=s, codebook=b)
        if tag == "kernel":
            kernel_log.reset_launches()
            y = km.qmatmul(xk, wk)
            if not _reaches(y.grad_fn, "QMatmul") or \
                    sum(kernel_log.launches().values()) != 1:
                fail(f"gama {name} m{m}: the product did not take one "
                     f"kernel launch and QMatmul ({kernel_log.launches()})")
        else:
            y = torch.matmul(xk, wk.dequantize(torch.bfloat16))
        y.backward(dy)
        out[tag] = (xk.grad, s.grad, None if b is None else b.grad)
    torch.cuda.synchronize()
    for i, part in enumerate(("dx", "dscales", "dbook")):
        got, ref = out["kernel"][i], out["plain"][i]
        if ref is None:
            continue
        check(f"gama {name} m{m} {part}", max_err(got, ref),
              1e-2 * float(ref.float().abs().max()) + 1e-6)


def qmatmul_grad_phase(torch, gen) -> None:
    """The quantized products' gradient on the card: x.grad through a
    kernel-covered QTensor (the GEMM and GEMV shapes; RTN INT4 and INT8,
    k-means NF4 and MINI NF3 books) against the gradient through the
    dequantized bf16 weight; with the scales (and the book) requiring a
    gradient too (gama training), the forward still the kernel's and
    dscales and dbook against autograd through ``QTensor.dequantize``.
    Row 5 with an x that requires a gradient raises. Fails the run
    otherwise."""
    from koifish_tpu_torch.dtypes import QFormat
    from koifish_tpu_torch.ops import matmul as om
    from koifish_tpu_torch.ops.kernels import matmul as km
    from koifish_tpu_torch.ops.kernels import qmv_int8 as kq
    from koifish_tpu_torch.quant.cluster import quantize_kmeans, quantize_mini
    from koifish_tpu_torch.quant.rtn import quantize
    say("[grad] dx through the quantized matmul "
        "(koifish_tpu_torch/ops/kernels/matmul.py::QMatmul)")
    K, N = 1024, 3072
    base = torch.randn((K, N), generator=gen, device="cuda") * 0.02

    def make():
        return {"INT4": quantize(base, QFormat.INT4, group=128),
                "INT8": quantize(base, QFormat.INT8, group=128),
                "k-means NF4": quantize_kmeans(base, bits=4, group=128),
                "MINI NF3": quantize_mini(base, bits=3, group=128)}

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda"
                           ).to(torch.bfloat16)

    for name, w in make().items():
        wd = w.dequantize(torch.bfloat16)
        for m in (32, 4096):
            x, dy = rnd(m, K), rnd(m, N)
            xk = x.clone().requires_grad_(True)
            y = om.qmatmul(xk, w)
            if not _reaches(y.grad_fn, "QMatmul"):
                fail(f"qmatmul {name} m{m}: the product's graph has no "
                     f"QMatmul node ({y.grad_fn})")
            y.backward(dy)
            xr = x.clone().requires_grad_(True)
            torch.matmul(xr, wd).backward(dy)
            torch.cuda.synchronize()
            # both take dy·deq(w)ᵀ in bf16 with f32 accumulation: at most a
            # bf16 ulp of the largest entry apart
            ref = xr.grad
            check(f"grad {name} m{m} dx", max_err(xk.grad, ref),
                  1e-2 * float(ref.float().abs().max()) + 1e-3)
            gama_grad_check(torch, km, name, w, x, dy)

    def raises(label, fn, match):
        try:
            fn()
        except NotImplementedError as e:
            if match not in str(e):
                fail(f"{label}: raised without naming {match!r}: {e}")
            say(f"  check {label}: raises NotImplementedError ok")
            return
        fail(f"{label}: did not raise")

    ws = make()
    x = rnd(64, K).requires_grad_(True)
    ws["INT4"].scales.requires_grad_(True)
    w8, x8 = ws["INT8"], rnd(8, K).requires_grad_(True)
    raises("qmv_int8 with x requiring a gradient",
           lambda: kq.qmv_int8(x8, w8.codes, w8.scales), 'INT8_GEMV = "dot"')
    flavour, om.INT8_GEMV = om.INT8_GEMV, "mxu"
    try:
        raises("ops.matmul under INT8_GEMV = mxu with x requiring a gradient",
               lambda: om.qmatmul(x8, w8), 'INT8_GEMV = "dot"')
    finally:
        om.INT8_GEMV = flavour
    with torch.no_grad():   # without a gradient to carry, no raise
        kq.qmv_int8(x8, w8.codes, w8.scales)
        km.qmatmul(x, ws["INT4"])
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# phase 4: the slice
# ---------------------------------------------------------------------------

def reference_check(torch):
    """A tiny QWEN3 card with INT4 RTN g128 weights: the card's run
    (kernels) against the CPU run of the same weights (plain versions) —
    prefill logits and greedy tokens over an INT8 cache."""
    from koifish_tpu_torch.dtypes import QFormat
    _tiny_serve_check(torch, "tiny QWEN3", {
        "self_attn": {"bits": 4}, "mlp": {"bits": 4}, "group_size": 128},
        QFormat.INT8, 96, 4, 70, 12, seed=3, prompt_seed=5)


KMEANS_RULES = {"self_attn": {"quant_method": "KMEANS", "bits": 4},
                "mlp": {"quant_method": "KMEANS", "bits": 4}}


def _tiny_card():
    from koifish_tpu_torch.config import ModelCard
    return ModelCard.from_arch("QWEN3", vocab_size=256, n_layer=2,
                               n_embd=128, n_head=2, n_kv_head=1,
                               head_dim=64, n_ffn=256, n_ctx=64, max_pos=128)


def _agree(label: str, a, b) -> None:
    agree = float((a == b).float().mean())
    say(f"  {label}: greedy tokens card vs CPU agree on {agree * 100:.1f}%")
    if agree < 0.75:
        fail(f"{label}: greedy tokens of the card and the CPU run diverge")


def _to_card(params):
    """A serving param tree (bf16 leaves and QTensors) copied to the card."""
    return {k: ([{n: w.to("cuda") for n, w in lp.items()} for lp in v]
                if k == "layers" else v.to("cuda"))
            for k, v in params.items()}


def _tiny_serve_check(torch, label: str, rules, kv_fmt, size: int, B: int,
                      P: int, new: int, seed: int = 21,
                      prompt_seed: int = 21) -> None:
    """The tiny QWEN3 card with ``rules`` applied on the CPU, its params
    copied to the card: prefill logits (f32 logits of O(1): bf16
    activations rounded at other points on the two devices, 5e-2) and
    ``generate``'s greedy tokens (75 %) on ``kv_fmt`` caches of ``size``
    slots, card vs CPU; fails if a ring that should wrap did not."""
    from koifish_tpu_torch.config import QuantCard, SamplerCard
    from koifish_tpu_torch.models import init_params
    from koifish_tpu_torch.quant import quantize_params
    from koifish_tpu_torch.serve import cache_for, generate, prefill
    card = _tiny_card()
    p_cpu = quantize_params(init_params(card, device="cpu", seed=seed),
                            QuantCard.from_json(rules), card, device="cpu")
    prompt = torch.randint(0, card.vocab_size, (B, P),
                           generator=torch.Generator().manual_seed(
                               prompt_seed))
    out = {}
    for dev, params in (("cpu", p_cpu), ("cuda", _to_card(p_cpu))):
        c = cache_for(card, B, size, fmt=kv_fmt, layered=True, device=dev)
        logits, _ = prefill(card, params, prompt.to(dev), c, fresh=True,
                            device=dev)
        c = cache_for(card, B, size, fmt=kv_fmt, layered=True, device=dev)
        toks, c = generate(card, params, prompt, c,
                           sampler=SamplerCard(temperature=0.0),
                           max_new_tokens=new, decode_chunk=4, device=dev)
        out[dev] = (logits.float().cpu(), toks.cpu(), int(c.pos[0]))
    check(f"{label} prefill logits, card vs CPU",
          max_err(out["cpu"][0], out["cuda"][0]), 5e-2)
    _agree(label, out["cpu"][1], out["cuda"][1])
    if P + new - 1 > size and not out["cuda"][2] > size:
        fail(f"{label}: the ring did not wrap")


def reference_check_slice3(torch):
    """A tiny QWEN3 card with k-means NF4 weights (quantized on the CPU,
    copied to the card): its card run (book GEMV/GEMM, slot writes, flash,
    decode attention, the paged attention with its page write) against the
    CPU run (plain versions) — prefill logits and ContinuousBatcher greedy
    tokens (INT8 KV, 2 slots, 5 requests); the paged step's logits after a
    prompt feed and generate_paged greedy tokens across a page boundary,
    the card's paged run one paged_attn_write launch a layer a step. The
    thresholds of ``reference_check``."""
    from koifish_tpu_torch.config import QuantCard, SamplerCard
    from koifish_tpu_torch.dtypes import QFormat
    from koifish_tpu_torch.models import init_params
    from koifish_tpu_torch.quant import quantize_params
    from koifish_tpu_torch.serve import (ContinuousBatcher, Request,
                                         cache_for, generate_paged, prefill)
    from koifish_tpu_torch.serve.paged import (decode_step_paged,
                                               init_paged_cache)
    from koifish_tpu_torch.utils import kernel_log
    card = _tiny_card()
    NEW_PAGED = 64      # 70 prompt + 64 positions: across the page at 128
    p_cpu = quantize_params(init_params(card, device="cpu", seed=4),
                            QuantCard.from_json(KMEANS_RULES), card,
                            device="cpu")
    p_gpu = _to_card(p_cpu)
    say(f"  tiny k-means card: {type(p_cpu['layers'][0]['q']).__name__} "
        f"{p_cpu['layers'][0]['q'].fmt.name}, book "
        f"{tuple(p_cpu['layers'][0]['q'].codebook.shape)}")
    g = torch.Generator().manual_seed(6)
    prompt = torch.randint(0, 256, (4, 70), generator=g)
    lens = torch.randint(3, 40, (5,), generator=g).tolist()
    reqs = [torch.randint(0, 256, (n,), generator=g).tolist() for n in lens]
    greedy = SamplerCard(temperature=0.0)
    out = {}
    for dev, params in (("cpu", p_cpu), ("cuda", p_gpu)):
        c = cache_for(card, 4, 96, fmt=QFormat.INT8, layered=True,
                      device=dev)
        logits, _ = prefill(card, params, prompt.to(dev), c, fresh=True,
                            device=dev)
        eng = ContinuousBatcher(card, params, n_slots=2, cache_size=96,
                                kv_fmt=QFormat.INT8, sampler=greedy,
                                decode_chunk=4, device=dev)
        for i, ids in enumerate(reqs):
            eng.submit(Request(rid=i, prompt=ids, max_new=10))
        res = eng.run()
        btoks = torch.tensor([res[i].tokens for i in range(len(reqs))])
        kernel_log.reset_launches()
        pc, alloc = init_paged_cache(card.n_layer, 4, card.n_kv_head,
                                     card.head_dim, max_pages=4, device=dev)
        pc = alloc.ensure(pc, 20)
        for t in range(20):
            plog, pc = decode_step_paged(card, params, prompt[:, t].to(dev),
                                         pc)
        ptoks = generate_paged(card, params, prompt, sampler=greedy,
                               max_new_tokens=NEW_PAGED, decode_chunk=8,
                               max_pages=4, device=dev)
        out[dev] = (logits.cpu(), btoks, plog.float().cpu(), ptoks.cpu())
        counts = kernel_log.launches()
        if dev == "cuda" and (counts.get("page_write", 0)
                              or counts.get("paged_attn_write", 0)
                              != card.n_layer * (20 + prompt.shape[1]
                                                 + NEW_PAGED - 1)):
            fail(f"tiny paged run on the card: {json.dumps(counts)}, not "
                 f"one paged_attn_write a layer a step")
    check("tiny k-means QWEN3 prefill logits, card vs CPU",
          max_err(out["cpu"][0], out["cuda"][0]), 5e-2)
    _agree("ContinuousBatcher (k-means, INT8 KV)", out["cpu"][1],
           out["cuda"][1])
    check("tiny k-means QWEN3 paged-step logits, card vs CPU",
          max_err(out["cpu"][2], out["cuda"][2]), 5e-2)
    _agree("generate_paged (k-means, across a page boundary)", out["cpu"][3],
           out["cuda"][3])


def fused_write_check(counts, run: str) -> None:
    """On an INT8 cache every decode attention launch also wrote the new
    token's K/V (one launch a layer), and no standalone slot write ran."""
    n, w = counts.get("decode_attn", 0), counts.get("kv_write", 0)
    say(f"  {run}: {n} decode attention launches, {w} with the K/V write, "
        f"{counts.get('slot_write', 0)} standalone slot writes")
    if w != n or counts.get("slot_write", 0):
        fail(f"{run}: the decode step wrote its K/V outside the decode "
             f"attention's launch")


def profile_window(torch, label: str, fn, steps: int = 1) -> None:
    """Where ``fn``'s time goes: torch.profiler over one warm call — device
    time by kernel and the device's idle share of the wall time, per step
    of the ``steps`` that ``fn`` runs."""
    from torch.profiler import ProfilerActivity, profile
    fn()                              # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [(e.key, e.self_device_time_total, e.count)
           for e in prof.key_averages()
           if getattr(e, "self_device_time_total", 0) > 0
           and str(e.device_type).endswith("CUDA")]
    busy_us = sum(t for _, t, _ in dev)
    say(f"[profile] {label}: wall {wall * 1e3 / steps:.3f} ms/step "
        f"(under the profiler); {sum(n for _, _, n in dev) / steps:.1f} "
        f"device launches (kernels and copies) a step")
    if busy_us <= 0:
        say("  device time: not measured (the profiler saw no CUDA time)")
        return
    say(f"  device busy {busy_us / 1e3 / steps:.3f} ms/step, idle share "
        f"{1 - busy_us / 1e6 / wall:.3f}")
    for key, t, n in sorted(dev, key=lambda r: -r[1])[:10]:
        say(f"  {t / 1e3 / steps:8.4f} ms/step  {n / steps:7.1f} launches/step"
            f"  {key[:90]}")


def profile_slice(torch, card, qp, prompts, lc, tok, sampler,
                  steps: int = 16) -> None:
    """Profile a fresh prefill of ``prompts`` and one decode chunk of
    ``steps`` decode+sample steps (what ``generate`` runs per chunk)."""
    from koifish_tpu_torch.ops.sampling import sample_logits
    from koifish_tpu_torch.serve import decode_step_layered, prefill
    from koifish_tpu_torch.serve.kvcache import cache_for
    from koifish_tpu_torch.dtypes import QFormat
    pc = cache_for(card, prompts.shape[0], lc.size, fmt=QFormat.INT8,
                   layered=True)
    profile_window(torch, f"fresh prefill B={prompts.shape[0]} "
                   f"P={prompts.shape[1]}",
                   lambda: prefill(card, qp, prompts, pc, fresh=True))
    del pc
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)

    def chunk():
        c, t = lc, tok
        for _ in range(steps):
            logits, c = decode_step_layered(card, qp, t, c, streaming=False)
            t = sample_logits(gen, logits, sampler.temperature,
                              sampler.top_k, sampler.top_p)

    profile_window(torch, f"decode chunk of {steps} steps "
                   f"(B={tok.shape[0]})", chunk, steps)


def slice_phase(torch):
    from koifish_tpu_torch.config import SamplerCard
    from koifish_tpu_torch.dtypes import QFormat
    from koifish_tpu_torch.models import init_params
    from koifish_tpu_torch.quant import quantize_params
    from koifish_tpu_torch.serve import (cache_for, decode_step_layered,
                                         generate, prefill)
    from koifish_tpu_torch.utils import kernel_log
    say("[slice] Qwen3-0.6B INT4 RTN g128 weights + INT8 KV")
    p = load_config("qwen3_0.6b.json")
    card = p.model
    say(f"  card: L={card.n_layer} E={card.n_embd} Hq={card.n_head} "
        f"Hkv={card.n_kv_head} D={card.head_dim} F={card.n_ffn} "
        f"V={card.vocab_size} tie={card.tie_embeddings}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(p.seed)
    t0 = time.perf_counter()
    params = init_params(card, gen)
    qp = quantize_params(params, p.quant, card)
    del params
    torch.cuda.synchronize()
    say(f"  init + quantize: {time.perf_counter() - t0:.2f} s; "
        f"{type(qp['layers'][0]['q']).__name__} "
        f"{qp['layers'][0]['q'].fmt.name} projections")
    B, S, P, NEW = 32, 1024, 128, 64
    sampler = SamplerCard(temperature=0.6, top_k=50, top_p=0.95)
    prompts = torch.randint(0, card.vocab_size, (B, P), generator=gen,
                            device="cuda", dtype=torch.int64)

    def fresh(b=B):
        c = cache_for(card, b, S, fmt=QFormat.INT8, layered=True)
        torch.cuda.synchronize()
        return c

    # warm every path once (first launches load the kernels)
    generate(card, qp, prompts, fresh(), sampler=sampler, max_new_tokens=17,
             decode_chunk=16)
    torch.cuda.synchronize()

    # REPS rounds of (TTFT call, full call): the decode loop is host-bound
    # and its time spreads from run to run, so report each and the median
    REPS = 3
    kernel_log.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    ttfts, steps = [], []
    for _ in range(REPS):
        c = fresh()
        t0 = time.perf_counter()
        generate(card, qp, prompts, c, sampler=sampler, max_new_tokens=1)
        torch.cuda.synchronize()
        ttfts.append(time.perf_counter() - t0)
        c = fresh()
        t0 = time.perf_counter()
        toks, c = generate(card, qp, prompts, c, sampler=sampler,
                           max_new_tokens=NEW, decode_chunk=16)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0 - ttfts[-1]) / (NEW - 1))
    greedy, _ = generate(card, qp, prompts[:1], fresh(1),
                         sampler=SamplerCard(temperature=0.0),
                         max_new_tokens=32, decode_chunk=16)
    torch.cuda.synchronize()
    counts = kernel_log.launches()
    peak = torch.cuda.max_memory_allocated()

    ttft, step = sorted(ttfts)[REPS // 2], sorted(steps)[REPS // 2]
    say(f"  warm TTFT (B={B}, P={P}, prefill + first sample): median "
        f"{ttft * 1e3:.2f} ms; runs "
        f"{[round(t * 1e3, 2) for t in ttfts]}")
    say(f"  decode: median {step * 1e3:.3f} ms/step, {B / step:.1f} tok/s "
        f"(B={B}, chunk 16, {NEW - 1} steps); runs "
        f"{[round(B / s, 1) for s in steps]} tok/s")
    say(f"  peak device memory: {peak / 2**30:.2f} GiB")
    say(f"  launches in the main path ({REPS} x (TTFT call + {NEW}-token "
        f"call) at B={B}, then one greedy B=1 call): {json.dumps(counts)}")
    for name in ("flash_fwd", "qmm", "qmv", "decode_attn", "kv_write"):
        if counts.get(name, 0) <= 0:
            fail(f"kernel {name} was not launched on the main path")
    fused_write_check(counts, "the serving run")
    if tuple(toks.shape) != (B, NEW) or tuple(greedy.shape) != (1, 32):
        fail(f"generate returned {tuple(toks.shape)} / "
             f"{tuple(greedy.shape)}")
    if int(toks.min()) < 0 or int(toks.max()) >= card.vocab_size:
        fail("generated token ids out of the vocabulary")
    if int(c.pos[0]) != P + NEW - 1:
        fail(f"cache position {int(c.pos[0])} != {P + NEW - 1}")
    # finite logits from a prefill and one decode step at full width
    c = fresh()
    logits, c = prefill(card, qp, prompts, c, fresh=True)
    dlogits, _ = decode_step_layered(card, qp, toks[:, 0].to(torch.int32), c,
                                     streaming=False)
    if not (bool(torch.isfinite(logits).all())
            and bool(torch.isfinite(dlogits).all())):
        fail("non-finite logits")
    say(f"  logits finite: prefill {tuple(logits.shape)}, decode "
        f"{tuple(dlogits.shape)}")
    profile_slice(torch, card, qp, prompts, c, toks[:, 0].to(torch.int32),
                  sampler)
    reference_check(torch)
    return counts


def batcher_requests(torch, card, n: int, seed: int) -> list:
    """``n`` requests of seeded prompts (16-512 tokens) and lengths (16-128
    new tokens), no eos."""
    from koifish_tpu_torch.serve import Request
    g = torch.Generator().manual_seed(seed)
    lens = torch.randint(16, 513, (n,), generator=g).tolist()
    news = torch.randint(16, 129, (n,), generator=g).tolist()
    return [Request(rid=i, prompt=torch.randint(
        0, card.vocab_size, (k,), generator=g).tolist(), max_new=m, eos_id=-1)
        for i, (k, m) in enumerate(zip(lens, news))]


def batcher_phase(torch):
    """Slice 3 at full width: Qwen3-0.6B with k-means NF4 weights behind a
    ContinuousBatcher (INT8 KV, 32 slots of 1024, decode_chunk 8) serving
    96 requests of seeded lengths. Returns (kernel launches, the quantized
    params and card for the paged phase)."""
    from koifish_tpu_torch.config import QuantCard, SamplerCard
    from koifish_tpu_torch.dtypes import QFormat
    from koifish_tpu_torch.models import init_params
    from koifish_tpu_torch.quant import quantize_params
    from koifish_tpu_torch.serve import ContinuousBatcher, Request
    from koifish_tpu_torch.utils import kernel_log
    N_REQ, SLOTS, S, CHUNK = 96, 32, 1024, 8
    say(f"[batcher] Qwen3-0.6B k-means NF4 weights + INT8 KV: "
        f"ContinuousBatcher({SLOTS} slots, S={S}, decode_chunk={CHUNK}), "
        f"{N_REQ} requests")
    p = load_config("qwen3_0.6b.json")
    card = p.model
    gen = torch.Generator(device="cuda")
    gen.manual_seed(p.seed)
    t0 = time.perf_counter()
    params = init_params(card, gen)
    qp = quantize_params(params, QuantCard.from_json(KMEANS_RULES), card)
    del params
    torch.cuda.synchronize()
    w = qp["layers"][0]["q"]
    say(f"  init + k-means quantize: {time.perf_counter() - t0:.2f} s; "
        f"{w.fmt.name} codes, book {tuple(w.codebook.shape)} per tensor")
    reqs = batcher_requests(torch, card, N_REQ, p.seed)
    lens = [len(r.prompt) for r in reqs]
    sampler = SamplerCard(temperature=0.6, top_k=50, top_p=0.95)
    eng = ContinuousBatcher(card, qp, n_slots=SLOTS, cache_size=S,
                            kv_fmt=QFormat.INT8, sampler=sampler,
                            decode_chunk=CHUNK)
    for r in reqs:
        eng.submit(r)
    t0 = time.perf_counter()
    eng.warmup()
    torch.cuda.synchronize()
    say(f"  warmup (a prefill of each bucket 16..512, one decode chunk): "
        f"{time.perf_counter() - t0:.2f} s")
    # count the decode dispatches (each runs CHUNK steps over all slots)
    dispatches = [0]
    decode = eng._decode

    def counted(*args):
        dispatches[0] += 1
        return decode(*args)
    eng._decode = counted
    kernel_log.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernel_log.launches()
    peak = torch.cuda.max_memory_allocated()
    eng._decode = decode
    done = [results[r.rid] for r in reqs if r.rid in results]
    ttfts = sorted(r.ttft_s for r in done)
    pct = lambda q: ttfts[min(len(ttfts) - 1, int(q * len(ttfts)))]
    say(f"  completed {len(done)} of {N_REQ} requests in {wall:.2f} s; "
        f"{sum(lens)} prompt tokens, {eng.decoded_tokens} decoded tokens")
    steps = dispatches[0] * CHUNK
    say(f"  aggregate decode: {eng.aggregate_tokens_per_sec:.1f} tok/s over "
        f"{eng.decode_wall_s:.2f} s of decode dispatches; {steps} decode "
        f"steps, {eng.decode_wall_s / steps * 1e3:.3f} ms/step, lanes busy "
        f"{eng.decoded_tokens / (steps * SLOTS):.3f} of the slot-steps")
    say(f"  warm TTFT (one request's bucketed prefill + first sample): p50 "
        f"{pct(0.5) * 1e3:.2f} ms, p90 {pct(0.9) * 1e3:.2f} ms; cold: "
        f"{sum(r.ttft_cold for r in done)}")
    say(f"  peak device memory: {peak / 2**30:.2f} GiB")
    say(f"  launches in the batcher run: {json.dumps(counts)}")
    if len(done) != N_REQ:
        fail(f"{N_REQ - len(done)} requests did not complete")
    for r in done:
        if len(r.tokens) != r.max_new:
            fail(f"request {r.rid}: {len(r.tokens)} tokens, max_new "
                 f"{r.max_new}")
        if min(r.tokens) < 0 or max(r.tokens) >= card.vocab_size:
            fail(f"request {r.rid}: token ids out of the vocabulary")
    for name in ("qmv_book", "qmm_book", "kv_write", "flash_fwd",
                 "decode_attn"):
        if counts.get(name, 0) <= 0:
            fail(f"kernel {name} was not launched by the batcher run")
    fused_write_check(counts, "the batcher run")
    # one decode chunk of the host loop with every slot busy
    for i in range(SLOTS):
        eng.submit(Request(rid=1000 + i, prompt=reqs[i].prompt[:128],
                           max_new=4 * CHUNK))
    eng._admit()
    profile_window(torch, f"batcher decode chunk ({CHUNK} steps, "
                   f"{SLOTS} busy slots)", eng.step, CHUNK)
    return counts, card, qp


def paged_phase(torch, card, qp):
    """generate_paged on the batcher's params: B=32 prompts of 128 tokens
    fed through the paged step, 64 new tokens, decode_chunk 8. Fails unless
    every layer of every step made one paged_attn_write launch (the page
    write and the attention in one), with no standalone page write and no
    gather of the pages; then profiles one paged decode chunk."""
    import dataclasses
    from koifish_tpu_torch.config import SamplerCard
    from koifish_tpu_torch.ops.kernels import paged_attn as kpa
    from koifish_tpu_torch.ops.sampling import sample_logits
    from koifish_tpu_torch.serve import generate_paged
    from koifish_tpu_torch.serve.paged import (PAGE, decode_step_paged,
                                               init_paged_cache)
    from koifish_tpu_torch.utils import kernel_log
    B, T, NEW = 32, 128, 64
    say(f"[paged] generate_paged: B={B}, {T}-token prompts, {NEW} new, "
        f"decode_chunk 8, page {PAGE}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    prompts = torch.randint(0, card.vocab_size, (B, T), generator=gen,
                            device="cuda")
    sampler = SamplerCard(temperature=0.6, top_k=50, top_p=0.95)
    gathers = [0]
    gather = kpa.gather_pages

    def counted(*args):
        gathers[0] += 1
        return gather(*args)
    kpa.gather_pages = counted
    try:
        kernel_log.reset_launches()
        t0 = time.perf_counter()
        toks, cache = generate_paged(card, qp, prompts, sampler=sampler,
                                     max_new_tokens=NEW, decode_chunk=8,
                                     max_pages=4, return_cache=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernel_log.launches()
    finally:
        kpa.gather_pages = gather
    steps = T + NEW - 1
    say(f"  {wall:.2f} s for {steps} paged steps at B={B}: "
        f"{B * steps / wall:.1f} tok/s through the paged step "
        f"({B * NEW / wall:.1f} generated tok/s, prompt feed included)")
    kv_bytes = (2 * card.n_layer * cache.n_pages * PAGE * card.n_kv_head
                * card.head_dim * 2)
    say(f"  page pool: {B} -> {cache.n_pages} pages of {PAGE} positions "
        f"({kv_bytes / 2**20:.0f} MiB of bf16 K+V over {card.n_layer} "
        f"layers)")
    say(f"  launches in the paged run: {json.dumps(counts)}")
    if tuple(toks.shape) != (B, NEW):
        fail(f"generate_paged returned {tuple(toks.shape)}")
    if int(toks.min()) < 0 or int(toks.max()) >= card.vocab_size:
        fail("paged token ids out of the vocabulary")
    n, want = counts.get("paged_attn_write", 0), card.n_layer * steps
    say(f"  {n} paged_attn_write launches ({card.n_layer} layers x {steps} "
        f"steps = {want}), {counts.get('page_write', 0)} standalone page "
        f"writes, {gathers[0]} gathers of the pages")
    if n != want or counts.get("paged_attn", 0) != n:
        fail(f"generate_paged made {n} paged_attn_write launches, not one a "
             f"layer a step ({want})")
    if counts.get("page_write", 0) or gathers[0]:
        fail("the paged decode path wrote its pages outside the paged "
             "attention's launch or gathered them")
    # one decode chunk (8 decode + sample steps) from position T, all lanes
    pc, alloc = init_paged_cache(card.n_layer, B, card.n_kv_head,
                                 card.head_dim, max_pages=4)
    pc = dataclasses.replace(alloc.ensure(pc, T + 9),
                             pos=torch.full_like(pc.pos, T))
    gen.manual_seed(12)

    def chunk():
        c, t = pc, toks[:, -1]
        for _ in range(8):
            logits, c = decode_step_paged(card, qp, t, c)
            t = sample_logits(gen, logits, sampler.temperature,
                              sampler.top_k, sampler.top_p)
    profile_window(torch, f"paged decode chunk (8 steps, B={B})", chunk, 8)
    return counts


# ---------------------------------------------------------------------------
# phase 4b: the chat entry point (slice 5)
# ---------------------------------------------------------------------------

SPECIALS = ("<|endoftext|>", "<|im_start|>", "<|im_end|>")
CHAT_PROMPTS = [
    "Write a short story about a lighthouse keeper who finds a message in "
    "a bottle.",
    "Explain in plain words why the sky is blue during the day and red at "
    "sunset.",
    "List five things to pack for a week of hiking in the mountains in "
    "autumn.",
]


#: the byte-level tokenizer's merges, in rank order, after the 256 bytes
BYTE_MERGES = ((b"h", b"e"), (b"l", b"l"), (b"he", b"ll"), (b"hell", b"o"),
               (b" ", b"w"))


def qwen3_hf_tensors(torch, card, seed: int) -> dict:
    """HF-named bf16 CPU tensors of a Qwen3 model at ``card``'s dims, as the
    JAX package's tests make them: seeded normal(0.02) weights drawn on the
    card, norms 1."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    E, D, F = card.n_embd, card.head_dim, card.n_ffn

    def w(*shape):
        return (torch.randn(shape, generator=gen, device="cuda") * 0.02
                ).to(torch.bfloat16).cpu()

    def ones(n):
        return torch.ones((n,), dtype=torch.bfloat16)

    ts = {"model.embed_tokens.weight": w(card.vocab_size, E),
          "model.norm.weight": ones(E)}
    for i in range(card.n_layer):
        pre = f"model.layers.{i}."
        ts.update({
            pre + "input_layernorm.weight": ones(E),
            pre + "self_attn.q_proj.weight": w(card.n_head * D, E),
            pre + "self_attn.k_proj.weight": w(card.n_kv_head * D, E),
            pre + "self_attn.v_proj.weight": w(card.n_kv_head * D, E),
            pre + "self_attn.o_proj.weight": w(E, card.n_head * D),
            pre + "self_attn.q_norm.weight": ones(D),
            pre + "self_attn.k_norm.weight": ones(D),
            pre + "post_attention_layernorm.weight": ones(E),
            pre + "mlp.gate_proj.weight": w(F, E),
            pre + "mlp.up_proj.weight": w(F, E),
            pre + "mlp.down_proj.weight": w(E, F)})
    return ts


def write_hf_dir(torch, path: str, card, seed: int) -> float:
    """A HF Qwen3 folder at ``card``'s dims: ``qwen3_hf_tensors`` written by
    the port's safetensors writer, its ``config.json`` keys and a byte-level
    ``tokenizer.json`` (the 256 bytes, ``BYTE_MERGES`` and the three chat
    specials). Returns the GB written."""
    from koifish_tpu_torch.io.safetensors import write_safetensors
    os.makedirs(path, exist_ok=True)
    ts = qwen3_hf_tensors(torch, card, seed)
    write_safetensors(os.path.join(path, "model.safetensors"), ts)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({
            "model_type": "qwen3", "vocab_size": card.vocab_size,
            "num_hidden_layers": card.n_layer, "hidden_size": card.n_embd,
            "num_attention_heads": card.n_head,
            "num_key_value_heads": card.n_kv_head, "head_dim": card.head_dim,
            "intermediate_size": card.n_ffn, "rope_theta": 1e6,
            "rms_norm_eps": 1e-6, "tie_word_embeddings": True,
            "max_position_embeddings": card.max_pos}, f)
    write_tokenizer_json(path)
    return sum(t.numel() * t.element_size() for t in ts.values()) / 1e9


def _chat(torch, argv, label, n_turns=len(CHAT_PROMPTS)):
    """One ``bubble.main`` run of ``n_turns`` turns, its kernel launches and
    fallbacks counted from 0; returns (turn records, launches)."""
    from koifish_tpu_torch.cli import bubble
    from koifish_tpu_torch.utils import kernel_log
    turns = []
    torch.cuda.synchronize()
    kernel_log.reset_launches()
    t0 = time.perf_counter()
    rc = bubble.main(argv, turns=turns)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, falls = kernel_log.launches(), kernel_log.fallbacks()
    say(f"  {label}: rc={rc}, {wall:.2f} s for {len(turns)} turns; "
        f"launches {json.dumps(counts)}; fallbacks {json.dumps(falls)}")
    if rc != 0 or len(turns) != n_turns:
        fail(f"{label}: bubble returned {rc} after {len(turns)} turns")
    for t in turns:
        say(f"    turn: {len(t['prompt_ids'])} prompt tokens, "
            f"{len(t['tokens'])} new, {t['tk_s']:.2f} tk/s"
            + (f", rounds {t['stats']['rounds']}, accept_rate "
               f"{t['stats']['accept_rate']:.3f}" if t["stats"] else ""))
    if falls.get("qmatmul", 0):
        fail(f"{label}: a qmatmul fallback was logged")
    return turns, counts


def _agreement(a, b) -> float:
    """Share of ``a``'s positions where ``b`` has the same token."""
    return sum(x == y for x, y in zip(a, b)) / max(len(a), 1)


def int8_decode_ab(torch, card, qp) -> None:
    """``generate`` at B = 32 x 128-token prompts, 64 new tokens, on the
    INT8 params with an INT8 KV cache, under the "mxu" (row 5) and "dot"
    (row 4) INT8 GEMV flavours in turns (mxu, dot, dot, mxu)."""
    from koifish_tpu_torch.config import SamplerCard
    from koifish_tpu_torch.dtypes import QFormat
    from koifish_tpu_torch.ops import matmul as tmm
    from koifish_tpu_torch.serve import cache_for, generate
    B, P, NEW, S = 32, 128, 64, 1024
    gen = torch.Generator(device="cuda")
    gen.manual_seed(21)
    prompts = torch.randint(0, card.vocab_size, (B, P), generator=gen,
                            device="cuda")
    sampler = SamplerCard(temperature=0.6, top_k=50, top_p=0.95)

    def run(max_new):
        c = cache_for(card, B, S, fmt=QFormat.INT8, layered=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generate(card, qp, prompts, c, sampler=sampler, max_new_tokens=max_new,
                 decode_chunk=16)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    res = {"mxu": [], "dot": []}
    for flavour in ("mxu", "dot", "dot", "mxu"):
        tmm.INT8_GEMV = flavour
        run(17)                                   # warm
        ttft, full = run(1), run(NEW)
        res[flavour].append((full - ttft) / (NEW - 1))
    tmm.INT8_GEMV = "dot"
    for flavour, steps in res.items():
        say(f"  INT8 decode A/B, {flavour!r} flavour (B={B}, P={P}, {NEW} new,"
            f" chunk 16): ms/step {[round(s * 1e3, 3) for s in steps]}, "
            f"tok/s {[round(B / s, 1) for s in steps]}")


def profile_chat_turn(torch, card, qp, prompt_len: int) -> None:
    """Where a chat turn's time goes: a B = 1 greedy ``generate`` of 17
    tokens (prefill + 16 decode steps, decode_chunk 8, stacked decode
    params) on the INT8 params with an INT8 KV cache and the "mxu" GEMV,
    as ``bubble`` runs a turn."""
    from koifish_tpu_torch.config import SamplerCard
    from koifish_tpu_torch.dtypes import QFormat
    from koifish_tpu_torch.ops import matmul as tmm
    from koifish_tpu_torch.serve import cache_for, generate, stack_layers
    gen = torch.Generator(device="cuda")
    gen.manual_seed(22)
    prompt = torch.randint(0, card.vocab_size, (1, prompt_len), generator=gen,
                           device="cuda")
    dparams = stack_layers(qp)

    def turn():
        c = cache_for(card, 1, 1024, fmt=QFormat.INT8)
        generate(card, qp, prompt, c, SamplerCard(temperature=0.0),
                 max_new_tokens=17, decode_params=dparams, decode_chunk=8)

    tmm.INT8_GEMV = "mxu"
    profile_window(torch, f"chat turn B=1 (prefill {prompt_len} + 16 decode "
                   f"steps, INT8 + INT8 KV, 'mxu'), per generated token",
                   turn, 17)
    tmm.INT8_GEMV = "dot"


def reference_check_bubble(torch) -> None:
    """A tiny Qwen3 folder through ``bubble.main`` (INT8 weights, INT8 KV,
    greedy, "mxu") on the card against the CPU run of the same folder."""
    import dataclasses
    import shutil
    from koifish_tpu_torch.cli import bubble
    from koifish_tpu_torch.ops import matmul as tmm
    path = os.path.join(ROOT, "build", "bubble_tiny")
    # the byte-level tokenizer's ids reach 263; chat prompts ~130 tokens
    write_hf_dir(torch, path, dataclasses.replace(
        _tiny_card(), vocab_size=300, max_pos=512), seed=8)
    tmm.INT8_GEMV = "mxu"
    out = {}
    for dev in ("cpu", "cuda"):
        turns = []
        bubble.main(["--hf", path, "--prompts", CHAT_PROMPTS[0], "--bits", "8",
                     "--kv-bits", "8", "--max-new", "24", "--temperature",
                     "0", "--ctx", "256", "--csv", "", "--device", dev],
                    turns=turns)
        out[dev] = turns[0]["tokens"]
    tmm.INT8_GEMV = "dot"
    shutil.rmtree(path)
    agree = _agreement(out["cpu"], out["cuda"])
    say(f"  tiny bubble (INT8, INT8 KV, greedy): card vs CPU tokens agree on "
        f"{agree * 100:.1f}%")
    if agree < 0.75:
        fail("tiny bubble: greedy tokens of the card and the CPU run diverge")


def bubble_phase(torch):
    """Slice 5 at full width: a Qwen3-0.6B HF folder (configs/qwen3_0.6b.json
    dims, seeded bf16 weights) served through ``bubble.main`` with INT8
    weights at load, an INT8 KV cache and the "mxu" INT8 GEMV (row 5), plain
    and with a bf16 self-draft (k = 4); then a profiled chat turn, the
    "mxu"/"dot" decode A/B at B = 32 and a tiny folder card vs CPU. Returns
    the plain run's launches."""
    import shutil
    from koifish_tpu_torch.config import CLIParams, QuantCard
    from koifish_tpu_torch.io.hf_loader import load_hf_model
    from koifish_tpu_torch.ops import matmul as tmm
    from koifish_tpu_torch.quant import quantize_params
    card = CLIParams.load(os.path.join(ROOT, "configs", "qwen3_0.6b.json")
                          ).model     # its 28 layers (see DEPTH)
    path = os.path.join(ROOT, "build", "bubble_qwen3")
    say(f"[bubble] Qwen3-0.6B HF folder (L={card.n_layer} E={card.n_embd} "
        f"Hq={card.n_head} Hkv={card.n_kv_head} D={card.head_dim} "
        f"F={card.n_ffn} V={card.vocab_size}), --bits 8 --kv-bits 8, "
        f"INT8 GEMV 'mxu'")
    t0 = time.perf_counter()
    gb = write_hf_dir(torch, path, card, seed=5)
    say(f"  wrote {gb:.2f} GB of bf16 weights in "
        f"{time.perf_counter() - t0:.1f} s")
    base = ["--hf", path, "--prompts", *CHAT_PROMPTS, "--bits", "8",
            "--kv-bits", "8", "--max-new", "64", "--temperature", "0",
            "--csv", os.path.join(ROOT, "build", "bubble_chat.csv")]
    tmm.INT8_GEMV = "mxu"
    torch.cuda.reset_peak_memory_stats()
    plain, counts = _chat(torch, base, "bubble plain")
    spec, spec_counts = _chat(torch, base + ["--draft-hf", path],
                              "bubble --draft-hf (bf16 self-draft, k=4)")
    tmm.INT8_GEMV = "dot"
    say(f"  peak device memory: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for name in ("qmv_int8", "flash_fwd", "qmm", "decode_attn"):
        if counts.get(name, 0) <= 0:
            fail(f"kernel {name} was not launched by the plain bubble run")
    if spec_counts.get("qmv_int8", 0) <= 0:
        fail("kernel qmv_int8 was not launched by the speculative run")
    for a, b in zip(plain, spec):
        if len(a["prompt_ids"]) <= 32:
            fail(f"a prompt of {len(a['prompt_ids'])} tokens does not reach "
                 f"the GEMM shape")
        ids = a["tokens"] + b["tokens"]
        if min(ids) < 0 or max(ids) >= card.vocab_size:
            fail("bubble token ids out of the vocabulary")
        agree = _agreement(a["tokens"], b["tokens"])
        say(f"  plain tokens   {a['tokens']}\n  speculative    {b['tokens']}\n"
            f"  greedy agreement speculative vs plain: {agree * 100:.1f}%")
        if agree < 0.75:
            fail("speculative greedy tokens disagree with plain greedy")

    # the INT8 params bubble serves, for the B=32 decode A/B
    card, params = load_hf_model(path)
    qp = quantize_params(params, QuantCard.from_json(
        {"self_attn": {"bits": 8}, "mlp": {"bits": 8}}), card)
    del params
    shutil.rmtree(path)
    profile_chat_turn(torch, card, qp, len(plain[0]["prompt_ids"]))
    int8_decode_ab(torch, card, qp)
    del qp
    torch.cuda.empty_cache()
    reference_check_bubble(torch)
    return counts


# ---------------------------------------------------------------------------
# phase 5: training
# ---------------------------------------------------------------------------

def _step_card_vs_cpu(torch, label, card, tcard, vocab, tol_loss, tol_norm,
                      tol_head, qcard=None, seed=7, sp=1, zero_grad=()):
    """One ``make_train_step`` of ``card`` on the card (kernels) against the
    same step on the CPU (plain versions), SR off: the loss, every
    gradient's norm (the tied head's ``wte`` within ``tol_head``) and the
    updated parameters. ``sp`` > 1: sequence-parallel, an ``SPPolicy``
    over ``sp`` virtual ranks of the step's device. ``zero_grad``: names of
    leaves whose gradient is 0 in exact arithmetic (k's bias: it shifts a
    softmax row), so that its norm is rounding noise on both devices: held
    under 1e-4 of the largest gradient norm instead of to the relative
    gate."""
    from koifish_tpu_torch.models import init_params
    from koifish_tpu_torch.train import init_train_state, make_train_step
    from koifish_tpu_torch.utils.tree import (flatten_with_path, leaves,
                                              tree_map)
    base = init_params(card, device="cpu", seed=seed)
    tokens = torch.randint(0, vocab, (1, 4, 65),
                           generator=torch.Generator().manual_seed(seed + 1))
    res = {}
    for dev in ("cpu", "cuda"):
        # a fresh copy per device: the step updates its params in place
        params = tree_map(lambda t: t.to(dev, copy=True), base)
        state = init_train_state(card, tcard, params=params)
        policy = None
        if sp > 1:
            from koifish_tpu_torch.ops.tracectx import SPPolicy
            from koifish_tpu_torch.parallel import make_mesh
            policy = SPPolicy("sp", make_mesh({"sp": sp}, devices=dev))
        step = make_train_step(card, tcard, total_steps=10, qcard=qcard,
                               sp=policy)
        state, metrics = step(state, {"tokens": tokens.to(dev)})
        res[dev] = (float(metrics["loss"]), metrics["leaf_norms"].cpu(),
                    [p.detach().float().cpu()
                     for p in leaves(state.params)])
    check(f"{label} loss, card vs CPU",
          abs(res["cpu"][0] - res["cuda"][0]), tol_loss)
    n_cpu, n_gpu = res["cpu"][1], res["cuda"][1]
    rel = (n_gpu - n_cpu).abs() / n_cpu.clamp_min(1e-6)
    zero = [i for i, (p, _) in enumerate(flatten_with_path(base))
            if p[-1] in zero_grad]
    if zero:
        noise = float(torch.maximum(n_cpu[zero], n_gpu[zero]).max()
                      / n_cpu.max())
        check(f"{label} grad norms of {', '.join(zero_grad)} (0 in exact "
              f"arithmetic) over the largest", noise, 1e-4)
        rel[zero] = 0.0
    worst = int(rel.argmax())
    say(f"  worst grad norm: {flatten_with_path(base)[worst][0]} "
        f"(CPU norm {float(n_cpu[worst]):.3e})")
    check(f"{label} grad norms, card vs CPU (relative)", float(rel.max()),
          tol_norm)
    # the tied head's gradient (the fused CE's dw plus the embedding's) is
    # not zero in exact arithmetic, unlike the worst leaf's above: its norm
    # is held to a tighter limit
    head = [p for p, _ in flatten_with_path(base)].index(("wte",))
    check(f"{label} wte grad norm, card vs CPU (relative)",
          float(rel[head]), tol_head)
    # updated params: AdamW's first step moves each weight by about lr times
    # the sign of its gradient, so a gradient entry near 0 may move the
    # weight either way on the two devices (2·lr), plus one bf16 ulp: each
    # value rounds within half its own ulp (at most 2^-8 of itself), so the
    # larger of the two sets it (a weight that crosses 0 has |b| >> |a|)
    lr = tcard.lr
    worst, moved = 0.0, 0
    for a, b in zip(res["cpu"][2], res["cuda"][2]):
        d = (a - b).abs()
        ulp = torch.maximum(a.abs(), b.abs()) * 2 ** -7
        worst = max(worst, float((d - (2 * lr + ulp)).max()))
        moved += int((d > 0).sum())
    total = sum(a.numel() for a in res["cpu"][2])
    say(f"  updated params differ in {moved} of {total} entries")
    check(f"{label} updated params, card vs CPU (excess over 2·lr + "
          "1 ulp)", max(worst, 0.0), 0.0)


#: the tiny train steps' limit on the relative difference of the tied
#: head's gradient norm, card against CPU (20x the 5.3e-5 read at most)
TOL_HEAD = 1e-3


def train_reference_check(torch):
    """A tiny QWEN3 card, one ``make_train_step`` on the card (flash and
    fused-CE kernels) against the same step on the CPU (plain versions),
    SR off: the loss, every gradient's norm and the updated parameters."""
    from koifish_tpu_torch.config import ModelCard, TrainCard
    card = ModelCard.from_arch("QWEN3", vocab_size=512, n_layer=2, n_embd=128,
                               n_head=2, n_kv_head=1, head_dim=64, n_ffn=256,
                               n_ctx=64, max_pos=128)
    tcard = TrainCard(batch=4, lr=1e-3, warmup=0, scheduler="static",
                      fused_ce=True, stochastic_round=False,
                      check_tensor_norm=True)
    # f32 loss of O(6): bf16 activations rounded at other points (cuBLAS
    # vs the CPU, kernel sum orders); per-leaf grad norms 2 % relative
    _step_card_vs_cpu(torch, "tiny QWEN3 train step", card, tcard, 512,
                      1e-2, 2e-2, TOL_HEAD)
    # the SR hash runs on wrapping int32 arithmetic: the card must give
    # the CPU's bits (which the CPU tests hold to the JAX package's)
    from koifish_tpu_torch.train.optimizer import stochastic_round
    x = torch.randn((3_000_017,), generator=torch.Generator().manual_seed(9))
    sr_cpu = stochastic_round(x, 0xDEADBEEF, torch.bfloat16)
    sr_gpu = stochastic_round(x.to("cuda"), 0xDEADBEEF, torch.bfloat16).cpu()
    check("stochastic_round card vs CPU (entries whose bits differ)",
          float((sr_cpu.view(torch.int16) != sr_gpu.view(torch.int16)).sum()),
          0.0)


def reference_check_int8(torch):
    """A tiny GPT2 int8 step (every weight int8, the fc dgrad through the
    tile kernel, the int8 fused CE) and a tiny QAT step (INT4 g128 rules),
    card against CPU. Tolerances: the bf16 step's, widened as far as int8
    codes flipping at rounding edges require (a bf16 activation an ulp
    apart moves a code by one step of 1/127 of its row's range): loss 2e-2,
    grad norms 5 %; the updated params keep the 2·lr + 1 ulp rule."""
    from koifish_tpu_torch.config import ModelCard, QuantCard, TrainCard
    card = ModelCard.from_arch("GPT2", vocab_size=2048, n_layer=2, n_embd=128,
                               n_head=2, n_kv_head=2, head_dim=64, n_ffn=1024,
                               n_ctx=64, max_pos=128)
    tcard = TrainCard(batch=4, lr=1e-3, warmup=0, scheduler="static",
                      fused_ce=True, stochastic_round=False,
                      check_tensor_norm=True, int8_matmul=True,
                      int8_min_kn=0, int8_dgrad="tile")
    _step_card_vs_cpu(torch, "tiny GPT2 int8 train step", card, tcard, 2048,
                      2e-2, 5e-2, TOL_HEAD)
    qcard = QuantCard.from_json({"self_attn": {"bits": 4},
                                 "mlp": {"bits": 4}, "group_size": 128})
    tcard = TrainCard(batch=4, lr=1e-3, warmup=0, scheduler="static",
                      fused_ce=True, stochastic_round=False,
                      check_tensor_norm=True)
    _step_card_vs_cpu(torch, "tiny GPT2 QAT train step", card, tcard, 2048,
                      2e-2, 5e-2, TOL_HEAD, qcard=qcard)


def train_model(torch, label, config, B, steps=8, profile=False, tcard=None,
                full_depth=False):
    """``train_loop`` for ``steps`` steps of one fixed random batch
    [1, B, 1025] at ``bench.py``'s settings (or ``tcard``); with
    ``profile`` it also times the optimizer and profiles a step. The model
    is cut to DEPTH layers unless ``full_depth``. Returns the losses and
    the kernel launches."""
    from koifish_tpu_torch.config import CLIParams, TrainCard
    from koifish_tpu_torch.train import (init_train_state, make_train_step,
                                         train_loop)
    from koifish_tpu_torch.utils import kernel_log, mfu
    p = (CLIParams.load(os.path.join(ROOT, "configs", config)) if full_depth
         else load_config(config))
    card = p.model
    T = 1024
    say(f"[train] {label}: L={card.n_layer} E={card.n_embd} Hq={card.n_head} "
        f"Hkv={card.n_kv_head} D={card.head_dim} F={card.n_ffn} "
        f"V={card.vocab_size} tie={card.tie_embeddings}; B={B} T={T}")
    if tcard is None:
        tcard = TrainCard(batch=B, lr=6e-4, warmup=10, optimizer="adamw",
                          remat=False, seed=p.seed, dump_every=1)
    t0 = time.perf_counter()
    state = init_train_state(card, tcard)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(p.seed)
    batch = {"tokens": torch.randint(0, card.vocab_size, (1, B, T + 1),
                                     generator=gen, device="cuda")}
    torch.cuda.synchronize()
    say(f"  init: {time.perf_counter() - t0:.2f} s; "
        f"{mfu.matmul_params(card) / 1e6:.1f} M matmul parameters")
    lines = []
    kernel_log.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    state, infos = train_loop(card, tcard, state, iter([batch] * steps),
                              total_steps=1000, log_fn=lines.append)
    torch.cuda.synchronize()
    counts = kernel_log.launches()
    peak = torch.cuda.max_memory_allocated()
    for ln in lines:
        say("  " + ln)
    losses = infos.losses
    dts = sorted(r[3] for r in infos.rows[2:])
    dt = dts[len(dts) // 2]
    peak_flops = mfu.chip_peak_flops()
    say(f"  losses: {[round(x, 4) for x in losses]}")
    say(f"  median {dt * 1e3:.2f} ms/step over steps 2..{steps - 1} "
        f"(runs {[round(r[3] * 1e3, 2) for r in infos.rows]}), "
        f"{B * T / dt:.1f} tok/s, MFU "
        f"{mfu.step_mfu(card, B * T, dt, peak_flops):.4f} "
        f"(peak {peak_flops / 1e12:.0f} TFLOP/s bf16)")
    say(f"  peak device memory: {peak / 2**30:.2f} GiB")
    say(f"  launches in the {steps}-step train_loop: {json.dumps(counts)}")
    if not all(torch.isfinite(torch.tensor(losses))):
        fail(f"{label}: non-finite loss")
    if not losses[-1] < losses[0]:
        fail(f"{label}: the loss did not fall ({losses[0]} -> {losses[-1]})")
    # the optimizer alone: one AdamW + SR update of every leaf
    from koifish_tpu_torch.train.optimizer import apply_updates
    from koifish_tpu_torch.utils.tree import leaves, tree_map
    if profile:
        grads = tree_map(lambda p: torch.full_like(p, 1e-3), state.params)
        seeds = list(range(len(leaves(state.params))))
        opt_ms = event_ms(torch, lambda: apply_updates(
            state.params, grads, state.opt, optimizer="adamw", lr=1e-6,
            sr_seeds=seeds), iters=3, warm=1)
        say(f"  optimizer: one apply_updates (AdamW + SR, {len(seeds)} "
            f"leaves) {opt_ms:.2f} ms (CUDA events around eager calls)")
        del grads
    if profile:
        step = make_train_step(card, tcard, total_steps=1000)

        def one():
            nonlocal state
            state, metrics = step(state, batch)
            float(metrics["loss"])
        profile_window(torch, f"{label} train step (B={B}, T={T})", one)
    del state, batch
    torch.cuda.empty_cache()
    return losses, counts


def train_phase(torch):
    import math
    train_reference_check(torch)
    q_losses, counts = train_model(torch, "Qwen3-0.6B", "qwen3_0.6b.json", 8,
                                   profile=True)
    if abs(q_losses[0] - math.log(151936)) > 0.5:
        fail(f"first Qwen3 loss {q_losses[0]} is not within 0.5 of "
             f"ln 151936 = {math.log(151936):.4f}")
    for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "fused_ce_fwd",
                 "fused_ce_dlogits", "fused_ce_dx", "fused_ce_dw"):
        if counts.get(name, 0) <= 0:
            fail(f"kernel {name} was not launched by the Qwen3 train_loop")
    _, g_counts = train_model(torch, "GPT2-124M", "gpt2_124m.json", 32,
                              profile=True)
    for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        if g_counts.get(name, 0) <= 0:
            fail(f"kernel {name} was not launched by the GPT2 train_loop")
    return counts


def train_774m_phase(torch):
    """GPT2-774M from configs/gpt2_774m.json at full width, DEPTH layers, its
    train card as shipped (int8 matmuls >= 4M weights, int8 fused CE, bf16
    moments, no remat, B 16) with warmup 10 as ``bench.py`` runs it: (a) as
    shipped, 8 steps and a profiled step; (b) int8_dgrad "tile", 4 steps;
    (c) int8_matmul off (the bf16 fused CE at E 1280), 4 steps. Fails
    unless the losses are finite, (a)'s fall from within 0.5 of ln 50304,
    ``bench.py``'s gate holds (loss < 11.5, no climb above the third step's
    + 0.05) and each run's kernels launched. Returns (a)'s and (b)'s
    launches."""
    import dataclasses
    import math
    from koifish_tpu_torch.config import CLIParams
    p = CLIParams.load(os.path.join(ROOT, "configs", "gpt2_774m.json"))
    base = dataclasses.replace(p.train, warmup=10, dump_every=1, seed=p.seed)
    say(f"[train] GPT2-774M card from configs/gpt2_774m.json: "
        f"int8_matmul={base.int8_matmul} int8_min_kn={base.int8_min_kn} "
        f"int8_dgrad={base.int8_dgrad} fused_ce={base.fused_ce} "
        f"moment_dtype={base.moment_dtype} remat={base.remat} "
        f"batch={base.batch} lr={base.lr}")
    runs = (("GPT2-774M int8 as shipped", {}, 8, True,
             ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "fused_ce_fwd_int8",
              "fused_ce_dlogits_int8", "fused_ce_dx_int8", "fused_ce_dw_int8",
              "rowquant", "colquant")),
            ("GPT2-774M int8_dgrad tile", {"int8_dgrad": "tile"}, 4, False,
             ("qdgrad_quant", "qdgrad_int8_tile", "fused_ce_fwd_int8")),
            ("GPT2-774M bf16 (int8_matmul off)", {"int8_matmul": False}, 4,
             False, ("fused_ce_fwd", "fused_ce_dlogits", "fused_ce_dx",
                     "fused_ce_dw")))
    out = []
    for label, over, steps, prof, need in runs:
        tcard = dataclasses.replace(base, **over)
        losses, counts = train_model(torch, label, "gpt2_774m.json",
                                     tcard.batch, steps=steps, profile=prof,
                                     tcard=tcard)
        if not all(0.0 < x < 11.5 for x in losses):
            fail(f"{label}: a loss outside bench.py's gate (0, 11.5): "
                 f"{losses}")
        if losses[-1] > losses[2] + 0.05:
            fail(f"{label}: the loss climbed {losses[2]} -> {losses[-1]}")
        for name in need:
            if counts.get(name, 0) <= 0:
                fail(f"kernel {name} was not launched by the {label} run")
        if prof:   # run (a)
            if abs(losses[0] - math.log(50304)) > 0.5:
                fail(f"first GPT2-774M loss {losses[0]} is not within 0.5 "
                     f"of ln 50304 = {math.log(50304):.4f}")
            if not losses[-1] < losses[0]:
                fail(f"{label}: the loss did not fall ({losses[0]} -> "
                     f"{losses[-1]})")
        out.append(counts)
    return out[0], out[1]


# ---------------------------------------------------------------------------
# phase 5b: the koifish CLI
# ---------------------------------------------------------------------------

#: Qwen3-0.6B's published max_position_embeddings
QWEN3_MAX_POS = 40960
#: conversations of the SFT run's jsonl: 3 steps of configs/
#: qwen3_sft_lora.json's batch of 16
SFT_CONVS = 48
SFT_WORDS = ("hello", "world", "river", "stone", "light", "green", "seven",
             "paper", "north", "quiet", "table", "music")


def write_chatml_jsonl(path: str, n: int, seed: int) -> None:
    """``n`` seeded OAI-message conversations, as tests/test_cli.py:218-226
    writes them: a user turn and an assistant turn of a few words."""
    import random
    rng = random.Random(seed)

    def words(lo, hi):
        return " ".join(rng.choice(SFT_WORDS)
                        for _ in range(rng.randint(lo, hi)))
    with open(path, "w") as f:
        for i in range(n):
            f.write(json.dumps({"messages": [
                {"role": "user", "content": f"{words(2, 8)} {i}"},
                {"role": "assistant", "content": words(3, 12)}]}) + "\n")


def config_copy(src: str, dst: str, hf=None, train=None, eval_glob=None):
    """configs/<src> written to ``dst`` with only its paths changed: the SFT
    folder (``sft.hf-card``), the train glob and the ``eval_1`` glob."""
    with open(os.path.join(ROOT, "configs", src)) as f:
        cfg = json.load(f)
    if hf is not None:
        cfg["sft"]["hf-card"] = hf
    if train is not None:
        cfg["datasets"]["train"]["glob"] = train
    if eval_glob is not None:
        cfg["datasets"]["eval_1"]["glob"] = eval_glob
    with open(dst, "w") as f:
        json.dump(cfg, f, indent=1)
    return cfg


class _Tee:
    """stdout that is also kept: a CLI's own lines are read back."""

    def __init__(self):
        self.lines = []

    def write(self, s):
        self.lines.append(s)
        return sys.__stdout__.write(s)

    def flush(self):
        sys.__stdout__.flush()

    def text(self) -> str:
        return "".join(self.lines)


def run_cli(torch, main, argv, label, check=True):
    """One CLI ``main(argv, result=...)`` with the launches and fallbacks
    counted from 0 and its stdout kept; on the card (``check``) it fails
    unless the CLI returns 0 and logs no fallback. Returns (result, stdout,
    launches)."""
    import contextlib
    from koifish_tpu_torch.utils import kernel_log
    res, tee = {}, _Tee()
    if check:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    kernel_log.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        rc = main(argv, result=res)
    if check:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, falls = kernel_log.launches(), kernel_log.fallbacks()
    if check:
        say(f"  {label}: rc={rc}, {wall:.2f} s; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
            f"{json.dumps(counts)}; fallbacks {json.dumps(falls)}")
        if falls:
            fail(f"{label}: a kernel fallback was logged: {falls}")
    if rc != 0:
        fail(f"{label}: returned {rc}")
    return res, tee.text(), counts


def _same_bits(torch, a, b) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point() and a.element_size() == 2:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return torch.equal(a, b)


def sft_launches(steps: int, card, remat, m: int) -> dict:
    """The launches ``steps`` LoRA SFT steps make: a flash forward a layer
    (and its recompute with ``remat``), a dK/dV and a dQ backward a layer,
    one fused-CE forward and a dlogits and a dx launch per vocab chunk of
    the m rows (no dW: the tied head is frozen)."""
    from koifish_tpu_torch.ops.kernels import fused_ce as kc
    L = card.n_layer
    chunks = len(kc.chunk_plan(m, card.vocab_size)[1])
    return {"flash_fwd": steps * L * (2 if remat else 1),
            "flash_bwd_dkv": steps * L, "flash_bwd_dq": steps * L,
            "fused_ce_fwd": steps, "fused_ce_dlogits": steps * chunks,
            "fused_ce_dx": steps * chunks}


def koifish_sft(torch, root: str):
    """configs/qwen3_sft_lora.json as shipped (paths only changed) through
    ``koifish.main`` for 3 steps on a full-width Qwen3-0.6B folder; then the
    final state saved, loaded back bit for bit and resumed for one step.
    Returns the SFT run's launches."""
    import dataclasses
    import math
    from koifish_tpu_torch.cli import koifish
    from koifish_tpu_torch.config import CLIParams
    from koifish_tpu_torch.io import (load_hf_model, load_train_state,
                                      save_train_state)
    from koifish_tpu_torch.utils import mfu
    from koifish_tpu_torch.utils.tree import flatten_with_path
    card = dataclasses.replace(load_config("qwen3_0.6b.json").model,
                               max_pos=QWEN3_MAX_POS)
    hf = os.path.join(root, "qwen3_0.6b")
    jsonl = os.path.join(root, "chatml.jsonl")
    cfgp = os.path.join(root, "qwen3_sft_lora.json")
    t0 = time.perf_counter()
    gb = write_hf_dir(torch, hf, card, seed=11)
    write_chatml_jsonl(jsonl, SFT_CONVS, seed=12)
    cfg = config_copy("qwen3_sft_lora.json", cfgp, hf=hf, train=jsonl)
    say(f"[koifish] configs/qwen3_sft_lora.json, paths changed: "
        f"{json.dumps(cfg)}")
    say(f"  wrote a Qwen3-0.6B HF folder ({gb:.2f} GB of bf16 weights, "
        f"max_position_embeddings {QWEN3_MAX_POS}) and {SFT_CONVS} "
        f"conversations in {time.perf_counter() - t0:.1f} s")
    steps = 3
    res, out, counts = run_cli(torch, koifish.main, [
        cfgp, "--most-iter", str(steps), "--out-dir",
        os.path.join(root, "sft")], "koifish SFT (3 steps)")
    scard, state, infos = res["card"], res["state"], res["infos"]
    tcard = CLIParams.load(cfgp).train
    B, T = tcard.batch, scard.n_ctx
    losses = infos.losses
    say(f"  card: L={scard.n_layer} E={scard.n_embd} V={scard.vocab_size} "
        f"n_ctx={T}; B={B}, remat={tcard.remat}; losses "
        f"{[round(x, 4) for x in losses]}")
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        fail(f"koifish SFT: losses {losses}")
    dts = [r[3] for r in infos.rows]
    dt = sorted(dts[1:])[len(dts[1:]) // 2]
    util = mfu.step_mfu(scard, B * T, dt)
    say(f"  step ms {[round(d * 1e3, 1) for d in dts]}; median of steps 1-"
        f"{steps - 1}: {dt * 1e3:.1f} ms, {B * T / dt:.1f} tok/s (B x n_ctx "
        f"tokens a step, padding included), MFU "
        f"{'not measured' if util is None else f'{util:.4f}'} (6·N·tokens "
        f"+ attention; the frozen weights' dW is not computed)")
    want = sft_launches(steps, scard, tcard.remat, B * T)
    for name, n in want.items():
        if counts.get(name, 0) != n:
            fail(f"koifish SFT: {counts.get(name, 0)} {name} launches, "
                 f"{n} expected")
    say(f"  launches as expected: {json.dumps(want)}; fused_ce_dw "
        f"{counts.get('fused_ce_dw', 0)} (the frozen head takes no dW)")
    if counts.get("fused_ce_dw", 0):
        fail("koifish SFT: the dW GEMM launched for the frozen head")
    _, base = load_hf_model(hf, device="cuda")
    trained = flatten_with_path(state.params)
    base_now = [(p, t) for p, t in trained
                if not any(str(k).endswith("_lora") for k in p)]
    if [p for p, _ in base_now] != [p for p, _ in flatten_with_path(base)]:
        fail("koifish SFT: the trained params' base leaves are not the "
             "folder's")
    for (path, a), (_, b) in zip(flatten_with_path(base), base_now):
        if not _same_bits(torch, a, b.detach()):
            fail(f"koifish SFT: base weight {path} changed")
    lora_b = [(p, t) for p, t in trained if len(p) > 3 and p[-1] == "b"]
    for path, b in lora_b:
        if not b.abs().max() > 0:
            fail(f"koifish SFT: adapter {path} did not move")
    say(f"  every base weight ({len(base_now)} tensors) bit for bit "
        f"unchanged; all {len(lora_b)} adapters' b moved")
    del base

    ck = os.path.join(root, "sft_step3.safetensors")
    t0 = time.perf_counter()
    save_train_state(ck, state, scard, extra_meta={"iter": steps})
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded, _ = load_train_state(ck, state)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    trees = (("params", state.params, loaded.params),
             ("opt_m", state.opt.m, loaded.opt.m),
             ("opt_v", state.opt.v, loaded.opt.v))
    n = 0
    for tag, a, b in trees:
        for (path, x), (_, y) in zip(flatten_with_path(a),
                                     flatten_with_path(b)):
            n += 1
            if not _same_bits(torch, x.detach(), y):
                fail(f"checkpoint: {tag} {path} did not load bit for bit")
    if loaded.opt.step != state.opt.step or \
            not torch.equal(loaded.opt.spikes, state.opt.spikes):
        fail("checkpoint: step or spikes did not load")
    say(f"  checkpoint {os.path.getsize(ck) / 1e9:.2f} GB: saved in "
        f"{t_save:.1f} s, loaded in {t_load:.1f} s; {n} tensors and step "
        f"{loaded.opt.step} bit for bit")
    del loaded
    profile_sft_step(torch, scard, tcard, state, jsonl, hf)
    del res, state
    torch.cuda.empty_cache()
    res, out, _ = run_cli(torch, koifish.main, [
        cfgp, "--most-iter", "1", "--resume", ck, "--out-dir",
        os.path.join(root, "sft_resume")], "koifish SFT --resume (1 step)")
    if f"(step {steps})" not in out:
        fail(f"koifish --resume did not report step {steps}")
    if not all(math.isfinite(x) for x in res["infos"].losses):
        fail("koifish --resume: a non-finite loss")
    say(f"  resumed at step {steps}: loss "
        f"{res['infos'].losses[0]:.4f}")
    del res
    os.remove(ck)
    torch.cuda.empty_cache()
    return counts, hf


def profile_sft_step(torch, card, tcard, state, jsonl: str, hf: str) -> None:
    """The SFT step's device time by kernel and idle share: one step of
    the CLI's batches, LoRA mask and train card under the profiler."""
    from koifish_tpu_torch.data import BPETokenizer
    from koifish_tpu_torch.data.sft import SFTDataset
    from koifish_tpu_torch.train import make_train_step
    from koifish_tpu_torch.train.lora import trainable_mask
    b = next(SFTDataset.from_jsonl(jsonl, BPETokenizer.from_file(hf),
                                   card.n_ctx).batches(tcard.batch))
    batch = {"tokens": torch.from_numpy(b["tokens"]).to("cuda", torch.int64),
             "loss_mask": torch.from_numpy(b["loss_mask"]).to("cuda")}
    step = make_train_step(card, tcard, total_steps=3,
                           trainable=trainable_mask(state.params, "lora"))

    def one():
        nonlocal state
        state, metrics = step(state, batch)
        float(metrics["loss"])
    profile_window(torch, f"Qwen3-0.6B LoRA SFT step (B={tcard.batch}, "
                   f"T={card.n_ctx})", one)


def koifish_gpt2(torch, root: str) -> dict:
    """configs/gpt2_124m.json (paths only changed) through ``koifish.main``
    for 4 steps from seeded uint16 train and val shards."""
    import math
    import numpy as np
    from koifish_tpu_torch.cli import koifish
    from koifish_tpu_torch.data import MAGIC_GPT2, write_shard
    d = os.path.join(root, "edu_fineweb")
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(13)
    for split, n in (("train", 300_000), ("val", 40_000)):
        write_shard(os.path.join(d, f"edu_fineweb_{split}_000000.bin"),
                    rng.integers(0, 50257, n).astype(np.uint16), MAGIC_GPT2,
                    50257)
    cfgp = os.path.join(root, "gpt2_124m.json")
    config_copy("gpt2_124m.json", cfgp, train=os.path.join(d, "*train*.bin"),
                eval_glob=os.path.join(d, "*val*.bin"))
    say("[koifish] configs/gpt2_124m.json, paths changed: seeded uint16 "
        "shards (300,000 train and 40,000 val tokens)")
    steps = 4
    res, _, counts = run_cli(torch, koifish.main, [
        cfgp, "--most-iter", str(steps), "--out-dir",
        os.path.join(root, "gpt2")], "koifish GPT2-124M (4 steps)")
    losses = res["infos"].losses
    dts = [round(r[3] * 1e3, 1) for r in res["infos"].rows]
    say(f"  losses {[round(x, 4) for x in losses]}; step ms {dts}")
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        fail(f"koifish GPT2-124M: losses {losses}")
    for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        if counts.get(name, 0) <= 0:
            fail(f"koifish GPT2-124M: kernel {name} was not launched")
    del res
    torch.cuda.empty_cache()
    return counts


def koifish_pangpi(torch, root: str, hf: str) -> dict:
    """``pangpi --bits 4 --ppl`` on the full-width Qwen3 folder (n_ctx 8192,
    one row a batch, two batches)."""
    import math
    import numpy as np
    from koifish_tpu_torch.cli import pangpi
    from koifish_tpu_torch.config import ModelCard
    from koifish_tpu_torch.data import MAGIC_QWEN3, write_shard
    with open(os.path.join(hf, "config.json")) as f:
        card = ModelCard.from_hf(json.load(f))
    V = card.vocab_size
    val = os.path.join(root, "qwen3_val.bin")
    write_shard(val, np.random.default_rng(15).integers(
        0, V, 3 * (card.n_ctx + 1)).astype(np.uint32), MAGIC_QWEN3, V)
    say(f"[koifish] pangpi --bits 4 --ppl on the Qwen3-0.6B folder (n_ctx "
        f"{card.n_ctx}, 2 batches of 1 row)")
    res, _, counts = run_cli(torch, pangpi.main, [
        "--hf", hf, "--ppl", val, "--bits", "4", "--batch", "1", "--max", "2"],
        "pangpi --bits 4 --ppl")
    say(f"  ce {res['ce']:.4f}, ppl {res['ppl']:.1f} (random weights: ln "
        f"{V} = {math.log(V):.4f})")
    if not math.isfinite(res["ppl"]) or abs(res["ce"] - math.log(V)) > 0.5:
        fail(f"pangpi: ce {res['ce']} is not within 0.5 of ln {V}")
    for name in ("qmm", "flash_fwd"):
        if counts.get(name, 0) <= 0:
            fail(f"pangpi: kernel {name} was not launched")
    return counts


def koifish_reference_check(torch, root: str) -> None:
    """Tiny folders through the CLIs on the card against the CPU: two LoRA
    SFT steps of ``koifish.main`` (the losses within 1e-2, step 2's
    adapter gradient norms within ``_step_card_vs_cpu``'s 2 %, the
    adapters' b; SR off), and ``pangpi --bits 4 --ppl`` (mean CE within
    1e-2)."""
    import dataclasses
    import numpy as np
    from koifish_tpu_torch.cli import koifish, pangpi
    from koifish_tpu_torch.data import MAGIC_QWEN3, write_shard
    from koifish_tpu_torch.utils.tree import flatten_with_path
    tiny = dataclasses.replace(_tiny_card(), vocab_size=300, max_pos=256)
    hf = os.path.join(root, "tiny_hf")
    write_hf_dir(torch, hf, tiny, seed=14)
    jsonl = os.path.join(root, "tiny.jsonl")
    write_chatml_jsonl(jsonl, 8, seed=16)
    lr = 1e-3
    cfgp = os.path.join(root, "tiny_sft.json")
    with open(cfgp, "w") as f:
        json.dump({"sft": {"hf-card": hf, "method": "lora", "lora_rank": 8,
                           "lora_alpha": 16},
                   "model": {"arch": "QWEN3"},
                   "train": {"batch": 4, "learning-rate": lr, "warmup": 0,
                             "scheduler": "static", "dump-every": 1,
                             "optimizatioin": {"method": "adamw",
                                               "stochastic_round": False}},
                   "datasets": {"train": {"glob": jsonl,
                                          "type": "OAI_message"}},
                   "debug": {"check_tensor_norm": True, "nn_structure": False},
                   "seed": 42}, f)
    got = {}
    for dev in ("cpu", "cuda"):
        res, _, _ = run_cli(torch, koifish.main, [
            cfgp, "--most-iter", "2", "--device", dev, "--out-dir",
            os.path.join(root, f"tiny_{dev}")], f"tiny SFT on {dev}",
            check=dev == "cuda")
        got[dev] = (res["infos"].losses,
                    res["metrics"]["leaf_norms"].float().cpu(),
                    [(p, t.detach().float().cpu()) for p, t in
                     flatten_with_path(res["state"].params)])
    check("tiny LoRA SFT 2 steps through koifish.main losses, card vs CPU",
          max(abs(a - b) for a, b in zip(got["cpu"][0], got["cuda"][0])),
          1e-2)
    paths = [p for p, _ in got["cpu"][2]]
    ad = [i for i, p in enumerate(paths) if any(
        str(x).endswith("_lora") for x in p)]
    n_cpu, n_gpu = got["cpu"][1][ad], got["cuda"][1][ad]
    rel = (n_gpu - n_cpu).abs() / n_cpu.clamp_min(1e-6)
    say(f"  {len(ad)} adapter tensors; step 2's grad norms (CPU) "
        f"{float(n_cpu.min()):.3e}..{float(n_cpu.max()):.3e}")
    check("tiny LoRA SFT adapter grad norms, card vs CPU (relative)",
          float(rel.max()), 2e-2)
    # each b starts at 0 and AdamW moves an entry by about lr·sign(g) a
    # step: after two steps a card that made no update reads 1 here, one
    # with the wrong sign 2, one with twice the step 1; an entry whose
    # gradient is near 0 may take the other sign on the two devices
    # (0.25 allows ~1.5 % of the entries to)
    bs = [i for i in ad if paths[i][-1] == "b"]
    d2 = sum(float(((got["cuda"][2][i][1] - got["cpu"][2][i][1]) ** 2).sum())
             for i in bs)
    c2 = sum(float((got["cpu"][2][i][1] ** 2).sum()) for i in bs)
    flips = sum(int((got["cuda"][2][i][1].sign()
                     != got["cpu"][2][i][1].sign()).sum()) for i in bs)
    say(f"  {len(bs)} adapters' b: {flips} of "
        f"{sum(got['cpu'][2][i][1].numel() for i in bs)} entries differ in "
        f"sign, card vs CPU")
    check("tiny LoRA SFT adapters' b after 2 steps, card vs CPU "
          "(‖Δ‖/‖b_cpu‖)", (d2 / max(c2, 1e-30)) ** 0.5, 0.25)
    val = os.path.join(root, "tiny_val.bin")
    write_shard(val, np.random.default_rng(17).integers(0, 300, 2000).astype(
        np.uint32), MAGIC_QWEN3, 300)
    ce = {}
    for dev in ("cpu", "cuda"):
        res, _, counts = run_cli(torch, pangpi.main, [
            "--hf", hf, "--ppl", val, "--bits", "4", "--batch", "2", "--max",
            "2", "--device", dev], f"tiny pangpi on {dev}",
            check=dev == "cuda")
        ce[dev] = res["ce"]
    if counts.get("qmm", 0) <= 0:
        fail("tiny pangpi --bits 4: qmm was not launched on the card")
    check("tiny pangpi --bits 4 --ppl mean CE, card vs CPU",
          abs(ce["cpu"] - ce["cuda"]), 1e-2)


def koifish_phase(torch):
    """Slice 12: the koifish training CLI on the card. Writes its inputs
    under build/koifish; runs configs/qwen3_sft_lora.json as shipped (3
    steps, then save, load and resume), configs/gpt2_124m.json (4 steps)
    and ``pangpi --bits 4 --ppl``, each with its launches counted from 0,
    then the tiny card-against-CPU checks. Returns the SFT run's launches."""
    import shutil
    root = os.path.join(ROOT, "build", "koifish")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t0 = time.perf_counter()
    sft_counts, hf = koifish_sft(torch, root)
    koifish_gpt2(torch, root)
    koifish_pangpi(torch, root, hf)
    koifish_reference_check(torch, root)
    shutil.rmtree(root)
    say(f"[koifish] phase: {time.perf_counter() - t0:.1f} s")
    return sft_counts


# ---------------------------------------------------------------------------
# phase 5c: gama training, distillation, .kun models, QJL serving (slice 13)
# ---------------------------------------------------------------------------

#: steps of the gama CLI run and of the distillation
GAMA_STEPS = 4
DISTILL_STEPS = 3
#: rows of the distillation batch (of 1024 tokens)
DISTILL_B = 4
#: token ids the seeded shards draw from, with Zipf weights
SHARD_IDS = 512


def write_token_shard(path: str, vocab: int, n: int, seed: int,
                      period: int = 0) -> None:
    """``n`` seeded uint32 tokens (Qwen3 shard magic), drawn from the first
    ``SHARD_IDS`` ids (at most ``vocab``) with weights 1/rank. ``period``:
    one drawn sequence of that length repeated, so that every window of a
    ``TokenDataset`` at that stride holds the same tokens."""
    import numpy as np
    from koifish_tpu_torch.data import MAGIC_QWEN3, write_shard
    rng = np.random.default_rng(seed)
    k = min(SHARD_IDS, vocab)
    w = 1.0 / np.arange(1, k + 1)
    toks = rng.choice(k, period or n, p=w / w.sum())
    if period:
        toks = np.resize(toks, n)
    write_shard(path, toks.astype(np.uint32), MAGIC_QWEN3, vocab)


def _qtensors(torch, params):
    """[(path, QTensor)] of a param tree."""
    from koifish_tpu_torch.quant.qtensor import QTensor
    return [((li, k), w) for li, lp in enumerate(params["layers"])
            for k, w in lp.items() if isinstance(w, QTensor)]


def gama_launches(steps: int, card, remat, m: int) -> dict:
    """The launches ``steps`` gama steps of ``card`` make at m rows: row 3
    in each of a layer's 7 projections and a flash forward a layer (each
    twice with ``remat``: the backward recomputes the block; the backward
    itself multiplies by the dequantized weight), a dK/dV and a dQ a
    layer, and the fused CE's forward and, per vocab chunk, its dlogits, dx
    and dW (the tied embedding trains)."""
    from koifish_tpu_torch.ops.kernels import fused_ce as kc
    L = card.n_layer
    r = 2 if remat else 1
    chunks = len(kc.chunk_plan(m, card.vocab_size)[1])
    return {"qmm": steps * L * 7 * r, "flash_fwd": steps * L * r,
            "flash_bwd_dkv": steps * L, "flash_bwd_dq": steps * L,
            "fused_ce_fwd": steps, "fused_ce_dlogits": steps * chunks,
            "fused_ce_dx": steps * chunks, "fused_ce_dw": steps * chunks}


def gama_cli(torch, root: str) -> dict:
    """configs/qwen3_0.6b.json as shipped, with ``"train_target": "gama"``
    in its quantizer card and its train glob on a seeded shard, through
    ``koifish.main`` for ``GAMA_STEPS`` steps (B 16 x 1024; the config's
    warmup is the default 700 steps, so the lr is 0 at step 0 and ~1e-6
    after: one token sequence repeated makes every batch the same, so that
    the losses move only with the updates). Fails unless
    the losses are finite and fall, every code tensor is bit for bit the
    initial quantization's, every scale tensor moved and the launches are
    ``gama_launches``'s. Returns the launches."""
    import math
    from koifish_tpu_torch.cli import koifish
    from koifish_tpu_torch.config import CLIParams
    from koifish_tpu_torch.models import init_params
    from koifish_tpu_torch.quant import quantize_params
    from koifish_tpu_torch.utils import mfu
    with open(os.path.join(ROOT, "configs", "qwen3_0.6b.json")) as f:
        cfg = cut_config(json.load(f))
    cfg["quantizer"]["train_target"] = "gama"
    shard = os.path.join(root, "qwen3_train_000.bin")
    cfg["datasets"]["train"]["glob"] = os.path.join(root, "*train*.bin")
    cfgp = os.path.join(root, "qwen3_gama.json")
    with open(cfgp, "w") as f:
        json.dump(cfg, f, indent=1)
    p = CLIParams.load(cfgp)
    card, tcard = p.model, p.train
    B, T = tcard.batch, card.n_ctx
    # every window the same T tokens: the losses differ only by the updates
    write_token_shard(shard, card.vocab_size, 2 * GAMA_STEPS * B * (T + 1),
                      seed=31, period=T)
    say(f"[gama] configs/qwen3_0.6b.json with train_target gama and a "
        f"seeded shard: {json.dumps(cfg)}")
    res, _, counts = run_cli(torch, koifish.main, [
        cfgp, "--most-iter", str(GAMA_STEPS), "--out-dir",
        os.path.join(root, "gama")], f"koifish gama ({GAMA_STEPS} steps)")
    state, infos = res["state"], res["infos"]
    losses = infos.losses
    dts = [r[3] for r in infos.rows]
    dt = sorted(dts[1:])[len(dts[1:]) // 2]
    util = mfu.step_mfu(card, B * T, dt)
    say(f"  B={B}, T={T}, remat={tcard.remat}, warmup {tcard.warmup}, lr "
        f"{[round(r[2], 10) for r in infos.rows]}; losses "
        f"{[round(x, 6) for x in losses]}")
    say(f"  step ms {[round(d * 1e3, 1) for d in dts]}; median of steps 1-"
        f"{GAMA_STEPS - 1}: {dt * 1e3:.1f} ms, {B * T / dt:.1f} tok/s, MFU "
        f"{'not measured' if util is None else f'{util:.4f}'} (6·N·tokens "
        f"+ attention)")
    if len(losses) != GAMA_STEPS or not all(math.isfinite(x)
                                            for x in losses):
        fail(f"gama: losses {losses}")
    if not losses[-1] < losses[0]:
        fail(f"gama: the loss did not fall ({losses[0]} -> {losses[-1]})")
    want = gama_launches(GAMA_STEPS, card, tcard.remat, B * T)
    for name, n in want.items():
        if counts.get(name, 0) != n:
            fail(f"gama: {counts.get(name, 0)} {name} launches, {n} "
                 f"expected")
    say(f"  launches as expected: {json.dumps(want)}")
    with torch.no_grad():
        ref = quantize_params(init_params(card, device="cuda",
                                          seed=tcard.seed), p.quant, card)
    got = dict(_qtensors(torch, state.params))
    n = 0
    for path, q0 in _qtensors(torch, ref):
        q = got[path]
        if not torch.equal(q.codes, q0.codes):
            fail(f"gama: the codes of {path} changed")
        if torch.equal(q.scales.detach(), q0.scales):
            fail(f"gama: the scales of {path} did not move")
        n += 1
    moved = max(float(((got[p].scales.detach() - q.scales).abs()
                       / q.scales.abs().clamp_min(1e-12)).max())
                for p, q in _qtensors(torch, ref))
    say(f"  all {n} code tensors bit for bit the initial quantization's; "
        f"all {n} scale tensors moved (largest relative move {moved:.3e})")
    if n != card.n_layer * 7:
        fail(f"gama: {n} quantized weights, {card.n_layer * 7} expected")
    del ref
    gama_backward_times(torch, [q for (li, _), q in got.items() if li == 0],
                        card.n_layer, B * T)
    profile_gama_step(torch, card, tcard, p.quant, state, cfg, B * T)
    del res, state, got
    torch.cuda.empty_cache()
    return counts


def gama_backward_times(torch, qs, n_layer: int, m: int) -> None:
    """The plain PyTorch work of gama's backward for one layer's quantized
    weights ``qs`` at m rows (dx through the dequantized weight, ``dW =
    x2ᵀ·dy`` and the scales' sums), times ``n_layer``, against the same
    layers' bf16 dx and dW products (CUDA events around eager calls)."""
    from koifish_tpu_torch.ops.kernels.matmul import weight_grads
    g = torch.Generator(device="cuda")
    g.manual_seed(34)
    ins = []
    with torch.no_grad():
        for q in qs:
            K, N = q.shape
            x = torch.randn((m, K), generator=g, device="cuda").bfloat16()
            dy = torch.randn((m, N), generator=g, device="cuda").bfloat16()
            ins.append((q, x, dy, q.dequantize(torch.bfloat16)))

        def gama():
            for q, x, dy, _ in ins:
                torch.matmul(dy, q.dequantize(dy.dtype).t())
                weight_grads(x, dy, q)

        def plain():
            for _, x, dy, w in ins:
                torch.matmul(dy, w.t())
                torch.matmul(x.t(), dy)
        t_gama, t_plain = event_ms(torch, gama), event_ms(torch, plain)
    say(f"  gama backward of the quantized weights (dequantize + dx, dW, "
        f"the scales' sums; {len(qs)} weights a layer, m {m}): "
        f"{t_gama * n_layer:.2f} ms a step ({n_layer} layers) against "
        f"{t_plain * n_layer:.2f} ms for their bf16 dx and dW products")


def profile_gama_step(torch, card, tcard, qcard, state, cfg, m: int) -> None:
    """One gama step of the CLI's train card on its first batch under the
    profiler: device time by kernel and the idle share."""
    from koifish_tpu_torch.data import TokenDataset
    from koifish_tpu_torch.train import make_train_step
    b = next(TokenDataset(cfg["datasets"]["train"]["glob"]).batches(
        tcard.batch, card.n_ctx))
    batch = {"tokens": torch.from_numpy(b["tokens"]).to("cuda", torch.int64)}
    step = make_train_step(card, tcard, total_steps=GAMA_STEPS, qcard=qcard)

    def one():
        nonlocal state
        state, metrics = step(state, batch)
        float(metrics["loss"])
    profile_window(torch, f"Qwen3-0.6B gama step (B={tcard.batch}, "
                   f"T={card.n_ctx}, remat={tcard.remat})", one)


def gama_reference_check(torch, root: str) -> None:
    """A tiny Qwen3 folder (E 128: every product takes the kernels at g128)
    through ``koifish.main`` with a gama quantizer card, 3 steps on the
    card against the CPU (SR off): losses within 2e-2 and the last step's
    scale gradient norms within 5 % (the tiny QAT step's tolerances)."""
    import dataclasses
    from koifish_tpu_torch.cli import koifish
    from koifish_tpu_torch.utils.tree import flatten_with_path
    tiny = dataclasses.replace(_tiny_card(), vocab_size=300, max_pos=256)
    hf = os.path.join(root, "tiny_gama_hf")
    write_hf_dir(torch, hf, tiny, seed=32)
    shard = os.path.join(root, "tiny_train_000.bin")
    write_token_shard(shard, 300, 20000, seed=33)
    cfgp = os.path.join(root, "tiny_gama.json")
    with open(cfgp, "w") as f:
        json.dump({"quantizer": {"self_attn": {"bits": 4}, "mlp": {"bits": 4},
                                 "group_size": 128, "train_target": "gama"},
                   "model": {"arch": "QWEN3", "hf-card": hf},
                   "train": {"batch": 4, "learning-rate": 1e-3, "warmup": 0,
                             "scheduler": "static", "dump-every": 1,
                             "optimizatioin": {"method": "adamw",
                                               "stochastic_round": False}},
                   "datasets": {"train": {"glob": shard}},
                   "debug": {"check_tensor_norm": True,
                             "nn_structure": False}, "seed": 42}, f)
    got = {}
    for dev in ("cpu", "cuda"):
        res, _, counts = run_cli(torch, koifish.main, [
            cfgp, "--most-iter", "3", "--device", dev, "--out-dir",
            os.path.join(root, f"tiny_gama_{dev}")], f"tiny gama on {dev}",
            check=dev == "cuda")
        paths = [p for p, _ in flatten_with_path(res["state"].params)]
        got[dev] = (res["infos"].losses,
                    res["metrics"]["leaf_norms"].float().cpu(), paths)
    want = gama_launches(3, tiny, True, 4 * tiny.max_pos)["qmm"]
    if counts.get("qmm", 0) != want:
        fail(f"tiny gama: {counts.get('qmm', 0)} qmm launches on the card, "
             f"{want} expected")
    check("tiny gama CLI 3 steps losses, card vs CPU",
          max(abs(a - b) for a, b in zip(got["cpu"][0], got["cuda"][0])),
          2e-2)
    sc = [i for i, p in enumerate(got["cpu"][2]) if p[-1] == ".scales"]
    n_cpu, n_gpu = got["cpu"][1][sc], got["cuda"][1][sc]
    say(f"  {len(sc)} scale tensors; step 3's grad norms (CPU) "
        f"{float(n_cpu.min()):.3e}..{float(n_cpu.max()):.3e}")
    check("tiny gama scale grad norms, card vs CPU (relative)",
          float(((n_gpu - n_cpu).abs() / n_cpu.clamp_min(1e-6)).max()), 5e-2)


def distill_phase(torch) -> dict:
    """An INT4-g128 gama student of a seeded Qwen3-0.6B (configs/
    qwen3_0.6b.json) distilled from its own bf16 teacher with
    ``distill_step_loss`` (T 2, cosine σ 0.9 -> 0.1 over the steps):
    ``DISTILL_STEPS`` AdamW steps (lr 1e-4, no warmup, SR off) at
    ``DISTILL_B`` x 1024. Prints the reckoned and the measured peak memory;
    fails unless kd is finite and positive at step 0, σ is the schedule's,
    the codes are frozen and every scale moved. Returns the launches."""
    import math
    from koifish_tpu_torch.models import init_params
    from koifish_tpu_torch.quant import quantize_params
    from koifish_tpu_torch.train.distill import (DistillSchedule,
                                                 distill_step_loss)
    from koifish_tpu_torch.train.optimizer import (apply_updates,
                                                   init_opt_state)
    from koifish_tpu_torch.utils import kernel_log
    from koifish_tpu_torch.utils.tree import leaves, unflatten_like
    p = load_config("qwen3_0.6b.json")
    card = p.model
    B, T, V = DISTILL_B, card.n_ctx, card.vocab_size
    teacher = init_params(card, device="cuda", seed=41)
    with torch.no_grad():
        student = quantize_params(teacher, p.quant, card)
    flat = leaves(student)
    diff = [i for i, t in enumerate(flat) if t.is_floating_point()]
    for i in diff:
        flat[i].requires_grad_(True)
    opt = init_opt_state(student, "adamw")
    sched = DistillSchedule(sigma0=0.9, sigma1=0.1,
                            total_steps=DISTILL_STEPS, kind="cosine")
    codes0 = [(path, q.codes.clone(), q.scales.detach().clone())
              for path, q in _qtensors(torch, student)]
    logits_gb = B * T * V * 4 / 1e9
    say(f"[distill] Qwen3-0.6B INT4 g128 gama student <- its bf16 teacher, "
        f"B={B} x T={T}, {DISTILL_STEPS} AdamW steps; reckoned peak: the "
        f"two models' f32 logits {2 * logits_gb:.2f} GB, kd_loss's f32 "
        f"[B, T, V] temporaries (the two scaled logits, p_t, both "
        f"log-softmaxes, their difference: ~6 x {logits_gb:.2f} GB, about "
        f"half kept for the backward), CE and the logits' gradient "
        f"(~2 x {logits_gb:.2f} GB): ~{10 * logits_gb + 3:.0f} GB with the "
        f"weights, moments and activations")
    g = torch.Generator(device="cuda")
    g.manual_seed(42)
    tokens = torch.randint(0, SHARD_IDS, (DISTILL_STEPS, B, T + 1),
                           generator=g, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel_log.reset_launches()
    log, dts = [], []
    for step in range(DISTILL_STEPS):
        t0 = time.perf_counter()
        loss, aux = distill_step_loss(card, student, card, teacher,
                                      tokens[step], step, sched)
        grads = torch.autograd.grad(loss, [flat[i] for i in diff])
        gl = [torch.zeros((0,), dtype=torch.float32, device="cuda")
              for _ in flat]
        for i, gr in zip(diff, grads):
            gl[i] = gr
        student, opt, _ = apply_updates(
            student, unflatten_like(student, gl), opt, optimizer="adamw",
            lr=1e-4, beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.0,
            grad_clip=1.0)
        flat = leaves(student)
        vals = [float(loss.detach()), float(aux["ce"].detach()),
                float(aux["kd"].detach()), float(aux["sigma"])]
        torch.cuda.synchronize()
        dts.append(time.perf_counter() - t0)
        log.append(vals)
        del loss, aux, grads, gl
    counts = kernel_log.launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    say(f"  (loss, ce, kd, sigma) a step: "
        f"{[[round(v, 6) for v in r] for r in log]}")
    say(f"  step ms {[round(d * 1e3, 1) for d in dts]}; {B * T / dts[-1]:.1f}"
        f" student tok/s at the last step; peak device memory {peak:.2f} "
        f"GiB; launches {json.dumps(counts)}")
    kd0 = log[0][2]
    if not (math.isfinite(kd0) and kd0 > 0):
        fail(f"distill: kd at step 0 is {kd0}")
    for step, r in enumerate(log):
        if not all(math.isfinite(v) for v in r):
            fail(f"distill: step {step}: {r}")
        if abs(r[3] - float(sched.sigma(step))) > 1e-6:
            fail(f"distill: sigma {r[3]} at step {step}, the schedule's is "
                 f"{float(sched.sigma(step))}")
    got = dict(_qtensors(torch, student))
    for path, c0, s0 in codes0:
        if not torch.equal(got[path].codes, c0):
            fail(f"distill: the codes of {path} changed")
        if torch.equal(got[path].scales.detach(), s0):
            fail(f"distill: the scales of {path} did not move")
    for name in ("qmm", "flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        if counts.get(name, 0) <= 0:
            fail(f"distill: kernel {name} was not launched")
    say(f"  kd at step 0 {kd0:.6f}; sigma as the schedule gives it; all "
        f"{len(codes0)} code tensors frozen, every scale moved")
    del student, teacher, opt, tokens, codes0, got
    torch.cuda.empty_cache()
    return counts


def distill_reference_check(torch) -> None:
    """A tiny gama student (E 128, INT4 g128) and its bf16 teacher: one
    ``distill_step_loss`` on the card against the CPU, loss within 1e-2."""
    from koifish_tpu_torch.config import QuantCard
    from koifish_tpu_torch.models import init_params
    from koifish_tpu_torch.quant import quantize_params
    from koifish_tpu_torch.train.distill import (DistillSchedule,
                                                 distill_step_loss)
    card = _tiny_card()
    qc = QuantCard.from_json({"self_attn": {"bits": 4}, "mlp": {"bits": 4},
                              "group_size": 128, "train_target": "gama"})
    teacher = init_params(card, device="cpu", seed=43)
    student = quantize_params(teacher, qc, card, device="cpu")
    tok = torch.randint(0, 256, (4, 65),
                        generator=torch.Generator().manual_seed(44))
    out = {}
    for dev in ("cpu", "cuda"):
        mv = lambda tree: {k: ([{n: t.to(dev) for n, t in lp.items()}
                                for lp in v] if k == "layers" else v.to(dev))
                           for k, v in tree.items()}
        loss, aux = distill_step_loss(card, mv(student), card, mv(teacher),
                                      tok.to(dev), 1,
                                      DistillSchedule(total_steps=4))
        out[dev] = (float(loss), float(aux["kd"]))
    say(f"  tiny distill step: loss cpu {out['cpu'][0]:.6f} card "
        f"{out['cuda'][0]:.6f}; kd cpu {out['cpu'][1]:.3e} card "
        f"{out['cuda'][1]:.3e}")
    check("tiny distill_step_loss, card vs CPU", abs(out["cpu"][0]
                                                     - out["cuda"][0]), 1e-2)


def write_tokenizer_dat(path: str) -> None:
    """``bubble_phase``'s byte-level vocabulary as a reference token table:
    ids 0-255 the bytes, then ``BYTE_MERGES`` (score -log(rank + 1)), then
    the chat specials."""
    import math
    from koifish_tpu_torch.io.kun import write_tokenizer_dat as write
    toks = [bytes([b]) for b in range(256)]
    toks += [a + b for a, b in BYTE_MERGES]
    scores = [0.0] * 256 + [-math.log(r + 1) for r in range(len(BYTE_MERGES))]
    toks += [s.encode() for s in SPECIALS]
    scores += [0.0] * len(SPECIALS)
    write(path, toks, scores, bos_id=len(toks) - 3, eos_id=len(toks) - 1)


def kun_phase(torch) -> dict:
    """A seeded Qwen3-0.6B ``.kun`` (configs/qwen3_0.6b.json's model card
    embedded, HF-named bf16 tensors) and a ``tokenizer.dat``, both from the
    port's writers: ``load_kun_model`` must give the params they were
    written from, every tensor ``torch.equal``; then ``bubble.main --bits 8
    --kv-bits 8 --temperature 0 --max-new 64`` ("mxu") on the file, which
    must launch rows 5, 7 (with its K/V write) and 1a. Returns the bubble
    run's launches."""
    import shutil
    from koifish_tpu_torch.io.hf_loader import _map_llama_family, load_kun_model
    from koifish_tpu_torch.io.kun import write_kun
    from koifish_tpu_torch.ops import matmul as tmm
    from koifish_tpu_torch.utils.tree import flatten_with_path
    card = load_config("qwen3_0.6b.json").model
    # the reference's model schema, as the config file gives it
    cfg = {"model": {"arch": card.arch, "vocab_size": card.vocab_size,
                     "parameter": {
                         "Layer": card.n_layer,
                         "tie_word_embeddings": card.tie_embeddings,
                         "max_pos_embeddings": card.max_pos,
                         "transformer": {
                             "Ctx": card.n_ctx, "Embed": card.n_embd,
                             "Ffn": card.n_ffn, "Head": card.n_head,
                             "KVHead": card.n_kv_head,
                             "head_dim": card.head_dim}}}}
    d = os.path.join(ROOT, "build", "kun_qwen3")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    kun = os.path.join(d, "model.kun")
    t0 = time.perf_counter()
    ts = qwen3_hf_tensors(torch, card, seed=51)
    t1 = time.perf_counter()
    write_kun(kun, cfg, ts)
    write_tokenizer_dat(os.path.join(d, "tokenizer.dat"))
    t2 = time.perf_counter()
    say(f"[kun] Qwen3-0.6B .kun: {os.path.getsize(kun) / 1e9:.2f} GB "
        f"(tensors made in {t1 - t0:.1f} s, written in {t2 - t1:.1f} s)")
    kcard, kp, kcfg = load_kun_model(kun)
    torch.cuda.synchronize()
    say(f"  load_kun_model: {time.perf_counter() - t2:.1f} s; card L="
        f"{kcard.n_layer} E={kcard.n_embd} V={kcard.vocab_size} tie="
        f"{kcard.tie_embeddings}")
    if kcfg != cfg or kcard != card:
        fail(f"load_kun_model: the embedded config did not come back: "
             f"{kcard}")
    want = _map_llama_family(kcard, ts, torch.bfloat16,
                             torch.device("cuda"))
    a, b = flatten_with_path(kp), flatten_with_path(want)
    if [x for x, _ in a] != [x for x, _ in b]:
        fail("load_kun_model: the param tree is not the written one's")
    for (path, x), (_, y) in zip(a, b):
        if not torch.equal(x, y):
            fail(f"load_kun_model: {path} is not the tensor written")
    say(f"  every one of {len(a)} params torch.equal to the tensors written")
    del kp, want, ts, a, b
    torch.cuda.empty_cache()
    tmm.INT8_GEMV = "mxu"
    turns, counts = _chat(torch, [
        "--hf", kun, "--prompts", *CHAT_PROMPTS, "--bits", "8", "--kv-bits",
        "8", "--max-new", "64", "--temperature", "0", "--csv",
        os.path.join(ROOT, "build", "kun_chat.csv")], "bubble on the .kun")
    tmm.INT8_GEMV = "dot"
    for name in ("qmv_int8", "decode_attn", "kv_write", "flash_fwd"):
        if counts.get(name, 0) <= 0:
            fail(f"bubble on the .kun: kernel {name} was not launched")
    fused_write_check(counts, "bubble on the .kun")
    for t in turns:
        if min(t["tokens"]) < 0 or max(t["tokens"]) >= card.vocab_size:
            fail("bubble on the .kun: token ids out of the vocabulary")
    shutil.rmtree(d)
    return counts


def qjl_phase(torch) -> dict:
    """``generate`` on Qwen3-0.6B (configs/qwen3_0.6b.json, seeded weights)
    with INT4 RTN g128 weights and a layered QJL KV cache (B 32 x 128-token
    prompts, 64 new, S 1024, decode_chunk 16, T 0.6 / top-k 50 / top-p
    0.95): warm TTFT and decode tok/s over three rounds (median). Fails
    unless rows 1a, 3 and 4 launched and row 7 did not (QJL attends in plain
    PyTorch), and the tokens are in the vocabulary. Returns the launches."""
    from koifish_tpu_torch.config import SamplerCard
    from koifish_tpu_torch.dtypes import QFormat
    from koifish_tpu_torch.models import init_params
    from koifish_tpu_torch.quant import quantize_params
    from koifish_tpu_torch.serve import cache_for, generate
    from koifish_tpu_torch.utils import kernel_log
    p = load_config("qwen3_0.6b.json")
    card = p.model
    gen = torch.Generator(device="cuda")
    gen.manual_seed(61)
    with torch.no_grad():
        qp = quantize_params(init_params(card, gen), p.quant, card)
    B, S, P, NEW = 32, 1024, 128, 64
    say(f"[qjl] Qwen3-0.6B INT4 RTN g128 + a QJL KV cache (sketch "
        f"{2 * card.head_dim} bits a key), B={B}, S={S}, P={P}, {NEW} new")
    sampler = SamplerCard(temperature=0.6, top_k=50, top_p=0.95)
    prompts = torch.randint(0, card.vocab_size, (B, P), generator=gen,
                            device="cuda", dtype=torch.int64)

    def fresh():
        c = cache_for(card, B, S, fmt=QFormat.QJL, layered=True)
        torch.cuda.synchronize()
        return c

    generate(card, qp, prompts, fresh(), sampler=sampler, max_new_tokens=17,
             decode_chunk=16)
    torch.cuda.synchronize()
    REPS = 3
    kernel_log.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    ttfts, steps = [], []
    for _ in range(REPS):
        c = fresh()
        t0 = time.perf_counter()
        generate(card, qp, prompts, c, sampler=sampler, max_new_tokens=1)
        torch.cuda.synchronize()
        ttfts.append(time.perf_counter() - t0)
        c = fresh()
        t0 = time.perf_counter()
        toks, c = generate(card, qp, prompts, c, sampler=sampler,
                           max_new_tokens=NEW, decode_chunk=16)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0 - ttfts[-1]) / (NEW - 1))
    counts = kernel_log.launches()
    ttft, step = sorted(ttfts)[REPS // 2], sorted(steps)[REPS // 2]
    say(f"  warm TTFT: median {ttft * 1e3:.2f} ms; runs "
        f"{[round(t * 1e3, 2) for t in ttfts]}")
    say(f"  decode: median {step * 1e3:.3f} ms/step, {B / step:.1f} tok/s; "
        f"runs {[round(B / s, 1) for s in steps]} tok/s")
    say(f"  peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{json.dumps(counts)}")
    for name in ("flash_fwd", "qmm", "qmv"):
        if counts.get(name, 0) <= 0:
            fail(f"qjl: kernel {name} was not launched")
    for name in ("decode_attn", "kv_write", "slot_write"):
        if counts.get(name, 0):
            fail(f"qjl: {counts[name]} {name} launches on the QJL path")
    if tuple(toks.shape) != (B, NEW) or int(toks.min()) < 0 \
            or int(toks.max()) >= card.vocab_size:
        fail(f"qjl: generate returned {tuple(toks.shape)} tokens out of "
             f"range")
    from koifish_tpu_torch.ops.sampling import sample_logits
    from koifish_tpu_torch.serve import decode_step_layered

    def chunk():
        lc, t = c, toks[:, -1].to(torch.int32)
        for _ in range(16):
            logits, lc = decode_step_layered(card, qp, t, lc, streaming=False)
            t = sample_logits(gen, logits, sampler.temperature,
                              sampler.top_k, sampler.top_p)
    profile_window(torch, f"QJL decode chunk of 16 steps (B={B})", chunk, 16)
    del qp, c
    torch.cuda.empty_cache()
    return counts


def qjl_reference_check(torch) -> None:
    """A tiny INT4 g128 model with a QJL cache: a fresh prefill and one
    decode step's logits (5e-2) and 12 greedy tokens of ``generate`` (at
    least 75 % equal) on the card against the CPU."""
    from koifish_tpu_torch.config import QuantCard, SamplerCard
    from koifish_tpu_torch.dtypes import QFormat
    from koifish_tpu_torch.models import init_params
    from koifish_tpu_torch.quant import quantize_params
    from koifish_tpu_torch.serve import cache_for, decode_step, generate
    from koifish_tpu_torch.serve import prefill
    card = _tiny_card()
    qc = QuantCard.from_json({"self_attn": {"bits": 4}, "mlp": {"bits": 4},
                              "group_size": 128})
    p_cpu = quantize_params(init_params(card, device="cpu", seed=62), qc,
                            card, device="cpu")
    p_gpu = {"wte": p_cpu["wte"].to("cuda"), "ln_f": p_cpu["ln_f"].to("cuda"),
             "layers": [{k: v.to("cuda") for k, v in lp.items()}
                        for lp in p_cpu["layers"]]}
    prompt = torch.randint(0, 256, (4, 70),
                           generator=torch.Generator().manual_seed(63))
    out = {}
    for dev, params in (("cpu", p_cpu), ("cuda", p_gpu)):
        c = cache_for(card, 4, 96, fmt=QFormat.QJL, device=dev)
        _, c = prefill(card, params, prompt[:, :-1].to(dev), c, fresh=True,
                       device=dev)
        logits, _ = decode_step(card, params, prompt[:, -1].to(dev), c)
        c = cache_for(card, 4, 96, fmt=QFormat.QJL, layered=True, device=dev)
        toks, _ = generate(card, params, prompt, c,
                           sampler=SamplerCard(temperature=0.0),
                           max_new_tokens=12, decode_chunk=4, device=dev)
        out[dev] = (logits.cpu(), toks.cpu())
    check("tiny QJL decode-step logits, card vs CPU",
          max_err(out["cpu"][0], out["cuda"][0]), 5e-2)
    _agree("generate on a QJL cache", out["cpu"][1], out["cuda"][1])


def slice13_phase(torch) -> dict:
    """Slice 13 on the card: gama training through the CLI, distillation, a
    ``.kun`` model through ``bubble`` and QJL serving, each at Qwen3-0.6B's
    full width and DEPTH layers with its launches counted from 0, and each with
    its tiny card-against-CPU check. Returns each path's launches."""
    import shutil
    root = os.path.join(ROOT, "build", "slice13")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t0 = time.perf_counter()
    runs = {"gama": gama_cli(torch, root)}
    gama_reference_check(torch, root)
    shutil.rmtree(root)
    runs["distill"] = distill_phase(torch)
    distill_reference_check(torch)
    runs["kun_bubble"] = kun_phase(torch)
    runs["qjl"] = qjl_phase(torch)
    qjl_reference_check(torch)
    say(f"[slice13] phase: {time.perf_counter() - t0:.1f} s; launches "
        f"{json.dumps(runs)}")
    return runs


# ---------------------------------------------------------------------------
# slice 14: the sequence-parallel ring (row 13) and koifish --sp
# ---------------------------------------------------------------------------

#: the ring's card shape: Qwen3-0.6B's attention at the SFT config's n_ctx
RING_SHAPE = (1, 8192, 16, 8, 128)            # B, T, Hq, Hkv, D
RING_SPS = (4, 2, 8)                          # sp 4 first: the main run
#: (label, B, T, Hq, Hkv, D, sp, q dtype): ragged Tl (rows and keys past a
#: tile), f32 q, batch strides, g 1, 3 and 8
RING_CASES = [
    ("B2 T1000 Hq8 Hkv1 D64 f32 sp4", 2, 1000, 8, 1, 64, 4, "f32"),
    ("B3 T384 Hq4 Hkv4 D128 f32 sp3", 3, 384, 4, 4, 128, 3, "f32"),
    ("B1 T2048 Hq12 Hkv4 D64 bf16 sp8", 1, 2048, 12, 4, 64, 8, "bf16"),
    ("B2 T640 Hq16 Hkv8 D128 bf16 sp2", 2, 640, 16, 8, 128, 2, "bf16"),
]
#: the one-piece attention's gate: the JAX ring test's 2e-2
RING_FULL_TOL = 2e-2
#: the gate against the plain version: |Δ| <= 2^-7·|plain| + RING_ABS. The
#: kernel's exp and its dot's summation order differ from PyTorch's in the
#: last f32 bits, which now and then flips a p's rounding to bf16; one flip
#: moves an output by 2^-8·p·|v|/l (measured <= 4.7e-4 in f32 outputs)
RING_ABS = 2e-3


def ring_bound(B, T, Hq, Hkv, D, sp, q_bytes):
    """(bytes, flops, design bytes) of the ring: q, k, v read and the
    output written once, and the causal pairs' 4·D flops each, make the
    bound; the design's own traffic is apart from it: the bf16 slot fill
    (read and written), the sp(sp-1)/2 chunks forwarded (written: the
    sender reads them for its own product) and the carried state (o, m, l
    in f32, written by a rank's r non-last launches and read by its r
    non-first ones)."""
    Tl = T // sp
    kv = 2 * B * Tl * Hkv * D * 2                  # a chunk's K and V, bf16
    state = B * Tl * Hq * (D + 2) * 4
    nbytes = 2 * B * T * Hq * D * q_bytes + 2 * B * T * Hkv * D * 2
    design = sp * 2 * kv + sp * (sp - 1) // 2 * kv + sp * (sp - 1) * state
    flops = 4 * D * Hq * B * T * (T + 1) // 2
    return nbytes, flops, design


def ring_ptxas(name: str = "ring_attn") -> str:
    """ptxas's registers and spill bytes of each instantiation of the ring's
    step kernel (D, f32 q), from the build log; fails on a spill."""
    from koifish_tpu_torch.ops.kernels import _build
    rows, fn = [], None
    for ln in _build.log_path(name).read_text().splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?(\w+)", ln)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and fn and "ring_step_kernel" in fn:
            spill = (int(m.group(1)), int(m.group(2)))
            if any(spill):
                fail(f"ptxas: {fn} spills {spill} bytes (stores, loads)")
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn and "ring_step_kernel" in fn:
            t = re.search(r"ILi(\d+)ELb([01])E", fn)
            rows.append(f"D{t.group(1)} {'f32' if t.group(2) == '1' else 'bf16'}"
                        f" q: {m.group(1)} registers" if t else
                        f"{fn}: {m.group(1)} registers")
    if not rows:
        fail(f"ptxas: no ring_step_kernel in {_build.log_path(name)}")
    return "; ".join(rows)


def _ring_one_piece(torch, q, k, v):
    """Causal attention over the whole sequence in f32, head by kv head
    (the [B, g, T, T] logits of one kv head at a time)."""
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    g = Hq // Hkv
    out = torch.empty((B, T, Hq, D), dtype=torch.float32, device=q.device)
    mask = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    for h in range(Hkv):
        qh = q[:, :, h * g:(h + 1) * g].float().transpose(1, 2)  # [B,g,T,D]
        kh = k[:, :, h].float()                                  # [B,T,D]
        s = torch.einsum("bgtd,bsd->bgts", qh, kh) * D ** -0.5
        s = torch.where(mask, s, -1e30).softmax(-1)
        out[:, :, h * g:(h + 1) * g] = torch.einsum(
            "bgts,bsd->btgd", s, v[:, :, h].float())
        del s
    return out


def ring_phase(torch, gen):
    """Row 13, the kernel ring (``csrc/ring_attn.cu``), on virtual ranks of
    the one card: at the card shape (B 1 x T 8192, Hq 16, Hkv 8, D 128) at
    sp 4 (the main run: launches counted from 0), 2 and 8, and at four
    smaller shapes (ragged, f32 q, g 1-8); each against the kernel's plain
    version entry by entry (|Δ| <= 2^-7·|plain| + RING_ABS) and against
    one-piece causal attention (2e-2, the JAX ring test's); a repeat of the
    main run bit for bit; two planted faults must be rejected: each rank
    sends to the wrong neighbour (every launch past step 0 reads a chunk
    from the wrong source, or a slot nobody filled: the faulty transport's
    slots start zeroed), and every launch past the diagonal starts from a
    fresh state (o = 0, m = -1e30, l = 0). Times the ring (CUDA-graph
    replay of its launches, and eager with CUDA events around the call),
    its plain version and SDPA on the whole sequence. The ranks share the
    card's SMs and the forwarded chunks go through HBM, not NVLink."""
    from koifish_tpu_torch.ops.kernels import ring_attn as ra
    from koifish_tpu_torch.parallel import (make_mesh,
                                            ring_attention_pallas_sharded)
    from koifish_tpu_torch.parallel.ring_attention import shard_seq
    from koifish_tpu_torch.utils import kernel_log
    F = torch.nn.functional
    say("[kernels] ring_attn (koifish_tpu_torch/csrc/ring_attn.cu): the "
        "sequence-parallel ring on virtual ranks of one card (they share "
        "its SMs; the forwarded chunks go through HBM, not NVLink)")
    say(f"  ptxas ring_step_kernel: {ring_ptxas()}")

    def rnd(B, T, H, D, dtype):
        return torch.randn((B, T, H, D), generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)

    class Skewed(ra.LocalTransport):
        def __init__(self, *a):
            super().__init__(*a)
            for buf in self._buf.values():
                for x in buf:
                    x.zero_()

        def peer(self, r):
            return (r + 2) % self.n if self.n > 2 else r

    real_desc = ra._desc

    def fresh_desc(ptrs, q_off, k_off, slot, send, first, last):
        return real_desc(ptrs, q_off, k_off, slot, send, True, last)

    def check_case(label, q, k, v, sp, ring):
        dev = torch.device("cuda", torch.cuda.current_device())
        chunks = [shard_seq(x, [dev] * sp) for x in (q, k, v)]
        plain = torch.cat(ra.ring_plain(*chunks), dim=1)
        full = _ring_one_piece(torch, q, k, v)
        err = _paged_gate(f"ring {label} vs its plain version", ring, plain,
                          RING_ABS)
        err_full = max_err(ring, full)
        check(f"ring {label} vs one-piece attention", err_full,
              RING_FULL_TOL)
        faults = {"sends to the wrong neighbour": lambda: ra.ring_attention(
            *chunks, transport=Skewed),
            "each launch past the diagonal from a fresh state":
            lambda: ra.ring_attention(*chunks)}
        for what, run in faults.items():
            ra._desc = fresh_desc if "fresh" in what else real_desc
            try:
                bad = torch.cat(run(), dim=1)
                torch.cuda.synchronize()
            finally:
                ra._desc = real_desc
            rel_bad = paged_rel(bad, plain, RING_ABS)
            say(f"  planted fault ({what}): |Δ|/(2^-7·|plain| + "
                f"{RING_ABS:.0e})={rel_bad:.3e}, must be > 1")
            if not rel_bad > 1.0:
                fail(f"ring {label}: the planted fault ({what}) was not "
                     f"rejected")
            del bad
        del plain, full
        return err

    for label, B, T, Hq, Hkv, D, sp, dt in RING_CASES:
        dtype = torch.float32 if dt == "f32" else torch.bfloat16
        q = rnd(B, T, Hq, D, dtype)
        k, v = rnd(B, T, Hkv, D, dtype), rnd(B, T, Hkv, D, dtype)
        mesh = make_mesh({"sp": sp}, devices="cuda")
        ring = ring_attention_pallas_sharded(mesh, "sp")(q, k, v)
        torch.cuda.synchronize()
        if ring.dtype != dtype or ring.shape != q.shape:
            fail(f"ring {label}: out {ring.dtype} {tuple(ring.shape)}")
        check_case(label, q, k, v, sp, ring)

    B, T, Hq, Hkv, D = RING_SHAPE
    q = rnd(B, T, Hq, D, torch.bfloat16)
    k = rnd(B, T, Hkv, D, torch.bfloat16)
    v = rnd(B, T, Hkv, D, torch.bfloat16)
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    library = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True, enable_gqa=True), iters=10)
    res, counts = {}, {}
    for sp in RING_SPS:
        mesh = make_mesh({"sp": sp}, devices="cuda")
        fn = ring_attention_pallas_sharded(mesh, "sp")
        torch.cuda.synchronize()
        kernel_log.reset_launches()
        out = fn(q, k, v)
        torch.cuda.synchronize()
        counts[sp] = kernel_log.launches()
        label = f"B{B} T{T} Hq{Hq} Hkv{Hkv} D{D} bf16 sp{sp}"
        say(f"  {label}: launches {json.dumps(counts[sp])} (sp = {sp}: one "
            f"a step for all the ranks of the card)")
        if counts[sp] != {"ring_attn": sp}:
            fail(f"ring {label}: launches {counts[sp]}")
        err = check_case(label, q, k, v, sp, out)
        again = fn(q, k, v)
        torch.cuda.synchronize()
        if not torch.equal(again.view(torch.int16), out.view(torch.int16)):
            fail(f"ring {label}: a repeat differs in "
                 f"{bits_differ(again, out):.0f} entries")
        del again
        ms = time_ms(torch, lambda: fn(q, k, v), iters=10)
        eager = event_ms(torch, lambda: fn(q, k, v), iters=10)
        dev = torch.device("cuda", torch.cuda.current_device())
        chunks = [shard_seq(x, [dev] * sp) for x in (q, k, v)]
        plain = time_ms(torch, lambda: ra.ring_plain(*chunks), iters=2,
                        warm=1)
        nbytes, flops, design = ring_bound(B, T, Hq, Hkv, D, sp, 2)
        bound, by = bound_ms(nbytes, flops)
        say(f"  {label}: ring {ms:.4f} ms (graph replay; eager, events "
            f"around the call: {eager:.4f}), {flops / ms / 1e9:.1f} TFLOP/s "
            f"on the causal pairs, plain {plain:.4f}, SDPA on the whole "
            f"sequence {library:.4f}; bound {bound:.5f} ({by}: "
            f"{flops:.4e} flops of the causal pairs, {nbytes / 1e6:.2f} MB "
            f"of q, k, v and the output); the design moves "
            f"{design / 1e6:.2f} MB more (the fill, the forwarded chunks "
            f"and the state), {design / PEAK_BYTES * 1e3:.5f} ms at the "
            f"memory rate")
        res[sp] = dict(max_abs_err=err, ms=ms, eager_ms=eager, plain_ms=plain,
                       bound_ms=bound, bound_by=by, library_ms=library,
                       launches=counts[sp])
        del out, chunks
    torch.cuda.empty_cache()
    main = dict(res[RING_SPS[0]])
    main["by_sp"] = {str(sp): {k_: r[k_] for k_ in
                               ("ms", "eager_ms", "plain_ms", "bound_ms",
                                "max_abs_err", "launches")}
                     for sp, r in res.items()}
    return main, counts[RING_SPS[0]]


SP_STEPS = 4
SP_WAYS = 4


def sp_reference_check(torch) -> None:
    """A tiny QWEN3 step, sequence-parallel over 2 virtual ranks, on the
    card against the CPU (the bf16 step's tolerances: loss 1e-2, grad
    norms 2 %, updated params 2·lr + 1 ulp)."""
    from koifish_tpu_torch.config import ModelCard, TrainCard
    card = ModelCard.from_arch("QWEN3", vocab_size=512, n_layer=2, n_embd=128,
                               n_head=2, n_kv_head=1, head_dim=64, n_ffn=256,
                               n_ctx=64, max_pos=128)
    tcard = TrainCard(batch=4, lr=1e-3, warmup=0, scheduler="static",
                      fused_ce=True, stochastic_round=False,
                      check_tensor_norm=True, remat=True)
    _step_card_vs_cpu(torch, "tiny QWEN3 sp-2 train step", card, tcard, 512,
                      1e-2, 2e-2, TOL_HEAD, sp=2)


def _sp_config(root: str):
    """configs/qwen3_0.6b.json as shipped with its train glob on a seeded
    shard under ``root`` (one 1024-token sequence repeated, so that every
    batch is the same and the losses move only with the updates): the
    config's path, its JSON and its ``CLIParams``."""
    from koifish_tpu_torch.config import CLIParams
    with open(os.path.join(ROOT, "configs", "qwen3_0.6b.json")) as f:
        cfg = cut_config(json.load(f))
    cfg["datasets"]["train"]["glob"] = os.path.join(root, "*train*.bin")
    cfgp = os.path.join(root, "qwen3_sp.json")
    with open(cfgp, "w") as f:
        json.dump(cfg, f, indent=1)
    p = CLIParams.load(cfgp)
    T = p.model.n_ctx
    write_token_shard(os.path.join(root, "qwen3_train_000.bin"),
                      p.model.vocab_size, 2 * SP_STEPS * p.train.batch
                      * (T + 1), seed=41, period=T)
    return cfgp, cfg, p


def sp_train_phase(torch) -> dict:
    """``koifish --sp 4`` on configs/qwen3_0.6b.json as shipped (fake-quant
    INT4 g128 QAT, remat, warmup 700, B 16 x 1024), its train glob on a
    seeded shard (``_sp_config``), at full width and DEPTH layers for
    ``SP_STEPS`` steps: four ranks of a dp=1 tp=1 sp=4 mesh on the one
    card, the model's attention the plain ring over them. Fails unless the
    mesh line names sp=4, the losses are finite and fall, step 0's loss is
    within 1e-2 relative of ``--sp 1``'s on the same batch, no flash
    forward launched (the ring takes the attention) and the fused CE's
    forward launched once a step. Then the tiny sp-2 step card vs CPU.
    Returns the sp run's launches."""
    import math
    import shutil
    from koifish_tpu_torch.cli import koifish
    root = os.path.join(ROOT, "build", "sp")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t0 = time.perf_counter()
    cfgp, _, p = _sp_config(root)
    card, tcard = p.model, p.train
    B, T = tcard.batch, card.n_ctx
    say(f"[sp] configs/qwen3_0.6b.json, train glob on a seeded shard: "
        f"{card.n_layer} layers, E {card.n_embd}, V {card.vocab_size}, B {B} "
        f"x {T}, remat {tcard.remat}, QAT rules {len(p.quant.rules)}")
    res1, _, _ = run_cli(torch, koifish.main, [
        cfgp, "--most-iter", "2", "--out-dir", os.path.join(root, "sp1")],
        "koifish --sp 1 (2 steps)")
    base, dt1 = res1["infos"].losses[0], res1["infos"].rows[1][3]
    del res1
    torch.cuda.empty_cache()
    res, out, counts = run_cli(torch, koifish.main, [
        cfgp, "--most-iter", str(SP_STEPS), "--sp", str(SP_WAYS),
        "--out-dir", os.path.join(root, "sp4")],
        f"koifish --sp {SP_WAYS} ({SP_STEPS} steps)")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    line = [ln for ln in out.splitlines() if "[koifish] mesh" in ln]
    say(f"  {line}")
    if not line or f"sp={SP_WAYS} on 1 device(s)" not in line[0]:
        fail(f"koifish --sp {SP_WAYS}: no mesh line naming sp={SP_WAYS} on "
             f"the one card: {line}")
    infos = res["infos"]
    losses = infos.losses
    dts = [r[3] for r in infos.rows]
    dt = sorted(dts[1:])[len(dts[1:]) // 2]
    say(f"  losses {[round(x, 6) for x in losses]} (--sp 1 step 0: "
        f"{base:.6f}); step ms {[round(d * 1e3, 1) for d in dts]}; median "
        f"of steps 1-{SP_STEPS - 1}: {dt * 1e3:.1f} ms, {B * T / dt:.1f} "
        f"tok/s (--sp 1 step 1: {dt1 * 1e3:.1f} ms); peak device memory "
        f"{peak:.2f} GiB; {SP_WAYS} ranks on {torch.cuda.get_device_name(0)}")
    if len(losses) != SP_STEPS or not all(math.isfinite(x) for x in losses):
        fail(f"koifish --sp {SP_WAYS}: losses {losses}")
    if not losses[-1] < losses[0]:
        fail(f"koifish --sp {SP_WAYS}: the loss did not fall "
             f"({losses[0]} -> {losses[-1]})")
    check(f"koifish --sp {SP_WAYS} step 0 loss vs --sp 1 (relative)",
          abs(losses[0] - base) / base, 1e-2)
    if counts.get("flash_fwd", 0) or counts.get("fused_ce_fwd", 0) \
            != SP_STEPS:
        fail(f"koifish --sp {SP_WAYS}: launches {counts}: the ring takes "
             f"the attention (no flash_fwd), the fused CE one forward a step")
    del res, infos
    torch.cuda.empty_cache()
    shutil.rmtree(root)
    sp_reference_check(torch)
    say(f"[sp] phase: {time.perf_counter() - t0:.1f} s")
    return counts


# ---------------------------------------------------------------------------
# slice 16: the model zoo's MoE and MLA serving paths
# ---------------------------------------------------------------------------

#: Qwen/Qwen3-30B-A3B's config.json (the keys ModelCard.from_hf reads)
QWEN3_30B_A3B = {
    "model_type": "qwen3_moe", "vocab_size": 151936, "hidden_size": 2048,
    "intermediate_size": 6144, "moe_intermediate_size": 768,
    "num_hidden_layers": 48, "num_attention_heads": 32,
    "num_key_value_heads": 4, "head_dim": 128, "num_experts": 128,
    "num_experts_per_tok": 8, "norm_topk_prob": True,
    "max_position_embeddings": 40960, "rope_theta": 1000000.0,
    "rms_norm_eps": 1e-06, "tie_word_embeddings": False}
#: deepseek-ai/DeepSeek-V2-Lite's config.json. ModelCard.from_hf reads no
#: n_routed_experts (the JAX package's reading): MLA attention and a dense
#: 10944-wide FFN on every layer
DEEPSEEK_V2_LITE = {
    "model_type": "deepseek_v2", "vocab_size": 102400, "hidden_size": 2048,
    "intermediate_size": 10944, "moe_intermediate_size": 1408,
    "num_hidden_layers": 27, "num_attention_heads": 16,
    "num_key_value_heads": 16, "n_routed_experts": 64, "n_shared_experts": 2,
    "num_experts_per_tok": 6, "kv_lora_rank": 512, "q_lora_rank": None,
    "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "v_head_dim": 128,
    "max_position_embeddings": 163840, "rope_theta": 10000,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40,
                     "mscale": 0.707, "mscale_all_dim": 0.707,
                     "original_max_position_embeddings": 4096,
                     "type": "yarn"},
    "rms_norm_eps": 1e-06, "tie_word_embeddings": False}
ZOO_QUANT = {"self_attn": {"bits": 4}, "mlp": {"bits": 4}, "group_size": 128}
ZOO_B, ZOO_P, ZOO_NEW, ZOO_S = 8, 128, 32, 256
ZOO_BUBBLE_LAYERS = 2


def _nbytes(tree) -> int:
    from koifish_tpu_torch.utils.tree import leaves
    return sum(x.numel() * x.element_size() for x in leaves(tree))


def _zoo_params(torch, card, seed: int):
    """Seeded weights drawn on the card layer by layer (``init_params`` on
    the device), quantized by ZOO_QUANT; prints the bytes before and
    after. The 3-D expert stacks stay bf16, as the JAX rules leave them."""
    from koifish_tpu_torch.config import QuantCard
    from koifish_tpu_torch.models import init_params
    from koifish_tpu_torch.quant import quantize_params
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    with torch.no_grad():
        params = init_params(card, gen, device="cuda")
        bf16 = _nbytes(params)
        qp = quantize_params(params, QuantCard.from_json(ZOO_QUANT), card,
                             device="cuda")
    del params
    torch.cuda.synchronize()
    experts = sum(lp[k].numel() * 2 for lp in qp["layers"]
                  for k in ("egate", "eup", "edown") if k in lp)
    say(f"  weights: {bf16 / 1e9:.2f} GB bf16 drawn on the device, "
        f"{_nbytes(qp) / 1e9:.2f} GB served ({experts / 1e9:.2f} GB of "
        f"bf16 expert stacks) in {time.perf_counter() - t0:.1f} s")
    return qp


def _zoo_want(card, qp, new: int) -> dict:
    """The launches one ``generate`` of ZOO_B x ZOO_P prompts and ``new``
    tokens makes, from the layer count and shapes: the prefill's flash
    forward a layer (none where dv != d), one GEMM (row 3, m = B·P) per
    quantized projection, and per decode step one GEMV (row 4, m = B) per
    quantized projection and one fused write-and-attend (row 7) a layer."""
    from koifish_tpu_torch.quant.qtensor import QTensor
    nq = sum(isinstance(v, QTensor) for lp in qp["layers"]
             for v in lp.values())
    steps = new - 1
    return {"flash_fwd": card.n_layer if card.attn != "mla" else 0,
            "qmm": nq, "qmv": nq * steps, "decode_attn": card.n_layer * steps,
            "kv_write": card.n_layer * steps, "slot_write": 0}


def _zoo_serve(torch, label, card, qp, gen, B=ZOO_B, P=ZOO_P, NEW=ZOO_NEW,
               S=ZOO_S, sampler=None, chunk=8) -> tuple:
    """``generate`` at B x P-token prompts, NEW new tokens (ZOO_B, ZOO_P and
    ZOO_NEW unless given), temperature 0 (or ``sampler``), a layered INT8
    KV cache of S slots, ``chunk`` steps a dispatch: warm TTFT (median of
    3), decode tok/s (two runs), peak memory, the launches of the first run
    against ``_zoo_want`` (exact) and its fallbacks; one decode step
    profiled. Returns (tokens, launches, prompts, numbers)."""
    from koifish_tpu_torch.config import SamplerCard
    from koifish_tpu_torch.dtypes import QFormat
    from koifish_tpu_torch.serve import cache_for, decode_step_layered
    from koifish_tpu_torch.serve import generate
    from koifish_tpu_torch.utils import kernel_log
    prompts = torch.randint(0, card.vocab_size, (B, P), generator=gen,
                            device="cuda", dtype=torch.int64)
    sampler = sampler or SamplerCard(temperature=0.0)

    def fresh():
        return cache_for(card, B, S, fmt=QFormat.INT8, layered=True,
                         device="cuda")

    generate(card, qp, prompts, fresh(), sampler=sampler, max_new_tokens=3,
             decode_chunk=chunk, device="cuda")                 # warm
    torch.cuda.synchronize()
    ttfts = []
    for _ in range(3):
        c = fresh()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generate(card, qp, prompts, c, sampler=sampler, max_new_tokens=1,
                 device="cuda")
        torch.cuda.synchronize()
        ttfts.append(time.perf_counter() - t0)
    ttft = sorted(ttfts)[1]
    torch.cuda.reset_peak_memory_stats()
    steps, counts, falls, toks, by_k = [], None, None, None, None
    for run in range(2):
        c = fresh()
        torch.cuda.synchronize()
        kernel_log.reset_launches()
        t0 = time.perf_counter()
        out, c = generate(card, qp, prompts, c, sampler=sampler,
                          max_new_tokens=NEW, decode_chunk=chunk,
                          device="cuda")
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0 - ttft) / (NEW - 1))
        if run == 0:
            toks, counts = out, kernel_log.launches()
            falls, by_k = kernel_log.fallbacks(), kernel_log.launches_by_k()
    peak = torch.cuda.max_memory_allocated() / 2**30
    step = sorted(steps)[0]
    say(f"  {label}: warm TTFT {ttft * 1e3:.2f} ms (runs "
        f"{[round(t * 1e3, 2) for t in ttfts]}); decode "
        f"{step * 1e3:.3f} ms a step, {B / step:.1f} tok/s (runs "
        f"{[round(B / x, 1) for x in steps]}); peak device memory "
        f"{peak:.2f} GiB")
    say(f"  {label} launches {json.dumps(counts)}; fallbacks "
        f"{json.dumps(falls)}")
    want = _zoo_want(card, qp, NEW)
    got = {k: counts.get(k, 0) for k in want}
    if got != want:
        fail(f"{label}: launches {got}, the path's shapes give {want}")
    want_falls = ({"flash_attention": card.n_layer} if card.attn == "mla"
                  else {})
    if falls != want_falls:
        fail(f"{label}: fallbacks {falls}, expected {want_falls}")
    if tuple(toks.shape) != (B, NEW) or int(toks.min()) < 0 \
            or int(toks.max()) >= card.vocab_size:
        fail(f"{label}: generate returned {tuple(toks.shape)} tokens out of "
             f"range")
    tok = toks[:, -1].to(torch.int32)
    profile_window(torch, f"{label} decode step (B={B})",
                   lambda: decode_step_layered(card, qp, tok, c,
                                               streaming=False))
    return toks, counts, prompts, dict(ttft_ms=ttft * 1e3,
                                       step_ms=step * 1e3,
                                       tok_s=B / step, peak_gib=peak,
                                       by_k=by_k)


def _moe_drops(torch, card, qp, prompts) -> None:
    """One more greedy ``generate`` with ``models/moe.moe_ffn`` wrapped:
    each call's routes recomputed from its router logits
    (``models/moe.route``), the (token, expert) assignments the capacity
    drops counted apart in the prefill and in the decode steps, and the
    experts live in each decode step's layer."""
    from koifish_tpu_torch.config import SamplerCard
    from koifish_tpu_torch.dtypes import QFormat
    from koifish_tpu_torch.models import moe as tmoe
    from koifish_tpu_torch.models import transformer as ttr
    from koifish_tpu_torch.serve import cache_for, generate
    tally = {"prefill": [0, 0], "decode": [0, 0]}
    live, orig = [], ttr.moe_ffn

    def counted(card_, lp, x, *a, **kw):
        r = tmoe.route(card_, lp["router"], x.reshape(-1, x.shape[-1]))
        part = tally["prefill" if x.shape[1] > 1 else "decode"]
        part[0] += int((~r.keep).sum())
        part[1] += r.keep.numel()
        if x.shape[1] == 1:
            live.append(int(torch.unique(r.expert[r.keep]).numel()))
        return orig(card_, lp, x, *a, **kw)
    ttr.moe_ffn = counted
    try:
        generate(card, qp, prompts,
                 cache_for(card, ZOO_B, ZOO_S, fmt=QFormat.INT8,
                           layered=True, device="cuda"),
                 sampler=SamplerCard(temperature=0.0),
                 max_new_tokens=ZOO_NEW, decode_chunk=8, device="cuda")
    finally:
        ttr.moe_ffn = orig
    for part, (d, n) in tally.items():
        say(f"  dropped (token, expert) assignments, {part}: {d} of {n} "
            f"({100.0 * d / max(n, 1):.3f} %; capacity "
            f"{tmoe.capacity(card, ZOO_B * (ZOO_P if part == 'prefill' else 1))}"
            f")")
    say(f"  live experts a decode layer: min {min(live)}, mean "
        f"{sum(live) / len(live):.1f}, max {max(live)} of {card.n_experts}")


def _moe_hf_tensors(torch, card, seed: int) -> dict:
    """HF-named bf16 CPU tensors of a Qwen3-MoE model at ``card``'s dims
    (seeded normal(0.02) drawn on the card, norms 1): the router
    ``mlp.gate`` and each expert's three projections, an untied head."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    E, D, Fm = card.n_embd, card.head_dim, card.moe_ffn

    def w(*shape):
        return (torch.randn(shape, generator=gen, device="cuda") * 0.02
                ).to(torch.bfloat16).cpu()

    def ones(n):
        return torch.ones((n,), dtype=torch.bfloat16)

    ts = {"model.embed_tokens.weight": w(card.vocab_size, E),
          "model.norm.weight": ones(E),
          "lm_head.weight": w(card.vocab_size, E)}
    for i in range(card.n_layer):
        pre = f"model.layers.{i}."
        ts.update({
            pre + "input_layernorm.weight": ones(E),
            pre + "self_attn.q_proj.weight": w(card.n_head * D, E),
            pre + "self_attn.k_proj.weight": w(card.n_kv_head * D, E),
            pre + "self_attn.v_proj.weight": w(card.n_kv_head * D, E),
            pre + "self_attn.o_proj.weight": w(E, card.n_head * D),
            pre + "self_attn.q_norm.weight": ones(D),
            pre + "self_attn.k_norm.weight": ones(D),
            pre + "post_attention_layernorm.weight": ones(E),
            pre + "mlp.gate.weight": w(card.n_experts, E)})
        for e in range(card.n_experts):
            ex = f"{pre}mlp.experts.{e}."
            ts.update({ex + "gate_proj.weight": w(Fm, E),
                       ex + "up_proj.weight": w(Fm, E),
                       ex + "down_proj.weight": w(E, Fm)})
    return ts


def zoo_bubble(torch) -> dict:
    """A Qwen3-30B-A3B-width HF folder of ZOO_BUBBLE_LAYERS layers (seeded
    bf16, the published config.json with its depth cut) through
    ``bubble.main --bits 4 --kv-bits 8 --temperature 0 --max-new 32``: the
    loader's MoE branch, the expert stacks bf16, rows 1a, 3, 4 and 7's
    fused write launched. Returns the launches."""
    import shutil
    from koifish_tpu_torch.io.safetensors import write_safetensors
    from koifish_tpu_torch.config import ModelCard
    hf = dict(QWEN3_30B_A3B, num_hidden_layers=ZOO_BUBBLE_LAYERS)
    card = ModelCard.from_hf(hf)
    path = os.path.join(ROOT, "build", "zoo_qwen3_moe")
    os.makedirs(path, exist_ok=True)
    t0 = time.perf_counter()
    ts = _moe_hf_tensors(torch, card, seed=161)
    write_safetensors(os.path.join(path, "model.safetensors"), ts)
    gb = sum(t.numel() * t.element_size() for t in ts.values()) / 1e9
    del ts
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf, f)
    write_tokenizer_json(path)
    say(f"[zoo] bubble on a Qwen3-30B-A3B-width folder of {card.n_layer} "
        f"layers: wrote {gb:.2f} GB in {time.perf_counter() - t0:.1f} s")
    argv = ["--hf", path, "--prompts", *CHAT_PROMPTS, "--bits", "4",
            "--kv-bits", "8", "--max-new", "32", "--temperature", "0",
            "--csv", os.path.join(ROOT, "build", "zoo_chat.csv")]
    turns, counts = _chat(torch, argv, "bubble Qwen3-MoE")
    shutil.rmtree(path)
    for name in ("flash_fwd", "qmm", "qmv", "kv_write"):
        if counts.get(name, 0) <= 0:
            fail(f"bubble Qwen3-MoE: kernel {name} was not launched")
    for t in turns:
        if min(t["tokens"]) < 0 or max(t["tokens"]) >= card.vocab_size:
            fail("bubble Qwen3-MoE: token ids out of the vocabulary")
    return counts


def _mla_latent(torch, card, qp, prompts, std_toks) -> dict:
    """The latent-cache path on the same prompts: ``mla_prefill`` and
    greedy ``mla_decode_step``s (TTFT, ms a step), its cache's bytes
    against the standard INT8 cache's, and its greedy choice at each step
    fed the standard path's tokens (teacher-forced) held against them:
    at least 75 % equal, the tiny gates' bound. Returns the launches."""
    from koifish_tpu_torch.dtypes import QFormat
    from koifish_tpu_torch.serve import cache_for
    from koifish_tpu_torch.serve.mla_cache import (mla_cache_for,
                                                   mla_decode_step,
                                                   mla_prefill)
    from koifish_tpu_torch.utils import kernel_log
    B, NEW = ZOO_B, ZOO_NEW
    fresh = lambda: mla_cache_for(card, B, ZOO_S, device="cuda")
    mla_prefill(card, qp, prompts, fresh())                         # warm
    torch.cuda.synchronize()
    ttfts = []
    for _ in range(3):
        c = fresh()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, c = mla_prefill(card, qp, prompts, c)
        tok = logits.argmax(-1)
        torch.cuda.synchronize()
        ttfts.append(time.perf_counter() - t0)
    kernel_log.reset_launches()
    free = [tok]
    t0 = time.perf_counter()
    for _ in range(NEW - 1):
        logits, c = mla_decode_step(card, qp, free[-1], c)
        free.append(logits.argmax(-1))
    torch.cuda.synchronize()
    step = (time.perf_counter() - t0) / (NEW - 1)
    counts = kernel_log.launches()
    free = torch.stack(free, dim=1)
    # teacher-forced on the standard path's tokens
    c = fresh()
    logits, c = mla_prefill(card, qp, prompts, c)
    choice = [logits.argmax(-1)]
    for i in range(NEW - 1):
        logits, c = mla_decode_step(card, qp, std_toks[:, i], c)
        choice.append(logits.argmax(-1))
    choice = torch.stack(choice, dim=1)
    forced = float((choice == std_toks).float().mean())
    running = float((free == std_toks).float().mean())
    lat = c.c_kv.numel() * 2 + c.k_rope.numel() * 2
    std = cache_for(card, B, ZOO_S, fmt=QFormat.INT8, layered=True,
                    device="cuda")
    std_b = sum(t.numel() * t.element_size() for part in
                (std.k, std.v, std.k_scale, std.v_scale) for t in part)
    ttft = sorted(ttfts)[1]
    say(f"  latent cache: warm TTFT {ttft * 1e3:.2f} ms (runs "
        f"{[round(t * 1e3, 2) for t in ttfts]}); decode {step * 1e3:.3f} "
        f"ms a step, {B / step:.1f} tok/s; launches {json.dumps(counts)}")
    say(f"  cache bytes at B {B}, S {ZOO_S}: latent (bf16 c_kv + k_rope) "
        f"{lat / 1e6:.2f} MB, standard INT8 K/V + scales {std_b / 1e6:.2f} "
        f"MB ({std_b / lat:.2f}x)")
    say(f"  greedy tokens, latent vs standard path: {forced * 100:.1f}% "
        f"equal teacher-forced (bound 75%), {running * 100:.1f}% free-"
        f"running")
    if forced < 0.75:
        fail("the latent path's greedy tokens disagree with the standard "
             "path's")
    return counts


ZOO_TINY_MOE = dict(vocab_size=256, n_layer=2, n_embd=128, n_head=2,
                    n_kv_head=1, head_dim=64, n_ffn=256, n_ctx=64,
                    max_pos=128, n_experts=8, n_experts_active=2, moe_ffn=128)
ZOO_TINY_HYBRID = {
    "arch": "QWEN3_MOE", "vocab_size": 256,
    "parameter": {"Layer": 4, "num_experts": 8, "num_experts_per_tok": 2,
                  "moe_intermediate_size": 128, "max_pos_embeddings": 128,
                  "transformer": {"Ctx": 64, "Embed": 128, "Head": 2,
                                  "KVHead": 1, "head_dim": 64, "Ffn": 256}},
    "backbone": {
        "embed_tokens": {"Embedding": []},
        "dense_a *1": {"self_attn": {"QKV": []}, "mlp": {"FFN": []}},
        "sparse_a *1": {"self_attn": {"QKV": []}, "mlp": {"MOE": []}},
        "dense_b *1": {"self_attn": {"QKV": []}, "mlp": {"FFN": []}},
        "sparse_b *1": {"self_attn": {"QKV": []}, "mlp": {"MOE": []}},
        "norm": {"Normal": []}, "output": {"CLASIFY": []}}}
ZOO_TINY_MLA = dict(vocab_size=256, n_layer=2, n_embd=128, n_head=2,
                    n_kv_head=2, n_ffn=256, n_ctx=64, max_pos=128,
                    attn="mla", q_lora_rank=32, kv_lora_rank=64,
                    qk_nope_head_dim=128, qk_rope_head_dim=64,
                    v_head_dim=128, head_dim=192)


def zoo_reference_check(torch) -> None:
    """Tiny cards on the card against the CPU (the same INT4 g128 weights,
    an INT8 cache): a 2-layer MoE card, a hybrid-backbone card (dense and
    MoE layers by turns) and a 2-layer MLA card; prefill logits within
    5e-2 and 12 greedy tokens of ``generate`` at least 75 % equal."""
    import dataclasses
    from koifish_tpu_torch.config import ModelCard, QuantCard, SamplerCard
    from koifish_tpu_torch.dtypes import QFormat
    from koifish_tpu_torch.models import init_params
    from koifish_tpu_torch.quant import quantize_params
    from koifish_tpu_torch.serve import cache_for, generate, prefill
    from koifish_tpu_torch.utils.tree import tree_map
    mla = dataclasses.replace(ModelCard.from_arch("DEEPSEEK"), **ZOO_TINY_MLA)
    cards = (("2-layer MoE", ModelCard.from_arch("QWEN3_MOE",
                                                 **ZOO_TINY_MOE)),
             ("hybrid-backbone MoE", ModelCard.from_json(ZOO_TINY_HYBRID)),
             ("2-layer MLA", mla))
    qc = QuantCard.from_json(ZOO_QUANT)
    for i, (label, card) in enumerate(cards):
        p_cpu = quantize_params(init_params(card, device="cpu", seed=160 + i),
                                qc, card, device="cpu")
        p_dev = tree_map(lambda t: t.to("cuda"), p_cpu)
        prompt = torch.randint(0, 256, (4, 70),
                               generator=torch.Generator().manual_seed(165))
        out = {}
        for dev, params in (("cpu", p_cpu), ("cuda", p_dev)):
            c = cache_for(card, 4, 96, fmt=QFormat.INT8, layered=True,
                          device=dev)
            logits, _ = prefill(card, params, prompt.to(dev), c, fresh=True,
                                device=dev)
            c = cache_for(card, 4, 96, fmt=QFormat.INT8, layered=True,
                          device=dev)
            toks, _ = generate(card, params, prompt, c,
                               sampler=SamplerCard(temperature=0.0),
                               max_new_tokens=12, decode_chunk=4, device=dev)
            out[dev] = (logits.cpu(), toks.cpu())
        check(f"tiny {label} prefill logits, card vs CPU",
              max_err(out["cpu"][0], out["cuda"][0]), 5e-2)
        _agree(f"tiny {label} generate", out["cpu"][1], out["cuda"][1])


def zoo_phase(torch) -> dict:
    """Slice 16: (a) Qwen3-30B-A3B at full width, DEPTH layers, from its
    published config.json (seeded weights, INT4 g128 attention, bf16
    experts, INT8 KV) through ``generate`` (B 8 x 128, 32 new, greedy),
    its capacity drops recomputed, then through ``bubble`` on a 2-layer
    folder; (b) DeepSeek-V2-Lite as the JAX package reads it (DEPTH
    layers, MLA, a dense FFN) through ``generate`` and the latent cache;
    the tiny card-vs-CPU gates. Returns each path's launches."""
    from koifish_tpu_torch.config import ModelCard
    t0 = time.perf_counter()
    runs, numbers = {}, {}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(16)
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    say(f"[zoo] device memory free {free / 1e9:.2f} of {total / 1e9:.2f} GB")
    card = cut_card(ModelCard.from_hf(QWEN3_30B_A3B))
    if (card.n_experts, card.n_experts_active, card.moe_ffn) != (128, 8, 768):
        fail(f"Qwen3-30B-A3B's card: {card}")
    say(f"[zoo] (a) Qwen3-30B-A3B: L={card.n_layer} E={card.n_embd} "
        f"Hq={card.n_head} Hkv={card.n_kv_head} D={card.head_dim} "
        f"experts {card.n_experts} (k {card.n_experts_active}, Fm "
        f"{card.moe_ffn}) V={card.vocab_size}; INT4 g128 attention, bf16 "
        f"experts, INT8 KV, B={ZOO_B} P={ZOO_P} new={ZOO_NEW}")
    qp = _zoo_params(torch, card, seed=162)
    toks, runs["zoo_qwen3_moe"], prompts, numbers["qwen3_moe"] = _zoo_serve(
        torch, "Qwen3-30B-A3B", card, qp, gen)
    _moe_drops(torch, card, qp, prompts)
    del qp, toks
    torch.cuda.empty_cache()
    runs["zoo_bubble_moe"] = zoo_bubble(torch)

    card = cut_card(ModelCard.from_hf(DEEPSEEK_V2_LITE))
    if card.attn != "mla" or card.n_experts or card.head_dim != 192:
        fail(f"DeepSeek-V2-Lite's card: {card}")
    say(f"[zoo] (b) DeepSeek-V2-Lite as the JAX package reads it: "
        f"L={card.n_layer} E={card.n_embd} H={card.n_head} MLA (kv_lora "
        f"{card.kv_lora_rank}, q_lora {card.q_lora_rank}, d "
        f"{card.head_dim}, dv {card.v_head_dim}), dense FFN {card.n_ffn} "
        f"(n_routed_experts unread), V={card.vocab_size}")
    qp = _zoo_params(torch, card, seed=163)
    toks, runs["zoo_mla"], prompts, numbers["mla"] = _zoo_serve(
        torch, "DeepSeek-V2-Lite (JAX reading)", card, qp, gen)
    runs["zoo_mla_latent"] = _mla_latent(torch, card, qp, prompts, toks)
    del qp, toks
    torch.cuda.empty_cache()
    zoo_reference_check(torch)
    say(f"[zoo] phase: {time.perf_counter() - t0:.1f} s; launches "
        f"{json.dumps(runs)}")
    return runs


def write_tokenizer_json(path: str) -> None:
    """A byte-level ``tokenizer.json`` in ``path``: the 256 bytes,
    ``BYTE_MERGES`` and the three chat specials."""
    from koifish_tpu_torch.data.tokenizer import _bytes_to_unicode
    b2u = _bytes_to_unicode()
    vocab = {b2u[b]: b for b in range(256)}
    u = lambda bs: "".join(b2u[c] for c in bs)
    merges = [(u(a), u(b)) for a, b in BYTE_MERGES]
    for a, b in merges:
        vocab[a + b] = len(vocab)
    added = [{"content": s, "id": len(vocab) + i}
             for i, s in enumerate(SPECIALS)]
    with open(os.path.join(path, "tokenizer.json"), "w") as f:
        json.dump({"model": {"type": "BPE", "vocab": vocab,
                             "merges": [f"{a} {b}" for a, b in merges]},
                   "added_tokens": added,
                   "pre_tokenizer": {"type": "ByteLevel"}}, f)


def _zoo_row7(dec, prefix: str) -> dict:
    """Row 7's fused entry's numbers at the zoo shape ``prefix`` names
    (``decode_attn_phase``'s timed case)."""
    (sh,) = [x for x in dec["shapes"] if x["label"].startswith(prefix)]
    return dict(ms=sh["fused_ms"], plain_ms=sh["fused_plain_ms"],
                library_ms=sh["library_ms"], bound_ms=sh["fused_bound_ms"],
                bound_by=sh["fused_bound_by"],
                max_abs_err=sh["fused_max_abs_err"])


# --------------------------------------------------------------------------
# slice 17: the rest of the model zoo
# --------------------------------------------------------------------------

S17_STEPS = 3
#: state-spaces/mamba-130m's published config.json (the fields the arch
#: reads; the vocabulary padded to a multiple of 8 as its
#: pad_vocab_size_multiple says: 50,277 -> 50,280)
MAMBA_130M = {"d_model": 768, "n_layer": 24, "vocab_size": 50277,
              "ssm_cfg": {}, "rms_norm": True, "residual_in_fp32": True,
              "fused_add_norm": True, "pad_vocab_size_multiple": 8}
#: GPT2-124M's 12 layers cycling (QKV FFN), GAU, (BROWN FFN), four times,
#: in the syntax of koifish_tpu/models/backbone.py
S17_HYBRID_BACKBONE = {
    "embed_tokens": {"Embedding": []},
    "cycle *4": {"a": {"self_attn": {"QKV": []}, "mlp": {"FFN": []}},
                 "g": {"GAU": []},
                 "b": {"self_attn": {"BROWN": []}, "mlp": {"FFN": []}}},
    "norm": {"Normal": []}, "output": {"CLASIFY": []}}
HOT_B, HOT_P, HOT_NEW, HOT_S = 32, 128, 64, 1024   # slice 1's serving
HOT_CALIB = (8, 512)
SALMON_GEN = (8, 64, 128, 16)          # B, prompt, total length, steps


def s17_train_launches(steps: int, card, remat, m: int) -> dict:
    """The launches ``steps`` steps of a card whose every layer is QKV
    (the flash forward a layer, twice with remat, a dK/dV and a dQ) make,
    and where the vocabulary takes the fused CE (>= 65,536; the tied head
    trains: dlogits, dx and dW per vocab chunk of the m rows)."""
    from koifish_tpu_torch.ops.kernels import fused_ce as kc
    L, r = card.n_layer, 2 if remat else 1
    out = {"flash_fwd": steps * L * r, "flash_bwd_dkv": steps * L,
           "flash_bwd_dq": steps * L}
    if card.vocab_size >= 65536:
        chunks = len(kc.chunk_plan(m, card.vocab_size)[1])
        out.update(fused_ce_fwd=steps, fused_ce_dlogits=steps * chunks,
                   fused_ce_dx=steps * chunks, fused_ce_dw=steps * chunks)
    return out


def _exact_launches(label: str, counts: dict, want: dict) -> None:
    """Fail unless the run's launches are exactly ``want``'s: every kernel
    the shapes give, as often, and no other."""
    got = {k: v for k, v in counts.items() if v}
    exp = {k: v for k, v in want.items() if v}
    if got != exp:
        fail(f"{label}: launches {json.dumps(got)}, the shapes give "
             f"{json.dumps(exp)}")
    say(f"  {label}: launches exactly as the shapes give: {json.dumps(got)}")


def _s17_train(torch, root: str, name: str, cfg: dict, falls_want=None):
    """``cfg`` written to ``root`` with its train glob on a seeded shard,
    through ``koifish.main`` for S17_STEPS steps: finite losses, the first
    within 1.0 of ln V (random weights), step ms, tok/s, peak memory, the
    fallbacks ``falls_want`` (none unless given). Returns (result,
    launches, numbers)."""
    import math
    from koifish_tpu_torch.cli import koifish
    from koifish_tpu_torch.config import CLIParams
    from koifish_tpu_torch.utils import kernel_log
    from koifish_tpu_torch.utils.tree import leaves
    cfg = dict(cfg, datasets={"train": {
        "glob": os.path.join(root, f"{name}_train_*.bin"), "name": name}})
    cfg["debug"] = dict(cfg.get("debug", {}), most_iter=S17_STEPS)
    cfgp = os.path.join(root, f"{name}.json")
    with open(cfgp, "w") as f:
        json.dump(cfg, f, indent=1)
    p = CLIParams.load(cfgp)
    card, tcard = p.model, p.train
    B, T = tcard.batch, card.n_ctx
    write_token_shard(os.path.join(root, f"{name}_train_000.bin"),
                      card.vocab_size, 2 * S17_STEPS * B * (T + 1), seed=171)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # check=False: the fallbacks are held to falls_want below
    res, _, counts = run_cli(torch, koifish.main, [
        cfgp, "--out-dir", os.path.join(root, name)],
        f"koifish {name} ({S17_STEPS} steps)", check=False)
    torch.cuda.synchronize()
    falls = kernel_log.fallbacks()
    if falls != (falls_want or {}):
        fail(f"{name}: fallbacks {falls}, expected {falls_want or {}}")
    infos = res["infos"]
    losses, dts = infos.losses, [r[3] for r in infos.rows]
    dt = sorted(dts[1:])[len(dts[1:]) // 2]
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_params = sum(x.numel() for x in leaves(res["state"].params))
    say(f"  {name}: arch {card.arch}, {n_params / 1e6:.1f} M parameters, "
        f"B={B} T={T} remat={tcard.remat}; losses "
        f"{[round(x, 5) for x in losses]}; step ms "
        f"{[round(d * 1e3, 1) for d in dts]} (median of steps 1-"
        f"{S17_STEPS - 1}: {dt * 1e3:.1f} ms, {B * T / dt:.1f} tok/s); "
        f"peak {peak:.2f} GiB; fallbacks {json.dumps(falls)}")
    if len(losses) != S17_STEPS or not all(math.isfinite(x) for x in losses):
        fail(f"{name}: losses {losses}")
    if abs(losses[0] - math.log(card.vocab_size)) > 1.0:
        fail(f"{name}: first loss {losses[0]}, ln V = "
             f"{math.log(card.vocab_size):.3f}")
    return res, counts, dict(step_ms=dt * 1e3, tok_s=B * T / dt,
                             peak_gib=peak, losses=losses,
                             params_m=n_params / 1e6)


def _qwen3_cfg(arch: str, **param) -> dict:
    """configs/qwen3_0.6b.json with another arch (and ``param`` in its
    parameter block), bf16 (no quantizer card), B 8."""
    with open(os.path.join(ROOT, "configs", "qwen3_0.6b.json")) as f:
        cfg = cut_config(json.load(f))
    cfg.pop("quantizer")
    cfg["model"]["arch"] = arch
    cfg["model"]["parameter"].update(param)
    cfg["train"]["batch"] = 8
    return cfg


def s17_guppy(torch, root: str, gen) -> tuple:
    """(a) GUPPY at Qwen3-0.6B's width, DEPTH layers, through ``koifish``, then
    ``generate`` on the evaluation sample (the trained params, INT8 KV,
    B 8 x 128, 32 greedy new). Returns ({path: launches}, numbers)."""
    from koifish_tpu_torch.models.guppy import sample_ids
    res, counts, num = _s17_train(torch, root, "guppy", _qwen3_cfg("GUPPY"))
    card = res["card"]
    _exact_launches("guppy train", counts,
               s17_train_launches(S17_STEPS, card, True, 8 * card.n_ctx))
    samps = sample_ids(card)
    rows = card.n_layer * card.n_ffn * card.n_embd * 2
    say(f"  guppy evaluation sample: {samps.shape} ids in [{samps.min()}, "
        f"{samps.max()}]; injected rows {rows / 1e6:.1f} MB bf16")
    params = res["state"].params
    del res
    torch.cuda.empty_cache()
    with torch.no_grad():
        _, serve, _, snum = _zoo_serve(torch, "Guppy generate", card, params,
                                       gen)
    num.update(serve=snum)
    del params
    torch.cuda.empty_cache()
    return {"guppy_train": counts, "guppy_serve": serve}, num


def s17_llama_vae(torch, root: str) -> tuple:
    """(b) LLAMA_VAE at Qwen3-0.6B's widths, ``token_embeds [192]``."""
    res, counts, num = _s17_train(torch, root, "llama_vae", _qwen3_cfg(
        "LLAMA_VAE", token_embeds=[192]))
    card = res["card"]
    enc = res["state"].params["evae"]["enc"][0]["w"]
    if tuple(enc.shape) != (card.n_embd, 192):
        fail(f"llama_vae: evae enc {tuple(enc.shape)}")
    _exact_launches("llama_vae train", counts,
               s17_train_launches(S17_STEPS, card, True, 8 * card.n_ctx))
    del res
    torch.cuda.empty_cache()
    return {"llama_vae_train": counts}, num


def s17_hybrid(torch, root: str) -> tuple:
    """(c) configs/gpt2_124m.json's widths with a backbone cycling QKV FFN,
    GAU and BROWN FFN: 4 QKV layers take the flash kernels, the 4 GAU
    layers log a ``flash_attention`` fallback a forward (value width F/H =
    256 against D 64), twice with remat; serving raises."""
    import dataclasses
    from koifish_tpu_torch.serve import cache_for, prefill
    with open(os.path.join(ROOT, "configs", "gpt2_124m.json")) as f:
        cfg = json.load(f)
    cfg["model"]["backbone"] = S17_HYBRID_BACKBONE
    cfg.pop("datasets")
    cfg["train"].pop("save-every")         # no checkpoint of a 3-step run
    res, counts, num = _s17_train(
        torch, root, "hybrid", cfg,
        falls_want={"flash_attention": 4 * S17_STEPS * 2})
    card = res["card"]
    if (card.gau_layers, card.brown_layers) != ((1, 4, 7, 10),
                                                (2, 5, 8, 11)):
        fail(f"hybrid: GAU {card.gau_layers}, BROWN {card.brown_layers}")
    # the 4 QKV layers' kernels; V 50,304 takes the bf16-logits CE
    _exact_launches("hybrid train", counts, s17_train_launches(
        S17_STEPS, dataclasses.replace(card, n_layer=4), True, 0))
    try:
        prefill(card, res["state"].params,
                torch.zeros((1, 8), dtype=torch.int64, device="cuda"),
                cache_for(card, 1, 16, device="cuda"), fresh=True)
    except NotImplementedError as e:
        say(f"  hybrid serving raises NotImplementedError, as the JAX "
            f"package's prefill: {e}")
    else:
        fail("hybrid: serving a GAU/BROWN card did not raise")
    del res
    torch.cuda.empty_cache()
    return {"hybrid_train": counts}, num


def s17_mamba(torch, root: str) -> tuple:
    """(d) state-spaces/mamba-130m's published config (MAMBA_130M): no
    kernel, as in JAX; the scan's layer profiled over one step."""
    vocab = -(-MAMBA_130M["vocab_size"] // MAMBA_130M[
        "pad_vocab_size_multiple"]) * MAMBA_130M["pad_vocab_size_multiple"]
    cfg = {"model": {"arch": "MAMBA", "vocab_size": vocab, "parameter": {
        "Layer": MAMBA_130M["n_layer"], "tie_word_embeddings": True,
        "transformer": {"Ctx": 1024, "Embed": MAMBA_130M["d_model"],
                        "Head": 12, "Ffn": 4 * MAMBA_130M["d_model"]}}},
        "train": {"batch": 8, "dump-every": 1, "learning-rate": 0.0006,
                  "optimizatioin": {"method": "adamw",
                                    "grad_accumulation": 1}},
        "seed": 42}
    res, counts, num = _s17_train(torch, root, "mamba", cfg)
    if abs(num["params_m"] - 129.1) > 0.5:
        fail(f"mamba: {num['params_m']:.2f} M parameters, mamba-130m has "
             f"129.1 M")
    _exact_launches("mamba train", counts, {})
    card, state = res["card"], res["state"]
    del res
    torch.cuda.empty_cache()
    profile_train_step(torch, "mamba-130m train step (B 8 x 1024)", card,
                       state, 8)
    del state
    torch.cuda.empty_cache()
    return {"mamba_train": counts}, num


def profile_train_step(torch, label, card, state, B) -> None:
    """One more ``make_train_step`` on a seeded batch, profiled."""
    from koifish_tpu_torch.config import TrainCard
    from koifish_tpu_torch.train import make_train_step
    step = make_train_step(card, TrainCard(batch=B), total_steps=10)
    toks = torch.randint(0, card.vocab_size, (1, B, card.n_ctx + 1),
                         device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(
                             17))
    box = [state]

    def run():
        box[0], _ = step(box[0], {"tokens": toks})
    profile_window(torch, label, run)


def s17_salmon(torch, root: str) -> tuple:
    """(e) SALMON at the qwen2.5-0.5b preset's widths through ``koifish``
    (the reference's arch string "SCORE"), then greedy
    ``diffusion_generate`` (SALMON_GEN). No kernel, as in JAX."""
    from koifish_tpu_torch.config import ModelCard
    from koifish_tpu_torch.models.salmon import diffusion_generate, mask_id
    from koifish_tpu_torch.utils import kernel_log
    pre = ModelCard.preset("qwen2.5-0.5b")
    cfg = {"model": {"arch": "SCORE", "vocab_size": pre.vocab_size,
                     "parameter": {
                         "Layer": pre.n_layer, "max_pos_embeddings":
                         pre.max_pos, "rope_theta": pre.rope_theta,
                         "tie_word_embeddings": True,
                         "transformer": {"Ctx": 1024, "Embed": pre.n_embd,
                                         "Head": pre.n_head,
                                         "KVHead": pre.n_kv_head,
                                         "head_dim": pre.head_dim,
                                         "Ffn": pre.n_ffn}}},
           "train": {"batch": 8, "dump-every": 1, "learning-rate": 0.0006,
                     "optimizatioin": {"method": "adamw",
                                       "grad_accumulation": 1}},
           "seed": 42}
    res, counts, num = _s17_train(torch, root, "salmon", cfg)
    card = res["card"]
    if (card.arch, card.causal, card.qkv_bias, card.n_embd, card.n_head,
            card.n_kv_head, card.n_ffn, card.rope_theta) != (
            "SALMON", False, True, pre.n_embd, pre.n_head, pre.n_kv_head,
            pre.n_ffn, pre.rope_theta):
        fail(f"salmon: card {card}")
    _exact_launches("salmon train", counts, {})
    params = res["state"].params
    del res
    torch.cuda.empty_cache()
    B, P, total, steps = SALMON_GEN
    prompt = torch.randint(0, card.vocab_size - 1, (B, P), device="cuda",
                           generator=torch.Generator(
                               device="cuda").manual_seed(172))
    diffusion_generate(card, params, prompt, total, steps=2)     # warm
    torch.cuda.synchronize()
    kernel_log.reset_launches()
    t0 = time.perf_counter()
    out = diffusion_generate(card, params, prompt, total, steps=steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gcounts = kernel_log.launches()
    # the last greedy pass may itself pick the mask id (random weights)
    say(f"  salmon diffusion_generate B {B}, prompt {P}, total {total}, "
        f"{steps} steps: {wall * 1e3:.1f} ms ({B * (total - P) / wall:.1f} "
        f"tok/s, {steps + 1} forwards); {int((out == mask_id(card)).sum())} "
        f"mask ids in the output; launches {json.dumps(gcounts)}")
    if tuple(out.shape) != (B, total) or int(out.min()) < 0 \
            or int(out.max()) >= card.vocab_size \
            or not torch.equal(out[:, :P].long(), prompt):
        fail("salmon: diffusion_generate's output is out of range or moved "
             "the prompt")
    _exact_launches("salmon generate", gcounts, {})
    num.update(generate_ms=wall * 1e3)
    del params
    torch.cuda.empty_cache()
    return {"salmon_train": counts, "salmon_generate": gcounts}, num


def s17_hotpick(torch, gen) -> tuple:
    """(f) slice 1's model (configs/qwen3_0.6b.json, INT4 RTN g128) at
    DEPTH layers: ``ffn_activation_energy`` on HOT_CALIB seeded tokens,
    ``pick_hot(keep=0.5)`` (n_ffn 1536; ``down`` requantized at K 1536),
    then served as slice 1 serves (B 32 x 128, 64 new, T 0.6 / top-k 50 /
    top-p 0.95, INT8 KV, decode_chunk 16)."""
    from koifish_tpu_torch.config import SamplerCard
    from koifish_tpu_torch.models import init_params
    from koifish_tpu_torch.models.hotpick import ffn_activation_energy, pick_hot
    from koifish_tpu_torch.quant import quantize_params
    from koifish_tpu_torch.utils import kernel_log
    p = load_config("qwen3_0.6b.json")
    card = p.model
    with torch.no_grad():
        qp = quantize_params(init_params(card, gen, device="cuda"), p.quant,
                             card, device="cuda")
    calib = torch.randint(0, card.vocab_size, HOT_CALIB, device="cuda",
                          generator=gen)
    torch.cuda.synchronize()
    kernel_log.reset_launches()
    t0 = time.perf_counter()
    energies = ffn_activation_energy(card, qp, calib)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    calib_counts = kernel_log.launches()
    card2, qp2 = pick_hot(card, qp, energies, keep=0.5)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    say(f"[slice17] (f) HotPick: calibration on {HOT_CALIB} tokens "
        f"{(t1 - t0) * 1e3:.1f} ms (launches {json.dumps(calib_counts)}), "
        f"pick_hot {(t2 - t1) * 1e3:.1f} ms: n_ffn {card.n_ffn} -> "
        f"{card2.n_ffn}, down {qp2['layers'][0]['down'].shape} "
        f"{qp2['layers'][0]['down'].fmt.name} g{qp2['layers'][0]['down'].group}"
        f"; {_nbytes(qp) / 1e9:.3f} -> {_nbytes(qp2) / 1e9:.3f} GB")
    L = card.n_layer
    _exact_launches("hotpick calibration", calib_counts,
               {"flash_fwd": L, "qmm": 9 * L})
    if card2.n_ffn != 1536 or any(tuple(lp["down"].shape) != (1536, 1024)
                                  for lp in qp2["layers"]):
        fail(f"hotpick: picked n_ffn {card2.n_ffn}")
    del qp, energies
    torch.cuda.empty_cache()
    _, serve, _, num = _zoo_serve(
        torch, "HotPick generate", card2, qp2, gen, B=HOT_B, P=HOT_P,
        NEW=HOT_NEW, S=HOT_S, chunk=16,
        sampler=SamplerCard(temperature=0.6, top_k=50, top_p=0.95))
    # rows 3 and 4 count each launch under its K: the counted run's K 1536
    # launches are the picked down's, one GEMM a layer in the prefill and
    # one GEMV a layer in each decode step
    by_k = num.pop("by_k")
    per_run = {kind: by_k.get((kind, 1536), 0) for kind in ("qmm", "qmv")}
    say(f"  launches by (kernel, K) in the counted run: "
        f"{json.dumps({f'{n}@K{k}': c for (n, k), c in sorted(by_k.items())})}")
    _exact_launches("hotpick serving at K 1536", per_run,
               {"qmm": L, "qmv": L * (HOT_NEW - 1)})
    del qp2
    torch.cuda.empty_cache()
    return ({"hotpick_calibration": calib_counts, "hotpick_serve": serve},
            dict(serve=num, calib_ms=(t1 - t0) * 1e3,
                 pick_ms=(t2 - t1) * 1e3, k1536=per_run))


def k1536_phase(torch, gen) -> dict:
    """Rows 3 and 4 at the picked ``down``'s K 1536 (N 1024, INT4 g128):
    against their plain versions at the served m (B·P = 4096 and B = 32),
    timed beside the library's product on the dequantized weight and the
    bound, 12 layers' weights cycled as ``qmatmul_phase`` times them."""
    from koifish_tpu_torch.dtypes import QFormat
    from koifish_tpu_torch.ops.kernels import matmul as km
    from koifish_tpu_torch.quant.rtn import quantize
    K, N, n_layers = 1536, 1024, 12
    out = {}
    for kind, m in (("qmm", HOT_B * HOT_P), ("qmv", HOT_B)):
        ws = [quantize(torch.randn((K, N), generator=gen, device="cuda")
                       * 0.02, QFormat.INT4, group=128)
              for _ in range(n_layers)]
        x = torch.randn((m, K), generator=gen, device="cuda"
                        ).to(torch.bfloat16)
        y = km.qmatmul(x, ws[0])
        ref = km.qmatmul_plain(x, ws[0].codes, ws[0].scales, ws[0].fmt,
                               ws[0].group)
        torch.cuda.synchronize()
        err = max_err(y, ref)
        check(f"{kind} K{K} m{m} N{N} INT4 (HotPick's picked down)", err,
              1e-2 * float(ref.float().abs().max()) + 1e-3)
        deq = [w.dequantize(torch.bfloat16) for w in ws[:4]]
        kms = time_ms(torch, lambda: [km.qmatmul(x, w) for w in ws],
                      iters=5) / n_layers
        pms = time_ms(torch, lambda: km.qmatmul_plain(
            x, ws[0].codes, ws[0].scales, ws[0].fmt, ws[0].group), iters=3)
        lms = time_ms(torch, lambda: [torch.matmul(x, w) for w in deq],
                      iters=5) / len(deq)
        bms, by = bound_ms(m * K * 2 + K * N // 2 + (K // 128) * N * 4
                           + m * N * 2, 2.0 * m * K * N)
        say(f"  time {kind} K{K} N{N} m{m} INT4: kernel_ms={kms:.4f} "
            f"plain_ms={pms:.4f} library_ms(matmul on dequantized bf16)="
            f"{lms:.4f} bound_ms={bms:.5f} ({by}); max_abs_err {err:.3e}")
        out[kind] = dict(ms=kms, plain_ms=pms, library_ms=lms, bound_ms=bms,
                         bound_by=by, max_abs_err=err)
        del ws, deq
    return out


def s17_reference_check(torch) -> None:
    """Tiny cards of each family on the card against the CPU (SR off):
    one train step of GUPPY, LLAMA_VAE, a QKV/GAU/BROWN hybrid, MAMBA and
    SALMON (loss 1e-2, grad norms 2 %, updated params within 2·lr + 1 ulp);
    prefill logits 5e-2 and greedy tokens 75 % of a GUPPY model and of a
    picked (HotPick) INT4 model; SALMON's greedy ``diffusion_generate``
    75 %."""
    import dataclasses
    from koifish_tpu_torch.config import (ModelCard, QuantCard, SamplerCard,
                                          TrainCard)
    from koifish_tpu_torch.dtypes import QFormat
    from koifish_tpu_torch.models import init_params
    from koifish_tpu_torch.models.hotpick import ffn_activation_energy, pick_hot
    from koifish_tpu_torch.models.salmon import diffusion_generate
    from koifish_tpu_torch.quant import quantize_params
    from koifish_tpu_torch.serve import cache_for, generate, prefill
    from koifish_tpu_torch.utils.tree import tree_map
    tiny = dict(vocab_size=512, n_layer=2, n_embd=128, n_head=2,
                n_kv_head=1, head_dim=64, n_ffn=256, n_ctx=64, max_pos=128)
    tcard = TrainCard(batch=4, lr=1e-3, warmup=0, scheduler="static",
                      stochastic_round=False, check_tensor_norm=True)
    hybrid = dataclasses.replace(ModelCard.from_arch("QWEN3", **dict(
        tiny, n_layer=3, n_kv_head=2)), gau_layers=(1,), brown_layers=(2,))
    cards = [("GUPPY", ModelCard.from_arch("GUPPY", **tiny)),
             ("LLAMA_VAE", ModelCard.from_arch("LLAMA_VAE", token_embeds=(
                 32,), **tiny)),
             ("QKV/GAU/BROWN hybrid", hybrid),
             ("MAMBA", ModelCard.from_arch("MAMBA", **tiny)),
             ("SALMON", ModelCard.from_arch("SALMON", **tiny))]
    for label, card in cards:
        # wte also feeds Guppy's rows and the VAE: the §2 grad-norm gate
        _step_card_vs_cpu(torch, f"tiny {label} train step", card, tcard,
                          511, 1e-2, 2e-2, 2e-2)
    prompt = torch.randint(0, 511, (4, 40),
                           generator=torch.Generator().manual_seed(173))
    qc = QuantCard.from_json({"self_attn": {"bits": 4}, "mlp": {"bits": 4},
                              "group_size": 128})
    guppy = cards[0][1]
    hot = ModelCard.from_arch("QWEN3", **dict(tiny, n_ffn=512))
    p_hot = quantize_params(init_params(hot, device="cpu", seed=174), qc,
                            hot, device="cpu")
    energies = ffn_activation_energy(hot, p_hot, prompt)
    hot2, p_hot2 = pick_hot(hot, p_hot, energies, keep=0.5)
    e_dev = ffn_activation_energy(hot, tree_map(lambda t: t.to("cuda"),
                                                p_hot), prompt.to("cuda"))
    check("tiny HotPick activation energies, card vs CPU (relative)",
          max(max_err(a, b.cpu()) / float(a.abs().max())
              for a, b in zip(energies, e_dev)), 5e-2)
    for label, card, p_cpu in (
            ("GUPPY", guppy, init_params(guppy, device="cpu", seed=175)),
            ("HotPick INT4 (down K 256)", hot2, p_hot2)):
        p_dev = tree_map(lambda t: t.to("cuda"), p_cpu)
        out = {}
        for dev, params in (("cpu", p_cpu), ("cuda", p_dev)):
            c = cache_for(card, 4, 64, fmt=QFormat.INT8, layered=True,
                          device=dev)
            logits, _ = prefill(card, params, prompt.to(dev), c, fresh=True,
                                device=dev)
            c = cache_for(card, 4, 64, fmt=QFormat.INT8, layered=True,
                          device=dev)
            toks, _ = generate(card, params, prompt, c,
                               sampler=SamplerCard(temperature=0.0),
                               max_new_tokens=12, decode_chunk=4, device=dev)
            out[dev] = (logits.cpu(), toks.cpu())
        check(f"tiny {label} prefill logits, card vs CPU",
              max_err(out["cpu"][0], out["cuda"][0]), 5e-2)
        _agree(f"tiny {label} generate", out["cpu"][1], out["cuda"][1])
    # untied: a tied head's random embeddings make every masked position
    # predict the mask id itself, which would leave nothing to compare
    salmon = dataclasses.replace(cards[4][1], tie_embeddings=False)
    p_cpu = init_params(salmon, device="cpu", seed=176)
    out = [diffusion_generate(salmon, p, prompt[:, :16].to(d), 32, steps=4
                              ).cpu()
           for d, p in (("cpu", p_cpu),
                        ("cuda", tree_map(lambda t: t.to("cuda"), p_cpu)))]
    say(f"  tiny SALMON diffusion_generate: {int((out[0][:, 16:] == 511).sum())}"
        f" of {out[0][:, 16:].numel()} generated tokens are the mask id")
    _agree("tiny SALMON diffusion_generate", out[0][:, 16:], out[1][:, 16:])


def slice17_phase(torch) -> tuple:
    """Slice 17: the rest of the model zoo at published widths on the card,
    every weight seeded: (a) GUPPY (Qwen3-0.6B) trained, then served on its
    evaluation sample; (b) LLAMA_VAE (Qwen3-0.6B, token_embeds [192]);
    (c) GPT2-124M's widths with QKV/GAU/BROWN layers (serving raises);
    (d) mamba-130m; (e) SALMON at qwen2.5-0.5b's widths, trained and
    diffusion-generated; (f) HotPick on slice 1's INT4 model, served at K
    1536; rows 3 and 4 at K 1536 against their plain versions; the tiny
    card-vs-CPU gates. Returns ({path: launches}, k1536 kernel numbers,
    the K 1536 launches of the HotPick serving run)."""
    root = os.path.join(ROOT, "build", "slice17")
    os.makedirs(root, exist_ok=True)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    runs, numbers = {}, {}
    say("[slice17] (a) GUPPY: configs/qwen3_0.6b.json with arch GUPPY, bf16")
    r, numbers["guppy"] = s17_guppy(torch, root, gen)
    runs.update(r)
    say("[slice17] (b) LLAMA_VAE: configs/qwen3_0.6b.json, token_embeds [192]")
    r, numbers["llama_vae"] = s17_llama_vae(torch, root)
    runs.update(r)
    say("[slice17] (c) configs/gpt2_124m.json with QKV FFN / GAU / BROWN FFN "
        "layers")
    r, numbers["hybrid"] = s17_hybrid(torch, root)
    runs.update(r)
    say(f"[slice17] (d) mamba-130m (published config {json.dumps(MAMBA_130M)})")
    r, numbers["mamba"] = s17_mamba(torch, root)
    runs.update(r)
    say("[slice17] (e) SALMON at the qwen2.5-0.5b preset's widths")
    r, numbers["salmon"] = s17_salmon(torch, root)
    runs.update(r)
    r, numbers["hotpick"] = s17_hotpick(torch, gen)
    runs.update(r)
    k1536 = k1536_phase(torch, gen)
    s17_reference_check(torch)
    say(f"[slice17] phase: {time.perf_counter() - t0:.1f} s; launches "
        f"{json.dumps(runs)}")
    return runs, k1536, numbers["hotpick"]["k1536"]


# ---------------------------------------------------------------------------
# slice 18: data, tensor, FSDP and pipeline parallelism, one rank a process
# ---------------------------------------------------------------------------

#: Qwen/Qwen3-32B's widths (its config.json), cut to 2 layers for the
#: streamed load's rehearsal (the JAX package's tests/test_stream_load.py:190)
QWEN3_32B = dict(vocab_size=151936, n_layer=2, n_embd=5120, n_head=64,
                 n_kv_head=8, head_dim=128, n_ffn=27648, n_ctx=1024,
                 max_pos=40960)
#: the 32B serving recipe of the JAX package's rehearsal: INT4 linears,
#: INT8 embedding / tied head, g128
PAR_32B_QC = {"self_attn": {"bits": 4}, "mlp": {"bits": 4},
              "embed_tokens": {"bits": 8}, "group_size": 128}
PAR_NEW = 32            # bubble --tp 2's greedy tokens
PAR_STEPS = 3           # steps of each koifish run
PAR_B = 4               # the koifish runs' global batch (x 1024 tokens)
PAR_DEPTH = 4           # layers of the cut koifish runs
#: koifish --tp 2's layers: 28 (full depth) before slice 20, cut to
#: PAR_DEPTH so that slice20_phase fits the script's time limit
PAR_TP_DEPTH = PAR_DEPTH
PAR_RUNS = (("koifish_dp2", ["--dp", "2"], PAR_DEPTH),
            ("koifish_tp2", ["--tp", "2"], PAR_TP_DEPTH),
            ("koifish_dp2_fsdp", ["--dp", "2", "--fsdp"], PAR_DEPTH),
            ("koifish_pp2_1f1b", ["--pp", "2", "--pp-schedule", "1f1b"],
             PAR_DEPTH),
            ("koifish_pp2_gpipe", ["--pp", "2", "--pp-schedule", "gpipe"],
             PAR_DEPTH))
#: the ops the comm layer (``parallel/comm.py``) hands gloo unstaged on
#: CUDA tensors, each tried by the ranks on the card. Not ``send``/``recv``:
#: gloo hands their CUDA pointer to the socket and the process aborts
#: (``gloo::IoException ... writev: Bad address``, seen on the H100), so the
#: comm layer stages them through host memory
GLOO_PROBE = ("all_reduce", "broadcast", "all_gather", "reduce_scatter")
#: the koifish runs against one rank at the same global batch, each step's
#: relative gap: the loss, and the global gradient norm (which a missing or
#: halved dp sum moves even where AdamW's normalised update hides it). On
#: the H100 the sound runs read at most 2.5e-5 and 1.7e-3, a one-rank run
#: at learning rate 0 a loss gap of 6.0e-3; on the CPU at a tiny width a
#: skipped or halved dp sum reads grad-norm gaps of 0.43 and 0.50
PAR_LOSS_RTOL = 1e-3
PAR_GNORM_RTOL = 1e-2


def _rss_anon_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("RssAnon"):
                return int(line.split()[1]) / 1024.0
    return 0.0


def _par_probe(torch, dist, rank: int) -> dict:
    """Which collectives gloo runs on CUDA tensors here: each op tried
    directly on a card tensor (no staging) and its result checked."""
    out = {}
    x = torch.full((4,), float(rank + 1), device="cuda")
    for op in GLOO_PROBE:
        try:
            if op == "all_reduce":
                y = x.clone()
                dist.all_reduce(y)
                ok = float(y[0]) == 3.0
            elif op == "broadcast":
                y = x.clone()
                dist.broadcast(y, 0)
                ok = float(y[0]) == 1.0
            elif op == "all_gather":
                parts = [torch.empty_like(x) for _ in range(2)]
                dist.all_gather(parts, x)
                ok = float(parts[1][0]) == 2.0
            else:
                y = torch.empty(2, device="cuda")
                dist.reduce_scatter(y, [x[:2].clone(), x[2:].clone()])
                ok = float(y[0]) == 3.0
            out[op] = "ok" if ok else "wrong result"
        except Exception as e:      # an op gloo refuses on CUDA tensors
            out[op] = f"{type(e).__name__}: {str(e).splitlines()[0][:80]}"
        dist.barrier()
    return out


#: the JAX package's logit tolerance for its sharded serving
#: (tests/test_sharding.py:188: rtol 2e-2, atol 2e-2)
PAR_RTOL = PAR_ATOL = 2e-2
#: the limit of the tp-2 prefill logits' allclose excess over atol (at
#: rtol 2e-2) against the one-rank run. Random layers amplify any change
#: of f32 order: on the H100 the ranks read 3.07e-2 (Qwen3-0.6B, 28
#: layers) and 4.58e-2 (32B widths, 2 layers), the one-rank run through
#: rows 3 and 4's plain versions 3.10e-2 and 5.33e-2 from the kernels',
#: and a wrong shard 4.41 and 13.3
PAR_TP_GAP = 0.1


def allclose_excess(a, b, rtol: float) -> float:
    """max(|a - b| - rtol·|b|): what ``assert_allclose(a, b, rtol, atol)``
    holds to atol."""
    a, b = a.float(), b.float()
    return float(((a - b).abs() - rtol * b.abs()).max())


def tp_gates(label: str, got, ref, var: dict) -> None:
    """The tp-2 prefill logits ``got`` (rank 0's) against the one-rank run
    ``ref`` and ``prefill_variant``'s runs ``var``: within JAX's allclose
    (rtol, atol 2e-2) of the tp-2 arithmetic in one process, and within
    ``PAR_TP_GAP`` (the allclose excess over atol at rtol 2e-2) of the
    one-rank run, a limit a wrong shard must exceed."""
    gap = PAR_TP_GAP
    ref = ref.float().cpu()
    ex = {m: allclose_excess(v.float().cpu(), ref, PAR_RTOL)
          for m, v in var.items()}
    say(f"  {label} prefill logits (max |logit| "
        f"{float(ref.abs().max()):.3f}), allclose excess over atol at rtol "
        f"2e-2 against the one-rank run: the ranks "
        f"{allclose_excess(got, ref, PAR_RTOL):.4e} (max |Δ| "
        f"{max_err(got, ref):.4e}); one process's tp-2 arithmetic "
        f"{ex['tp2']:.4e}; the one-rank run through rows 3 and 4's plain "
        f"versions {ex['plain']:.4e}; a wrong shard {ex['tp2_wrong']:.4e}")
    check(f"{label} prefill logits vs one process's tp-2 arithmetic "
          f"(allclose excess over atol 2e-2)",
          allclose_excess(got, var["tp2"].float().cpu(), PAR_RTOL), PAR_ATOL)
    check(f"{label} prefill logits vs the one-rank run (allclose excess)",
          allclose_excess(got, ref, PAR_RTOL), gap)
    if ex["tp2_wrong"] <= gap:
        fail(f"{label}: a wrong shard passes the gate against the one-rank "
             f"run ({ex['tp2_wrong']:.4e} <= {gap:g})")


class _TpRank:
    """Rank ``r`` of a tp-2 layout, for ``parallel/sharding`` without a
    process group."""

    def __init__(self, r: int):
        self.r = r

    def size(self, axis: str) -> int:
        return 2 if axis == "tp" else 1

    def index(self, axis: str) -> int:
        return self.r if axis == "tp" else 0


def prefill_variant(torch, card, params, ids, cache, mode: str,
                    fresh=True):
    """One process's prefill with the layers' products computed another
    way. ``"tp2"``: the tp-2 arithmetic, each column-parallel product as
    its two N halves and each row-parallel one as its two K halves through
    the kernels, the K halves' f32 outputs summed and rounded once, as the
    two ranks sum them (``models/transformer._linear_l``); ``"tp2_wrong"``:
    the same with each row-parallel product's input halves paired with the
    other rank's weight shard (a wrong shard, which the gates must
    refuse); ``"plain"``: one rank, every quantized product through rows 3
    and 4's plain versions instead of the kernels (the same sums in
    another f32 order: what the one-rank arithmetic itself moves)."""
    from koifish_tpu_torch.models import transformer as tr
    from koifish_tpu_torch.ops.kernels import matmul as km
    from koifish_tpu_torch.ops.matmul import qmatmul
    from koifish_tpu_torch.parallel.sharding import shard_params
    from koifish_tpu_torch.quant.qtensor import QTensor
    from koifish_tpu_torch.serve import engine, prefill
    halves, real = {}, tr._linear_l

    def parts(key, w):
        if id(w) not in halves:
            halves[id(w)] = [shard_params({"layers": [{key: w}]}, _TpRank(r))[
                "layers"][0][key] for r in (0, 1)]
        return halves[id(w)]

    def split(x, lp, key):
        if key + "_b" in lp or key + "_lora" in lp:
            return real(x, lp, key)
        w = lp[key]
        if mode == "plain":
            if not isinstance(w, QTensor) or not km.takes(w):
                return real(x, lp, key)
            y = km.qmatmul_plain(x.reshape(-1, x.shape[-1]), w.codes,
                                 w.scales, w.fmt, w.group)
            return y.reshape(*x.shape[:-1], w.shape[-1]).to(x.dtype)
        if key in ("q", "k", "v", "gate", "up"):
            a, b = parts(key, w)
            return torch.cat([qmatmul(x, a), qmatmul(x, b)], -1)
        if key in ("o", "down"):
            a, b = parts(key, w)
            if mode == "tp2_wrong":
                a, b = b, a
            k2 = x.shape[-1] // 2
            f32 = torch.float32
            return (qmatmul(x[..., :k2], a, out_dtype=f32)
                    + qmatmul(x[..., k2:], b, out_dtype=f32)).to(x.dtype)
        return real(x, lp, key)
    tr._linear_l = engine._linear_l = split
    try:
        with torch.no_grad():
            logits, _ = prefill(card, params, ids, cache, fresh=fresh)
    finally:
        tr._linear_l = engine._linear_l = real
    return logits


def _par_counts(kernel_log) -> tuple:
    return kernel_log.launches(), kernel_log.fallbacks()


def par_rank(root: str) -> None:
    """One rank of ``parallel_phase``'s 2-rank gloo group on the one card
    (started by ``parallel/multihost.spawn``): the probe, (a) ``bubble --tp
    2`` and its TP prefill, (b) the 32B streamed load, (c) the koifish
    runs. Writes ``rank{r}.json`` (and rank 0's logits) under ``root``."""
    import threading
    import torch
    import torch.distributed as dist
    sys.path.insert(0, ROOT)
    from koifish_tpu_torch.cli import bubble, koifish
    from koifish_tpu_torch.config import QuantCard
    from koifish_tpu_torch.dtypes import QFormat
    from koifish_tpu_torch.io import stream_load
    from koifish_tpu_torch.io.stream_load import load_hf_sharded_quantized
    from koifish_tpu_torch.ops.tracectx import TPPolicy, tp_scope
    from koifish_tpu_torch.parallel import make_process_mesh, multihost
    from koifish_tpu_torch.parallel.sharding import (leaf_shards, local_card,
                                                     take)
    from koifish_tpu_torch.serve import cache_for, decode_step, prefill
    from koifish_tpu_torch.utils import kernel_log
    from koifish_tpu_torch.utils.tree import leaves
    multihost.init_distributed(timeout_s=600)
    rank = dist.get_rank()
    rec = {"backend": multihost.backend_choice(),
           "probe": _par_probe(torch, dist, rank)}

    def dump():
        with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
            json.dump(rec, f)
    dump()
    print(f"[parallel] rank {rank}: {json.dumps(rec)}", flush=True)
    mesh = make_process_mesh({"tp": 2})
    pol = TPPolicy(group=mesh.group("tp"), rank=mesh.index("tp"), size=2,
                   vocab=151936, src=mesh.ranks("tp")[0])

    # (a) bubble --tp 2 --bits 4 --kv-bits 8 through the streamed load
    hf = os.path.join(root, "qwen3_0.6b")
    argv = ["--hf", hf, "--tp", "2", "--bits", "4", "--kv-bits", "8",
            "--temperature", "0", "--max-new", str(PAR_NEW), "--ctx", "512",
            "--prompts", CHAT_PROMPTS[0], "--csv", ""]
    turns = []
    torch.cuda.synchronize()
    kernel_log.reset_launches()
    t0 = time.perf_counter()
    bubble.main(argv, turns)
    torch.cuda.synchronize()
    counts, falls = _par_counts(kernel_log)
    rec["bubble"] = dict(wall=time.perf_counter() - t0, counts=counts,
                         falls=falls, ids=turns[0]["prompt_ids"],
                         tokens=turns[0]["tokens"], tk_s=turns[0]["tk_s"])
    qc = QuantCard.from_json({"self_attn": {"bits": 4}, "mlp": {"bits": 4}})
    card, params = load_hf_sharded_quantized(hf, mesh, qc)
    lc = local_card(card, 2)
    prompt = torch.tensor([turns[0]["prompt_ids"]], device="cuda")
    ttft = []
    with tp_scope(pol), torch.no_grad():
        for _ in range(3):          # the first warms the allocator
            cache = cache_for(lc, 1, 512, fmt=QFormat.INT8, device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = prefill(lc, params, prompt, cache, fresh=True)
            int(torch.argmax(logits[0]))
            ttft.append(time.perf_counter() - t0)
    rec["bubble"]["ttft"] = ttft
    rec["bubble"]["device_bytes"] = torch.cuda.memory_allocated()
    dump()
    if rank == 0:
        torch.save(logits.float().cpu(), os.path.join(root, "logits06.pt"))
    del params, cache, logits
    torch.cuda.empty_cache()

    # (b) the streamed load at Qwen3-32B's widths, 2 layers
    folder = os.path.join(root, "qwen3_32b_2l")
    peak, stop = [_rss_anon_mb()], [False]

    def track():
        while not stop[0]:
            peak[0] = max(peak[0], _rss_anon_mb())
            time.sleep(0.01)
    base = _rss_anon_mb()
    th = threading.Thread(target=track, daemon=True)
    th.start()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    read0 = stream_load.bytes_read()
    card32, p32 = load_hf_sharded_quantized(
        folder, mesh, QuantCard.from_json(PAR_32B_QC))
    torch.cuda.synchronize()
    stop[0] = True
    th.join()
    s32 = dict(load_s=time.perf_counter() - t0, peak_rss_mb=peak[0] - base,
               read_bytes=stream_load.bytes_read() - read0,
               device_bytes=torch.cuda.memory_allocated())
    lc32 = local_card(card32, 2)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(32)
    toks = torch.randint(0, 512, (1, 64), generator=gen, device="cuda")
    pol32 = TPPolicy(group=mesh.group("tp"), rank=mesh.index("tp"), size=2,
                     vocab=card32.vocab_size, src=mesh.ranks("tp")[0])
    kernel_log.reset_launches()
    with tp_scope(pol32), torch.no_grad():
        cache = cache_for(lc32, 1, 128, fmt=QFormat.INT8, device="cuda")
        lg32, cache = prefill(lc32, p32, toks, cache)
        for t in range(2):
            _, cache = decode_step(lc32, p32, torch.full(
                (1,), 7 + t, dtype=torch.int32, device="cuda"), cache)
    torch.cuda.synchronize()
    s32["counts"], s32["falls"] = _par_counts(kernel_log)
    s32["by_k"] = {f"{k}@{K}": n for (k, K), n in
                   kernel_log.launches_by_k().items()}
    if rank == 0:
        torch.save(lg32.float().cpu(), os.path.join(root, "logits32.pt"))
    # the shards against the one-rank quantize_params, bit for bit
    from koifish_tpu_torch.io.hf_loader import load_hf_model
    from koifish_tpu_torch.quant.apply import quantize_params
    _, whole = load_hf_model(folder, device="cuda")
    whole = quantize_params(whole, QuantCard.from_json(PAR_32B_QC), card32)
    shards = leaf_shards(whole, mesh)
    n_bad, n_all = 0, 0
    for w, s, mine in zip(leaves(whole), shards, leaves(p32)):
        n_all += 1
        n_bad += int(not torch.equal(take(w, s), mine))
    s32["leaves"], s32["leaves_differ"] = n_all, n_bad
    rec["stream32b"] = s32
    dump()
    del whole, p32, cache
    torch.cuda.empty_cache()

    # (c) koifish on configs/qwen3_0.6b.json, full width
    rec["koifish"] = {}
    for name, flags, depth in PAR_RUNS:
        cfg = os.path.join(root, f"qwen3_{depth}l.json")
        res = {}
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernel_log.reset_launches()
        t0 = time.perf_counter()
        rc = koifish.main([cfg, "--most-iter", str(PAR_STEPS), "--out-dir",
                           os.path.join(root, name), *flags], res)
        torch.cuda.synchronize()
        counts, falls = _par_counts(kernel_log)
        rec["koifish"][name] = dict(
            rc=rc, wall=time.perf_counter() - t0, counts=counts, falls=falls,
            losses=res["infos"].losses, gnorms=res["infos"].grad_norms,
            step_s=[r[3] for r in res["infos"].rows],
            peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            slack_gib=(torch.cuda.max_memory_reserved()
                       - torch.cuda.max_memory_allocated()) / 2 ** 30)
        dump()
        del res
        torch.cuda.empty_cache()


def _smi_used_mib() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return float(out.stdout.strip().splitlines()[0])


def par_context(root: str) -> None:
    """A fresh process's CUDA context on the card: the card's used memory
    (nvidia-smi) before and after the context and one 1-element tensor,
    less what the caching allocator reserved for the tensor. Writes
    ``context.json`` under ``root``."""
    import torch
    before = _smi_used_mib()
    torch.empty(1, device="cuda")
    torch.cuda.synchronize()
    after = _smi_used_mib()
    with open(os.path.join(root, "context.json.part"), "w") as f:
        json.dump({"context_mib": after - before
                   - torch.cuda.memory_reserved() / 2 ** 20}, f)
    os.replace(os.path.join(root, "context.json.part"),
               os.path.join(root, "context.json"))


def _par_config(root: str, depth: int, lr=None) -> str:
    """configs/qwen3_0.6b.json at full width, ``depth`` layers, B
    ``PAR_B`` x 1024, no QAT rules (the pipeline step takes no QAT, as the
    JAX package's), its train glob on a seeded shard in which every
    1024-token row differs (so each dp rank's rows differ); ``lr``: its
    learning rate instead of the config's."""
    with open(os.path.join(ROOT, "configs", "qwen3_0.6b.json")) as f:
        cfg = json.load(f)
    cfg["model"]["parameter"]["Layer"] = depth
    cfg["train"]["batch"] = PAR_B
    if lr is not None:
        cfg["train"]["learning-rate"] = lr
    cfg.pop("quantizer", None)
    cfg["datasets"]["train"]["glob"] = os.path.join(root, "*train*.bin")
    path = os.path.join(root, f"qwen3_{depth}l"
                        f"{'' if lr is None else f'_lr{lr:g}'}.json")
    with open(path, "w") as f:
        json.dump(cfg, f, indent=1)
    return path


def _write_32b_dir(torch, path: str) -> float:
    """A seeded bf16 checkpoint at Qwen3-32B's widths (2 layers): every
    matrix tiled from one 1024 x 1024 block drawn on the card, as the JAX
    package's rehearsal builds it. Returns the GB written."""
    from koifish_tpu_torch.config import ModelCard
    from koifish_tpu_torch.io.safetensors import write_safetensors
    card = ModelCard.from_arch("QWEN3", **QWEN3_32B)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3232)
    blk = (torch.randn((1024, 1024), generator=gen, device="cuda") * 0.02
           ).to(torch.bfloat16)

    def w(r, c):
        return blk.repeat(-(-r // 1024), -(-c // 1024))[:r, :c].cpu()
    E, D, F = card.n_embd, card.head_dim, card.n_ffn
    one = lambda n: torch.ones((n,), dtype=torch.bfloat16)
    ts = {"model.embed_tokens.weight": w(card.vocab_size, E),
          "model.norm.weight": one(E)}
    for i in range(card.n_layer):
        pre = f"model.layers.{i}."
        ts.update({
            pre + "input_layernorm.weight": one(E),
            pre + "self_attn.q_proj.weight": w(card.n_head * D, E),
            pre + "self_attn.k_proj.weight": w(card.n_kv_head * D, E),
            pre + "self_attn.v_proj.weight": w(card.n_kv_head * D, E),
            pre + "self_attn.o_proj.weight": w(E, card.n_head * D),
            pre + "self_attn.q_norm.weight": one(D),
            pre + "self_attn.k_norm.weight": one(D),
            pre + "post_attention_layernorm.weight": one(E),
            pre + "mlp.gate_proj.weight": w(F, E),
            pre + "mlp.up_proj.weight": w(F, E),
            pre + "mlp.down_proj.weight": w(E, F)})
    os.makedirs(path, exist_ok=True)
    write_safetensors(os.path.join(path, "model.safetensors"), ts)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({
            "model_type": "qwen3", "vocab_size": card.vocab_size,
            "num_hidden_layers": card.n_layer, "hidden_size": E,
            "num_attention_heads": card.n_head,
            "num_key_value_heads": card.n_kv_head, "head_dim": D,
            "intermediate_size": F, "rope_theta": 1e6, "rms_norm_eps": 1e-6,
            "tie_word_embeddings": True,
            "max_position_embeddings": card.max_pos}, f)
    return sum(t.numel() * 2 for t in ts.values()) / 1e9


PAR_32B_SHAPES = (("q", 5120, 4096), ("k/v", 5120, 512), ("o", 4096, 5120),
                  ("gate/up", 5120, 13824), ("down", 13824, 5120))


def k32b_phase(torch, gen) -> dict:
    """Rows 3 and 4 at Qwen3-32B's tp-2 shard shapes (INT4 g128), ``down``
    with K 13824 (not a multiple of 1024): each against its plain version
    at a 1024-token prefill's m and at m 1, in bf16 and with the f32
    output (rounded, the bf16 output bit for bit); ``down`` timed beside
    the library's product on the dequantized weight and its bound."""
    from koifish_tpu_torch.dtypes import QFormat
    from koifish_tpu_torch.ops.kernels import matmul as km
    from koifish_tpu_torch.quant.rtn import quantize
    out = {}
    for label, K, N in PAR_32B_SHAPES:
        w = quantize(torch.randn((K, N), generator=gen, device="cuda") * 0.02,
                     QFormat.INT4, group=128)
        for kind, m in (("qmm", 1024), ("qmv", 1)):
            x = torch.randn((m, K), generator=gen, device="cuda"
                            ).to(torch.bfloat16)
            y = km.qmatmul(x, w)
            ref = km.qmatmul_plain(x, w.codes, w.scales, w.fmt, w.group)
            torch.cuda.synchronize()
            err = max_err(y, ref)
            check(f"{kind} Qwen3-32B tp-2 {label} K{K} N{N} m{m} INT4", err,
                  1e-2 * float(ref.float().abs().max()) + 1e-3)
            # the f32 output a row-parallel shard's partial takes: the sum
            # the bf16 output rounds, bit for bit
            y32 = km.qmatmul(x, w, torch.float32)
            ref32 = km.qmatmul_plain(x, w.codes, w.scales, w.fmt, w.group,
                                     torch.float32)
            check(f"{kind} Qwen3-32B tp-2 {label} K{K} N{N} m{m} INT4 f32 "
                  f"out", max_err(y32, ref32),
                  1e-4 * float(ref32.abs().max()))
            if not torch.equal(y32.to(torch.bfloat16), y):
                fail(f"{kind} {label} K{K} N{N} m{m}: the f32 output, "
                     f"rounded, is not the bf16 output")
            if label != "down":
                continue
            deq = w.dequantize(torch.bfloat16)
            kms = time_ms(torch, lambda: km.qmatmul(x, w), iters=20)
            pms = time_ms(torch, lambda: km.qmatmul_plain(
                x, w.codes, w.scales, w.fmt, w.group), iters=3)
            lms = time_ms(torch, lambda: torch.matmul(x, deq), iters=20)
            bms, by = bound_ms(m * K * 2 + K * N // 2 + (K // 128) * N * 4
                               + m * N * 2, 2.0 * m * K * N)
            say(f"  time {kind} K{K} N{N} m{m} INT4 (32B down, tp 2): "
                f"kernel_ms={kms:.4f} plain_ms={pms:.4f} library_ms(matmul "
                f"on dequantized bf16)={lms:.4f} bound_ms={bms:.5f} ({by}); "
                f"max_abs_err {err:.3e}")
            out[kind] = dict(ms=kms, plain_ms=pms, library_ms=lms,
                             bound_ms=bms, bound_by=by, max_abs_err=err)
        del w
    return out


def parallel_phase(torch) -> tuple:
    """Slice 18: data, tensor, FSDP and pipeline parallelism, one rank a
    process: two ranks share the one card over gloo (NCCL refuses two
    ranks on one GPU), so the run shows the sharded paths computing the
    right thing with the kernels at shard shapes, and measures no
    interconnect and no multi-card speed. A generator: it writes its
    inputs and yields its root, ``mesh_groups`` runs the ranks, and it
    then checks them. Two ranks (``par_rank``) run: the gloo probe of
    CUDA-tensor collectives; (a)
    ``bubble --tp 2 --bits 4 --kv-bits 8`` through the streamed load on a
    seeded full-width Qwen3-0.6B folder of DEPTH layers (prefill logits
    against one process's run of the tp-2 arithmetic at 2e-2 and against
    the one-rank run within ``PAR_TP_GAP``, which a wrong shard must
    exceed (``tp_gates``); greedy agreement, tok/s, TTFT, launches a rank
    a step); (b) the streamed load at Qwen3-32B's widths, 2 layers (every
    shard bit for bit the one-rank ``quantize_params``'s slice, the bytes
    each rank read, peak host RSS and device bytes a rank, a prefill
    under the same gates); (c) ``koifish`` on configs/qwen3_0.6b.json at
    full width: ``--dp 2``, ``--tp 2``, ``--dp 2 --fsdp``,
    ``--pp 2`` with both schedules, 3 steps each, losses
    (``PAR_LOSS_RTOL``) and grad norms (``PAR_GNORM_RTOL``) against the
    one-rank run at the same global batch, limits that a one-rank run at
    learning rate 0 must fail. Then rows 3 and 4 at the 32B shard shapes.
    Any rank's failure fails the run; a logged plain fallback on these
    paths too. Returns ({path: rank 0's launches}, the K 13824 rows'
    numbers, their launches)."""
    import math
    import shutil
    from koifish_tpu_torch.cli import bubble, koifish
    from koifish_tpu_torch.config import ModelCard, QuantCard
    from koifish_tpu_torch.dtypes import QFormat
    from koifish_tpu_torch.io.hf_loader import load_hf_model
    from koifish_tpu_torch.parallel import planner
    from koifish_tpu_torch.quant.apply import quantize_params
    from koifish_tpu_torch.serve import cache_for, prefill
    root = os.path.join(ROOT, "build", "parallel")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t_phase = time.perf_counter()
    say("[parallel] 2 ranks, one process each, on the one card: "
        f"{torch.cuda.get_device_name(0)}; ranks sharing one card, no "
        f"interconnect measured")
    free, total = torch.cuda.mem_get_info()
    card06 = load_config("qwen3_0.6b.json").model
    card06 = ModelCard.from_arch("QWEN3", **dict(
        vocab_size=card06.vocab_size, n_layer=card06.n_layer,
        n_embd=card06.n_embd, n_head=card06.n_head,
        n_kv_head=card06.n_kv_head, head_dim=card06.head_dim,
        n_ffn=card06.n_ffn, n_ctx=1024, max_pos=QWEN3_MAX_POS))
    gb06 = write_hf_dir(torch, os.path.join(root, "qwen3_0.6b"), card06, 18)
    gb32 = _write_32b_dir(torch, os.path.join(root, "qwen3_32b_2l"))
    for d in sorted({PAR_DEPTH, PAR_TP_DEPTH}):
        _par_config(root, d)
    cfg_lr0 = _par_config(root, PAR_DEPTH, lr=0.0)
    T = 1024
    write_token_shard(os.path.join(root, "qwen3_train_000.bin"),
                      card06.vocab_size, 2 * PAR_STEPS * PAR_B * (T + 1),
                      seed=18)
    say(f"  wrote a {gb06:.2f} GB Qwen3-0.6B folder, a {gb32:.2f} GB "
        f"Qwen3-32B-width 2-layer folder, configs of {PAR_DEPTH} and "
        f"{PAR_TP_DEPTH} layers ({time.perf_counter() - t_phase:.1f} s)")
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t_wait = time.perf_counter()
    yield root                  # main runs the ranks (mesh_groups)
    t_phase += time.perf_counter() - t_wait
    with open(os.path.join(root, "context.json")) as f:
        ctx_mib = json.load(f)["context_mib"]
    ranks = []
    for r in range(2):
        with open(os.path.join(root, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    r0 = ranks[0]
    say(f"  backend: {r0['backend']}")
    say(f"  gloo on CUDA tensors (each op tried unstaged): "
        f"{json.dumps(r0['probe'])}")
    bad = [op for op in GLOO_PROBE if r0["probe"].get(op) != "ok"]
    if bad:
        fail(f"gloo refused {bad} on CUDA tensors, which the comm layer "
             f"sends unstaged")
    for r, rec in enumerate(ranks):
        for name, run in [("bubble", rec["bubble"]),
                          ("stream32b", rec["stream32b"])] + list(
                              rec["koifish"].items()):
            if run["falls"]:
                fail(f"rank {r} {name}: a plain fallback was logged: "
                     f"{run['falls']}")

    # (a) against the one-rank run
    b = r0["bubble"]
    turns = []
    bubble.main(["--hf", os.path.join(root, "qwen3_0.6b"), "--bits", "4",
                 "--kv-bits", "8", "--temperature", "0", "--max-new",
                 str(PAR_NEW), "--ctx", "512", "--prompts", CHAT_PROMPTS[0],
                 "--csv", ""], turns)
    agree = _agreement(turns[0]["tokens"], b["tokens"])
    _, p06 = load_hf_model(os.path.join(root, "qwen3_0.6b"))
    p06 = quantize_params(p06, QuantCard.from_json(
        {"self_attn": {"bits": 4}, "mlp": {"bits": 4}}), card06)
    with torch.no_grad():
        ref06, _ = prefill(card06, p06, torch.tensor([b["ids"]],
                                                     device="cuda"),
                           cache_for(card06, 1, 512, fmt=QFormat.INT8),
                           fresh=True)
    var06 = {m: prefill_variant(
        torch, card06, p06, torch.tensor([b["ids"]], device="cuda"),
        cache_for(card06, 1, 512, fmt=QFormat.INT8), m)
        for m in ("tp2", "tp2_wrong", "plain")}
    del p06
    got06 = torch.load(os.path.join(root, "logits06.pt"))
    n_steps = len(b["tokens"])
    per_step = {k: round(v / n_steps, 2) for k, v in b["counts"].items()}
    say(f"  (a) bubble --tp 2 --bits 4 --kv-bits 8: {b['tk_s']:.2f} tok/s "
        f"(rank 0; the one-rank run {turns[0]['tk_s']:.2f}), TTFT "
        f"{min(b['ttft']) * 1e3:.1f} ms warm ({len(b['ids'])}-token "
        f"prompt); greedy agreement with the one-rank run "
        f"{agree:.3f} over {n_steps} tokens; launches a rank a step "
        f"{json.dumps(per_step)} (rank 1: "
        f"{json.dumps(ranks[1]['bubble']['counts'])} in all); device bytes "
        f"a rank {b['device_bytes'] / 1e9:.3f} GB")
    tp_gates(f"(a) bubble --tp 2 (Qwen3-0.6B, {card06.n_layer} layers)",
             got06, ref06, var06)

    # (b) the 32B streamed load: every tensor of the 32B widths splits
    # over tp 2 but the 1-D norms, so a rank reads half the checkpoint
    for r, rec in enumerate(ranks):
        s = rec["stream32b"]
        share = s["read_bytes"] / (gb32 * 1e9)
        say(f"  (b) rank {r}: streamed load {s['load_s']:.1f} s, read "
            f"{s['read_bytes'] / 1e9:.4f} GB of the {gb32:.4f} GB bf16 "
            f"checkpoint ({share:.4f}); peak host RssAnon "
            f"+{s['peak_rss_mb']:.0f} MB over the load (the file's pages, "
            f"mapped, not counted); device bytes "
            f"{s['device_bytes'] / 1e9:.3f} GB; {s['leaves']} leaves, "
            f"{s['leaves_differ']} differ from the one-rank "
            f"quantize_params's slice; launches {json.dumps(s['counts'])}")
        if s["leaves_differ"]:
            fail(f"rank {r}: {s['leaves_differ']} streamed shards differ "
                 f"from the one-rank quantize_params's")
        check(f"rank {r}: the streamed load's share of the checkpoint read "
              f"(its tp-2 shards: 0.5 and the replicated norms)", share,
              0.505)
    card32 = ModelCard.from_arch("QWEN3", **QWEN3_32B)
    _, w32 = load_hf_model(os.path.join(root, "qwen3_32b_2l"))
    w32 = quantize_params(w32, QuantCard.from_json(PAR_32B_QC), card32)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(32)
    toks = torch.randint(0, 512, (1, 64), generator=gen, device="cuda")
    with torch.no_grad():
        ref32, _ = prefill(card32, w32, toks, cache_for(
            card32, 1, 128, fmt=QFormat.INT8))
    var32 = {m: prefill_variant(torch, card32, w32, toks, cache_for(
        card32, 1, 128, fmt=QFormat.INT8), m, fresh=False)
        for m in ("tp2", "tp2_wrong", "plain")}
    del w32
    torch.cuda.empty_cache()
    got32 = torch.load(os.path.join(root, "logits32.pt"))
    tp_gates("(b) the 32B-width streamed TP prefill (2 layers)", got32,
             ref32, var32)
    shutil.rmtree(os.path.join(root, "qwen3_32b_2l"))

    # (c) the koifish runs against one rank at the same global batch
    def one_rank(cfg, label):
        res, _, _ = run_cli(torch, koifish.main, [
            cfg, "--most-iter", str(PAR_STEPS), "--out-dir",
            os.path.join(root, "one_" + os.path.basename(cfg))],
            f"koifish, one rank, {label} ({PAR_STEPS} steps)")
        out = dict(losses=res["infos"].losses,
                   gnorms=res["infos"].grad_norms)
        del res
        torch.cuda.empty_cache()
        return out

    def gaps(run, ref):
        """The largest relative gap of the losses and of the grad norms."""
        return tuple(max(abs(a - c) / abs(c) for a, c in zip(run[k], ref[k]))
                     for k in ("losses", "gnorms"))
    refs = {d: one_rank(os.path.join(root, f"qwen3_{d}l.json"),
                        f"{d} layers")
            for d in sorted({PAR_DEPTH, PAR_TP_DEPTH})}
    # the gates' own check: a run that trains nothing (learning rate 0)
    # must fail them
    lr0 = one_rank(cfg_lr0, f"{PAR_DEPTH} layers, learning rate 0")
    gl, gg = gaps(lr0, refs[PAR_DEPTH])
    say(f"  (c) control, learning rate 0: losses "
        f"{[round(x, 6) for x in lr0['losses']]} grad norms "
        f"{[round(x, 5) for x in lr0['gnorms']]}; gaps to the one-rank run "
        f"loss {gl:.3e} (limit {PAR_LOSS_RTOL:g}), grad norm {gg:.3e} "
        f"(limit {PAR_GNORM_RTOL:g})")
    if gl <= PAR_LOSS_RTOL and gg <= PAR_GNORM_RTOL:
        fail("the koifish gates pass a run that trains nothing")
    paths = {"tp2_bubble": b["counts"], "tp2_stream32b": r0["stream32b"][
        "counts"]}
    for name, flags, depth in PAR_RUNS:
        runs = [rec["koifish"][name] for rec in ranks]
        k0 = runs[0]
        say(f"  (c) koifish {' '.join(flags)} ({depth} layers, B {PAR_B} x "
            f"1024): losses {[round(x, 6) for x in k0['losses']]} (one "
            f"rank {[round(x, 6) for x in refs[depth]['losses']]}); grad "
            f"norms {[round(x, 5) for x in k0['gnorms']]} (one rank "
            f"{[round(x, 5) for x in refs[depth]['gnorms']]}); step s "
            f"{[round(x, 3) for x in k0['step_s']]}; peak "
            f"{[round(r['peak_gib'], 2) for r in runs]} GiB a rank; rank 0 "
            f"launches {json.dumps(k0['counts'])}")
        if any(r["rc"] for r in runs) or any(
                len(r["losses"]) != PAR_STEPS for r in runs):
            fail(f"koifish {flags}: rc {[r['rc'] for r in runs]}, losses "
                 f"{[r['losses'] for r in runs]}")
        if not all(math.isfinite(x) for x in k0["losses"]):
            fail(f"koifish {flags}: losses {k0['losses']}")
        if "--pp" not in flags and (runs[1]["losses"] != k0["losses"]
                                    or runs[1]["gnorms"] != k0["gnorms"]):
            fail(f"koifish {flags}: the ranks report different losses or "
                 f"grad norms")
        gl, gg = gaps(k0, refs[depth])
        check(f"koifish {' '.join(flags)} losses vs one rank (largest "
              f"relative gap)", gl, PAR_LOSS_RTOL)
        check(f"koifish {' '.join(flags)} grad norms vs one rank (largest "
              f"relative gap)", gg, PAR_GNORM_RTOL)
        paths[name] = k0["counts"]
    slack = max(r["slack_gib"] for rec in ranks
                for r in rec["koifish"].values())
    say(f"  the planner's reserve (parallel/planner.RESERVE "
        f"{planner.RESERVE / 2**30:.2f} GiB): a fresh process's CUDA "
        f"context {ctx_mib:.0f} MiB + the caching allocator's largest "
        f"slack at a koifish run's peak (reserved - allocated) "
        f"{slack:.2f} GiB = {ctx_mib / 1024 + slack:.2f} GiB")
    k32 = k32b_phase(torch, gen)
    by_k = r0["stream32b"]["by_k"]
    k32_launches = {"qmm": by_k.get("qmm@13824", 0),
                    "qmv": by_k.get("qmv@13824", 0)}
    say(f"  the 32B path's K 13824 launches (rank 0): "
        f"{json.dumps(k32_launches)}")
    shutil.rmtree(root)
    say(f"[parallel] phase: {time.perf_counter() - t_phase:.1f} s (the "
        f"ranks' run not counted); card "
        f"memory before it: {free / 2**30:.2f} of {total / 2**30:.2f} GiB "
        f"free")
    return paths, k32, k32_launches


# ---------------------------------------------------------------------------
# slice 19: the zoo and sequence parallelism on the process mesh
# ---------------------------------------------------------------------------

S19_STEPS = 3           # steps of each training run
S19_DEPTH = 4           # layers of every run (the widths are slice 17's)
S19_SP_CTX = 4096       # the sp runs' context (B S19_SP_B)
S19_SP_B = 2
S19_SALMON_B = 4        # SALMON's batch, cut from slice 17's 8
S19_MLA_B = 4           # the MLA card's batch (x 1024)
S19_RING_REPS = 10      # timed rings a rank
#: every run's learning rate, without warmup: 6e-4 from the first step
#: drove GUPPY's and the MLA card's random-init losses up on an H100 (12.0
#: -> 13.7, 11.9 -> 15.2 in 3 steps), where f32 order differences grow
#: fastest
S19_LR = 2e-4
#: (a) the ring across processes: sp 2 on the 2-rank group, sp 4 on the
#: 4-rank one
S19_SP_RUNS = (("koifish_dp2_sp2", ["--dp", "2", "--sp", "2"]),
               ("koifish_tp2_sp2", ["--tp", "2", "--sp", "2"]))
#: (c) under --tp 2 and (d) under --pp 2; "mla" through the training API
#: (the CLI builds an MLA card from a DeepSeek folder only, as the JAX CLI)
S19_TP_ZOO = ("guppy", "hybrid", "mamba", "salmon", "mla")
S19_PP_ZOO = ("mamba", "salmon", "llama_vae", "mla")
#: GPT2-124M's widths, 4 layers: QKV FFN, GAU, BROWN FFN, QKV FFN
S19_HYBRID_BACKBONE = {
    "embed_tokens": {"Embedding": []},
    "a *1": {"self_attn": {"QKV": []}, "mlp": {"FFN": []}},
    "g *1": {"GAU": []},
    "b *1": {"self_attn": {"BROWN": []}, "mlp": {"FFN": []}},
    "c *1": {"self_attn": {"QKV": []}, "mlp": {"FFN": []}},
    "norm": {"Normal": []}, "output": {"CLASIFY": []}}


def _s19_cfg_dicts() -> dict:
    """Each run's config (slice 17's widths, S19_DEPTH layers; the sp
    config is configs/qwen3_0.6b.json at n_ctx S19_SP_CTX, B S19_SP_B, no
    QAT rules; "mla" holds the train and data sections of the MLA card's
    API runs); no warmup, so that 3 steps move the params at the full
    learning rate and a learning-rate-0 run reads apart, at S19_LR."""
    cfgs = {}
    sp = _qwen3_cfg("QWEN3", Layer=S19_DEPTH)
    sp["model"]["parameter"]["transformer"]["Ctx"] = S19_SP_CTX
    sp["train"]["batch"] = S19_SP_B
    cfgs["sp"] = sp
    cfgs["guppy"] = _qwen3_cfg("GUPPY", Layer=S19_DEPTH)
    cfgs["llama_vae"] = _qwen3_cfg("LLAMA_VAE", Layer=S19_DEPTH,
                                   token_embeds=[192])
    with open(os.path.join(ROOT, "configs", "gpt2_124m.json")) as f:
        hyb = json.load(f)
    hyb["model"]["backbone"] = S19_HYBRID_BACKBONE
    hyb["model"]["parameter"]["Layer"] = S19_DEPTH
    hyb.pop("datasets")
    hyb["train"].pop("save-every")
    cfgs["hybrid"] = hyb
    vocab = -(-MAMBA_130M["vocab_size"] // MAMBA_130M[
        "pad_vocab_size_multiple"]) * MAMBA_130M["pad_vocab_size_multiple"]
    train = {"batch": 8, "dump-every": 1, "learning-rate": 0.0006,
             "optimizatioin": {"method": "adamw", "grad_accumulation": 1}}
    cfgs["mamba"] = {"model": {"arch": "MAMBA", "vocab_size": vocab,
                               "parameter": {
        "Layer": S19_DEPTH, "tie_word_embeddings": True,
        "transformer": {"Ctx": 1024, "Embed": MAMBA_130M["d_model"],
                        "Head": 12, "Ffn": 4 * MAMBA_130M["d_model"]}}},
        "train": dict(train), "seed": 42}
    from koifish_tpu_torch.config import ModelCard
    pre = ModelCard.preset("qwen2.5-0.5b")
    cfgs["salmon"] = {"model": {"arch": "SCORE", "vocab_size": pre.vocab_size,
                                "parameter": {
        "Layer": S19_DEPTH, "max_pos_embeddings": pre.max_pos,
        "rope_theta": pre.rope_theta, "tie_word_embeddings": True,
        "transformer": {"Ctx": 1024, "Embed": pre.n_embd, "Head": pre.n_head,
                        "KVHead": pre.n_kv_head, "head_dim": pre.head_dim,
                        "Ffn": pre.n_ffn}}},
        "train": dict(train, batch=S19_SALMON_B), "seed": 42}
    # the MLA card comes from DEEPSEEK_V2_LITE (_s19_mla_card); its config
    # carries the train and data sections only
    cfgs["mla"] = {"model": {"arch": "QWEN3", "vocab_size": 102400,
                             "parameter": {"transformer": {"Ctx": 1024}}},
                   "train": dict(train, batch=S19_MLA_B), "seed": 42}
    for cfg in cfgs.values():       # the full rate from the first step
        cfg["train"].update({"warmup": 0, "learning-rate": S19_LR})
    for name in ("sp", "mamba"):               # the gates' controls
        cfgs[name + "_lr0"] = json.loads(json.dumps(cfgs[name]))
        cfgs[name + "_lr0"]["train"]["learning-rate"] = 0.0
    return cfgs


def _s19_write(root: str) -> dict:
    """Every run's config under ``root`` with its train glob on a seeded
    shard of its own, every row its own tokens; returns {name: path}."""
    from koifish_tpu_torch.config import CLIParams
    paths = {}
    for name, cfg in _s19_cfg_dicts().items():
        data = name.replace("_lr0", "")
        cfg = dict(cfg, datasets={"train": {
            "glob": os.path.join(root, f"{data}_train_*.bin"), "name": data}})
        cfg["debug"] = dict(cfg.get("debug", {}), most_iter=S19_STEPS)
        paths[name] = os.path.join(root, f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(cfg, f, indent=1)
        if name != data:
            continue
        p = CLIParams.load(paths[name])
        write_token_shard(os.path.join(root, f"{name}_train_000.bin"),
                          p.model.vocab_size, 2 * S19_STEPS * p.train.batch
                          * (p.model.n_ctx + 1), seed=190)
    return paths


def _s19_mla_card():
    """DeepSeek-V2-Lite as the JAX package reads it, S19_DEPTH layers,
    n_ctx 1024."""
    import dataclasses
    from koifish_tpu_torch.config import ModelCard
    return dataclasses.replace(ModelCard.from_hf(DEEPSEEK_V2_LITE),
                               n_layer=S19_DEPTH, n_ctx=1024)


def _s19_data(cfgp: str):
    """(card, train card, the batches ``koifish.main`` reads from the
    config's shard, on the card, and the run's total steps as
    ``koifish.main`` counts them, which set the learning-rate schedule);
    the MLA config's card is ``_s19_mla_card``."""
    import torch
    from koifish_tpu_torch.config import CLIParams
    from koifish_tpu_torch.data import TokenDataset
    p = CLIParams.load(cfgp)
    card, tcard = p.model, p.train
    if os.path.basename(cfgp).startswith("mla"):
        card = _s19_mla_card()
    ds = TokenDataset(p.datasets["train"].glob,
                      most=p.datasets["train"].most)
    out = []
    for b in ds.batches(tcard.batch, card.n_ctx, seed=p.seed,
                        epochs=tcard.epochs, accum=tcard.grad_accum):
        out.append(torch.from_numpy(b["tokens"].astype("int64")).cuda())
        if len(out) == S19_STEPS:
            break
    total = max(ds.total // (tcard.batch * card.n_ctx), 1) * tcard.epochs
    return card, tcard, out, total


def _s19_record(torch, kernel_log, t0, losses, gnorms, step_s) -> dict:
    torch.cuda.synchronize()
    return dict(wall=time.perf_counter() - t0, losses=losses, gnorms=gnorms,
                step_s=step_s, counts=kernel_log.launches(),
                falls=kernel_log.fallbacks(),
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)


def _s19_start(torch, kernel_log) -> float:
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernel_log.reset_launches()
    return time.perf_counter()


def s19_cli(torch, cfgp: str, flags, out_dir: str) -> dict:
    """``koifish.main`` on ``cfgp`` with ``flags`` (in a rank of a group,
    or alone): losses, grad norms, step seconds, launches, fallbacks, peak
    memory."""
    from koifish_tpu_torch.cli import koifish
    from koifish_tpu_torch.utils import kernel_log
    t0 = _s19_start(torch, kernel_log)
    res = {}
    rc = koifish.main([cfgp, "--most-iter", str(S19_STEPS), "--out-dir",
                       out_dir, *flags], res)
    if rc:
        fail(f"koifish {cfgp} {flags}: returned {rc}")
    infos = res["infos"]
    return _s19_record(torch, kernel_log, t0, infos.losses,
                       infos.grad_norms, [r[3] for r in infos.rows])


def s19_api_train(torch, cfgp: str, mesh=None) -> dict:
    """The MLA card's run through the training API ``koifish.main`` drives
    (``init_train_state``, ``shard_train_state`` on ``mesh``, the sharded
    ``make_train_step``) on the config's batches."""
    from koifish_tpu_torch.train.sharded import shard_train_state
    from koifish_tpu_torch.train.trainer import (init_train_state,
                                                 make_train_step)
    from koifish_tpu_torch.utils import kernel_log
    card, tcard, batches, total = _s19_data(cfgp)
    t0 = _s19_start(torch, kernel_log)
    state = init_train_state(card, tcard, device="cuda")
    if mesh is not None:
        state = shard_train_state(state, mesh)
    step = make_train_step(card, tcard, total_steps=total)
    losses, gnorms, step_s = [], [], []
    for toks in batches:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, m = step(state, {"tokens": toks})
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        step_s.append(time.perf_counter() - t1)
    del state
    return _s19_record(torch, kernel_log, t0, losses, gnorms, step_s)


def s19_api_pp(torch, cfgp: str, mesh, n_micro: int = 4) -> dict:
    """The pipeline loop of ``koifish --pp`` (``make_pp_train_step``, 1F1B,
    ``n_micro`` micro-batches) on the config's batches: on a pp-2 mesh the
    MLA card's run, on a one-rank mesh the reference of every pp run (the
    same, JAX-mirrored, loss on one rank)."""
    from koifish_tpu_torch.parallel.pipeline import (make_pp_train_step,
                                                     stack_for_pipeline)
    from koifish_tpu_torch.train.optimizer import init_opt_state
    from koifish_tpu_torch.train.trainer import init_train_state
    from koifish_tpu_torch.utils import kernel_log
    card, tcard, batches, total = _s19_data(cfgp)
    t0 = _s19_start(torch, kernel_log)
    state = init_train_state(card, tcard, device="cuda")
    sl, ot = stack_for_pipeline(state.params, mesh.size("pp"),
                                stage=mesh.index("pp"))
    del state
    opt = init_opt_state({"stages": sl, "other": ot}, tcard.optimizer,
                         tcard.moment_dtype)
    step = make_pp_train_step(card, tcard, mesh, n_micro, total)
    losses, gnorms, step_s = [], [], []
    for toks in batches:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        sl, ot, opt, m = step(sl, ot, opt, toks.reshape(-1, toks.shape[-1]))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        step_s.append(time.perf_counter() - t1)
    del sl, ot, opt
    return _s19_record(torch, kernel_log, t0, losses, gnorms, step_s)


def _s19_rows_one_piece(torch, q, k, v, r0: int, n: int):
    """Causal attention in f32 of the query rows r0..r0+n against every key
    (``_ring_one_piece`` for one rank's rows)."""
    B, T, Hq, D = q.shape
    g = Hq // k.shape[2]
    out = torch.empty((B, n, Hq, D), dtype=torch.float32, device=q.device)
    mask = (torch.arange(T, device=q.device)[None, :]
            <= torch.arange(r0, r0 + n, device=q.device)[:, None])
    for h in range(k.shape[2]):
        qh = q[:, r0:r0 + n, h * g:(h + 1) * g].float().transpose(1, 2)
        s = torch.einsum("bgtd,bsd->bgts", qh, k[:, :, h].float()) * D ** -0.5
        s = torch.where(mask, s, -1e30).softmax(-1)
        out[:, :, h * g:(h + 1) * g] = torch.einsum(
            "bgts,bsd->btgd", s, v[:, :, h].float())
        del s
    return out


def s19_ring(torch, dist, n: int) -> dict:
    """(a) on this rank of an n-rank group: row 13 through
    ``ring_attention_pallas_sharded`` on a ``ProcessMesh`` (sp n), each
    rank passing its chunk of one seeded RING_SHAPE q, k, v. The rank's
    output against the in-process kernel ring's (``LocalTransport``) on
    the same chunks (``torch.equal``), against the kernel's plain version
    (|Δ| <= 2^-7·|plain| + RING_ABS) and one-piece attention
    (RING_FULL_TOL); a planted transport that hands the last rank its own
    chunk again in place of rank n-2's must fail both; launches; the ring
    timed S19_RING_REPS times after a barrier, host clock and CUDA events."""
    from koifish_tpu_torch.ops.kernels import ring_attn as ra
    from koifish_tpu_torch.parallel import make_process_mesh
    from koifish_tpu_torch.parallel.ring_pallas import (
        ring_attention_pallas_sharded)
    from koifish_tpu_torch.utils import kernel_log
    B, T, Hq, Hkv, D = RING_SHAPE
    gen = torch.Generator(device="cuda")
    gen.manual_seed(19)
    q, k, v = (torch.randn((B, T, h, D), generator=gen, device="cuda",
                           dtype=torch.float32).to(torch.bfloat16)
               for h in (Hq, Hkv, Hkv))
    mesh = make_process_mesh({"sp": n})
    r, Tl = mesh.index("sp"), T // n
    mine = [x[:, r * Tl:(r + 1) * Tl] for x in (q, k, v)]
    fn = ring_attention_pallas_sharded(mesh, "sp")
    dist.barrier()
    torch.cuda.synchronize()
    kernel_log.reset_launches()
    out = fn(*mine)
    torch.cuda.synchronize()
    counts = kernel_log.launches()
    local = ra.ring_attention(*(list(x.chunk(n, dim=1)) for x in (q, k, v)))
    equal = torch.equal(out, local[r])
    del local
    state = None
    for s in range(r + 1):           # the kernel's plain version, rank r
        state = ra.ring_step_plain(mine[0], k[:, (r - s) * Tl:(r - s + 1) * Tl],
                                   v[:, (r - s) * Tl:(r - s + 1) * Tl], state,
                                   r * Tl, (r - s) * Tl, D ** -0.5)
    plain = ra.ring_finish_plain(state, torch.bfloat16)
    full = _s19_rows_one_piece(torch, q, k, v, r * Tl, Tl)
    rel = paged_rel(out, plain, RING_ABS)
    err = max_err(out, plain)
    err_full = max_err(out, full)

    class Wrong(ra.ProcessTransport):
        """The last rank's first received chunk replaced by its own."""

        def wait_recv(self, rr, c, stream):
            super().wait_recv(rr, c, stream)
            if rr == self.n - 1 and self._chunk[c] == rr - 1:
                for b in self._buf:
                    b[c].copy_(b[1 - c])
    real = ra.ProcessTransport
    ra.ProcessTransport = Wrong
    try:
        bad = fn(*mine)
        torch.cuda.synchronize()
    finally:
        ra.ProcessTransport = real
    bad_equal = torch.equal(bad, out)
    bad_rel = paged_rel(bad, plain, RING_ABS)
    bad_full = max_err(bad, full)
    del bad, full, plain, state
    host, dev = [], []
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    for _ in range(2):                # warm
        fn(*mine)
    for _ in range(S19_RING_REPS):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        e0.record()
        fn(*mine)
        e1.record()
        e1.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        dev.append(e0.elapsed_time(e1))
    med = lambda xs: sorted(xs)[len(xs) // 2]       # noqa: E731
    return dict(sp=n, rank=r, counts=counts, equal=equal, rel=rel, err=err,
                err_full=err_full, bad_equal=bad_equal, bad_rel=bad_rel,
                bad_full=bad_full, host_ms=med(host), event_ms=med(dev),
                host_all=host)


def s19_rank(root: str, group: str) -> None:
    """One rank of ``slice19_phase``'s groups on the one card (started by
    ``parallel/multihost.spawn``). ``"two"``: (a) the ring at sp 2, (c)
    the zoo under --tp 2, (d) the zoo under --pp 2; ``"four"``: (a) the
    ring at sp 4, (b) koifish --sp 2 beside --dp 2 and --tp 2. Writes
    ``{group}_rank{r}.json`` under ``root`` after each run."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, ROOT)
    from koifish_tpu_torch.parallel import make_process_mesh, multihost
    multihost.init_distributed(timeout_s=600)
    rank = dist.get_rank()
    cfgs = json.load(open(os.path.join(root, "cfgs.json")))
    rec = {"backend": multihost.backend_choice()}

    def dump():
        with open(os.path.join(root, f"{group}_rank{rank}.json"), "w") as f:
            json.dump(rec, f)
    rec["ring"] = s19_ring(torch, dist, dist.get_world_size())
    dump()
    torch.cuda.empty_cache()
    if group == "four":
        for name, flags in S19_SP_RUNS:
            rec[name] = s19_cli(torch, cfgs["sp"], flags,
                                os.path.join(root, name))
            dump()
        return
    for name in S19_TP_ZOO:
        label = f"tp2_{name}"
        rec[label] = (s19_api_train(torch, cfgs[name], make_process_mesh(
            {"tp": 2})) if name == "mla" else s19_cli(
                torch, cfgs[name], ["--tp", "2"], os.path.join(root, label)))
        dump()
    for name in S19_PP_ZOO:
        label = f"pp2_{name}"
        rec[label] = (s19_api_pp(torch, cfgs[name], make_process_mesh(
            {"pp": 2})) if name == "mla" else s19_cli(
                torch, cfgs[name], ["--pp", "2", "--pp-schedule", "1f1b"],
                os.path.join(root, label)))
        dump()


def _s19_tp_want(name: str, cfgp: str) -> tuple:
    """(launches, fallbacks) a rank's --tp 2 run of ``name`` makes, as its
    shapes give them (those of one rank: each layer's kernels once, the
    fused CE whole on every rank over the gathered head)."""
    import dataclasses
    from koifish_tpu_torch.config import CLIParams
    p = CLIParams.load(cfgp)
    card, tcard = p.model, p.train
    m = tcard.batch * card.n_ctx
    r = 2 if tcard.remat else 1
    if name == "guppy":
        return s17_train_launches(S19_STEPS, card, tcard.remat, m), {}
    if name == "hybrid":           # the QKV layers; V 50,304: bf16 logits
        qkv = card.n_layer - len(card.gau_layers) - len(card.brown_layers)
        return (s17_train_launches(S19_STEPS, dataclasses.replace(
            card, n_layer=qkv), tcard.remat, 0),
            {"flash_attention": len(card.gau_layers) * S19_STEPS * r})
    if name == "mla":              # dv != d: the logged plain attention
        card = _s19_mla_card()
        want = s17_train_launches(S19_STEPS, card, tcard.remat, m)
        for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
            want.pop(k)
        return want, {"flash_attention": card.n_layer * S19_STEPS * r}
    return {}, {}                  # mamba, salmon: no kernel, as in JAX


def _s19_gaps(run, ref) -> tuple:
    return tuple(max(abs(a - c) / abs(c) for a, c in zip(run[k], ref[k]))
                 for k in ("losses", "gnorms"))


def _s19_gate(label: str, runs, ref, want=None, falls=None) -> None:
    """Every rank's run of ``label`` against the one-rank ``ref``: finite
    losses, S19_STEPS of them, the same on every rank (a pipeline's stages
    report one loss too), the gaps within PAR_LOSS_RTOL and
    PAR_GNORM_RTOL; launches and fallbacks exactly ``want``/``falls``
    where given."""
    import math
    k0 = runs[0]
    for r, run in enumerate(runs):
        if len(run["losses"]) != S19_STEPS or not all(
                math.isfinite(x) for x in run["losses"]):
            fail(f"{label} rank {r}: losses {run['losses']}")
        if run["losses"] != k0["losses"] or run["gnorms"] != k0["gnorms"]:
            fail(f"{label}: ranks report different losses or grad norms")
    gl, gg = _s19_gaps(k0, ref)
    say(f"  {label}: losses {[round(x, 6) for x in k0['losses']]} (one rank "
        f"{[round(x, 6) for x in ref['losses']]}), grad norms "
        f"{[round(x, 5) for x in k0['gnorms']]} (one rank "
        f"{[round(x, 5) for x in ref['gnorms']]}); gaps loss {gl:.3e}, grad "
        f"norm {gg:.3e}; step s {[round(x, 3) for x in k0['step_s']]} (one "
        f"rank {[round(x, 3) for x in ref['step_s']]}); peak "
        f"{[round(x['peak_gib'], 2) for x in runs]} GiB a rank; rank 0 "
        f"launches {json.dumps(k0['counts'])}, fallbacks "
        f"{json.dumps(k0['falls'])}")
    check(f"{label} losses vs one rank (largest relative gap)", gl,
          PAR_LOSS_RTOL)
    check(f"{label} grad norms vs one rank (largest relative gap)", gg,
          PAR_GNORM_RTOL)
    if want is not None:
        for r, run in enumerate(runs):
            _exact_launches(f"{label} rank {r}", run["counts"], want)
    if falls is not None:
        for r, run in enumerate(runs):
            if run["falls"] != falls:
                fail(f"{label} rank {r}: fallbacks {run['falls']}, the "
                     f"shapes give {falls}")


def _s19_control(label: str, lr0, ref) -> None:
    """The gates' own check: a one-rank run at learning rate 0 must fail
    them against ``ref``."""
    gl, gg = _s19_gaps(lr0, ref)
    say(f"  control ({label}, learning rate 0): gaps to the one-rank run "
        f"loss {gl:.3e} (limit {PAR_LOSS_RTOL:g}), grad norm {gg:.3e} "
        f"(limit {PAR_GNORM_RTOL:g})")
    if gl <= PAR_LOSS_RTOL and gg <= PAR_GNORM_RTOL:
        fail(f"the gates pass a run that trains nothing ({label})")


def s19_tooling(torch, root: str) -> None:
    """(e) one Qwen3-0.6B train step (configs/qwen3_0.6b.json's widths and
    depth, B 8 x 1024, the training phase's shape) captured through
    ``utils.profiler.trace``; fails unless ``utils.xprof.op_profile(...,
    "CUDA")``'s top rows name the flash forward and backward and the
    fused-CE kernels."""
    from koifish_tpu_torch.config import CLIParams, TrainCard
    from koifish_tpu_torch.train import make_train_step
    from koifish_tpu_torch.train.trainer import init_train_state
    from koifish_tpu_torch.utils.profiler import trace
    from koifish_tpu_torch.utils.xprof import format_profile, op_profile
    card = CLIParams.load(os.path.join(ROOT, "configs",
                                       "qwen3_0.6b.json")).model
    tcard = TrainCard(batch=8)
    state = init_train_state(card, tcard, device="cuda")
    step = make_train_step(card, tcard, total_steps=10)
    toks = torch.randint(0, card.vocab_size, (1, 8, card.n_ctx + 1),
                         device="cuda", generator=torch.Generator(
                             device="cuda").manual_seed(195))
    state, _ = step(state, {"tokens": toks})             # warm
    torch.cuda.synchronize()
    d = os.path.join(root, "trace")
    t0 = time.perf_counter()
    with trace(d):
        state, _ = step(state, {"tokens": toks})
    wall = time.perf_counter() - t0
    rows = op_profile(d, "CUDA", top=25)
    say(f"  (e) a Qwen3-0.6B train step ({card.n_layer} layers, B 8 x "
        f"1024) under "
        f"utils.profiler.trace: {wall * 1e3:.1f} ms wall, trace "
        f"{sorted(os.listdir(d))}; utils.xprof.op_profile(..., 'CUDA'), top "
        f"{len(rows)}:")
    for ln in format_profile(rows, width=90).splitlines():
        say("    " + ln)
    names = " ".join(r.name for r in rows)
    for want in ("flash_fwd", "flash_bwd", "fce_"):
        if want not in names:
            fail(f"tooling: the profile's top rows name no {want} kernel")
    del state


def slice19_phase(torch, ring_local: dict) -> tuple:
    """Slice 19: the zoo and sequence parallelism on the process mesh, one
    rank a process, the ranks sharing the one card over gloo (no
    interconnect measured). A generator that yields its root to
    ``mesh_groups``, as ``parallel_phase``. Its ranks (``s19_rank``): 2 run
    (a) row 13 across processes at sp 2, (c) ``koifish --tp 2`` on GUPPY,
    the GPT2-124M QKV/GAU/BROWN hybrid, mamba-130m, SALMON and the
    DeepSeek-V2-Lite-width MLA card (through the training API) and (d)
    ``--pp 2`` (1F1B) on MAMBA, SALMON, LLAMA_VAE and MLA; 4 ranks run (a)
    at sp 4 and (b) ``koifish --dp 2 --sp 2`` and ``--tp 2 --sp 2``. Every
    run S19_STEPS steps at S19_DEPTH layers and slice 17's widths, each
    gated against one rank (PAR_LOSS_RTOL, PAR_GNORM_RTOL), with a
    learning-rate-0 control for (b), (c) and (d) that the gates must
    refuse, and launches exact where the shapes give them; (e) a profiled
    train step through ``utils.profiler`` and ``utils.xprof``. Returns
    ({path: rank 0's launches}, row 13's process-path numbers)."""
    import shutil
    from koifish_tpu_torch.parallel.mesh import ProcessMesh
    root = os.path.join(ROOT, "build", "slice19")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t_phase = time.perf_counter()
    say(f"[slice19] ranks one process each on the one card "
        f"({torch.cuda.get_device_name(0)}) over gloo: ranks sharing one "
        f"card, no interconnect measured")
    cfgs = _s19_write(root)
    with open(os.path.join(root, "cfgs.json"), "w") as f:
        json.dump(cfgs, f)
    torch.cuda.empty_cache()
    t_wait = time.perf_counter()
    yield root                  # main runs the ranks (mesh_groups)
    t_phase += time.perf_counter() - t_wait
    groups = {group: [json.load(open(os.path.join(
        root, f"{group}_rank{r}.json"))) for r in range(n)]
        for group, n in (("two", 2), ("four", 4))}

    # (a) row 13 across processes
    B, T, Hq, Hkv, D = RING_SHAPE
    nbytes, flops, _ = ring_bound(B, T, Hq, Hkv, D, 4, 2)
    bound, by = bound_ms(nbytes, flops)
    ring = {}
    for group in ("two", "four"):
        rs = [g["ring"] for g in groups[group]]
        n = rs[0]["sp"]
        launches = sum(x["counts"].get("ring_attn", 0) for x in rs)
        for x in rs:
            say(f"  (a) sp {n} rank {x['rank']}: launches "
                f"{json.dumps(x['counts'])}; torch.equal to the in-process "
                f"kernel ring's chunk: {x['equal']}; vs the kernel's plain "
                f"version |Δ| {x['err']:.3e} (|Δ|/(2^-7·|plain| + "
                f"{RING_ABS:g}) {x['rel']:.3f}), vs one-piece attention "
                f"{x['err_full']:.3e}; host {x['host_ms']:.4f} ms, events "
                f"{x['event_ms']:.4f} ms (medians of {S19_RING_REPS})")
            if x["counts"] != {"ring_attn": x["rank"] + 1}:
                fail(f"ring sp {n} rank {x['rank']}: launches {x['counts']}"
                     f", its steps 0..{x['rank']} give {x['rank'] + 1}")
            if not x["equal"]:
                fail(f"ring sp {n} rank {x['rank']}: the process ring's "
                     f"chunk differs from the in-process kernel ring's")
            check(f"ring sp {n} rank {x['rank']} vs its plain version "
                  f"(|Δ|/(2^-7·|plain| + RING_ABS))", x["rel"], 1.0)
            check(f"ring sp {n} rank {x['rank']} vs one-piece attention",
                  x["err_full"], RING_FULL_TOL)
        last = rs[-1]
        say(f"  (a) sp {n} planted transport (the last rank's first chunk "
            f"its own again): torch.equal {last['bad_equal']}, "
            f"|Δ|/(2^-7·|plain| + {RING_ABS:g}) {last['bad_rel']:.3f}, vs "
            f"one-piece {last['bad_full']:.3e}; must fail both gates")
        if last["bad_equal"] or last["bad_rel"] <= 1.0 or \
                last["bad_full"] <= RING_FULL_TOL:
            fail(f"ring sp {n}: the planted transport passes a gate")
        host = max(x["host_ms"] for x in rs)
        event = max(x["event_ms"] for x in rs)
        loc = ring_local["by_sp"].get(str(n), {})
        say(f"  (a) sp {n}: the ring across {n} processes {host:.4f} ms host "
            f"clock (the slowest rank, from a barrier), {event:.4f} ms CUDA "
            f"events (the slowest rank's stream); {launches} launches "
            f"(rank r: r + 1); the in-process ring (LocalTransport) in this "
            f"run: {loc.get('eager_ms', float('nan')):.4f} ms eager, "
            f"{loc.get('ms', float('nan')):.4f} ms by replay; bound "
            f"{bound:.5f} ms ({by}); ranks share one card, no interconnect")
        ring[n] = dict(launches=launches, host_ms=host, event_ms=event,
                       max_abs_err=max(x["err"] for x in rs),
                       max_err_full=max(x["err_full"] for x in rs))
    process = dict(launches=ring[4]["launches"], by_sp={
        str(n): r for n, r in ring.items()})

    # (b) koifish --sp 2 beside --dp 2 and --tp 2, against --sp 1
    from koifish_tpu_torch.config import CLIParams
    from koifish_tpu_torch.ops.kernels import fused_ce as kc
    ref = s19_cli(torch, cfgs["sp"], [], os.path.join(root, "one_sp"))
    _s19_control("sp config", s19_cli(torch, cfgs["sp_lr0"], [], os.path.join(
        root, "one_sp_lr0")), ref)
    p = CLIParams.load(cfgs["sp"])
    paths = {}
    for name, flags in S19_SP_RUNS:
        runs = [g[name] for g in groups["four"]]
        rows = p.train.batch // (2 if "--dp" in flags else 1) * p.model.n_ctx
        chunks = len(kc.chunk_plan(rows, p.model.vocab_size)[1])
        want = {"fused_ce_fwd": S19_STEPS,
                "fused_ce_dlogits": S19_STEPS * chunks,
                "fused_ce_dx": S19_STEPS * chunks,
                "fused_ce_dw": S19_STEPS * chunks}
        _s19_gate(f"(b) koifish {' '.join(flags)} (Qwen3-0.6B widths, "
                  f"{S19_DEPTH} layers, B {S19_SP_B} x {S19_SP_CTX})", runs,
                  ref, want, {})
        paths[name] = runs[0]["counts"]

    # (c) the zoo under --tp 2, against one rank
    two = groups["two"]
    refs = {}
    for name in S19_TP_ZOO:
        refs[name] = (s19_api_train(torch, cfgs[name]) if name == "mla"
                      else s19_cli(torch, cfgs[name], [],
                                   os.path.join(root, "one_" + name)))
        want, falls = _s19_tp_want(name, cfgs[name])
        _exact_launches(f"(c) {name} one rank", refs[name]["counts"], want)
        label = f"tp2_{name}"
        _s19_gate(f"(c) koifish --tp 2 {name}", [g[label] for g in two],
                  refs[name], want, falls)
        paths["koifish_" + label] = two[0][label]["counts"]
    _s19_control("mamba", s19_cli(torch, cfgs["mamba_lr0"], [], os.path.join(
        root, "one_mamba_lr0")), refs["mamba"])

    # (d) the zoo under --pp 2 (1F1B), against the pipeline on one rank
    one = ProcessMesh({"pp": 1}, "cuda")
    prefs = {}
    for name in S19_PP_ZOO:
        prefs[name] = s19_api_pp(torch, cfgs[name], one)
        label = f"pp2_{name}"
        _s19_gate(f"(d) koifish --pp 2 {name}", [g[label] for g in two],
                  prefs[name])
        for r, g in enumerate(two):     # MLA's dv != d: the logged plain
            if set(g[label]["falls"]) - ({"flash_attention"}   # attention
                                         if name == "mla" else set()):
                fail(f"(d) {name} rank {r}: fallbacks {g[label]['falls']}")
        paths["koifish_" + label] = two[0][label]["counts"]
    _s19_control("mamba pipeline", s19_api_pp(torch, cfgs["mamba_lr0"], one),
                 prefs["mamba"])

    # (e) tooling
    s19_tooling(torch, root)
    shutil.rmtree(root)
    say(f"[slice19] phase: {time.perf_counter() - t_phase:.1f} s (the "
        f"ranks' run not counted); rank 0 "
        f"launches {json.dumps(paths)}")
    return paths, process



S20_STEPS = S19_STEPS   # steps of each training run
S20_DEPTH = 4           # layers of every training run (Qwen3-0.6B widths)
S20_B = 4               # the training runs' global batch (x 1024 tokens)
S20_NEW = 16            # bubble's greedy tokens
S20_LARS = 0.5          # (d) lars_ratio
#: (e) the grad-norm gap of the pipeline with SR on to the one-rank
#: pipeline: LLAMA_VAE's 7.49e-3 under PAR_GNORM_RTOL in slice 19 came from
#: the stage-local SR index; with the stages hashing the stack's indices
#: only the f32 order of the stages' sums and the tied head's bf16 gradient
#: (summed over pp in f32, where one rank's autograd sums the two paths in
#: bf16) are left: 3.75e-5 on QWEN3 and 1.07e-3 on LLAMA_VAE on an H100, so
#: the gate is 3e-3, which the stage-local index, planted, must exceed
S20_SR_GNORM_RTOL = 3e-3
S20_NATIVE_BATCHES = 64
#: (name, config, flags) of the 2-rank group's koifish runs
S20_RUNS = (("gama_dp2_fsdp", "gama", ["--dp", "2", "--fsdp"]),
            ("fuyou_dp2", "fuyou", ["--dp", "2"]),
            ("fuyou_tp2", "fuyou", ["--tp", "2"]),
            ("lars_pp2", "lars", ["--pp", "2"]),
            ("sr_pp2", "sr", ["--pp", "2"]),
            ("llama_vae_pp2", "llama_vae", ["--pp", "2"]))


def _s20_cfg_dicts() -> dict:
    """Each run's config: configs/qwen3_0.6b.json's widths at S20_DEPTH
    layers, B S20_B x 1024, no warmup, S19_LR; "gama" keeps the shipped
    quantizer card (RTN INT4 g128) as a gama card; "fuyou" a 2-branch swarm
    rotating every step; "lars" lars_ratio S20_LARS; "sr" and "llama_vae"
    stochastic rounding on (the default); learning-rate-0 controls."""
    with open(os.path.join(ROOT, "configs", "qwen3_0.6b.json")) as f:
        shipped = json.load(f)
    base = _qwen3_cfg("QWEN3", Layer=S20_DEPTH)
    base["train"].update({"batch": S20_B, "warmup": 0,
                          "learning-rate": S19_LR})
    cfgs = {}
    for name in ("gama", "fuyou", "lars", "sr"):
        cfgs[name] = json.loads(json.dumps(base))
    cfgs["gama"]["quantizer"] = dict(shipped["quantizer"],
                                     train_target="gama")
    cfgs["fuyou"]["model"]["fuyou"] = {"branch": 2, "switch": 1}
    cfgs["lars"]["train"]["optimizatioin"]["lars_ratio"] = S20_LARS
    cfgs["llama_vae"] = _qwen3_cfg("LLAMA_VAE", Layer=S20_DEPTH,
                                   token_embeds=[192])
    cfgs["llama_vae"]["train"].update({"batch": S20_B, "warmup": 0,
                                       "learning-rate": S19_LR})
    for name in ("gama", "fuyou", "lars"):
        cfgs[name + "_lr0"] = json.loads(json.dumps(cfgs[name]))
        cfgs[name + "_lr0"]["train"]["learning-rate"] = 0.0
    return cfgs


def _s20_write(root: str) -> dict:
    """Every config under ``root``, all reading one seeded shard of
    Qwen3's vocabulary, every row its own tokens; returns {name: path}."""
    paths = {}
    glob = os.path.join(root, "qwen3_train_*.bin")
    for name, cfg in _s20_cfg_dicts().items():
        cfg = dict(cfg, datasets={"train": {"glob": glob, "name": "s20"}})
        cfg["debug"] = dict(cfg.get("debug", {}), most_iter=S20_STEPS)
        paths[name] = os.path.join(root, f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(cfg, f, indent=1)
    write_token_shard(os.path.join(root, "qwen3_train_000.bin"), 151936,
                      2 * S20_STEPS * S20_B * 1025, seed=200)
    return paths


def s20_cli(torch, cfgp: str, flags, out_dir: str) -> dict:
    """``s19_cli`` with the native host layer's calls of the run."""
    from koifish_tpu_torch import native
    native.reset_calls()
    rec = s19_cli(torch, cfgp, flags, out_dir)
    rec["native"] = native.calls()
    return rec


def _s20_bubble(torch, hf: str, draft: bool) -> dict:
    """``bubble --tp 2 --bits 8 --kv-bits 8`` greedy on ``hf`` (with the
    same folder as its draft), S20_NEW tokens: the turn, its launches,
    fallbacks and native calls."""
    from koifish_tpu_torch import native
    from koifish_tpu_torch.cli import bubble
    from koifish_tpu_torch.utils import kernel_log
    argv = ["--hf", hf, "--tp", "2", "--bits", "8", "--kv-bits", "8",
            "--temperature", "0", "--max-new", str(S20_NEW), "--ctx", "512",
            "--prompts", CHAT_PROMPTS[0], "--csv", ""]
    if draft:
        argv += ["--draft-hf", hf]
    turns = []
    torch.cuda.synchronize()
    kernel_log.reset_launches()
    native.reset_calls()
    t0 = time.perf_counter()
    if bubble.main(argv, turns):
        fail(f"bubble {argv}: nonzero return")
    torch.cuda.synchronize()
    t = turns[0]
    return dict(wall=time.perf_counter() - t0, counts=kernel_log.launches(),
                falls=kernel_log.fallbacks(), native=native.calls(),
                ids=t["prompt_ids"], tokens=t["tokens"], tk_s=t["tk_s"],
                seconds=t["seconds"], stats=t["stats"])


def _s20_stage_local(mesh, stage_layers, other, axis="pp"):
    """The pipeline's optimizer layout of slice 19 (a planted fault for
    (e)): every stage leaf unsharded, so stochastic rounding hashes its
    local index, each stage counting its own leaves once."""
    from koifish_tpu_torch.parallel.sharding import Shard
    from koifish_tpu_torch.train.sharded import ShardedLayout
    from koifish_tpu_torch.utils.tree import leaves
    flat = leaves({"other": other, "stages": stage_layers})
    lay = ShardedLayout(mesh, [Shard(tuple(x.shape), (None,) * x.dim(),
                                     (0,) * x.dim(), tuple(x.shape))
                               for x in flat])
    n = len(leaves(other))
    lay.owned = lay.owned[:n] + [1.0] * (len(flat) - n)
    return lay


def s20_rank(root: str, group: str) -> None:
    """One rank of ``slice20_phase``'s groups on the one card (started by
    ``parallel/multihost.spawn``). ``"two"``: (a) ``bubble --tp 2`` plain
    and with ``--draft-hf``, then every run of S20_RUNS; ``"four"``: (d)
    LARS under ``--dp 2 --tp 2 --fsdp``. Writes ``{group}_rank{r}.json``
    under ``root`` after each run."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, ROOT)
    from koifish_tpu_torch.parallel import multihost
    multihost.init_distributed(timeout_s=600)
    rank = dist.get_rank()
    cfgs = json.load(open(os.path.join(root, "cfgs.json")))
    rec = {"backend": multihost.backend_choice()}

    def dump():
        with open(os.path.join(root, f"{group}_rank{rank}.json"), "w") as f:
            json.dump(rec, f)
    if group == "four":
        rec["lars_dp2_tp2_fsdp"] = s20_cli(
            torch, cfgs["lars"], ["--dp", "2", "--tp", "2", "--fsdp"],
            os.path.join(root, "lars_dp2_tp2_fsdp"))
        dump()
        return
    hf = os.path.join(root, "qwen3_0.6b")
    rec["bubble_tp2"] = _s20_bubble(torch, hf, draft=False)
    dump()
    rec["bubble_tp2_spec"] = _s20_bubble(torch, hf, draft=True)
    dump()
    torch.cuda.empty_cache()
    for name, cfg, flags in S20_RUNS:
        rec[name] = s20_cli(torch, cfgs[cfg], flags, os.path.join(root, name))
        dump()
        torch.cuda.empty_cache()
    from koifish_tpu_torch.parallel import pipeline
    real = pipeline._pp_layout
    pipeline._pp_layout = _s20_stage_local
    try:                # (e)'s control: the stage-local SR index, planted
        rec["llama_vae_pp2_local"] = s20_cli(
            torch, cfgs["llama_vae"], ["--pp", "2"],
            os.path.join(root, "llama_vae_pp2_local"))
    finally:
        pipeline._pp_layout = real
    dump()


def s20_native(torch, root: str, hf: str, runs: dict) -> dict:
    """(f) the native host layer: every rank's koifish run took the batch
    server and each bubble run the BPE engine (their calls counted); the
    Qwen3 shard's first S20_NATIVE_BATCHES batches (B S20_B x 1024) and
    two seeded corpora's ids equal the Python paths', each timed on the
    host both ways."""
    import numpy as np
    from koifish_tpu_torch import native
    from koifish_tpu_torch.data import BPETokenizer, TokenDataset
    if not native.native_available():
        fail(f"native: no library ({native._error})")
    say(f"  (f) the native library {native.lib_path().name}, built from "
        f"native/*.cpp")
    for label, run in runs.items():
        key = "bpe" if label.startswith("bubble") else "batchserver"
        if run["native"].get(key, 0) <= 0:
            fail(f"(f) {label}: no native {key} calls "
                 f"({json.dumps(run['native'])})")
    glob = os.path.join(root, "qwen3_train_*.bin")

    def batches(python: bool):
        ds = TokenDataset(glob)
        if python:                       # masks present: the Python path
            ds.shards = [(t, np.ones(len(t), bool)) for t, _ in ds.shards]
        out = []
        t0 = time.perf_counter()
        for b in ds.batches(S20_B, 1024, seed=42, epochs=64):
            out.append(b["tokens"])
            if len(out) == S20_NATIVE_BATCHES:
                break
        return out, (time.perf_counter() - t0) * 1e3
    native.reset_calls()
    nat, nat_ms = batches(False)
    if native.calls().get("batchserver", 0) < S20_NATIVE_BATCHES:
        fail(f"(f) the batch server served {native.calls()}")
    py, py_ms = batches(True)
    same = all(np.array_equal(a, b) for a, b in zip(nat, py))
    say(f"  (f) {S20_NATIVE_BATCHES} batches of {S20_B} x 1025 tokens: "
        f"native {nat_ms:.2f} ms, Python {py_ms:.2f} ms (host); element "
        f"for element equal: {same}")
    if not same or len(nat) != len(py) != S20_NATIVE_BATCHES:
        fail("(f) the native batch server's batches differ from Python's")
    rng = np.random.default_rng(201)
    words = " ".join(CHAT_PROMPTS).split()
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    corpora = {   # the chat prompts' words (the Python BPE's cache hits),
        # and seeded 3-12 letter strings (nearly every pretoken new)
        "prompt words": [" ".join(rng.choice(words, 48))
                         for _ in range(400)],
        "random words": [" ".join("".join(rng.choice(letters,
                                                     rng.integers(3, 13)))
                                  for _ in range(48)) for _ in range(400)]}
    out = dict(batches_native_ms=nat_ms, batches_python_ms=py_ms)
    for label, corpus in corpora.items():
        tk = BPETokenizer.from_file(hf)
        py_tk = BPETokenizer.from_file(hf)
        py_tk._native_tried = True
        native.reset_calls()
        t0 = time.perf_counter()
        ids = [tk.encode(s) for s in corpus]
        enc_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        pids = [py_tk.encode(s) for s in corpus]
        py_enc_ms = (time.perf_counter() - t0) * 1e3
        say(f"  (f) encode 400 seeded lines of {label} "
            f"({sum(map(len, ids))} tokens, the folder's byte-level "
            f"tokenizer): native {enc_ms:.2f} ms "
            f"({native.calls().get('bpe', 0)} engine calls), Python "
            f"{py_enc_ms:.2f} ms (host; the Python BPE caches pretokens "
            f"under 64 characters); ids equal: {ids == pids}")
        if ids != pids:
            fail("(f) the native BPE's ids differ from the Python BPE's")
        out[label] = dict(encode_native_ms=enc_ms,
                          encode_python_ms=py_enc_ms)
    return out


def slice20_phase(torch) -> dict:
    """Slice 20: the last method combinations on the process mesh, the
    ranks processes sharing the one card over gloo (no interconnect
    measured). A generator that yields its root to ``mesh_groups``, as
    ``parallel_phase``. Two ranks (``s20_rank``) run (a) ``bubble --tp 2
    --bits 8 --kv-bits 8`` on a seeded full-width, full-depth Qwen3-0.6B
    folder, plain and with the same folder as its draft (k 4), greedy,
    S20_NEW tokens: the speculative tokens against the plain run's at the
    75 % greedy gate; then at Qwen3-0.6B's widths, S20_DEPTH layers, B
    S20_B x 1024, S20_STEPS steps: (b) ``koifish --dp 2 --fsdp`` on a gama
    card, (c) ``--dp 2`` and ``--tp 2`` with a 2-branch Fuyou swarm
    rotating every step, (d) ``--pp 2`` with lars_ratio S20_LARS and (e)
    ``--pp 2`` with SR on, on QWEN3 and LLAMA_VAE; four ranks run (d)
    under ``--dp 2 --tp 2 --fsdp``. Each against one rank (losses
    PAR_LOSS_RTOL, grad norms PAR_GNORM_RTOL; (e)'s grad norms
    S20_SR_GNORM_RTOL against the one-rank pipeline) with a
    learning-rate-0 control for (b), (c) and (d); (f) the native host
    layer. Returns {path: rank 0's launches}."""
    import shutil
    from koifish_tpu_torch.parallel.mesh import ProcessMesh
    root = os.path.join(ROOT, "build", "slice20")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t_phase = time.perf_counter()
    say(f"[slice20] ranks one process each on the one card "
        f"({torch.cuda.get_device_name(0)}) over gloo: ranks sharing one "
        f"card, no interconnect measured")
    card06 = _s20_card06()
    hf = os.path.join(root, "qwen3_0.6b")
    gb = write_hf_dir(torch, hf, card06, seed=5)
    cfgs = _s20_write(root)
    with open(os.path.join(root, "cfgs.json"), "w") as f:
        json.dump(cfgs, f)
    say(f"  wrote a {gb:.2f} GB Qwen3-0.6B folder (bubble_phase's seed) and "
        f"{len(cfgs)} configs ({time.perf_counter() - t_phase:.1f} s)")
    torch.cuda.empty_cache()
    t_wait = time.perf_counter()
    yield root                  # main runs the ranks (mesh_groups)
    t_phase += time.perf_counter() - t_wait
    two, four = ([json.load(open(os.path.join(root, f"{group}_rank{r}.json")))
                  for r in range(n)] for group, n in (("two", 2), ("four", 4)))
    paths = {}

    # (a) speculative decoding under bubble --tp 2
    plain, spec = two[0]["bubble_tp2"], two[0]["bubble_tp2_spec"]
    for r, g in enumerate(two):
        for label in ("bubble_tp2", "bubble_tp2_spec"):
            if g[label]["falls"]:
                fail(f"(a) rank {r} {label}: fallbacks {g[label]['falls']}")
        if g["bubble_tp2_spec"]["tokens"] != spec["tokens"]:
            fail(f"(a) rank {r} took other speculative tokens than rank 0")
    agree = _agreement(plain["tokens"], spec["tokens"])
    st = spec["stats"]
    say(f"  (a) bubble --tp 2 --bits 8 --kv-bits 8 (28 layers), "
        f"{len(spec['ids'])}-token prompt:\n    plain       "
        f"{plain['tokens']} ({plain['tk_s']:.2f} tok/s)\n    speculative "
        f"{spec['tokens']} ({spec['tk_s']:.2f} tok/s; {st['rounds']} "
        f"rounds, accept rate {st['accept_rate']:.3f})\n    greedy "
        f"agreement {agree * 100:.1f}% (gate 75%); rank 0 launches plain "
        f"{json.dumps(plain['counts'])}, speculative "
        f"{json.dumps(spec['counts'])}")
    if agree < 0.75:
        fail("(a) speculative greedy tokens under --tp 2 disagree with the "
             "plain --tp 2 run's")
    for name in ("flash_fwd", "qmm", "qmv"):
        if spec["counts"].get(name, 0) <= 0:
            fail(f"(a) the speculative run launched no {name}")
    if plain["counts"].get("kv_write", 0) <= 0:
        fail("(a) the plain run launched no decode_attn_write")
    paths["s20_bubble_tp2"] = plain["counts"]
    paths["s20_bubble_tp2_spec"] = spec["counts"]

    # (b)-(e) against one rank
    refs = {name: s20_cli(torch, cfgs[name], [], os.path.join(root, "one_"
                                                              + name))
            for name in ("gama", "fuyou", "lars")}
    for name in ("gama", "fuyou", "lars"):
        _s19_control(name, s20_cli(torch, cfgs[name + "_lr0"], [],
                                   os.path.join(root, f"one_{name}_lr0")),
                     refs[name])
    one = ProcessMesh({"pp": 1}, "cuda")
    for name in ("sr", "llama_vae"):
        refs[name + "_pipe"] = s19_api_pp(torch, cfgs[name], one)
    labels = {"gama_dp2_fsdp": "(b) koifish --dp 2 --fsdp, gama",
              "fuyou_dp2": "(c) koifish --dp 2, Fuyou",
              "fuyou_tp2": "(c) koifish --tp 2, Fuyou",
              "lars_pp2": "(d) koifish --pp 2, LARS",
              "sr_pp2": "(e) koifish --pp 2, SR on",
              "llama_vae_pp2": "(e) koifish --pp 2, SR on, LLAMA_VAE"}
    for name, cfg, _ in S20_RUNS:
        # (d) under --pp against the unstacked one-rank step: since slice
        # 21 LARS takes one ratio a layer of a stacked stage leaf
        ref = (refs[cfg + "_pipe"] if name.endswith("pp2")
               and cfg != "lars" else refs[cfg])
        runs = [g[name] for g in two]
        _s19_gate(labels[name], runs, ref)
        for r, run in enumerate(runs):
            if run["falls"]:
                fail(f"{labels[name]} rank {r}: fallbacks {run['falls']}")
        paths["s20_" + name] = runs[0]["counts"]
    _s19_gate("(d) koifish --dp 2 --tp 2 --fsdp, LARS",
              [g["lars_dp2_tp2_fsdp"] for g in four], refs["lars"])
    paths["s20_lars_dp2_tp2_fsdp"] = four[0]["lars_dp2_tp2_fsdp"]["counts"]
    for name in ("sr_pp2", "llama_vae_pp2"):
        cfg = name[:-4]
        _, gg = _s19_gaps(two[0][name], refs[cfg + "_pipe"])
        say(f"  (e) {name}: grad-norm gap to the one-rank pipeline "
            f"{gg:.3e} (slice 19's LLAMA_VAE gap 7.49e-3; gate "
            f"{S20_SR_GNORM_RTOL:g})")
        check(f"(e) {name} grad norms vs the one-rank pipeline", gg,
              S20_SR_GNORM_RTOL)
    _, gl = _s19_gaps(two[0]["llama_vae_pp2_local"], refs["llama_vae_pipe"])
    say(f"  (e) control: LLAMA_VAE --pp 2 with the stage-local SR index "
        f"(planted): grad-norm gap {gl:.3e}, must exceed the gate "
        f"{S20_SR_GNORM_RTOL:g}")
    if gl <= S20_SR_GNORM_RTOL:
        fail("(e) the gate passes the stage-local SR index")
    for name in ("qmm", "fused_ce_fwd"):
        if paths["s20_gama_dp2_fsdp"].get(name, 0) <= 0:
            fail(f"(b) the gama run launched no {name}")

    # (f) the native host layer
    s20_native(torch, root, hf, {
        "bubble_tp2": plain, "bubble_tp2_spec": spec,
        **{name: two[0][name] for name, _, _ in S20_RUNS},
        "lars_dp2_tp2_fsdp": four[0]["lars_dp2_tp2_fsdp"]})
    shutil.rmtree(root)
    say(f"[slice20] phase: {time.perf_counter() - t_phase:.1f} s (the "
        f"ranks' run not counted); rank 0 "
        f"launches {json.dumps(paths)}")
    return paths


# ---------------------------------------------------------------------------
# slice 21: the shipped paths that no card run had taken
# ---------------------------------------------------------------------------

#: steps of GPT2-1558M as shipped, and of the same card with the fused CE on
S21_G1558_STEPS = 3
#: the card-vs-CPU cut of GPT2-1558M's train card: 2 layers at widths the
#: CPU runs, its int8 gate between the cut's E x E and E x F weights (as
#: 4,194,304 lies between GPT2-1558M's 2,560,000 and 10,240,000), so that
#: fc, proj and the tied head run int8 and q, k, v and o bf16 in both
S21_CUT = dict(vocab_size=2048, n_layer=2, n_embd=128, n_head=2,
               n_kv_head=2, head_dim=64, n_ffn=512, n_ctx=64, max_pos=128)
S21_CUT_INT8_MIN_KN = 32768
S21_B, S21_P, S21_NEW = 32, 128, 64    # generate's batch, prompt, new tokens
#: the INT4 ring: S21_P + S21_NEW - 1 positions wrap past its 160 slots
#: (2 sinks), so every lane's sink keys are re-roped
S21_RING = 160
S21_BOOK_RULES = {
    "mini": {"self_attn": {"quant_method": "MINI", "bits": 3},
             "mlp": {"quant_method": "MINI", "bits": 3}},
    "sinkhorn": {"self_attn": {"quant_method": "SNQ", "bits": 4},
                 "mlp": {"quant_method": "SNQ", "bits": 4},
                 "group_size": 128}}
#: the zoo cards the JAX package's bubble serves (a .kun of each), under
#: bubble --tp 2 on the 2-rank group
S21_TP_ZOO = ("salmon", "llama_vae")


def _s21_time(label: str, t0: float) -> None:
    say(f"[time] slice21 {label}: {time.perf_counter() - t0:.1f} s")


def s21_gpt2_launches(steps: int, card, tcard, fused: bool) -> dict:
    """The launches ``steps`` steps of GPT2 ``card`` under ``tcard`` (full
    remat, int8 forwards of the weights ``int8_min_kn`` admits, bf16
    dgrad and wgrad) make at B x 1024 rows: a flash forward a layer twice
    (the recompute), a dK/dV and a dQ a layer; row 12's rowquant (x) and
    colquant (w) once for each int8 forward, each layer's twice and the
    tied head's once; with ``fused`` the int8 fused CE's forward, and its
    dlogits, dx and dW per vocab chunk."""
    from koifish_tpu_torch.ops.kernels import fused_ce as kc
    L, E, F = card.n_layer, card.n_embd, card.n_ffn
    HD = card.n_head * card.head_dim
    per_layer = sum(a * b >= tcard.int8_min_kn for a, b in (
        (E, HD), (E, HD), (E, HD), (HD, E), (E, F), (F, E)))
    q = steps * (2 * per_layer * L
                 + (card.vocab_size * E >= tcard.int8_min_kn))
    out = {"flash_fwd": steps * 2 * L, "flash_bwd_dkv": steps * L,
           "flash_bwd_dq": steps * L, "rowquant": q, "colquant": q}
    if fused:
        chunks = len(kc.chunk_plan(tcard.batch * 1024, card.vocab_size)[1])
        out.update(fused_ce_fwd_int8=steps,
                   fused_ce_dlogits_int8=steps * chunks,
                   fused_ce_dx_int8=steps * chunks,
                   fused_ce_dw_int8=steps * chunks)
    return out


def s21_gpt2(torch) -> dict:
    """(1) GPT2-1558M from configs/gpt2_1558m.json at its full width and
    depth (48 layers, E 1600, 25 heads of D 64, F 6400, V 50,304), B 16 x
    1024, its train card as shipped (int8 forwards of weights >= 4,194,304
    elements: fc, proj and the tied head; full remat; bf16 moments; the
    CE by the auto rule, which V 50,304 < 65,536 keeps off the fused CE)
    with warmup 10, S21_G1558_STEPS steps; then the same card with the
    fused CE on (the int8 fused CE at E 1600). Fails unless every loss is
    in ``bench.py``'s (0, 11.5), the first within 0.5 of ln 50,304, and the
    launches are exactly the shapes'. Then the card-vs-CPU step of the
    card's 2-layer cut. Returns {path: launches}."""
    import dataclasses
    import math
    from koifish_tpu_torch.config import CLIParams
    p = CLIParams.load(os.path.join(ROOT, "configs", "gpt2_1558m.json"))
    card = p.model
    base = dataclasses.replace(p.train, warmup=10, dump_every=1, seed=p.seed)
    say(f"[slice21] (1) GPT2-1558M card from configs/gpt2_1558m.json: "
        f"L={card.n_layer} int8_matmul={base.int8_matmul} int8_min_kn="
        f"{base.int8_min_kn} int8_dgrad={base.int8_dgrad} fused_ce="
        f"{base.fused_ce} moment_dtype={base.moment_dtype} remat="
        f"{base.remat} batch={base.batch} lr={base.lr}")
    paths = {}
    for path, label, over in (
            ("s21_gpt2_1558m", "GPT2-1558M as shipped", {}),
            ("s21_gpt2_1558m_fused_ce", "GPT2-1558M, the int8 fused CE on",
             {"fused_ce": True})):
        t0 = time.perf_counter()
        tcard = dataclasses.replace(base, **over)
        losses, counts = train_model(torch, label, "gpt2_1558m.json",
                                     tcard.batch, steps=S21_G1558_STEPS,
                                     tcard=tcard, full_depth=True)
        if not all(0.0 < x < 11.5 for x in losses):
            fail(f"{label}: a loss outside bench.py's gate (0, 11.5): "
                 f"{losses}")
        if abs(losses[0] - math.log(card.vocab_size)) > 0.5:
            fail(f"{label}: the first loss {losses[0]} is not within 0.5 of "
                 f"ln {card.vocab_size} = {math.log(card.vocab_size):.4f}")
        _exact_launches(label, counts, s21_gpt2_launches(
            S21_G1558_STEPS, card, tcard, bool(over)))
        paths[path] = counts
        _s21_time(path, t0)
    t0 = time.perf_counter()
    cut = dataclasses.replace(card, **S21_CUT)
    tcut = dataclasses.replace(
        p.train, batch=4, lr=1e-3, warmup=0, scheduler="static",
        stochastic_round=False, check_tensor_norm=True,
        int8_min_kn=S21_CUT_INT8_MIN_KN)
    _step_card_vs_cpu(torch, "GPT2-1558M train card, 2-layer cut", cut, tcut,
                      cut.vocab_size, 2e-2, 5e-2, TOL_HEAD,
                      zero_grad=("k_b",))
    _s21_time("GPT2-1558M card vs CPU", t0)
    return paths


def _s21_generate(torch, label: str, card, qp, gen, fmt, size: int,
                  want: dict):
    """``generate`` of S21_NEW tokens (temperature 0.6, decode_chunk 16)
    from B S21_B x S21_P seeded prompts over a ``fmt`` cache of ``size``
    slots, its launches counted from 0: fails unless the tokens are in
    shape and vocabulary and the launches are exactly ``want``. Returns
    (launches, the cache's last position, its slots)."""
    from koifish_tpu_torch.config import SamplerCard
    from koifish_tpu_torch.serve import cache_for, generate
    from koifish_tpu_torch.utils import kernel_log
    prompts = torch.randint(0, card.vocab_size, (S21_B, S21_P), generator=gen,
                            device="cuda", dtype=torch.int64)
    cache = cache_for(card, S21_B, size, fmt=fmt, layered=True)
    torch.cuda.synchronize()
    kernel_log.reset_launches()
    t0 = time.perf_counter()
    toks, cache = generate(card, qp, prompts, cache,
                           sampler=SamplerCard(temperature=0.6, top_k=50,
                                               top_p=0.95),
                           max_new_tokens=S21_NEW, decode_chunk=16)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernel_log.launches()
    say(f"  {wall:.2f} s, {S21_B * S21_NEW / wall:.1f} generated tok/s "
        f"(prefill included)")
    if tuple(toks.shape) != (S21_B, S21_NEW) or int(toks.min()) < 0 \
            or int(toks.max()) >= card.vocab_size:
        fail(f"{label}: tokens {tuple(toks.shape)} out of shape or range")
    _exact_launches(label, counts, want)
    return counts, int(cache.pos[0]), cache.size


def s21_int4_wrap(torch) -> dict:
    """(2) Qwen3-0.6B at its widths, DEPTH layers, INT4 RTN g128 weights,
    ``_s21_generate`` over an INT4 cache of S21_RING slots with 2 sinks:
    every lane wraps and its sink keys are re-roped. Fails unless the ring
    wrapped and the launches are exactly the shapes': the prefill's flash
    forward and row 3 in 7 projections a layer, then each decode step's
    row 4 in 7 projections and one row 7-write (the INT4 entry) a layer.
    Then the tiny card's INT4 ring (S 16, 20 new) card vs CPU."""
    from koifish_tpu_torch.dtypes import QFormat
    from koifish_tpu_torch.models import init_params
    from koifish_tpu_torch.quant import quantize_params
    t0 = time.perf_counter()
    p = load_config("qwen3_0.6b.json")
    card = p.model
    gen = torch.Generator(device="cuda")
    gen.manual_seed(p.seed)
    qp = quantize_params(init_params(card, gen), p.quant, card)
    say(f"[slice21] (2) Qwen3-0.6B INT4 RTN g128 weights, {card.n_layer} "
        f"layers, INT4 KV ring of {S21_RING} slots (2 sinks): B={S21_B}, "
        f"P={S21_P}, {S21_NEW} new")
    L, steps = card.n_layer, S21_NEW - 1
    counts, pos, size = _s21_generate(
        torch, "INT4 KV generate over a wrapping ring", card, qp, gen,
        QFormat.INT4, S21_RING, {
            "flash_fwd": L, "qmm": 7 * L, "qmv": 7 * L * steps,
            "decode_attn": L * steps, "kv_write": L * steps})
    say(f"  positions {pos} on {size} slots")
    if pos != S21_P + S21_NEW - 1 or not pos > size:
        fail(f"INT4 ring: position {pos} did not wrap {size} slots")
    del qp
    torch.cuda.empty_cache()
    _tiny_serve_check(torch, "tiny INT4 ring (S 16, 20 new)", {
        "self_attn": {"bits": 4}, "mlp": {"bits": 4}, "group_size": 128},
        QFormat.INT4, 16, 3, 6, 20)
    _s21_time("int4_wrap", t0)
    return counts


def s21_bf16_batcher(torch, card, qp) -> dict:
    """(3) ``batcher_phase``'s ContinuousBatcher (``qp``: its k-means NF4
    Qwen3-0.6B at DEPTH layers, 32 slots of 1024, decode_chunk 8, its 96
    seeded requests) over a BF16 pool: the decode's per-lane K/V writes
    take row 8's standalone kernel (one launch a layer a step), its
    attention plain PyTorch (the JAX package's Pallas decode kernel takes
    quantized caches only). Fails unless every request completes and the
    launches are exactly the shapes': each request's bucketed prefill a
    flash forward a layer and the book GEMM (bucket > 32) or GEMV in 7
    projections a layer, each decode step the book GEMV in 7 and one slot
    write a layer. Then the tiny card's BF16 batcher card vs CPU."""
    from koifish_tpu_torch.config import SamplerCard
    from koifish_tpu_torch.dtypes import QFormat
    from koifish_tpu_torch.ops.kernels.matmul import GEMV_MAX_M
    from koifish_tpu_torch.serve import ContinuousBatcher, Request
    from koifish_tpu_torch.serve.batching import _bucket
    from koifish_tpu_torch.utils import kernel_log
    t0 = time.perf_counter()
    N_REQ, SLOTS, S, CHUNK = 96, 32, 1024, 8
    reqs = batcher_requests(torch, card, N_REQ, 42)
    say(f"[slice21] (3) ContinuousBatcher({SLOTS} slots, S={S}, "
        f"decode_chunk={CHUNK}) over a BF16 pool, k-means NF4 weights, "
        f"{card.n_layer} layers, {N_REQ} requests")
    eng = ContinuousBatcher(card, qp, n_slots=SLOTS, cache_size=S,
                            kv_fmt=QFormat.BF16,
                            sampler=SamplerCard(temperature=0.6, top_k=50,
                                                top_p=0.95),
                            decode_chunk=CHUNK)
    for r in reqs:
        eng.submit(r)
    eng.warmup()
    torch.cuda.synchronize()
    dispatches = [0]
    decode = eng._decode

    def counted(*args):
        dispatches[0] += 1
        return decode(*args)
    eng._decode = counted
    kernel_log.reset_launches()
    t1 = time.perf_counter()
    results = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = kernel_log.launches()
    done = [results[r.rid] for r in reqs if r.rid in results]
    say(f"  completed {len(done)} of {N_REQ} requests in {wall:.2f} s; "
        f"aggregate decode {eng.aggregate_tokens_per_sec:.1f} tok/s; "
        f"{dispatches[0]} decode dispatches")
    if len(done) != N_REQ or any(len(r.tokens) != r.max_new for r in done):
        fail("BF16 batcher: a request did not complete its tokens")
    L, steps = card.n_layer, dispatches[0] * CHUNK
    small = sum(_bucket(len(r.prompt)) <= GEMV_MAX_M for r in reqs)
    _exact_launches("BF16 KV batcher", counts, {
        "flash_fwd": L * N_REQ, "qmm_book": 7 * L * (N_REQ - small),
        "qmv_book": 7 * L * (small + steps), "slot_write": L * steps})
    del eng
    torch.cuda.empty_cache()
    # the tiny card: the BF16 batcher's greedy tokens, card vs CPU
    from koifish_tpu_torch.config import QuantCard
    from koifish_tpu_torch.models import init_params
    from koifish_tpu_torch.quant import quantize_params
    tiny = _tiny_card()
    p_cpu = quantize_params(init_params(tiny, device="cpu", seed=21),
                            QuantCard.from_json(KMEANS_RULES), tiny,
                            device="cpu")
    g = torch.Generator().manual_seed(21)
    lens = torch.randint(3, 40, (5,), generator=g).tolist()
    prompts = [torch.randint(0, 256, (n,), generator=g).tolist()
               for n in lens]
    toks = {}
    for dev, params in (("cpu", p_cpu), ("cuda", _to_card(p_cpu))):
        e = ContinuousBatcher(tiny, params, n_slots=2, cache_size=96,
                              kv_fmt=QFormat.BF16,
                              sampler=SamplerCard(temperature=0.0),
                              decode_chunk=4, device=dev)
        for i, ids in enumerate(prompts):
            e.submit(Request(rid=i, prompt=ids, max_new=10))
        res = e.run()
        toks[dev] = torch.tensor([res[i].tokens for i in range(5)])
    _agree("tiny ContinuousBatcher (k-means, BF16 KV)", toks["cpu"],
           toks["cuda"])
    _s21_time("bf16_batcher", t0)
    return counts


def s21_books(torch) -> dict:
    """(4) Qwen3-0.6B at its widths, DEPTH layers, quantized on the card
    with MINI NF3 per-row books, then with Sinkhorn INT4 g128 (its row
    factors fold into the activations before rows 3 and 4):
    ``_s21_generate`` over an INT8 cache of 1024. Fails unless the
    launches are exactly the shapes' (MINI: rows 6b at the prefill and 6a
    at each decode step, 7 a layer; Sinkhorn: rows 3 and 4; both a flash
    forward a layer at the prefill and one row 7-write a layer a step).
    Then the tiny card with each rule card vs CPU."""
    from koifish_tpu_torch.config import QuantCard
    from koifish_tpu_torch.dtypes import QFormat
    from koifish_tpu_torch.models import init_params
    from koifish_tpu_torch.quant import quantize_params
    p = load_config("qwen3_0.6b.json")
    card = p.model
    L, steps = card.n_layer, S21_NEW - 1
    paths = {}
    for name, rules in S21_BOOK_RULES.items():
        t0 = time.perf_counter()
        gen = torch.Generator(device="cuda")
        gen.manual_seed(p.seed)
        qp = quantize_params(init_params(card, gen),
                             QuantCard.from_json(rules), card)
        torch.cuda.synchronize()
        w = qp["layers"][0]["q"]
        say(f"[slice21] (4) Qwen3-0.6B {name}: {w.fmt.name} codes, book "
            f"{None if w.codebook is None else tuple(w.codebook.shape)}, row "
            f"factors {None if w.row_scale is None else tuple(w.row_scale.shape)}"
            f"; quantized on the card in {time.perf_counter() - t0:.2f} s")
        gemm, gemv = ("qmm_book", "qmv_book") if name == "mini" else \
            ("qmm", "qmv")
        paths[f"s21_{name}"], _, _ = _s21_generate(
            torch, f"{name} generate", card, qp, gen, QFormat.INT8, 1024, {
                "flash_fwd": L, gemm: 7 * L, gemv: 7 * L * steps,
                "decode_attn": L * steps, "kv_write": L * steps})
        del qp
        torch.cuda.empty_cache()
        _tiny_serve_check(torch, f"tiny {name} card", rules, QFormat.INT8, 96,
                        4, 70, 12)
        _s21_time(name, t0)
    return paths


def slice21_phase(torch, book_card=None, book_qp=None) -> dict:
    """Slice 21: the shipped paths that no card run had taken, each with a
    card-vs-CPU check at a tiny size (logits 5e-2, greedy tokens 75 %, loss
    2e-2 and grad norms 5 % for int8) and its launches exactly as the
    shapes give: (1) GPT2-1558M trained as shipped (``s21_gpt2``), (2) INT4
    KV serving over a wrapping ring (``s21_int4_wrap``), (3) the BF16-KV
    batcher on ``batcher_phase``'s k-means params (``s21_bf16_batcher``;
    made here when the phase runs alone), (4) MINI NF3 and Sinkhorn weights
    served (``s21_books``). Returns {path: launches}."""
    t0 = time.perf_counter()
    if book_qp is None:
        from koifish_tpu_torch.config import QuantCard
        from koifish_tpu_torch.models import init_params
        from koifish_tpu_torch.quant import quantize_params
        p = load_config("qwen3_0.6b.json")
        book_card = p.model
        gen = torch.Generator(device="cuda")
        gen.manual_seed(p.seed)
        book_qp = quantize_params(init_params(book_card, gen),
                                  QuantCard.from_json(KMEANS_RULES),
                                  book_card)
    paths = s21_gpt2(torch)
    paths["s21_int4_wrap"] = s21_int4_wrap(torch)
    paths["s21_bf16_batcher"] = s21_bf16_batcher(torch, book_card, book_qp)
    paths.update(s21_books(torch))
    say(f"[slice21] phase: {time.perf_counter() - t0:.1f} s; launches "
        f"{json.dumps(paths)}")
    return paths


def _s21_kun(torch, path: str, name: str, seed: int) -> float:
    """A ``.kun`` of zoo card ``name`` (SALMON at the qwen2.5-0.5b preset's
    widths, the reference's arch string "SCORE"; LLAMA_VAE at Qwen3-0.6B's
    with token_embeds [192]), DEPTH layers, its params seeded on the card
    under the Llama names the loaders map (LLAMA_VAE's evae stack under its
    tree paths, which they drop), with a byte-level tokenizer.json beside
    it. Returns the GB written."""
    from koifish_tpu_torch.config import ModelCard
    from koifish_tpu_torch.io.kun import write_kun
    from koifish_tpu_torch.models import init_params
    from koifish_tpu_torch.utils.tree import flatten_with_path
    if name == "salmon":
        model = json.loads(json.dumps(_s19_cfg_dicts()["salmon"]["model"]))
    else:
        model = _qwen3_cfg("LLAMA_VAE", token_embeds=[192])["model"]
    model["parameter"]["Layer"] = DEPTH
    card = ModelCard.from_json(model)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    params = init_params(card, gen)
    names = {"ln1": "input_layernorm.weight",
             "ln2": "post_attention_layernorm.weight",
             "qn": "self_attn.q_norm.weight", "kn": "self_attn.k_norm.weight",
             "q": "self_attn.q_proj.weight", "k": "self_attn.k_proj.weight",
             "v": "self_attn.v_proj.weight", "o": "self_attn.o_proj.weight",
             "gate": "mlp.gate_proj.weight", "up": "mlp.up_proj.weight",
             "down": "mlp.down_proj.weight", "q_b": "self_attn.q_proj.bias",
             "k_b": "self_attn.k_proj.bias", "v_b": "self_attn.v_proj.bias"}
    ts = {"model.embed_tokens.weight": params["wte"],
          "model.norm.weight": params["ln_f"]}
    for i, lp in enumerate(params["layers"]):
        for k, w in lp.items():     # HF linears store [out, in]
            ts[f"model.layers.{i}.{names[k]}"] = w.T if w.dim() == 2 else w
    for pth, w in flatten_with_path(params.get("evae", {})):
        ts["evae." + ".".join(str(x) for x in pth)] = w
    ts = {k: w.contiguous().cpu() for k, w in ts.items()}
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_kun(path, {"model": model}, ts)
    write_tokenizer_json(os.path.dirname(path))
    return sum(w.numel() * w.element_size() for w in ts.values()) / 1e9


def s21_rank(root: str, group: str) -> None:
    """One rank of ``slice21_tp_phase``'s 2-rank group: ``bubble --tp 2
    --bits 8 --kv-bits 8`` greedy on each S21_TP_ZOO card's ``.kun``
    (``_s20_bubble``). Writes ``two_rank{r}.json`` under ``root``."""
    if group != "two":
        return
    import torch
    import torch.distributed as dist
    sys.path.insert(0, ROOT)
    from koifish_tpu_torch.parallel import multihost
    multihost.init_distributed(timeout_s=600)
    rec = {}
    for name in S21_TP_ZOO:
        rec[name] = _s20_bubble(torch, os.path.join(root, name, "model.kun"),
                                draft=False)
        torch.cuda.empty_cache()
    with open(os.path.join(root, f"two_rank{dist.get_rank()}.json"),
              "w") as f:
        json.dump(rec, f)


def slice21_tp_phase(torch) -> dict:
    """Slice 21's F2 run: SALMON and LLAMA_VAE, the zoo cards the JAX
    package's ``bubble`` serves, through ``bubble --tp 2 --bits 8 --kv-bits
    8`` on 2 ranks sharing the card over gloo (``s21_rank``) and through
    ``bubble`` on one rank in this process, greedy, S20_NEW tokens, on a
    ``.kun`` of each (``_s21_kun``). A generator that yields its root to
    ``mesh_groups``. Fails unless both ranks take the same tokens, those
    meet the one-rank run's at the 75 % greedy gate, and rank 0's launches
    are exactly the shapes' (the prefill a flash forward a layer, SALMON's
    too: the serving prefill is causal whatever the card, as in the JAX
    package; row 3 in the prefill's 7 projections a layer, then row 4 in 7
    and one row 7-write a layer each decode step). Returns {path: rank 0's
    launches}."""
    import shutil
    root = os.path.join(ROOT, "build", "slice21")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t0 = time.perf_counter()
    for i, name in enumerate(S21_TP_ZOO):
        gb = _s21_kun(torch, os.path.join(root, name, "model.kun"), name,
                      seed=21 + i)
        say(f"[slice21] wrote a {gb:.2f} GB .kun of {name.upper()} "
            f"({DEPTH} layers)")
    torch.cuda.empty_cache()
    t_wait = time.perf_counter()
    yield root
    t0 += time.perf_counter() - t_wait
    ranks = [json.load(open(os.path.join(root, f"two_rank{r}.json")))
             for r in range(2)]
    paths = {}
    for name in S21_TP_ZOO:
        kun = os.path.join(root, name, "model.kun")
        turns, _ = _chat(torch, ["--hf", kun, "--bits", "8", "--kv-bits",
                                 "8", "--temperature", "0", "--max-new",
                                 str(S20_NEW), "--ctx", "512", "--prompts",
                                 CHAT_PROMPTS[0], "--csv", ""],
                         f"{name} bubble on one rank", n_turns=1)
        run = ranks[0][name]
        if ranks[1][name]["tokens"] != run["tokens"]:
            fail(f"{name} --tp 2: the ranks took other tokens")
        agree = _agreement(turns[0]["tokens"], run["tokens"])
        say(f"  {name} bubble --tp 2 --bits 8 --kv-bits 8: "
            f"{len(run['ids'])}-token prompt, tokens {run['tokens']} "
            f"({run['tk_s']:.2f} tok/s), one rank's {turns[0]['tokens']}: "
            f"{agree * 100:.1f}% agree (gate 75%)")
        if agree < 0.75:
            fail(f"{name}: the --tp 2 tokens disagree with one rank's")
        L, steps = DEPTH, len(run["tokens"]) - 1
        want = {"flash_fwd": L, "qmm": 7 * L, "qmv": 7 * L * steps,
                "decode_attn": L * steps, "kv_write": L * steps}
        _exact_launches(f"{name} bubble --tp 2, rank 0", run["counts"], want)
        paths[f"s21_{name}_tp2"] = run["counts"]
    shutil.rmtree(root)
    _s21_time("the zoo under bubble --tp 2 (the ranks' run not counted)",
              t0)
    return paths


def mesh_rank(roots: dict, group: str) -> None:
    """One rank of the shared groups (``mesh_groups``): the rank work of
    slices 18, 19 and 20 (those of ``roots``: "parallel", "slice19",
    "slice20") one after another in one process, so that a group starts
    its processes, and warms its first training step, once. ``"two"``:
    rank 0 first measures a fresh process's CUDA context (``par_context``)
    while the other rank waits, then ``par_rank``, ``s19_rank`` and
    ``s20_rank``; ``"four"``: ``s19_rank`` and ``s20_rank``."""
    import gc
    import torch
    if group == "two" and "parallel" in roots:
        ctx = os.path.join(roots["parallel"], "context.json")
        if int(os.environ["KOIFISH_RANK"]) == 0:
            par_context(roots["parallel"])
        else:
            t0 = time.perf_counter()
            while not os.path.exists(ctx):
                if time.perf_counter() - t0 > 300:
                    raise TimeoutError("rank 0 measured no CUDA context")
                time.sleep(0.05)
        par_rank(roots["parallel"])
    for name, rank_fn in (("slice19", s19_rank), ("slice20", s20_rank),
                          ("slice21", s21_rank)):
        if name in roots:
            gc.collect()
            torch.cuda.empty_cache()
            rank_fn(roots[name], group)


def mesh_groups(torch, roots: dict) -> None:
    """The ranks of ``parallel_phase``, ``slice19_phase`` and
    ``slice20_phase`` (those whose root ``roots`` names): one group of 2
    processes and, for slices 19 and 20, one of 4 (``mesh_rank``), each
    started once by ``parallel/multihost.spawn``; the phases read what
    the ranks wrote under their roots. One phase alone:
    ``ph = slice20_phase(torch); mesh_groups(torch, {"slice20": next(ph)});
    resume(ph)``."""
    from koifish_tpu_torch.parallel import multihost
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    for group, n in (("two", 2), ("four", 4)):
        names = [k for k in roots
                 if group == "two" or k not in ("parallel", "slice21")]
        if not names:
            continue
        t0 = time.perf_counter()
        multihost.spawn(mesh_rank, n, (roots, group))
        say(f"[mesh] the {n}-rank group ({', '.join(names)}) ran in "
            f"{time.perf_counter() - t0:.1f} s")


def resume(phase):
    """Run a phase that yielded its root to ``mesh_groups`` to its end;
    returns what it returns."""
    try:
        next(phase)
    except StopIteration as done:
        return done.value
    fail(f"{phase.__name__} yielded twice")


def _s20_card06():
    """configs/qwen3_0.6b.json's card, as ``bubble_phase`` writes it."""
    from koifish_tpu_torch.config import CLIParams
    return CLIParams.load(os.path.join(ROOT, "configs", "qwen3_0.6b.json")
                          ).model


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, ROOT)
    from koifish_tpu_torch.ops.kernels import _build
    t_start = time.perf_counter()

    def timed(fn, *args):
        """``fn(*args)``, then its seconds and the script's so far."""
        t0 = time.perf_counter()
        out = fn(*args)
        now = time.perf_counter()
        name = args[0].__name__ if fn in (next, resume) else fn.__name__
        say(f"[time] {name}: {now - t0:.1f} s ({now - t_start:.1f} s "
            f"since the build began)")
        return out

    say("[build] nvcc " + " ".join(_build.ARCH))
    t0 = time.perf_counter()
    secs = _build.build()
    say(f"  built {sorted(secs)} in {time.perf_counter() - t0:.1f} s "
        f"(parallel; per library: "
        f"{ {k: round(v, 1) for k, v in secs.items()} })")
    for name in _build.SOURCES:
        log = _build.ptxas_summary(name)
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spill = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores", log))
        say(f"  ptxas {name}: {len(regs)} kernels, "
            f"{min(regs, default=0)}-{max(regs, default=0)} registers, "
            f"{spill} bytes of spill stores in all")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"[card] {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flash = timed(flash_phase, torch, gen)
    qmm = timed(qmatmul_phase, torch, gen)
    dec = timed(decode_attn_phase, torch, gen)
    pag = timed(paged_attn_phase, torch, gen)
    bwd = timed(flash_bwd_phase, torch, gen)
    fce = timed(fused_ce_phase, torch, gen)
    i8 = timed(int8_phase, torch, gen)
    sw = timed(slotwrite_phase, torch, gen)
    book = timed(book_phase, torch, gen)
    q8 = timed(qmv_int8_phase, torch, gen)
    timed(qmatmul_grad_phase, torch, gen)
    serve_counts = timed(slice_phase, torch)
    batch_counts, card, qp = timed(batcher_phase, torch)
    paged_counts = timed(paged_phase, torch, card, qp)
    torch.cuda.empty_cache()
    timed(reference_check_slice3, torch)
    chat_counts = timed(bubble_phase, torch)
    train_counts = timed(train_phase, torch)
    timed(reference_check_int8, torch)
    g774_counts, tile_counts = timed(train_774m_phase, torch)
    sft_counts = timed(koifish_phase, torch)
    say(f"[koifish] the SFT run's launches: {json.dumps(sft_counts)}")
    s13 = timed(slice13_phase, torch)
    g14 = torch.Generator(device="cuda")
    g14.manual_seed(14)
    ring, ring_counts = timed(ring_phase, torch, g14)
    sp_counts = timed(sp_train_phase, torch)
    zoo = timed(zoo_phase, torch)
    s17, k1536, k1536_launches = timed(slice17_phase, torch)
    s21 = timed(slice21_phase, torch, card, qp)
    del qp
    torch.cuda.empty_cache()
    # slices 18-21: each phase writes its inputs and yields its root, the
    # ranks of all four run in one 2-rank and one 4-rank group, then each
    # phase checks what its ranks wrote
    mesh = (parallel_phase(torch), slice19_phase(torch, ring),
            slice20_phase(torch), slice21_tp_phase(torch))
    roots = dict(zip(("parallel", "slice19", "slice20", "slice21"),
                     (timed(next, m) for m in mesh)))
    timed(mesh_groups, torch, roots)
    par, k13824, k13824_launches = timed(resume, mesh[0])
    s19, ring_process = timed(resume, mesh[1])
    s20 = timed(resume, mesh[2])
    s21.update(timed(resume, mesh[3]))

    src = "koifish_tpu_torch/csrc/"
    rows = [  # (name, source, TPU kernel, numbers, launches on its path)
        ("flash_fwd", "flash_fwd.cu", "koifish_tpu/ops/pallas/flash.py:844",
         flash, serve_counts),
        ("qmm", "qmm.cu", "koifish_tpu/ops/pallas/matmul.py:305",
         qmm["qmm"], serve_counts),
        ("qmv", "qmatmul.cu", "koifish_tpu/ops/pallas/matmul.py:201",
         qmm["qmv"], serve_counts),
        ("decode_attn", "decode_attn.cu",
         "koifish_tpu/ops/pallas/decode_attn.py:179", dec["decode_attn"],
         serve_counts),
        ("decode_attn_write", "decode_attn.cu",
         "koifish_tpu/ops/pallas/decode_attn.py:179",
         dec["decode_attn_write"],
         {"decode_attn_write": serve_counts.get("kv_write", 0)}),
        ("flash_bwd_dkv", "flash_bwd.cu",
         "koifish_tpu/ops/pallas/flash.py:932", bwd["flash_bwd_dkv"],
         train_counts),
        ("flash_bwd_dq", "flash_bwd.cu",
         "koifish_tpu/ops/pallas/flash.py:1077", bwd["flash_bwd_dq"],
         train_counts),
        ("fused_ce_fwd", "fused_ce.cu",
         "koifish_tpu/ops/pallas/fused_ce.py:126", fce["fused_ce_fwd"],
         train_counts),
        ("fused_ce_dlogits", "fused_ce.cu",
         "koifish_tpu/ops/pallas/fused_ce.py:217", fce["fused_ce_dlogits"],
         train_counts),
        ("fused_ce_dx", "fused_ce.cu",
         "koifish_tpu/ops/pallas/fused_ce.py:217", fce["fused_ce_dx"],
         train_counts),
        ("fused_ce_dw", "fused_ce.cu",
         "koifish_tpu/ops/pallas/fused_ce.py:302", fce["fused_ce_dw"],
         train_counts),
        # the batcher's slot writes: the standalone kernel's and those
        # folded into the decode attention's launch
        ("slot_write", "slotwrite.cu",
         "koifish_tpu/ops/pallas/slotwrite.py:87", sw["slot_write"],
         {"slot_write": batch_counts.get("slot_write", 0)
          + batch_counts.get("kv_write", 0)}),
        # the paged run's page writes: the standalone kernel's and those
        # folded into the paged attention's launch
        ("page_write", "slotwrite.cu",
         "koifish_tpu/ops/pallas/slotwrite.py:140", sw["page_write"],
         {"page_write": paged_counts.get("page_write", 0)
          + paged_counts.get("paged_attn_write", 0)}),
        # the library Pallas kernel jax.experimental.pallas.ops.tpu.
        # paged_attention that the JAX package's _paged_attention calls
        ("paged_attn", "paged_attn.cu", "koifish_tpu/serve/paged.py:173",
         pag["paged_attn"], paged_counts),
        ("paged_attn_write", "paged_attn.cu",
         "koifish_tpu/serve/paged.py:173", pag["paged_attn_write"],
         paged_counts),
        ("qmv_book", "qmatmul.cu", "koifish_tpu/ops/pallas/matmul.py:389",
         book["qmv_book"], batch_counts),
        ("qmm_book", "qmm.cu", "koifish_tpu/ops/pallas/matmul.py:451",
         book["qmm_book"], batch_counts),
        ("fused_ce_fwd_int8", "fused_ce_int8.cu",
         "koifish_tpu/ops/pallas/fused_ce.py:126", i8["fused_ce_fwd_int8"],
         g774_counts),
        ("fused_ce_dlogits_int8", "fused_ce_int8.cu",
         "koifish_tpu/ops/pallas/fused_ce.py:217",
         i8["fused_ce_dlogits_int8"], g774_counts),
        ("fused_ce_dx_int8", "fused_ce_int8.cu",
         "koifish_tpu/ops/pallas/fused_ce.py:217", i8["fused_ce_dx_int8"],
         g774_counts),
        ("fused_ce_dw_int8", "fused_ce_int8.cu",
         "koifish_tpu/ops/pallas/fused_ce.py:302", i8["fused_ce_dw_int8"],
         g774_counts),
        ("qdgrad_int8_tile", "qdgrad.cu", "koifish_tpu/ops/pallas/qdgrad.py:61",
         i8["qdgrad_int8_tile"], tile_counts),
        ("qdgrad_quant", "qdgrad.cu", "koifish_tpu/ops/pallas/qdgrad.py:61",
         i8["qdgrad_quant"], tile_counts),
        ("rowquant", "quantize.cu", "koifish_tpu/ops/pallas/quantize.py:53",
         i8["rowquant"], g774_counts),
        ("colquant", "quantize.cu", "koifish_tpu/ops/pallas/quantize.py:101",
         i8["colquant"], g774_counts),
        ("qmv_int8", "qmv_int8.cu", "koifish_tpu/ops/pallas/matmul.py:257",
         q8, chat_counts),
        # the kernel ring at sp 4 on virtual ranks of the one card
        ("ring_attn", "ring_attn.cu",
         "koifish_tpu/parallel/ring_pallas.py:152", ring, ring_counts),
        # row 7's fused entry at the zoo's decode shapes, launched by the
        # zoo's generate runs
        ("decode_attn_write_mla", "decode_attn.cu",
         "koifish_tpu/ops/pallas/decode_attn.py:179",
         _zoo_row7(dec, "zoo MLA"),
         {"decode_attn_write_mla": zoo["zoo_mla"].get("kv_write", 0)}),
        ("decode_attn_write_qwen3_moe", "decode_attn.cu",
         "koifish_tpu/ops/pallas/decode_attn.py:179",
         _zoo_row7(dec, "zoo Qwen3-30B-A3B"),
         {"decode_attn_write_qwen3_moe":
          zoo["zoo_qwen3_moe"].get("kv_write", 0)}),
        # rows 3 and 4 at HotPick's picked down (K 1536), launched by its
        # serving run
        ("qmm_k1536", "qmm.cu", "koifish_tpu/ops/pallas/matmul.py:305",
         k1536["qmm"], {"qmm_k1536": k1536_launches["qmm"]}),
        ("qmv_k1536", "qmatmul.cu", "koifish_tpu/ops/pallas/matmul.py:201",
         k1536["qmv"], {"qmv_k1536": k1536_launches["qmv"]}),
        # rows 3 and 4 at Qwen3-32B's tp-2 down (K 13824), launched by the
        # streamed 32B-width model's prefill and decode on rank 0
        ("qmm_k13824", "qmm.cu", "koifish_tpu/ops/pallas/matmul.py:305",
         k13824["qmm"], {"qmm_k13824": k13824_launches["qmm"]}),
        ("qmv_k13824", "qmatmul.cu", "koifish_tpu/ops/pallas/matmul.py:201",
         k13824["qmv"], {"qmv_k13824": k13824_launches["qmv"]}),
    ]
    kernels = [dict(name=n, route="cuda", source=src + f, replaces=r,
                    launches=c.get(n, 0), max_abs_err=m["max_abs_err"],
                    ms=m["ms"], plain_ms=m["plain_ms"],
                    bound_ms=m["bound_ms"], bound_by=m["bound_by"],
                    library_ms=m["library_ms"])
               for n, f, r, m, c in rows]
    # rows whose launches are, in part or whole, launches of a fused entry
    # that has its own row: ``folded_launches`` of their ``launches`` are
    # that entry's (``folded_into``), timed there, so a ranking by launches
    # x (ms - bound_ms) counts launches - folded_launches for these rows
    folded = {
        "decode_attn": ("decode_attn_write", serve_counts.get("kv_write", 0)),
        "slot_write": ("decode_attn_write", batch_counts.get("kv_write", 0)),
        "page_write": ("paged_attn_write",
                       paged_counts.get("paged_attn_write", 0)),
        "paged_attn": ("paged_attn_write",
                       paged_counts.get("paged_attn_write", 0))}
    for k in kernels:
        if k["name"] in folded:
            k["folded_into"], k["folded_launches"] = folded[k["name"]]
    # the zoo's shape rows of row 7's fused entry: their own generate run
    own_path = {"decode_attn_write_mla": "zoo_mla",
                "decode_attn_write_qwen3_moe": "zoo_qwen3_moe"}
    for k in kernels:   # slices 13, 14, 16 and 17's paths: launches in each
        if k["name"] in own_path:
            p = own_path[k["name"]]
            k["launches_by_path"] = {p: zoo[p].get("kv_write", 0)}
            continue
        if k["name"].endswith("_k1536"):
            k["launches_by_path"] = {"hotpick_serve": k["launches"]}
            continue
        if k["name"].endswith("_k13824"):
            k["launches_by_path"] = {"tp2_stream32b": k["launches"]}
            continue
        k["launches_by_path"] = {p: c.get(k["name"], 0) + (
            c.get("kv_write", 0) if k["name"] in ("slot_write",
                                                  "decode_attn_write")
            else 0)
            for p, c in dict(s13, koifish_sp4=sp_counts, **zoo,
                             **s17, **par, **s19, **s20, **s21).items()}
        if k["name"] == "ring_attn":   # the ring at sp 2, 4 and 8
            k["eager_ms"] = ring["eager_ms"]
            k["by_sp"] = ring["by_sp"]
            # across processes (slice 19): the launches of all the ranks of
            # the sp-4 ring, and each sp's numbers
            k["launches_by_path"]["process"] = ring_process["launches"]
            k["process_by_sp"] = ring_process["by_sp"]
    for k in kernels:   # the fused writes' own share of their launch
        if k["name"] == "decode_attn_write":
            k["write_ms"] = dec["decode_attn_write"]["write_ms"]
        if k["name"] == "paged_attn_write":
            k["write_ms"] = pag["paged_attn_write"]["write_ms"]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
