"""The training step and loop (the JAX package's ``train/trainer.py``;
the reference's ``Optimizer::Search``, Optimizer.cpp:580-680).

One step is (loss → grad → clip → update) over A micro-batches: autograd
computes each micro-batch's bf16 gradients, they are summed in f32 and
averaged, and ``apply_updates`` writes the parameters and moments in
place. PyTorch runs eagerly, so there is no jit and no donation; the
reference's auxiliary behaviours stay: NaN/inf loss and grad detection
with an emergency checkpoint, the loss-validity assert (0 < loss < 100),
the spike-guard counters, and the loss curve as CSV.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from koifish_tpu_torch.config import ModelCard, TrainCard
from koifish_tpu_torch.models.guppy import sample_ids
from koifish_tpu_torch.models.salmon import diffusion_loss
from koifish_tpu_torch.models.transformer import head_weight, model_forward
from koifish_tpu_torch.ops.cross_entropy import (cross_entropy_loss,
                                                 fused_ce_loss)
from koifish_tpu_torch.ops.tracectx import (Int8Policy, SPPolicy, int8_scope,
                                            sp_scope, tp_scope)
from koifish_tpu_torch.parallel import comm
from koifish_tpu_torch.parallel.overlap import GradReducer
from koifish_tpu_torch.quant.qtensor import QTensor
from koifish_tpu_torch.train.optimizer import (OptState, _is_float,
                                               apply_updates, init_opt_state)
from koifish_tpu_torch.train.schedule import lr_at
from koifish_tpu_torch.utils import kernel_log, prng
from koifish_tpu_torch.utils.tree import leaves, unflatten_like


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: OptState
    gen: torch.Generator      # host generator: the per-step SR seeds
    # a sharded state's train/sharded.ShardedLayout (None: whole leaves)
    layout: Any = None


def compute_loss(card: ModelCard, params, tokens, loss_mask=None,
                 remat=False, qcard=None, fused_ce=None, rng=None):
    """Next-token CE over [B, T+1] tokens (targets = tokens shifted):
    (mean_loss, per_token [B, T]). ``fused_ce``: None = auto (the logits-
    free fused classifier for vocab >= 64k), True/False force it.
    ``qcard`` with rules: fake-quant QAT (straight-through) in the forward,
    except for scale-only ("gama") training, where the params already hold
    QTensors whose scales take the gradient (``ops/kernels/matmul.py``).
    SALMON (the diffusion LM) takes the masked-reconstruction loss instead,
    its t and mask drawn from ``rng``; GUPPY resamples its FFN rows from
    ``rng`` (a uint32 [2] threefry key, ``utils/prng.py``; None:
    PRNGKey(0), as in the JAX package)."""
    if qcard is not None and qcard.rules and qcard.train_target != "gama":
        from koifish_tpu_torch.quant.qat import apply_qat
        params = apply_qat(params, qcard, card)
    key = rng if rng is not None else prng.prng_key(0)
    if card.arch == "SALMON":
        return diffusion_loss(card, params, tokens[:, :-1], key,
                              loss_mask=loss_mask[:, :-1]
                              if loss_mask is not None else None)
    targets = tokens[:, 1:]
    mask = loss_mask[:, 1:] if loss_mask is not None else None
    guppy_samps = None
    if card.arch == "GUPPY":
        # resample the vocab-memory FFN rows every step (the reference's
        # Guppy::BeforeNextStep / FFN::UpdateSamps(iter*nLayer+l))
        guppy_samps = sample_ids(card, key)
    head = params.get("head", params["wte"])
    use_fused = fused_ce if fused_ce is not None else card.vocab_size >= 65536
    if use_fused and not isinstance(head, QTensor):
        hidden = model_forward(card, params, tokens[:, :-1], remat=remat,
                               return_hidden=True, guppy_samps=guppy_samps)
        return fused_ce_loss(hidden, head_weight(params), targets, mask)
    logits = model_forward(card, params, tokens[:, :-1], remat=remat,
                           logits_dtype=torch.bfloat16,
                           guppy_samps=guppy_samps)
    return cross_entropy_loss(logits, targets, mask)


def _average(g: torch.Tensor, prev: Optional[torch.Tensor], accum: int
             ) -> torch.Tensor:
    """A leaf's last micro-batch gradient ``g`` folded into the f32 sum of
    the earlier ones and averaged: the arithmetic of the step's own
    accumulation, so an overlapped reduction sums the same values."""
    if accum == 1:
        return g / accum
    return (prev + g.to(torch.float32)) / accum


def step_key(seed: int, step: int, memo: Optional[dict] = None
             ) -> np.ndarray:
    """The JAX train step's key at ``step``: fold_in(rng_n, n) with rng_n
    the state's key after n steps from ``init_train_state`` (PRNGKey(seed),
    split once a step, its first half kept). ``memo`` carries the last
    (n, rng_n) so a loop advances one split a step."""
    memo = {} if memo is None else memo
    n, key = memo.get("at", (0, prng.prng_key(seed)))
    if step < n:
        n, key = 0, prng.prng_key(seed)
    while n < step:
        key, n = prng.split(key)[0], n + 1
    memo["at"] = (n, key)
    return prng.fold_in(key, step)


def _sr_on(tcard: TrainCard) -> bool:
    cfg = getattr(tcard, "stochastic_round", "auto")
    if isinstance(cfg, str):
        return cfg.lower() in ("auto", "on", "true", "1")
    return bool(cfg)


def make_train_step(card: ModelCard, tcard: TrainCard, total_steps: int,
                    qcard=None, trainable=None, sp=None) -> Callable:
    """The (state, batch) -> (state, metrics) step. ``batch["tokens"]`` is
    [A, B, T+1] (A micro-batches), ``batch.get("loss_mask")`` likewise.

    qcard:     a QuantCard: fake-quant QAT, or gama training when the params
               already hold QTensors and ``train_target == "gama"``
    trainable: a tree of bools of the params' structure; frozen leaves get
               empty-stub grads and are left untouched by the optimizer.
    Only float leaves take gradients: a QTensor's packed codes stay frozen
    and the optimizer keeps size-0 stubs for them.
    Metrics: ``loss``, ``lr``, ``grad_norm``, ``spikes`` and, with
    ``check_tensor_norm``, ``leaf_norms`` (per-leaf grad norms).

    ``tcard.int8_matmul``: an ``Int8Policy`` (int8_wgrad, int8_dgrad,
    int8_min_kn) is in force for the whole step, forward and backward;
    what the backward recomputes captures it at the forward
    (``ops/tracectx.py``).
    sp:        an ``SPPolicy(axis, mesh)``: sequence-parallel training, the
               model's causal self-attention a ring with T sharded over the
               axis (``ops/attention.py``), in force for the whole step.

    A state with a ``layout`` (``train/sharded.shard_train_state``) trains
    sharded over its process mesh: ``card`` is the whole model's card and
    the batch this rank's rows (``train/sharded.shard_batch``); see
    ``train/sharded.py`` for what each rank does."""
    int8_pol = (Int8Policy(wgrad=tcard.int8_wgrad, dgrad=tcard.int8_dgrad,
                           min_weight_elems=tcard.int8_min_kn)
                if tcard.int8_matmul else None)
    if sp is not None and not isinstance(sp, SPPolicy):
        raise TypeError(f"sp must be an SPPolicy or None, got "
                        f"{type(sp).__name__}")
    if getattr(tcard, "kernel_choices", False):
        kernel_log.set_verbose(True)
    sr_on = _sr_on(tcard)
    frozen = ([not t for t in leaves(trainable)] if trainable is not None
              else None)
    # GUPPY and SALMON draw from the JAX package's step keys
    draws = card.arch in ("GUPPY", "SALMON")
    key_memo: dict = {}

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        lay = state.layout
        tp = lay.tp_policy(card) if lay is not None else None
        with int8_scope(int8_pol), sp_scope(sp), tp_scope(tp):
            return _step(state, batch)

    def _step(state: TrainState, batch: Dict[str, torch.Tensor]):
        tokens = batch["tokens"]
        loss_mask = batch.get("loss_mask")
        accum = tokens.shape[0]
        lay = state.layout
        run_card = card if lay is None else lay.run_card(card)
        flat = leaves(state.params)
        diff = [i for i, p in enumerate(flat)
                if _is_float(p) and (frozen is None or not frozen[i])]
        # only the trained leaves require a gradient, so the backward makes
        # none for a frozen one (a frozen head's dW, a frozen embedding's);
        # params swapped in between steps (a resumed or Fuyou-injected
        # branch) are marked here too
        want = set(diff)
        for i, p in enumerate(flat):
            if _is_float(p) and p.requires_grad != (i in want):
                p.requires_grad_(i in want)
        # the leaves the forward reads: FSDP shards gathered whole
        cflat = flat
        if lay is not None and lay.fsdp:
            cflat = [lay.gather_fsdp(p, i) for i, p in enumerate(flat)]
            for i in diff:
                cflat[i].requires_grad_(True)
        cparams = (state.params if cflat is flat
                   else lay.with_leaves(state.params, cflat))
        weights = reducer = None
        if lay is not None:
            weights = lay.loss_weights(tokens, loss_mask)
            reducer = GradReducer(
                lay.mesh.group("dp"), diff,
                {i: lay.fsdp_dim(i) for i in diff if lay.fsdp_dim(i)
                 is not None})
        overlap = reducer is not None and reducer.group is not None
        acc = None
        loss_sum = 0.0
        step_rng = (step_key(tcard.seed, int(state.opt.step), key_memo)
                    if draws else None)
        for a in range(accum):
            rng = step_rng
            if draws and accum > 1:
                rng = prng.fold_in(step_rng, a)
            loss, _ = compute_loss(
                run_card, cparams, tokens[a],
                loss_mask[a] if loss_mask is not None else None,
                remat=tcard.remat, qcard=qcard,
                fused_ce=getattr(tcard, "fused_ce", None), rng=rng)
            if weights is not None:      # this rank's share of the mean
                loss = loss * weights[a]
            if overlap and a == accum - 1:
                prev = dict(zip(diff, acc)) if acc is not None else None
                reducer.arm({i: cflat[i] for i in diff},
                            lambda i, g, prev=prev: _average(
                                g, None if prev is None else prev[i], accum))
            gs = torch.autograd.grad(loss, [cflat[i] for i in diff],
                                     allow_unused=True)
            gs = [torch.zeros_like(cflat[i]) if g is None else g
                  for i, g in zip(diff, gs)]
            loss_sum = loss_sum + loss.detach()
            if accum == 1:
                acc = gs
            elif acc is None:
                acc = [g.to(torch.float32) for g in gs]
            elif not (overlap and a == accum - 1):
                for x, g in zip(acc, gs):
                    x += g.to(torch.float32)
        grads = [torch.zeros((0,), dtype=torch.float32, device=p.device)
                 for p in flat]
        if overlap:
            summed = reducer.finish()
        elif reducer is not None:
            summed = reducer.reduce({i: g / accum for i, g in zip(diff, acc)})
        else:
            summed = {i: g / accum for i, g in zip(diff, acc)}
        for i in diff:
            grads[i] = summed[i]
        grads = unflatten_like(state.params, grads)
        loss = loss_sum / accum
        if lay is not None:
            loss = comm.all_reduce_(loss.to(torch.float32).clone(),
                                    lay.mesh.group("dp"))

        lr = lr_at(state.opt.step, kind=tcard.scheduler, base_lr=tcard.lr,
                   total_steps=total_steps, warmup=tcard.warmup,
                   min_ratio=tcard.lr_min_ratio,
                   epoch_steps=tcard.epoch_iters)
        # stochastic rounding: one uint32 seed per leaf, drawn each step
        seeds = (torch.randint(0, 2 ** 32, (len(flat),), generator=state.gen,
                               dtype=torch.int64).tolist() if sr_on else None)
        params, opt, metrics = apply_updates(
            state.params, grads, state.opt, optimizer=tcard.optimizer, lr=lr,
            beta1=tcard.beta1, beta2=tcard.beta2, eps=tcard.eps,
            weight_decay=tcard.weight_decay, muon_momentum=tcard.muon_momentum,
            grad_clip=tcard.grad_clip,
            lars_ratio=getattr(tcard, "lars_ratio", 0.0),
            muon_ortho=getattr(tcard, "muon_ortho", "ns"), sr_seeds=seeds,
            dist=lay)
        metrics = dict(metrics, loss=loss, lr=lr)
        if tcard.check_tensor_norm:
            metrics["leaf_norms"] = (
                lay.leaf_norms(leaves(grads)) if lay is not None else
                torch.stack([
                    torch.linalg.norm(g.to(torch.float32)) if g.numel()
                    else torch.zeros((), device=g.device)
                    for g in leaves(grads)]))
        return TrainState(params=params, opt=opt, gen=state.gen,
                          layout=lay), metrics

    return step


@dataclasses.dataclass
class StepInfo:
    """Loss-curve recorder -> CSV (``StepInfos``, DataLoader.hpp:43-71);
    ``metrics`` keeps the last step's metrics dict, ``grad_norms`` each
    step's global gradient norm."""
    rows: list = dataclasses.field(default_factory=list)
    metrics: Optional[dict] = None
    grad_norms: list = dataclasses.field(default_factory=list)

    def add(self, it: int, loss: float, lr: float, dt: float, tps: float):
        self.rows.append((it, loss, lr, dt, tps))

    def save_csv(self, path: str):
        with open(path, "w") as f:
            f.write("iter,loss,lr,step_time,tokens_per_sec\n")
            for r in self.rows:
                f.write(",".join(f"{x:.6g}" for x in r) + "\n")

    @property
    def losses(self):
        return [r[1] for r in self.rows]


class TrainingInstability(RuntimeError):
    pass


def train_loop(
    card: ModelCard,
    tcard: TrainCard,
    state: TrainState,
    batches: Iterator[Dict[str, torch.Tensor]],
    total_steps: int,
    log_fn: Optional[Callable[[str], None]] = print,
    eval_fn: Optional[Callable[[TrainState, int], Dict[str, float]]] = None,
    save_fn: Optional[Callable[[TrainState, int, str], None]] = None,
    qcard=None,
    trainable=None,
    hook_fn: Optional[Callable[[TrainState, int, float],
                               Optional[TrainState]]] = None,
    sp=None,
) -> Tuple[TrainState, StepInfo]:
    """The host loop around the step, with the reference's instability
    handling (emergency checkpoint, then abort; Optimizer.cpp:176-179).
    ``hook_fn(state, it, loss)`` runs after each step and may return a
    replacement state. A step's time is taken on the host clock around
    the step and the loss's transfer to the host, which waits for the
    device."""
    if tcard.graph_dump:
        raise NotImplementedError(
            "graph_dump writes the traced XLA step; eager PyTorch has no "
            "step graph to write")
    step = make_train_step(card, tcard, total_steps, qcard=qcard,
                           trainable=trainable, sp=sp)
    infos = StepInfo()
    tokens_per_batch = None
    leaf_paths = None
    loop_t0 = time.perf_counter()
    for it, batch in enumerate(batches):
        if 0 <= tcard.most_iter <= it or it >= total_steps:
            break
        if tcard.time_most > 0 and \
                time.perf_counter() - loop_t0 > tcard.time_most:
            if log_fn:
                log_fn(f"[{it}] time budget {tcard.time_most}s exhausted "
                       f"(DEBUG.Time_most) — stopping")
            break
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        if tokens_per_batch is None:
            tokens_per_batch = int(batch["tokens"].numel())
        tps = tokens_per_batch / dt
        infos.add(it, loss, float(metrics["lr"]), dt, tps)
        infos.metrics = metrics

        gnorm = float(metrics["grad_norm"])
        infos.grad_norms.append(gnorm)
        if not (0.0 < loss < 100.0) or not torch.isfinite(
                torch.tensor(gnorm)):
            if save_fn:
                save_fn(state, it, "emergency")
            raise TrainingInstability(f"iter {it}: loss={loss} "
                                      f"grad_norm={gnorm}")

        if log_fn and tcard.dump_every and it % tcard.dump_every == 0:
            from koifish_tpu_torch.utils.mfu import step_mfu
            mfu = step_mfu(card, tokens_per_batch, dt)
            extra = f" mfu={mfu:.1%}" if mfu is not None else ""
            if "leaf_norms" in metrics:      # check_tensor_norm watch
                if leaf_paths is None:
                    from koifish_tpu_torch.utils.dump import _path_str
                    from koifish_tpu_torch.utils.tree import flatten_with_path
                    leaf_paths = [_path_str(p) for p, _ in
                                  flatten_with_path(state.params)]
                norms = metrics["leaf_norms"]
                wi = int(torch.argmax(norms))
                extra += f" worst_leaf={leaf_paths[wi]}:{float(norms[wi]):.3f}"
            log_fn(f"[{it}] loss={loss:.4f} lr={float(metrics['lr']):.2e} "
                   f"gnorm={gnorm:.3f} T={dt:.2f}s {tps / 1e3:.1f}K tok/s"
                   + extra)
        if hook_fn is not None:
            new_state = hook_fn(state, it, loss)
            if new_state is not None:
                state = new_state
        if eval_fn and tcard.eval_every and it and it % tcard.eval_every == 0:
            eval_fn(state, it)
        if save_fn and tcard.save_every and it and it % tcard.save_every == 0:
            save_fn(state, it, "periodic")
    return state, infos


def init_train_state(card: ModelCard, tcard: TrainCard, params=None,
                     device=None) -> TrainState:
    """Params (random from ``tcard.seed`` unless given) with
    ``requires_grad`` on every float leaf, zero moments, and the host
    generator for the SR seeds, seeded with ``tcard.seed``."""
    if params is None:
        from koifish_tpu_torch.models import init_params
        params = init_params(card, device=device, seed=tcard.seed)
    for p in leaves(params):
        if _is_float(p):
            p.requires_grad_(True)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(tcard.seed)
    return TrainState(params=params,
                      opt=init_opt_state(params, tcard.optimizer,
                                         tcard.moment_dtype),
                      gen=gen)
