"""Pipeline parallelism over the ``pp`` axis of a process mesh (the JAX
package's ``parallel/pipeline.py``).

The L layers are cut into P stages of L/P; stage p is the process at
``pp`` index p and holds only its stage's layers, stacked into [L/P, ...]
leaves as the JAX package's [P, L/P, ...] stack holds them (so the
optimizer sees the same leaf shapes). The embedding, final norm and head
are replicated: stage 0 embeds, only the last stage runs the norm, the
head and the CE. Activations and their gradients move between neighbouring
stages by ``send``/``recv`` (``parallel/comm.py``).

Two schedules, as in the JAX package:

- ``gpipe``: every micro-batch forward, then autograd over them all (all
  M micro-batches' activations live at once);
- ``1f1b``: the timetable of the JAX package's ``_pipeline_1f1b`` —
  F_p(i) at tick p + i, B_p(i) at tick 2(P-1) - p + i — where a stage
  stashes only its input in a ring of 2P slots and recomputes its interior
  at the backward, so live activation memory is O(P), not O(M).

The loss is the mean of the micro-batch means; the replicated params'
gradients are summed over ``pp`` (the JAX package's ``psum``).

The zoo's homogeneous cards (MAMBA, SALMON, MLA, LLAMA_VAE) stack and train
as the JAX pipeline trains them, losses included (ROADMAP.md queue 3, known
quirks): every card takes the next-token CE (SALMON's own loss is its
masked diffusion), and stage 0 embeds with ``gather_embed`` (LLAMA_VAE's
``evae`` stack is left out, its leaves take zero gradients). Heterogeneous
layers (GAU and BROWN hybrids) raise the JAX package's ``ValueError``;
GUPPY, whose JAX pipeline fails on ``guppy_rows``, is refused
(``sharding.check_parallel_card``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from koifish_tpu_torch.config import ModelCard
from koifish_tpu_torch.models.transformer import (_norm, gather_embed,
                                                  layer_forward, lm_head)
from koifish_tpu_torch.ops.cross_entropy import cross_entropy_loss
from koifish_tpu_torch.ops.rope import rope_freqs
from koifish_tpu_torch.parallel import comm
from koifish_tpu_torch.parallel.sharding import check_parallel_card
from koifish_tpu_torch.utils.tree import leaves, unflatten_like

SCHEDULES = ("1f1b", "gpipe")


def stack_for_pipeline(params: Dict[str, Any], n_stages: int,
                       stage: Optional[int] = None):
    """params['layers'] (a list of L dicts) -> (stage_layers, other):
    ``stage_layers`` the [L/P, ...] stacked leaves of stage ``stage`` (of
    every stage, a list, when ``stage`` is None); ``other`` the rest of
    the params. Raises on layers that do not divide (AssertionError, as in
    the JAX package) and on heterogeneous layers (ValueError)."""
    from koifish_tpu_torch.serve.stacked import _stack
    layers = params["layers"]
    L = len(layers)
    assert L % n_stages == 0, f"n_layer {L} % pp {n_stages} != 0"
    sig = [[(tuple(x.shape), x.dtype) for x in leaves(lp)]
           + sorted(lp) for lp in layers]
    if any(s != sig[0] for s in sig):
        raise ValueError("heterogeneous layers can't be pipeline-stacked")
    per = L // n_stages

    def stacked(p):
        s = _stack(layers[p * per:(p + 1) * per])
        if s is None:
            raise ValueError("heterogeneous layers can't be "
                             "pipeline-stacked")
        # the stage's own leaves (not views of the per-layer params)
        return unflatten_like(s, [x.detach().requires_grad_(
            x.is_floating_point()) for x in leaves(s)])

    other = {k: v for k, v in params.items() if k != "layers"}
    if stage is not None:
        return stacked(stage), other
    return [stacked(p) for p in range(n_stages)], other


def _layers_of(stage_layers, n: int) -> List[dict]:
    from koifish_tpu_torch.serve.stacked import layer_params
    return [layer_params(stage_layers, i) for i in range(n)]


def _n_layers(stage_layers) -> int:
    return leaves(stage_layers)[0].shape[0]


class _Stage:
    """One stage's computation for micro-batch inputs of [mb, T]."""

    def __init__(self, card: ModelCard, mesh, axis: str, T: int, device):
        check_parallel_card(card, what="pipeline parallelism")
        self.card = card
        self.P = mesh.size(axis)
        self.p = mesh.index(axis)
        ranks = mesh.ranks(axis)
        self.prev = ranks[self.p - 1] if self.p > 0 else None
        self.next = ranks[self.p + 1] if self.p < self.P - 1 else None
        self.last_rank = ranks[-1]
        self.group = mesh.group(axis)
        self.positions = torch.arange(T, dtype=torch.int64, device=device)
        self.cos = self.sin = None
        if card.pos_embed == "rope":
            self.cos, self.sin = rope_freqs(
                card.head_dim, card.max_pos, card.rope_theta,
                card.rope_scaling_dict(), device=device)
        self.first = self.p == 0
        self.last = self.p == self.P - 1
        self._sends: list = []

    def embed(self, other, toks):
        x = gather_embed(other["wte"], toks)
        if self.card.pos_embed == "learned":
            x = x + other["wpe"][self.positions]
        return x.to(torch.bfloat16)

    def apply(self, layers: List[dict], x):
        for lp in layers:
            x = layer_forward(self.card, lp, x, self.cos, self.sin,
                              self.positions)
        return x

    def head(self, other, y):
        h = _norm(self.card, y, other["ln_f"], other.get("ln_f_b"))
        return lm_head(self.card, other, h, out_dtype=torch.bfloat16)

    def send(self, t: torch.Tensor, dst: int) -> None:
        self._sends.append((comm.send(t.detach().contiguous(), dst), t))

    def recv(self, shape, src: int, dtype=torch.bfloat16):
        return comm.recv(shape, dtype, src, self.positions.device)

    def drain(self) -> None:
        for h, _ in self._sends:
            h.wait()
        self._sends = []


def _split(tokens, loss_mask, n_micro: int):
    B = tokens.shape[0]
    assert B % n_micro == 0, f"batch {B} % n_micro {n_micro} != 0"
    mb = B // n_micro
    inp = tokens[:, :-1].reshape(n_micro, mb, -1)
    tgt = tokens[:, 1:].reshape(n_micro, mb, -1)
    msk = (loss_mask[:, 1:].reshape(n_micro, mb, -1)
           if loss_mask is not None else None)
    return inp, tgt, msk


def pipeline_logits(card: ModelCard, stage_layers, other,
                    tokens: torch.Tensor, mesh, n_micro: int,
                    axis: str = "pp") -> torch.Tensor:
    """tokens [B, T] -> logits [B, T, V] (bf16) through the pipeline, on
    every stage (the last stage's, broadcast)."""
    B, T = tokens.shape
    assert B % n_micro == 0
    st = _Stage(card, mesh, axis, T, tokens.device)
    layers = _layers_of(stage_layers, _n_layers(stage_layers))
    toks = tokens.reshape(n_micro, B // n_micro, T)
    shape = (B // n_micro, T, card.n_embd)
    outs = []
    with torch.no_grad():
        for i in range(n_micro):
            x = st.embed(other, toks[i]) if st.first else \
                st.recv(shape, st.prev)
            y = st.apply(layers, x)
            if st.last:
                outs.append(st.head(other, y))
            else:
                st.send(y, st.next)
        st.drain()
        out = (torch.cat(outs) if st.last else
               torch.empty((B, T, card.vocab_size), dtype=torch.bfloat16,
                           device=tokens.device))
    return comm.broadcast_(out, st.last_rank, st.group)


def _loss_i(st: _Stage, other, y, tgt, msk):
    loss, _ = cross_entropy_loss(st.head(other, y), tgt, msk)
    return loss


def pipeline_loss(card: ModelCard, stage_layers, other,
                  tokens: torch.Tensor, mesh, n_micro: int,
                  axis: str = "pp",
                  loss_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next-token CE over [B, T+1] tokens through the pipeline (the mean
    of the micro-batch means), forward only, on every stage."""
    loss, _ = _gpipe(card, stage_layers, other, tokens, mesh, n_micro, axis,
                     loss_mask, with_grads=False)
    return loss


def _zeros32(xs):
    return [torch.zeros(x.shape, dtype=torch.float32, device=x.device)
            for x in xs]


def _finish(st: _Stage, acc_loss, gl, go, n_micro: int, stage_layers, other):
    """The loss on every stage, the stage grads /M, the replicated grads
    summed over ``pp`` /M, each cast to its param's dtype."""
    loss = comm.all_reduce_(acc_loss.to(torch.float32).reshape(1).clone(),
                            st.group)[0] / n_micro
    gl = [(g / n_micro).to(p.dtype) for g, p in zip(gl, leaves(stage_layers))]
    go = [(comm.all_reduce_(g, st.group) / n_micro).to(p.dtype)
          for g, p in zip(go, leaves(other))]
    return loss, {"stages": unflatten_like(stage_layers, gl),
                  "other": unflatten_like(other, go)}


def _grad(out, inputs, grad_out=None):
    gs = torch.autograd.grad(out, inputs, grad_outputs=grad_out,
                             allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for x, g in zip(inputs, gs)]


def _trainable(*trees) -> None:
    for x in leaves(list(trees)):
        if x.is_floating_point() and not x.requires_grad:
            x.requires_grad_(True)


def _gpipe(card, stage_layers, other, tokens, mesh, n_micro, axis,
           loss_mask, with_grads: bool):
    if with_grads:
        _trainable(stage_layers, other)
    inp, tgt, msk = _split(tokens, loss_mask, n_micro)
    mb, T = inp.shape[1], inp.shape[2]
    st = _Stage(card, mesh, axis, T, tokens.device)
    pl, po = leaves(stage_layers), leaves(other)
    layers = _layers_of(stage_layers, _n_layers(stage_layers))
    shape = (mb, T, card.n_embd)
    xs, ys, losses = [], [], []
    with torch.set_grad_enabled(with_grads):
        for i in range(n_micro):
            if st.first:
                x = st.embed(other, inp[i])
            else:
                x = st.recv(shape, st.prev).requires_grad_(with_grads)
                xs.append(x)
            y = st.apply(layers, x)
            if st.last:
                losses.append(_loss_i(st, other, y, tgt[i],
                                      None if msk is None else msk[i]))
            else:
                st.send(y, st.next)
                ys.append(y)
    acc_loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for loss_i in losses:
        acc_loss = acc_loss + loss_i.detach()
    if not with_grads:
        st.drain()
        loss = comm.all_reduce_(acc_loss.to(torch.float32).reshape(1),
                                st.group)[0] / n_micro
        return loss, None
    # the backward one micro-batch at a time, in order, accumulated in f32:
    # the sums 1F1B makes from its recomputed forwards
    fl = [k for k, x in enumerate(pl) if x.is_floating_point()]
    fo = [k for k, x in enumerate(po) if x.is_floating_point()]
    wants = [pl[k] for k in fl] + [po[k] for k in fo]
    gl, go = _zeros32(pl), _zeros32(po)
    for i in range(n_micro):
        extra = [] if st.first else [xs[i]]
        if st.last:
            gs = _grad(losses[i], wants + extra)
        else:
            gs = _grad(ys[i], wants + extra, st.recv(shape, st.next))
        for k, g in zip(fl, gs):
            gl[k] += g.to(torch.float32)
        for k, g in zip(fo, gs[len(fl):]):
            go[k] += g.to(torch.float32)
        if extra:
            st.send(gs[-1], st.prev)
    st.drain()
    return _finish(st, acc_loss, gl, go, n_micro, stage_layers, other)


def _one_f_one_b(card, stage_layers, other, tokens, mesh, n_micro, axis,
                 loss_mask):
    _trainable(stage_layers, other)
    inp, tgt, msk = _split(tokens, loss_mask, n_micro)
    M, mb, T = inp.shape
    st = _Stage(card, mesh, axis, T, tokens.device)
    P, p = st.P, st.p
    pl, po = leaves(stage_layers), leaves(other)
    fl = [i for i, x in enumerate(pl) if x.is_floating_point()]
    fo = [i for i, x in enumerate(po) if x.is_floating_point()]
    layers = _layers_of(stage_layers, _n_layers(stage_layers))
    shape = (mb, T, card.n_embd)
    S = 2 * P
    stash: List[Any] = [None] * S
    gl, go = _zeros32(pl), _zeros32(po)
    acc_loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for t in range(M + 2 * (P - 1)):
        # forward sub-step: F_p(i) at t == p + i
        i = t - p
        if 0 <= i < M:
            x = None if st.first else st.recv(shape, st.prev)
            stash[i % S] = x
            if not st.last:        # the last stage's backward recomputes
                with torch.no_grad():
                    y = st.apply(layers, st.embed(other, inp[i])
                                 if st.first else x)
                st.send(y, st.next)
        # backward sub-step: B_p(j) at t == 2(P-1) - p + j
        j = t - 2 * (P - 1) + p
        if 0 <= j < M:
            x = stash[j % S]
            stash[j % S] = None
            if x is not None:
                x = x.detach().requires_grad_(True)
            with torch.enable_grad():
                y = st.apply(layers, st.embed(other, inp[j])
                             if st.first else x)
                wants = [pl[k] for k in fl] + [po[k] for k in fo]
                extra = [] if x is None else [x]
                if st.last:
                    loss_j = _loss_i(st, other, y, tgt[j],
                                     None if msk is None else msk[j])
                    gs = _grad(loss_j, wants + extra)
                    acc_loss += loss_j.detach()
                else:
                    gs = _grad(y, wants + extra, st.recv(shape, st.next))
            for k, g in zip(fl, gs):
                gl[k] += g.to(torch.float32)
            for k, g in zip(fo, gs[len(fl):]):
                go[k] += g.to(torch.float32)
            if x is not None:
                st.send(gs[-1], st.prev)
    st.drain()
    return _finish(st, acc_loss, gl, go, M, stage_layers, other)


def pipeline_loss_and_grads(card: ModelCard, stage_layers, other,
                            tokens: torch.Tensor, mesh, n_micro: int,
                            axis: str = "pp",
                            loss_mask: Optional[torch.Tensor] = None,
                            schedule: str = "1f1b"
                            ) -> Tuple[torch.Tensor, dict]:
    """(loss, grads) of this stage: grads ``{"stages": ..., "other": ...}``
    in the params' dtypes, the replicated ones summed over ``pp``. The two
    schedules compute the same math."""
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule={schedule!r}: one of {SCHEDULES}")
    if schedule == "gpipe":
        return _gpipe(card, stage_layers, other, tokens, mesh, n_micro,
                      axis, loss_mask, with_grads=True)
    return _one_f_one_b(card, stage_layers, other, tokens, mesh, n_micro,
                        axis, loss_mask)


def pipeline_loss_and_grads_1f1b(card: ModelCard, stage_layers, other,
                                 tokens, mesh, n_micro: int,
                                 axis: str = "pp", loss_mask=None):
    """The 1F1B schedule's (loss, grads) (the JAX package's name)."""
    return pipeline_loss_and_grads(card, stage_layers, other, tokens, mesh,
                                   n_micro, axis, loss_mask, "1f1b")


def _pp_layout(mesh, stage_layers, other, axis: str = "pp"):
    """The optimizer's view of a stage's params: each stage leaf is the
    slice of the whole [L, ...] stack along ``axis`` from the stage's first
    layer (so stochastic rounding hashes every element by its index in the
    one-rank pipeline's leaf) and a stack of layers (so LARS takes each
    layer's norms, as the one-rank step does), the replicated ones are
    counted once."""
    from koifish_tpu_torch.parallel.sharding import Shard
    from koifish_tpu_torch.train.sharded import ShardedLayout
    P, p = mesh.size(axis), mesh.index(axis)
    shards = [Shard(tuple(x.shape), (None,) * x.dim(), (0,) * x.dim(),
                    tuple(x.shape)) for x in leaves(other)]
    for x in leaves(stage_layers):
        n = x.shape[0]
        shards.append(Shard((n * P,) + tuple(x.shape[1:]),
                            (axis,) + (None,) * (x.dim() - 1),
                            (p * n,) + (0,) * (x.dim() - 1),
                            tuple(x.shape), stacked=True))
    return ShardedLayout(mesh, shards)


def make_pp_train_step(card: ModelCard, tcard, mesh, n_micro: int,
                       total_steps: int, axis: str = "pp",
                       schedule: str = "1f1b"):
    """(stage_layers, other, opt, tokens[, loss_mask]) -> (stage_layers,
    other, opt, metrics): a pipeline train step over this stage's params
    with the AdamW/Muon update of ``train/optimizer.py`` (the params and
    moments written in place). The JAX package's pipeline step drops
    ``muon_momentum``, ``lars_ratio``, ``muon_ortho`` and stochastic
    rounding; this one forwards them, its SR seeds drawn from a generator
    seeded with ``tcard.seed`` (the same on every stage, so the replicated
    leaves round alike). ``opt``: ``init_opt_state({"stages":
    stage_layers, "other": other}, ...)``."""
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule={schedule!r}: one of {SCHEDULES}")
    from koifish_tpu_torch.ops.tracectx import Int8Policy, int8_scope
    from koifish_tpu_torch.train.optimizer import apply_updates
    from koifish_tpu_torch.train.schedule import lr_at
    from koifish_tpu_torch.train.trainer import _sr_on

    int8_pol = (Int8Policy(wgrad=tcard.int8_wgrad, dgrad=tcard.int8_dgrad,
                           min_weight_elems=tcard.int8_min_kn)
                if getattr(tcard, "int8_matmul", False) else None)
    layout: Dict[str, Any] = {}
    sr_gen = None
    if _sr_on(tcard):
        sr_gen = torch.Generator(device="cpu")
        sr_gen.manual_seed(tcard.seed)

    def step(stage_layers, other, opt, tokens, loss_mask=None):
        if "lay" not in layout:
            layout["lay"] = _pp_layout(mesh, stage_layers, other, axis)
        with int8_scope(int8_pol):
            loss, grads = pipeline_loss_and_grads(
                card, stage_layers, other, tokens, mesh, n_micro, axis,
                loss_mask, schedule)
        lr = lr_at(opt.step, kind=tcard.scheduler, base_lr=tcard.lr,
                   total_steps=total_steps, warmup=tcard.warmup,
                   min_ratio=tcard.lr_min_ratio,
                   epoch_steps=getattr(tcard, "epoch_iters", 0))
        params = {"stages": stage_layers, "other": other}
        seeds = (None if sr_gen is None else torch.randint(
            0, 2 ** 32, (len(leaves(params)),), generator=sr_gen,
            dtype=torch.int64).tolist())
        params, opt, metrics = apply_updates(
            params, grads, opt, optimizer=tcard.optimizer, lr=lr,
            beta1=tcard.beta1, beta2=tcard.beta2, eps=tcard.eps,
            weight_decay=tcard.weight_decay,
            muon_momentum=tcard.muon_momentum, grad_clip=tcard.grad_clip,
            lars_ratio=getattr(tcard, "lars_ratio", 0.0),
            muon_ortho=getattr(tcard, "muon_ortho", "ns"), sr_seeds=seeds,
            dist=layout["lay"])
        metrics = dict(metrics, loss=loss, lr=lr)
        return params["stages"], params["other"], opt, metrics

    return step
