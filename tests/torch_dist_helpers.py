"""Rank workers for the process-mesh tests (``tests/test_torch_parallel*``).

Each worker runs in a process of its own, started by
``koifish_tpu_torch.parallel.multihost.spawn`` on the CPU (gloo), so this
module imports torch and the port only, never JAX or a test module. A
worker reads its inputs from ``inp`` (``torch.save`` of numpy trees made by
the test from the JAX package) and writes what rank r computed to
``out/rank{r}.pt`` for the test to hold against the JAX package.
"""
from __future__ import annotations

import os

import torch

from koifish_tpu_torch.config import ModelCard, QuantCard, TrainCard
from koifish_tpu_torch.io.convert import params_from_numpy
from koifish_tpu_torch.parallel.mesh import make_process_mesh
from koifish_tpu_torch.parallel.multihost import init_distributed
from koifish_tpu_torch.train import trainer
from koifish_tpu_torch.utils.tree import leaves


def _join(axes):
    init_distributed(device="cpu")
    return make_process_mesh(axes, "cpu")


def _save(out: str, mesh, obj) -> None:
    torch.save(obj, os.path.join(out, f"rank{mesh.rank}.pt"))


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _card(inp):
    """The run's card: ``inp["model_card"]`` where the test built one (the
    zoo's), else ``inp["arch"]`` with ``inp["card"]``."""
    if inp.get("model_card") is not None:
        return inp["model_card"]
    return ModelCard.from_arch(inp["arch"], **inp["card"])


def _curve(mesh, inp, fsdp=False, masks=None, sp=None):
    """Train ``inp``'s batches from its init on ``mesh`` (``sp``: the
    sequence-parallel policy); (losses, grad norms, the whole params at
    the end as numpy, the whole state)."""
    from koifish_tpu_torch.train.sharded import (gather_train_state,
                                                 shard_batch,
                                                 shard_train_state)
    card = _card(inp)
    tcard = TrainCard(**inp["tcard"])
    state = trainer.init_train_state(
        card, tcard, params=params_from_numpy(inp["init"], device="cpu"))
    state = shard_train_state(state, mesh, fsdp="dp" if fsdp else None)
    step = trainer.make_train_step(card, tcard, total_steps=10, sp=sp)
    losses, gnorms = [], []
    for a, b in enumerate(inp["batches"]):
        batch = {"tokens": torch.from_numpy(b).long()}
        if masks is not None:
            batch["loss_mask"] = torch.from_numpy(masks[a])
        state, m = step(state, shard_batch(batch, mesh))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    whole = gather_train_state(state)
    return (losses, gnorms, [_np(x) for x in leaves(whole.params)],
            whole)


def _reducer(mesh, inp, fsdp=False):
    """The dp gradients of the first batch summed two ways with small
    buckets (several all-reduce and reduce-scatter buckets): collectives
    started from the backward's hooks (``arm``/``finish``, the train
    step's path) and ``GradReducer.reduce`` after the backward. Returns
    both as lists of numpy arrays, in leaf order."""
    from koifish_tpu_torch.ops.tracectx import tp_scope
    from koifish_tpu_torch.parallel.overlap import GradReducer
    from koifish_tpu_torch.train.sharded import (shard_batch,
                                                 shard_train_state)
    from koifish_tpu_torch.utils.tree import unflatten_like
    card = ModelCard.from_arch(inp["arch"], **inp["card"])
    tcard = TrainCard(**inp["tcard"])
    state = trainer.init_train_state(
        card, tcard, params=params_from_numpy(inp["init"], device="cpu"))
    state = shard_train_state(state, mesh, fsdp="dp" if fsdp else None)
    lay = state.layout
    flat = [lay.gather_fsdp(p, i) for i, p in enumerate(
        leaves(state.params))]
    idx = [i for i, p in enumerate(flat) if p.is_floating_point()]
    for i in idx:
        flat[i].requires_grad_(True)
    params = unflatten_like(state.params, flat)
    tokens = shard_batch({"tokens": torch.from_numpy(
        inp["batches"][0]).long()}, mesh)["tokens"]
    dims = {i: lay.fsdp_dim(i) for i in idx if lay.fsdp_dim(i) is not None}

    def loss():
        with tp_scope(lay.tp_policy(card)):
            out, _ = trainer.compute_loss(lay.run_card(card), params,
                                          tokens[0])
        return out * lay.loss_weights(tokens, None)[0]
    red = GradReducer(mesh.group("dp"), idx, dims, bucket_bytes=16 << 10)
    red.arm({i: flat[i] for i in idx}, lambda i, g: g)
    torch.autograd.grad(loss(), [flat[i] for i in idx])
    hooked = red.finish()
    n_buckets = len(red.buckets)
    gs = torch.autograd.grad(loss(), [flat[i] for i in idx])
    after = GradReducer(mesh.group("dp"), idx, dims,
                        bucket_bytes=16 << 10).reduce(dict(zip(idx, gs)))
    return ([_np(hooked[i]) for i in idx], [_np(after[i]) for i in idx],
            n_buckets, sorted(dims))


# ---------------------------------------------------------------------------
# dp: data parallelism, FSDP, the overlapped reduction, checkpoints
# ---------------------------------------------------------------------------

def dp_worker(inp_path: str, out: str) -> None:
    inp = torch.load(inp_path, weights_only=False)
    mesh = _join({"dp": 2})
    res = {}
    res["overlap"] = _curve(mesh, inp)[:3]
    res["reducer"] = _reducer(mesh, inp)
    res["reducer_fsdp"] = _reducer(mesh, inp, fsdp=True)
    res["fsdp"] = _curve(mesh, inp, fsdp=True)[:3]
    res["masked"] = _curve(mesh, inp, masks=inp["masks"])[:2]
    res["masked_fsdp"] = _curve(mesh, inp, fsdp=True,
                                masks=inp["masks"])[:2]

    # the checkpoint of a sharded state, written by rank 0 from the
    # gathered state, is a one-rank run's file
    from koifish_tpu_torch.io import save_train_state
    from koifish_tpu_torch.train.sharded import (gather_train_state,
                                                 shard_train_state)
    card = ModelCard.from_arch(inp["arch"], **inp["card"])
    tcard = TrainCard(**inp["tcard"])
    st = trainer.init_train_state(
        card, tcard, params=params_from_numpy(inp["init"], device="cpu"))
    whole = gather_train_state(shard_train_state(st, mesh, fsdp="dp"))
    if mesh.is_main:
        save_train_state(os.path.join(out, "sharded.safetensors"), whole,
                         card, extra_meta={"iter": 0})

    # koifish --dp 2 --fsdp through the CLI's main on this group
    from koifish_tpu_torch.cli import koifish
    result = {}
    koifish.main([inp["cfg"], "--device", "cpu", "--dp", "2", "--fsdp",
                  "--out-dir", os.path.join(out, f"cli{mesh.rank}")],
                 result)
    res["cli"] = result["infos"].losses
    _save(out, mesh, res)


# ---------------------------------------------------------------------------
# tp: tensor and expert parallelism, serving, the streamed load
# ---------------------------------------------------------------------------

def _tp_serve(mesh, card, params, tokens, n_decode=3):
    """TP prefill + decode logits of ``params`` (whole) on ``mesh``."""
    from koifish_tpu_torch.ops.tracectx import TPPolicy, tp_scope
    from koifish_tpu_torch.parallel.sharding import local_card, shard_params
    from koifish_tpu_torch.serve import cache_for, decode_step, prefill
    tp = mesh.size("tp")
    pol = TPPolicy(group=mesh.group("tp"), rank=mesh.index("tp"), size=tp,
                   vocab=card.vocab_size, src=0)
    local = shard_params(params, mesh)
    lc = local_card(card, tp)
    B = tokens.shape[0]
    outs = []
    with tp_scope(pol), torch.no_grad():
        cache = cache_for(lc, B, 32, device="cpu")
        lg, cache = prefill(lc, local, tokens, cache, device="cpu")
        outs.append(_np(lg))
        for t in range(n_decode):
            lg, cache = decode_step(lc, local,
                                    torch.full((B,), t + 7,
                                               dtype=torch.int32), cache)
            outs.append(_np(lg))
    return outs


def tp_worker(inp_path: str, out: str) -> None:
    inp = torch.load(inp_path, weights_only=False)
    mesh = _join({"tp": 2})
    res = {}
    res["curve"] = _curve(mesh, inp)[:3]
    card = ModelCard.from_arch(inp["arch"], **inp["card"])
    tokens = torch.from_numpy(inp["prompt"]).long()
    res["bf16"] = _tp_serve(mesh, card, params_from_numpy(inp["init"],
                                                          device="cpu"),
                            tokens)
    res["int4"] = _tp_serve(mesh, card, params_from_numpy(inp["int4"],
                                                          device="cpu"),
                            tokens, n_decode=0)

    # expert parallelism: a MoE card's forward and curve
    moe = dict(inp["moe"], init=inp["moe_init"])
    res["moe_curve"] = _curve(mesh, moe)[:2]
    from koifish_tpu_torch.models import model_forward
    from koifish_tpu_torch.ops.tracectx import TPPolicy, tp_scope
    from koifish_tpu_torch.parallel.sharding import local_card, shard_params
    mcard = ModelCard.from_arch(moe["arch"], **moe["card"])
    mp = shard_params(params_from_numpy(moe["init"], device="cpu"), mesh)
    pol = TPPolicy(group=mesh.group("tp"), rank=mesh.index("tp"), size=2,
                   vocab=mcard.vocab_size)
    with tp_scope(pol), torch.no_grad():
        res["moe_logits"] = _np(model_forward(local_card(mcard, 2), mp,
                                              tokens % mcard.vocab_size))

    # the streamed load: this rank's shards, multi-chunk, both layouts
    from koifish_tpu_torch.io import stream_load
    stream_load.CHUNK_BYTES = 1
    qc = QuantCard.from_json(inp["qc"])
    for name in ("single", "multi"):
        before = stream_load.bytes_read()
        scard, sp = stream_load.load_hf_sharded_quantized(
            inp["hf"][name], mesh, qc)
        res["stream_" + name] = [_np(x) if x.is_floating_point()
                                 else x.numpy() for x in leaves(sp)]
        whole = sum(v.numel() * v.element_size() for v in
                    stream_load._lazy_folder(inp["hf"][name]).values())
        res["stream_read_" + name] = (stream_load.bytes_read() - before,
                                      whole)
    pol = TPPolicy(group=mesh.group("tp"), rank=mesh.index("tp"), size=2,
                   vocab=scard.vocab_size)
    from koifish_tpu_torch.serve import cache_for, prefill
    with tp_scope(pol), torch.no_grad():
        lc = local_card(scard, 2)
        lg, _ = prefill(lc, sp, tokens, cache_for(lc, 2, 32, device="cpu"),
                        device="cpu")
        res["stream_prefill"] = _np(lg)

    # the checkpoint of the dp group's run resumes under tp
    from koifish_tpu_torch.io import load_train_state
    from koifish_tpu_torch.train.sharded import (gather_train_state,
                                                 shard_train_state)
    tcard = TrainCard(**inp["tcard"])
    tmpl = trainer.init_train_state(
        card, tcard, params=params_from_numpy(inp["init"], device="cpu"))
    st, _ = load_train_state(inp["ckpt"], tmpl)
    back = gather_train_state(shard_train_state(st, mesh))
    res["resume_equal"] = all(
        torch.equal(a, b) for a, b in zip(leaves(st.params),
                                          leaves(back.params)))

    # bubble --tp 2, bf16 and INT4, through the CLI's main on this group
    from koifish_tpu_torch.cli import bubble
    for bits in ("0", "4"):
        turns = []
        bubble.main(["--hf", inp["hf"]["single"], "--device", "cpu",
                     "--tp", "2", "--bits", bits, "--temperature", "0",
                     "--max-new", "8", "--ctx", "96", "--prompts", "hi",
                     "--csv", os.path.join(out, f"chat{mesh.rank}.csv")],
                    turns)
        res["bubble" + bits] = (turns[0]["prompt_ids"], turns[0]["tokens"])
    _save(out, mesh, res)


# ---------------------------------------------------------------------------
# pp: pipeline parallelism
# ---------------------------------------------------------------------------

def pp_worker(inp_path: str, out: str) -> None:
    inp = torch.load(inp_path, weights_only=False)
    mesh = _join({"pp": 2})
    from koifish_tpu_torch.parallel import pipeline as pl
    from koifish_tpu_torch.train.optimizer import init_opt_state
    card = ModelCard.from_arch(inp["arch"], **inp["card"])
    params = params_from_numpy(inp["init"], device="cpu")
    stage = mesh.index("pp")
    res = {}
    sl, ot = pl.stack_for_pipeline(params, 2, stage=stage)
    res["logits"] = _np(pl.pipeline_logits(
        card, sl, ot, torch.from_numpy(inp["prompt"]).long(), mesh, 2))
    toks = torch.from_numpy(inp["pp_tokens"]).long()
    l1, g1 = pl.pipeline_loss_and_grads(card, sl, ot, toks, mesh, 4,
                                        schedule="gpipe")
    l2, g2 = pl.pipeline_loss_and_grads(card, sl, ot, toks, mesh, 4,
                                        schedule="1f1b")
    res["loss_gpipe"], res["loss_1f1b"] = float(l1), float(l2)
    res["grads_equal"] = all(torch.equal(a, b) for a, b in
                             zip(leaves(g1), leaves(g2)))
    res["fwd_loss"] = float(pl.pipeline_loss(card, sl, ot, toks, mesh, 4))
    # only the last stage runs the norm, the head and the CE: one head
    # product a micro-batch in all (tests/test_pipeline.py:197)
    calls = []
    real = pl.lm_head
    pl.lm_head = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        pl.pipeline_loss_and_grads(card, sl, ot, toks, mesh, 4)
    finally:
        pl.lm_head = real
    res["head_calls"] = len(calls)
    tcard = TrainCard(**inp["tcard"])
    for sched in ("1f1b", "gpipe"):
        sl, ot = pl.stack_for_pipeline(
            params_from_numpy(inp["init"], device="cpu"), 2, stage=stage)
        opt = init_opt_state({"stages": sl, "other": ot}, tcard.optimizer)
        step = pl.make_pp_train_step(card, tcard, mesh, 4, 20,
                                     schedule=sched)
        losses = []
        for b in inp["pp_batches"]:
            sl, ot, opt, m = step(sl, ot, opt, torch.from_numpy(b).long())
            losses.append(float(m["loss"]))
        res["curve_" + sched] = (losses, _np(ot["wte"]),
                                 [_np(x) for x in leaves(sl)])

    # koifish --pp 2 through the CLI's main on this group
    from koifish_tpu_torch.cli import koifish
    result = {}
    koifish.main([inp["cfg"], "--device", "cpu", "--pp", "2", "--out-dir",
                  os.path.join(out, f"cli{mesh.rank}")], result)
    res["cli"] = result["infos"].losses
    _save(out, mesh, res)


# ---------------------------------------------------------------------------
# dp x tp on four ranks
# ---------------------------------------------------------------------------

def dp_tp_worker(inp_path: str, out: str) -> None:
    inp = torch.load(inp_path, weights_only=False)
    mesh = _join({"dp": 2, "tp": 2})
    res = {"fsdp": _curve(mesh, inp, fsdp=True)[:3],
           "overlap": _curve(mesh, inp)[:3],
           "reducer": _reducer(mesh, inp, fsdp=True),
           # Muon's leaves gather their whole lookahead over tp and dp
           "muon": _curve(mesh, dict(inp, tcard=dict(inp["tcard"],
                                                     optimizer="muon")),
                          fsdp=True)[:2]}
    res["coords"] = (mesh.index("dp"), mesh.index("tp"))
    _save(out, mesh, res)


# ---------------------------------------------------------------------------
# the model zoo under tp and pp
# ---------------------------------------------------------------------------

def zoo_tp_worker(inp_path: str, out: str) -> None:
    """Every zoo card of ``inp["zoo"]`` trained on one tp-2 mesh: each
    card's (losses, grad norms)."""
    inp = torch.load(inp_path, weights_only=False)
    mesh = _join({"tp": 2})
    _save(out, mesh, {name: _curve(mesh, z)[:2]
                      for name, z in inp["zoo"].items()})


def zoo_pp_worker(inp_path: str, out: str) -> None:
    """Every zoo card of ``inp["zoo"]`` trained through the 1F1B pipeline
    on a pp-2 mesh (4 micro-batches): each card's (losses, grad norms)."""
    from koifish_tpu_torch.parallel import pipeline as pl
    from koifish_tpu_torch.train.optimizer import init_opt_state
    inp = torch.load(inp_path, weights_only=False)
    mesh = _join({"pp": 2})
    res = {}
    for name, z in inp["zoo"].items():
        card, tcard = _card(z), TrainCard(**z["tcard"])
        sl, ot = pl.stack_for_pipeline(
            params_from_numpy(z["init"], device="cpu"), 2,
            stage=mesh.index("pp"))
        opt = init_opt_state({"stages": sl, "other": ot}, tcard.optimizer)
        step = pl.make_pp_train_step(card, tcard, mesh, 4, 10)
        losses, gnorms = [], []
        for b in z["batches"]:
            sl, ot, opt, m = step(sl, ot, opt, torch.from_numpy(b[0]).long())
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
        res[name] = (losses, gnorms)
    _save(out, mesh, res)


# ---------------------------------------------------------------------------
# sp beside dp and tp, the ring across processes
# ---------------------------------------------------------------------------

def _ring_inputs(seed, B, T, Hq, Hkv, D, grad=False):
    g = torch.Generator().manual_seed(seed)
    out = [torch.randn(B, T, h, D, generator=g).to(torch.bfloat16)
           for h in (Hq, Hkv, Hkv)]
    dy = torch.randn(B, T, Hq, D, generator=g).to(torch.bfloat16)
    return [x.requires_grad_(grad) for x in out], dy


def _sp_grads(mesh, inp, planted=False):
    """One step's gradients of the whole loss on this rank's dp rows with
    attention the ring over ``sp``: through the process ring, and through
    the one-controller ring of the same sp in this process (the one-rank
    arithmetic). ``planted``: the chunk taken with a plain slice in place of
    ``comm.split_to`` (a backward that does not gather)."""
    from koifish_tpu_torch.ops.tracectx import SPPolicy, sp_scope
    from koifish_tpu_torch.parallel import comm, make_mesh
    from koifish_tpu_torch.train.sharded import shard_batch
    card = _card(inp)
    tokens = shard_batch({"tokens": torch.from_numpy(
        inp["batches"][0]).long()}, mesh)["tokens"][0]
    params = params_from_numpy(inp["init"], device="cpu")
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    sp = mesh.size("sp")

    def grads(policy):
        with sp_scope(policy):
            loss, _ = trainer.compute_loss(card, params, tokens)
        return [g.detach() for g in torch.autograd.grad(loss, flat)]
    real = comm.split_to
    if planted:
        comm.split_to = lambda x, group, dim: x.narrow(
            dim, comm.group_rank(group) * (x.shape[dim] // sp),
            x.shape[dim] // sp)
    try:
        got = grads(SPPolicy("sp", mesh))
    finally:
        comm.split_to = real
    ref = grads(SPPolicy("sp", make_mesh({"sp": sp}, devices="cpu")))
    return all(torch.equal(a, b) for a, b in zip(got, ref))


def sp_worker(inp_path: str, out: str) -> None:
    """Four ranks: dp 2 x sp 2 and tp 2 x sp 2 curves; each sp rank's
    gradients against the one-controller ring's (and a planted slice in
    place of ``split_to``); the process rings (plain and kernel) against
    their one-controller counterparts, with the kernel ring's transfers."""
    from koifish_tpu_torch.ops.kernels import ring_attn as ra
    from koifish_tpu_torch.ops.tracectx import SPPolicy
    from koifish_tpu_torch.parallel import make_mesh
    from koifish_tpu_torch.parallel.ring_attention import (
        ring_attention_sharded)
    from koifish_tpu_torch.parallel.ring_pallas import (
        ring_attention_pallas_sharded)
    inp = torch.load(inp_path, weights_only=False)
    res = {}
    for name, axes in (("dp_sp", {"dp": 2, "sp": 2}),
                       ("tp_sp", {"tp": 2, "sp": 2})):
        mesh = _join(axes) if name == "dp_sp" else make_process_mesh(
            axes, "cpu")
        res[name] = _curve(mesh, inp, sp=SPPolicy("sp", mesh))[:2]
        if name == "dp_sp":
            res["grads_equal"] = _sp_grads(mesh, inp)
            res["planted_equal"] = _sp_grads(mesh, inp, planted=True)
    # the rings over all four ranks: the plain (differentiable) ring on
    # whole tensors, and the kernel ring's CPU path on each rank's chunk
    mesh = make_process_mesh({"sp": 4}, "cpu")
    (q, k, v), dy = _ring_inputs(0, 2, 32, 4, 2, 16, grad=True)
    o = ring_attention_sharded(mesh, "sp")(q, k, v)
    got = [o] + list(torch.autograd.grad(o, (q, k, v), dy))
    o1 = ring_attention_sharded(make_mesh({"sp": 4}, devices="cpu"), "sp")(
        q, k, v)
    ref = [o1] + list(torch.autograd.grad(o1, (q, k, v), dy))
    res["plain_ring_equal"] = [torch.equal(a, b) for a, b in zip(got, ref)]
    (q, k, v), _ = _ring_inputs(1, 1, 4 * 128, 8, 2, 64)
    r = mesh.index("sp")
    made = []

    class Recorded(ra.ProcessTransport):
        def __init__(self, *a):
            super().__init__(*a)
            made.append(self)
    real, ra.ProcessTransport = ra.ProcessTransport, Recorded
    try:
        o = ring_attention_pallas_sharded(mesh, "sp")(
            *(x.chunk(4, dim=1)[r] for x in (q, k, v)))
    finally:
        ra.ProcessTransport = real
    want = ra.ring_plain(*(list(x.chunk(4, dim=1)) for x in (q, k, v)))[r]
    res["kernel_ring_equal"] = torch.equal(o, want)
    res["transfers"] = made[0].log

    # koifish --dp 2 --sp 2 and --tp 2 --sp 2 through the CLI's main
    from koifish_tpu_torch.cli import koifish
    for flags in (["--dp", "2"], ["--tp", "2"]):
        result = {}
        koifish.main([inp["cfg"], "--device", "cpu", *flags, "--sp", "2",
                      "--out-dir", os.path.join(out, f"cli{mesh.rank}")],
                     result)
        res["cli" + flags[0]] = result["infos"].losses
    _save(out, mesh, res)


def load_results(out: str, n: int):
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(n)]

