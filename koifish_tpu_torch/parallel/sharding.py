"""Partition specs and rank-local shards of params, caches and batches (the
JAX package's ``parallel/sharding.py``).

The Megatron layout of the JAX package, spec for spec (a spec is a plain
tuple of axis names, one entry a dim, None for a replicated dim):

- column-parallel: q/k/v, gate/up, fc, lm head -> OUT features on ``tp``
- row-parallel:    o, down, proj               -> IN features on ``tp``
- embeddings: vocab on ``tp``; column biases with their columns
- MoE stacks ``egate``/``eup``/``edown``: the expert axis on ``tp``
  (expert parallelism)
- optional FSDP: the other axis of those matrices on ``dp`` as well

Where the JAX package hands the specs to GSPMD, each rank here holds its
slice (``shard_params``) and runs the model on a card of its local head,
FFN and expert counts (``local_card``), the collectives explicit in the
model code (``ops/tracectx.TPPolicy``). An axis that does not divide its
dimension is replicated (``_fit_spec``). QTensor fields share their
parent's spec; packed codes split along K at group boundaries only
(packing is group-local, ``quant/packing.py``, so a K shard of the codes
is the codes of the K shard). A learned per-row codebook and Sinkhorn row
factors follow a K split, as the rank-local product needs their rows; a
per-tensor codebook is replicated.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from koifish_tpu_torch.config import ModelCard
from koifish_tpu_torch.quant.qtensor import TENSOR_FIELDS, QTensor
from koifish_tpu_torch.utils.tree import flatten_with_path, leaves

Spec = Tuple[Optional[str], ...]

# param-name -> (in_axis_shard, out_axis_shard); None = replicated axis
_COL = {"q", "k", "v", "gate", "up", "fc", "head"}      # shard axis -1
_ROW = {"o", "down", "proj"}                            # shard axis 0
_COL_BIAS = {"q_b", "k_b", "v_b", "fc_b"}               # shard axis 0 (out features)
_EXPERTS = ("egate", "eup", "edown")


def _spec_for_matrix(name: str, tp: str, fsdp: Optional[str]) -> Spec:
    if name in _COL:
        return (fsdp, tp)
    if name in _ROW or name == "wte":   # wte [V, E]: vocab sharded
        return (tp, fsdp)
    return (None, None)


def _qtensor_specs(name: str, qt: QTensor, tp: str,
                   fsdp: Optional[str]) -> QTensor:
    """A QTensor of specs mirroring the leaf's fields (a quantized wte is
    in head layout [E, V], sharded as the head)."""
    base = _spec_for_matrix(name if name != "wte" else "head", tp, fsdp)
    return QTensor(codes=base, scales=base,
                   zeros=base if qt.zeros is not None else None, fmt=qt.fmt,
                   shape=qt.shape, group=qt.group)


def _spec_leaf(name: str, w, tp: str, fsdp: Optional[str]):
    if isinstance(w, QTensor):
        return _qtensor_specs(name, w, tp, fsdp)
    nd = getattr(w, "ndim", 0)
    if nd == 3 and name in _EXPERTS:
        return (tp, None, None)        # expert parallelism
    if nd == 2:
        if name in ("wpe", "router"):
            return (None, None)
        return _spec_for_matrix(name, tp, fsdp)
    if nd == 1 and name in _COL_BIAS:
        return (tp,)
    return (None,) * nd


def param_specs(params: Dict[str, Any], tp: str = "tp",
                fsdp: Optional[str] = None) -> Dict[str, Any]:
    """Same-structure tree of specs for a transformer param tree."""
    out: Dict[str, Any] = {}
    for k, v in params.items():
        if k == "layers":
            out[k] = [{n: _spec_leaf(n, w, tp, fsdp) for n, w in lp.items()}
                      for lp in v]
        else:
            out[k] = _spec_leaf(k, v, tp, fsdp)
    return out


def batch_spec(dp: str = "dp") -> Spec:
    """[(accum,) B, T] batches: the batch dim on dp."""
    return (None, dp, None)


def _fit_spec(shape, spec: Spec, mesh) -> Spec:
    """Drop axis shardings that do not divide the dimension evenly."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    fixed = []
    for dim, ax in zip(shape, spec):
        axes = () if ax is None else (ax if isinstance(ax, tuple) else (ax,))
        n = 1
        for a in axes:
            n *= mesh.size(a)
        fixed.append(ax if ax is not None and dim % n == 0 else None)
    return tuple(fixed)


# ---------------------------------------------------------------------------
# rank-local shards
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Shard:
    """One leaf's layout: its whole ``shape``, the fitted ``spec``, and
    this rank's ``start`` and ``local`` shape per dim. ``stacked``: dim 0
    stacks layers (a pipeline stage's [L/P, ...] leaf), each a leaf of the
    one-rank model of its own."""
    shape: Tuple[int, ...]
    spec: Spec
    start: Tuple[int, ...]
    local: Tuple[int, ...]
    stacked: bool = False

    @property
    def sharded(self) -> bool:
        return any(a is not None for a in self.spec)

    def axes(self) -> List[str]:
        return [a for a in self.spec if a is not None]


def _shard(shape, spec: Spec, mesh) -> Shard:
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    start, local = [], []
    for dim, ax in zip(shape, spec):
        if ax is None:
            start.append(0)
            local.append(dim)
            continue
        i, n = mesh.index(ax), mesh.size(ax)
        start.append(i * (dim // n))
        local.append(dim // n)
    return Shard(tuple(shape), spec, tuple(start), tuple(local))


def _qtensor_shards(qt: QTensor, spec: QTensor, mesh) -> Dict[str, Shard]:
    """The layouts of a QTensor's set fields. K (axis 0) splits only at
    group boundaries; the codes' rows follow the K split."""
    n_in, n_out = qt.shape[0], qt.shape[-1]
    k_ax, n_ax = spec.codes
    if k_ax is not None:
        m = mesh.size(k_ax)
        if n_in % m or (n_in // m) % qt.group or qt.scales.shape[0] % m:
            k_ax = None
    if n_ax is not None and n_out % mesh.size(n_ax):
        n_ax = None
    out = {}
    for f in ("codes", "scales", "zeros"):
        t = getattr(qt, f)
        if t is not None:
            out[f] = _shard(tuple(t.shape), (k_ax, n_ax), mesh)
    if qt.codebook is not None:
        cb = qt.codebook
        out["codebook"] = _shard(tuple(cb.shape), (k_ax, None)
                                 if cb.dim() == 2 else (None,), mesh)
    if qt.row_scale is not None:
        out["row_scale"] = _shard(tuple(qt.row_scale.shape), (k_ax,), mesh)
    return out


def leaf_shards(params: Dict[str, Any], mesh, tp: str = "tp",
                fsdp: Optional[str] = None) -> List[Shard]:
    """The ``Shard`` of every leaf of the WHOLE ``params``, in
    ``utils/tree`` leaf order (a QTensor's set fields in field order)."""
    specs = param_specs(params, tp, fsdp)
    out: List[Shard] = []

    def walk(name, w, spec):
        if isinstance(w, dict):   # an adapter on a one-rank mesh
            for n in sorted(w):
                walk(n, w[n], (None,) * getattr(w[n], "ndim", 0))
        elif isinstance(w, QTensor):
            sh = _qtensor_shards(w, spec, mesh)
            out.extend(sh[f] for f in TENSOR_FIELDS
                       if getattr(w, f) is not None)
        else:
            shape = tuple(w.shape)
            out.append(_shard(shape, _fit_spec(shape, spec, mesh), mesh))

    for k in sorted(params):
        if k == "layers":
            for lp, sp in zip(params["layers"], specs["layers"]):
                for n in sorted(lp):
                    walk(n, lp[n], sp[n])
        else:
            walk(k, params[k], specs[k])
    if len(out) != len(leaves(params)):
        raise ValueError("leaf_shards: a param tree deeper than the "
                         "transformer's layout")
    return out


def take(x: torch.Tensor, sh: Shard) -> torch.Tensor:
    """This rank's slice of a whole leaf (a copy, contiguous)."""
    for d, (s, n) in enumerate(zip(sh.start, sh.local)):
        if n != x.shape[d]:
            x = x.narrow(d, s, n)
    return x.contiguous().clone()


def rebuild(tree: Any, new_leaves: List[Any], qshape=None) -> Any:
    """``tree``'s structure over ``new_leaves`` (in ``utils/tree`` leaf
    order), each dict keeping ``tree``'s key order, so a checkpoint of the
    result is written in the same order; ``qshape(qt, fields)``, when
    given, is each QTensor's new logical shape."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, QTensor):
            vals = {f: next(it) for f in TENSOR_FIELDS
                    if getattr(t, f) is not None}
            shape = qshape(t, vals) if qshape is not None else t.shape
            return dataclasses.replace(t, shape=shape, **vals)
        if isinstance(t, dict):
            d = {k: build(t[k]) for k in sorted(t)}
            return {k: d[k] for k in t}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)
    return build(tree)


def _logical_shape(qt: QTensor, sh: Shard, local: bool) -> tuple:
    """A QTensor's logical [in, out] shape on this rank (``local``) or
    whole, from its codes' layout."""
    n_in, n_out = qt.shape[0], qt.shape[-1]
    k_ax, n_ax = sh.spec
    # the codes' row and column splits are the logical ones
    kf = sh.shape[0] // sh.local[0] if k_ax is not None else 1
    nf = sh.shape[1] // sh.local[1] if n_ax is not None else 1
    if local:
        return (n_in // kf, n_out // nf)
    return (n_in * kf, n_out * nf)


def shard_params(params: Dict[str, Any], mesh, tp: str = "tp",
                 fsdp: Optional[str] = None,
                 shards: Optional[List[Shard]] = None) -> Dict[str, Any]:
    """This rank's shard of every leaf of the whole ``params`` (copies; a
    QTensor's ``shape`` becomes its local logical shape). ``shards``: the
    layouts from ``leaf_shards`` (computed when not given)."""
    shards = shards or leaf_shards(params, mesh, tp, fsdp)
    flat = leaves(params)
    cut = [take(x, sh) for x, sh in zip(flat, shards)]
    codes_sh = iter([sh for (path, _), sh in
                     zip(flatten_with_path(params), shards)
                     if path and path[-1] == ".codes"])
    return rebuild(params, cut,
                    lambda qt, vals: _logical_shape(qt, next(codes_sh), True))


def gather_leaf(x: torch.Tensor, sh: Shard, mesh) -> torch.Tensor:
    """The whole leaf from every rank's shard: all-gathered along each
    sharded dim over its axis's group."""
    from koifish_tpu_torch.parallel import comm
    for d, ax in enumerate(sh.spec):
        if ax is not None:
            x = comm.all_gather_cat(x.contiguous(), mesh.group(ax), d)
    return x


def gather_params(local: Dict[str, Any], shards: List[Shard], mesh
                  ) -> Dict[str, Any]:
    """The whole param tree from every rank's shard (every rank of the mesh
    takes part; each gets the whole tree)."""
    flat = leaves(local)
    full = [gather_leaf(x, sh, mesh) if sh.sharded else x
            for x, sh in zip(flat, shards)]
    codes_sh = iter([sh for (path, _), sh in
                     zip(flatten_with_path(local), shards)
                     if path and path[-1] == ".codes"])
    return rebuild(local, full,
                    lambda qt, vals: _logical_shape(qt, next(codes_sh),
                                                    False))


def shard_cache(cache, mesh, tp: str = "tp", dp: Optional[str] = None):
    """This rank's part of a KV cache ([L, B, H, S, D] leaves): KV heads on
    ``tp`` (matching the column-parallel k/v projections), optionally the
    batch on ``dp``; ``pos`` follows the batch."""
    def put(x, spec):
        if x is None:
            return None
        if isinstance(x, (list, tuple)):
            return [put(a, spec[1:]) for a in x]
        sh = _shard(tuple(x.shape), _fit_spec(x.shape, spec, mesh), mesh)
        return take(x, sh)

    kv, sc = (None, dp, tp, None, None), (None, dp, tp, None)
    return dataclasses.replace(
        cache, k=put(cache.k, kv), v=put(cache.v, kv),
        k_scale=put(cache.k_scale, sc), v_scale=put(cache.v_scale, sc),
        pos=put(cache.pos, (dp,)))


def constrain_activations(x: torch.Tensor, mesh, dp: str = "dp"
                          ) -> torch.Tensor:
    """This rank's rows of a [B, ...] activation with the batch on ``dp``;
    raises where B does not divide."""
    n = mesh.size(dp)
    if x.shape[0] % n:
        raise ValueError(f"constrain_activations: batch {x.shape[0]} does "
                         f"not divide over {dp}={n}")
    per = x.shape[0] // n
    return x[mesh.index(dp) * per:(mesh.index(dp) + 1) * per]


# ---------------------------------------------------------------------------
# the rank-local card
# ---------------------------------------------------------------------------

def check_parallel_card(card: ModelCard,
                        what: str = "tensor parallelism") -> None:
    """Raise for the zoo cards whose JAX run fails under ``what``, naming
    the case (ROADMAP.md queue 3, known quirks): LLAMA_VAE under tensor
    parallelism (the JAX ``shard_params`` reads ``.shape`` of the nested
    ``evae`` params: AttributeError), GUPPY under pipeline parallelism (the
    JAX pipeline's layers find no ``guppy_rows``: KeyError). A pipeline
    over heterogeneous layers raises in ``pipeline.stack_for_pipeline``,
    as in the JAX package."""
    if what == "tensor parallelism" and card.arch == "LLAMA_VAE":
        raise NotImplementedError(
            "LLAMA_VAE under tensor parallelism: the JAX package's "
            "shard_params fails on the nested evae params (AttributeError: "
            "'dict' object has no attribute 'shape'), so the port refuses it")
    if what == "pipeline parallelism" and card.arch == "GUPPY":
        raise NotImplementedError(
            "GUPPY under pipeline parallelism: the JAX package's pipeline "
            "runs its layers without the sampled rows (KeyError: "
            "'guppy_rows'), so the port refuses it")


def check_mesh_params(params: Dict[str, Any], n_ranks: int) -> None:
    """Raise for a param tree the JAX package cannot shard: its
    ``shard_params`` (which its CLI calls whenever dp·tp·sp > 1) reads
    ``.shape`` of every entry, so LoRA adapters (``*_lora`` dicts) and
    LLAMA_VAE's nested ``evae`` params fail there (AttributeError: 'dict'
    object has no attribute 'shape'; ROADMAP.md queue 3, known quirks).
    ``n_ranks``: dp·tp·sp of the mesh; a one-rank mesh shards nothing."""
    if n_ranks <= 1:
        return
    names = sorted({n for lp in params.get("layers", []) for n, w in
                    lp.items() if isinstance(w, dict)}
                   | {k for k, w in params.items() if isinstance(w, dict)})
    if not names:
        return
    what = ("LLAMA_VAE" if "evae" in names else
            "LoRA adapters" if all(n.endswith("_lora") for n in names)
            else "nested params")
    raise NotImplementedError(
        f"{what} on a process mesh of {n_ranks} ranks: the JAX package's "
        f"shard_params fails on the nested {', '.join(names)} params "
        f"(AttributeError: 'dict' object has no attribute 'shape'), so the "
        f"port refuses it")


def local_card(card: ModelCard, tp: int, check: bool = True) -> ModelCard:
    """The card a tensor-parallel rank runs: ``n_head``, ``n_kv_head`` and
    ``n_ffn`` divided by ``tp`` (the vocab and the expert count stay whole;
    the embedding, head and expert stacks carry the split). The zoo: an MLA
    rank keeps its heads of the whole latent projections; a GAU layer its
    columns of F and its heads; a MAMBA card's layers (all replicated) and
    a GUPPY card's FFN (its sampled rows, replicated) stay whole, so MAMBA
    keeps its card and GUPPY its ``n_ffn``; BROWN layers read their whole
    head count from their table. ``check``: refuse the cards that
    ``check_parallel_card`` refuses under tensor parallelism; serving
    passes False (it takes LLAMA_VAE: a loaded checkpoint carries no
    ``evae`` stack, in either package)."""
    if tp == 1:
        return card
    if check:
        check_parallel_card(card)
    if card.arch == "MAMBA":
        return card
    names = ("n_head", "n_kv_head") + (() if card.arch == "GUPPY"
                                       else ("n_ffn",))
    for name in names:
        if getattr(card, name) % tp:
            raise ValueError(f"tensor parallelism over {tp} ranks needs "
                             f"{name}={getattr(card, name)} to divide")
    if card.n_experts and card.n_experts % tp:
        raise ValueError(f"expert parallelism over {tp} ranks needs "
                         f"n_experts={card.n_experts} to divide")
    return dataclasses.replace(
        card, **{name: getattr(card, name) // tp for name in names})
