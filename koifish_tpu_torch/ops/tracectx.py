"""Scoped training policies (the JAX package's ``ops/tracectx.py``).

A policy object is pushed for the duration of one train step, exception-
safe and thread-local, so concurrent steps or servers do not see each
other's switches. ``make_train_step`` keeps ``int8_scope``, ``sp_scope``
and ``tp_scope`` open for the whole step; the serving CLI keeps
``tp_scope`` open for a tensor-parallel run. Autograd runs a CUDA backward on its
own device thread, where this thread's scope is not visible, so what the
backward recomputes (remat blocks, checkpointed CE chunks) captures the
policies at the forward and re-enters them
(``models/transformer.py::_remat_block``): the recompute runs the same
int8 matmuls and the same ring attention as the forward.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional


@dataclasses.dataclass(frozen=True)
class Int8Policy:
    """Dynamic-range int8 training matmuls (``ops/int8_train.py``)."""
    wgrad: bool = False
    # False | True/'fold' (scale-folded dy) | 'tile' (per-tile kernel)
    dgrad: object = False
    min_weight_elems: int = 1 << 24   # K*N gate: head-sized and up

    def applies(self, shape) -> bool:
        return len(shape) == 2 and shape[0] * shape[1] >= self.min_weight_elems


@dataclasses.dataclass(frozen=True)
class SPPolicy:
    """Sequence-parallel training: full-sequence causal attention runs ring
    attention with T sharded over ``axis`` of ``mesh`` (a
    ``parallel/mesh.Mesh`` whose ranks one controller drives, or a
    ``ProcessMesh`` whose ranks are processes; untyped: this module imports
    nothing of them)."""
    axis: str
    mesh: object


@dataclasses.dataclass(frozen=True)
class TPPolicy:
    """Tensor parallelism over a process group: this rank holds
    ``n_head/size`` heads, ``n_kv_head/size`` KV heads, ``n_ffn/size`` FFN
    columns, ``n_experts/size`` experts and, where ``vocab`` divides, a
    vocab shard of the embedding and head (``parallel/sharding.py``). The
    model code sums the row-parallel outputs over ``group``
    (``parallel/comm.py``); ``rank`` is this rank's index in the group and
    ``src`` the global rank of index 0, which samples."""
    group: object
    rank: int
    size: int
    vocab: int
    src: int = 0


class _TLS(threading.local):
    def __init__(self):
        self.int8: list = []
        self.sp: list = []
        self.tp: list = []


_tls = _TLS()


@contextlib.contextmanager
def int8_scope(policy: Optional[Int8Policy]):
    """Pushing ``None`` explicitly disables int8 inside the scope."""
    _tls.int8.append(policy)
    try:
        yield
    finally:
        _tls.int8.pop()


def current_int8() -> Optional[Int8Policy]:
    return _tls.int8[-1] if _tls.int8 else None


@contextlib.contextmanager
def sp_scope(policy: Optional[SPPolicy]):
    _tls.sp.append(policy)
    try:
        yield
    finally:
        _tls.sp.pop()


def current_sp() -> Optional[SPPolicy]:
    return _tls.sp[-1] if _tls.sp else None


@contextlib.contextmanager
def tp_scope(policy: Optional[TPPolicy]):
    _tls.tp.append(policy)
    try:
        yield
    finally:
        _tls.tp.pop()


def current_tp() -> Optional[TPPolicy]:
    return _tls.tp[-1] if _tls.tp else None
