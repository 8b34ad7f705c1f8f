"""Overlap of the data-parallel gradient collectives with the backward (the
port's counterpart of the JAX package's ``parallel/overlap.py``, where
XLA's latency-hiding scheduler hides the collectives once the compiler
options are on).

``GradReducer`` sums each trained leaf's gradient over the ``dp`` group,
the leaves cut into buckets of about ``BUCKET_BYTES``: an all-reduce for
a leaf every rank keeps whole, a reduce-scatter for a leaf whose rank
keeps a part only (an FSDP shard, cut along ``fsdp_dims[i]``), so each
rank receives its shard of the sum and nothing more. ``arm`` hooks each
leaf, and a bucket's collective starts asynchronously as soon as autograd
has produced the last of its gradients, while the backward goes on with
the earlier layers; a bucket lands (is cut back into its leaves) as soon
as its collective has finished, and ``finish`` waits for the rest.
``reduce`` runs the same buckets after a finished backward, one at a time.
Both share one bucket plan over one leaf order and issue the same
collectives on the same flat buffers, so they give the same bits.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from koifish_tpu_torch.parallel import comm

BUCKET_BYTES = 32 << 20     # f32 bytes a bucket (PyTorch DDP's 25 MB order)


class GradReducer:
    """Sum the gradients of leaves ``idx`` over ``group``. ``fsdp_dims[i]``
    (optional): leaf i's rank keeps only its ``1/n`` of the sum along that
    dim, the part at its group rank."""

    def __init__(self, group, idx: List[int],
                 fsdp_dims: Optional[Dict[int, int]] = None,
                 bucket_bytes: int = BUCKET_BYTES):
        self.group = group
        self.fsdp_dims = fsdp_dims or {}
        self.bucket_bytes = bucket_bytes
        self.n = comm.group_size(group)
        self.rank = comm.group_rank(group)
        self.order = list(reversed(idx))      # the backward's rough order
        self.buckets: List[List[int]] = []
        self._hooks: list = []
        self._pending: list = []
        self._vals: Dict[int, torch.Tensor] = {}
        self._out: Dict[int, torch.Tensor] = {}

    def _plan(self, sizes: Dict[int, int]) -> None:
        """Buckets in backward order, all-reduced and reduce-scattered
        leaves in buckets of their own."""
        self.buckets = []
        for scatter in (False, True):
            cur, n = [], 0
            for i in self.order:
                if (i in self.fsdp_dims) != scatter:
                    continue
                if cur and n + 4 * sizes[i] > self.bucket_bytes:
                    self.buckets.append(cur)
                    cur, n = [], 0
                cur.append(i)
                n += 4 * sizes[i]
            if cur:
                self.buckets.append(cur)
        self._bucket_of = {i: b for b, bk in enumerate(self.buckets)
                           for i in bk}
        self._left = [len(b) for b in self.buckets]

    def _part(self, g: torch.Tensor, i: int, r: int) -> torch.Tensor:
        d = self.fsdp_dims[i]
        n = g.shape[d] // self.n
        return g.narrow(d, r * n, n)

    # -- one bucket -------------------------------------------------------

    def _start(self, b: int, async_op: bool):
        ids = self.buckets[b]
        vals = [self._vals.pop(i).to(torch.float32) for i in ids]
        if ids[0] in self.fsdp_dims:
            # rank-major: rank r's part of every leaf, then rank r + 1's
            ins = [torch.cat([self._part(v, i, r).reshape(-1)
                              for i, v in zip(ids, vals)])
                   for r in range(self.n)]
            flat = torch.empty_like(ins[0])
            work = dist.reduce_scatter(flat, ins, group=self.group,
                                       async_op=async_op)
            shapes = [self._part(v, i, self.rank).shape
                      for i, v in zip(ids, vals)]
        else:
            flat = torch.cat([v.reshape(-1) for v in vals])
            work = dist.all_reduce(flat, group=self.group, async_op=async_op)
            shapes = [v.shape for v in vals]
        self._pending.append((work, flat, ids, shapes))

    def _land(self, wait: bool) -> None:
        """Cut every finished bucket back into its leaves (every bucket
        with ``wait``)."""
        left = []
        for work, flat, ids, shapes in self._pending:
            if work is not None and not wait and not work.is_completed():
                left.append((work, flat, ids, shapes))
                continue
            if work is not None:
                work.wait()
            off = 0
            for i, shp in zip(ids, shapes):
                n = int(torch.Size(shp).numel())
                self._out[i] = flat[off:off + n].reshape(shp)
                off += n
        self._pending = left

    # -- after the backward ----------------------------------------------

    def reduce(self, grads: Dict[int, torch.Tensor]
               ) -> Dict[int, torch.Tensor]:
        """The summed gradients of a finished backward, bucket by bucket."""
        if self.group is None:
            return {i: g.to(torch.float32) for i, g in grads.items()}
        self._plan({i: grads[i].numel() for i in self.order})
        self._vals = dict(grads)
        self._out = {}
        for b in range(len(self.buckets)):
            self._start(b, async_op=False)
            self._land(wait=True)
        return self._out

    # -- during the backward ---------------------------------------------

    def arm(self, tensors: Dict[int, torch.Tensor],
            final: Callable[[int, torch.Tensor], torch.Tensor]) -> None:
        """Hook leaves ``tensors`` for the coming backward: when autograd
        hands leaf i its gradient g, ``final(i, g)`` is the value to sum
        (the micro-batch average); a complete bucket starts at once."""
        self._plan({i: tensors[i].numel() for i in self.order})
        self._vals, self._out, self._pending = {}, {}, []
        self._armed, self._final = tensors, final

        def hook(i):
            def fn(g):
                self._vals[i] = final(i, g)
                b = self._bucket_of[i]
                self._left[b] -= 1
                if self._left[b] == 0:
                    self._start(b, async_op=True)
                    self._land(wait=False)
            return fn
        self._hooks = [tensors[i].register_hook(hook(i)) for i in self.order]

    def finish(self) -> Dict[int, torch.Tensor]:
        """Wait for every bucket armed for the backward that just ended."""
        for h in self._hooks:
            h.remove()
        self._hooks = []
        # leaves the loss does not reach get no gradient: sum zeros
        for b, ids in enumerate(self.buckets):
            if self._left[b]:
                for i in ids:
                    if i not in self._vals:
                        self._vals[i] = self._final(
                            i, torch.zeros_like(self._armed[i]))
                self._left[b] = 0
                self._start(b, async_op=True)
        self._land(wait=True)
        return self._out
