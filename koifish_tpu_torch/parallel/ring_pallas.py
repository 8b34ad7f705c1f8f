"""The kernel ring's entry on global tensors (the JAX package's
``parallel/ring_pallas.py``).

``ring_attention_pallas_sharded(mesh, axis)`` takes global [B, T, H, D]
q, k, v with T sharded over ``axis`` and runs the ring of row 13's kernel
(``ops/kernels/ring_attn.py``) when the axis has more than one rank: on
CUDA chunks the kernel ring, on CPU chunks its plain version. The ranks on
q's device write their rows of the global output in place; only the rows
of ranks on another device are gathered. One rank runs the plain ring
(``parallel/ring_attention.py``), as in JAX.

On a ``ProcessMesh`` each rank is a process that passes its own chunk, as
each device of the JAX ``shard_map`` holds its own, and the kernel ring
runs rank by rank (``ring_attn.ring_attention_rank``), its chunks moving
between processes (``ring_attn.ProcessTransport``).

The JAX package also sends a chunk that does not fit the TPU's VMEM
(``fits_vmem``) to the ``ppermute`` ring. The port's chunks, slots and
state live in device memory, so its routing has no such guard;
``fits_vmem`` is kept for parity (ROADMAP.md queue 3).
"""
from __future__ import annotations

import torch

from koifish_tpu_torch.ops.kernels import ring_attn
from koifish_tpu_torch.parallel.ring_attention import (_is_process_mesh,
                                                       ring_attention_rank,
                                                       ring_attention_sharded,
                                                       shard_seq)

_VMEM_BUDGET = 100 * 1024 * 1024


def fits_vmem(b: int, tl: int, hq: int, hkv: int, d: int) -> bool:
    """Whether a TPU chunk fits the JAX kernel's VMEM budget."""
    acc = b * tl * hq * d * (4 + 4 + 2)        # acc_o f32 + o/q bf16-ish
    comm = 4 * b * tl * hkv * d * 2            # 2 slots x (k, v) bf16
    return acc + comm + 2 * b * hq * tl * 4 < _VMEM_BUDGET


def ring_attention_pallas_sharded(mesh, axis_name: str = "tp"):
    """(q, k, v) on GLOBAL [B, T, H, D] tensors, T sharded over
    ``axis_name`` -> out [B, T, Hq, D] in q's dtype on q's device: the
    kernel ring with more than one rank, else the plain ring. On a
    ``ProcessMesh``: (q, k, v) are this rank's chunks [B, Tl, H, D] and the
    result its output chunk."""
    if _is_process_mesh(mesh):
        ranks, index = mesh.ranks(axis_name), mesh.index(axis_name)

        def fn_process(q, k, v):
            if len(ranks) == 1:
                return ring_attention_rank(q, k, v, ranks, index)
            tr = ring_attn.ProcessTransport(ranks, index, q.device,
                                            tuple(k.shape))
            return ring_attn.ring_attention_rank(q, k, v, tr)
        return fn_process
    devices = mesh.axis_devices(axis_name)
    n = len(devices)

    def fn(q, k, v):
        if n == 1:
            return ring_attention_sharded(mesh, axis_name)(q, k, v)
        qs, ks, vs = (shard_seq(x, devices) for x in (q, k, v))
        here = ring_attn._key(q.device)
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        rows = list(out.chunk(n, dim=1))
        res = ring_attn.ring_attention(
            qs, ks, vs, outs=[o if ring_attn._key(x.device) == here else None
                              for o, x in zip(rows, qs)])
        for o, x in zip(rows, res):           # ranks on another device
            if x is not o:
                o.copy_(x)
        return out

    return fn

