"""Ring attention: sequence parallelism over a mesh axis (the JAX package's
``parallel/ring_attention.py``).

The sequence axis is cut into one chunk a rank of the axis. Each step
every rank attends its q chunk to the K/V chunk in hand (``_local_block``:
causal, f32, GQA by a head-group reshape), merges the result into its
online-softmax state (o, m, l) in f32, and passes the chunk to its right
neighbour: at step s rank ``my`` holds the chunk of rank
``(my - s) % sp``. This is the plain ring, differentiable through
autograd, which the sequence-parallel training path runs
(``ops/attention.py``); like the JAX ring it computes every step, the
chunks wholly above the diagonal included (their weight is exactly 0
once step 0, the diagonal, has made m finite). The forward-only kernel
ring is ``ops/kernels/ring_attn.py``.

On a ``parallel/mesh.Mesh`` one controller drives the ranks, as one JAX
program drives the devices of a ``shard_map``: rank r's chunks lie on its
mesh device and each pass is a copy to the neighbour's device
(``Tensor.to``, nothing where ranks share a device). The ranks run one
after the other on each device's current stream.

On a ``ProcessMesh`` each rank is a process that holds its own chunks
(``ring_attention_rank``): the same steps and merges in the same order,
each pass the JAX ring's ``ppermute`` (``comm.permute``, K and V as one
tensor; its backward the reverse pass). The training path keeps T whole
outside attention, as the JAX batch spec does, so each rank takes its
chunk of the whole q, k, v with ``comm.split_to`` (whose backward
all-gathers the chunks' gradients) and the output is joined with
``comm.gather_from`` (whose backward takes the rank's slice): every rank
of the axis then holds the one-rank gradients, and none is summed over
``sp``.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from koifish_tpu_torch.parallel import comm

_NEG_INF = -1e30


def _local_block(q, k, v, q_off: int, k_off: int, scale: float):
    """Blockwise causal attention piece: (unnormalized out, m, l).
    q [B, Tq, Hq, D] at absolute offset q_off; k/v [B, Tk, Hkv, D] at
    k_off. out [B, Tq, Hq, D], m and l [B, Hq, Tq], all f32."""
    b, tq, hq, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, tq, hkv, g, d)
    s = torch.einsum("bthgd,bshd->bhgts", qg.to(torch.float32),
                     k.to(torch.float32)) * scale
    qpos = q_off + torch.arange(tq, device=q.device)
    kpos = k_off + torch.arange(tk, device=q.device)
    mask = kpos[None, :] <= qpos[:, None]                  # [tq, tk]
    s = torch.where(mask, s, _NEG_INF)
    m = s.amax(-1)                                         # [b, h, g, tq]
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    o = torch.einsum("bhgts,bshd->bthgd", p, v.to(torch.float32))
    return (o.reshape(b, tq, hq, d), m.reshape(b, hq, tq),
            l.reshape(b, hq, tq))


def _merge(acc, o, m, l):
    """(o_acc, m_acc, l_acc) with a block's (o, m, l) folded in (f32)."""
    o_acc, m_acc, l_acc = acc
    m_new = torch.maximum(m_acc, m)
    a_old = torch.exp(m_acc - m_new)
    a_new = torch.exp(m - m_new)
    return (o_acc * a_old.transpose(1, 2)[..., None]
            + o * a_new.transpose(1, 2)[..., None],
            m_new, l_acc * a_old + l * a_new)


def _start(q):
    b, tl, hq, d = q.shape
    return (torch.zeros((b, tl, hq, d), dtype=torch.float32, device=q.device),
            torch.full((b, hq, tl), _NEG_INF, dtype=torch.float32,
                       device=q.device),
            torch.zeros((b, hq, tl), dtype=torch.float32, device=q.device))


def _finish(acc, dtype):
    o_acc, _, l_acc = acc
    return (o_acc / l_acc.transpose(1, 2)[..., None].clamp_min(1e-30)
            ).to(dtype)


def ring_attention(qs: List[torch.Tensor], ks: List[torch.Tensor],
                   vs: List[torch.Tensor], scale: Optional[float] = None
                   ) -> List[torch.Tensor]:
    """The ring over the ranks' local chunks: ``qs[r]`` [B, Tl, Hq, D] and
    ``ks[r]``/``vs[r]`` [B, Tl, Hkv, D] on rank r's device (rank r holds
    positions r·Tl..). Returns each rank's output chunk in q's dtype."""
    sp = len(qs)
    tl, d = qs[0].shape[1], qs[0].shape[3]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    devs = [q.device for q in qs]
    acc = [_start(q) for q in qs]
    kc, vc = list(ks), list(vs)
    for step in range(sp):
        for my in range(sp):
            src = (my - step) % sp                  # whose chunk we hold
            acc[my] = _merge(acc[my], *_local_block(
                qs[my], kc[my], vc[my], my * tl, src * tl, scale))
        if step + 1 < sp:                           # rank r -> rank r + 1
            kc = [kc[(r - 1) % sp].to(devs[r]) for r in range(sp)]
            vc = [vc[(r - 1) % sp].to(devs[r]) for r in range(sp)]
    return [_finish(acc[r], qs[r].dtype) for r in range(sp)]


def ring_attention_rank(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        ranks: List[int], index: int,
                        scale: Optional[float] = None) -> torch.Tensor:
    """One process's part of the ring: this rank's q [B, Tl, Hq, D] and
    k/v [B, Tl, Hkv, D] chunks (positions index·Tl..), the axis's global
    ``ranks`` in ring order; returns its output chunk in q's dtype. The
    steps and merges of ``ring_attention``'s rank ``index``, so given the
    same chunks the output and gradients are the same bit for bit."""
    sp = len(ranks)
    tl, d = q.shape[1], q.shape[3]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    acc = _start(q)
    kv = torch.stack((k, v)) if sp > 1 else None
    kc, vc = k, v
    for step in range(sp):
        src = (index - step) % sp
        acc = _merge(acc, *_local_block(q, kc, vc, index * tl, src * tl,
                                        scale))
        if step + 1 < sp:                           # to rank index + 1
            kv = comm.permute(kv, ranks, index)
            kc, vc = kv.unbind(0)
    return _finish(acc, q.dtype)


def shard_seq(x: torch.Tensor, devices) -> List[torch.Tensor]:
    """A global [B, T, ...] tensor cut into len(devices) equal chunks of T,
    chunk r moved to ``devices[r]`` (a view where it already lies there)."""
    n = len(devices)
    if x.shape[1] % n:
        raise ValueError(f"sequence length {x.shape[1]} is not a multiple "
                         f"of the {n} ranks of the axis")
    tl = x.shape[1] // n
    return [x[:, r * tl:(r + 1) * tl].to(devices[r]) for r in range(n)]


def gather_seq(chunks: List[torch.Tensor], device) -> torch.Tensor:
    """The ranks' chunks joined along T on ``device``."""
    return torch.cat([c.to(device) for c in chunks], dim=1)


def _is_process_mesh(mesh) -> bool:
    from koifish_tpu_torch.parallel.mesh import ProcessMesh
    return isinstance(mesh, ProcessMesh)


def ring_attention_sharded(mesh, axis_name: str = "tp",
                           scale: Optional[float] = None):
    """A function (q, k, v) -> out on GLOBAL [B, T, H, D] tensors with T
    sharded over ``axis_name`` of ``mesh``. On a ``parallel/mesh.Mesh``
    each rank of the axis takes its chunk on its device and the output is
    joined on q's device; on a ``ProcessMesh`` every rank of the axis holds
    the whole q, k, v, takes its chunk (``comm.split_to``), runs its part
    of the ring and gathers every rank's output (``comm.gather_from``)."""
    if _is_process_mesh(mesh):
        group, ranks = mesh.group(axis_name), mesh.ranks(axis_name)
        index = mesh.index(axis_name)

        def fn_process(q, k, v):
            if len(ranks) > 1 and q.shape[1] % len(ranks):
                raise ValueError(f"sequence length {q.shape[1]} is not a "
                                 f"multiple of the {len(ranks)} ranks of "
                                 f"the axis")
            ql, kl, vl = (comm.split_to(x, group, 1) for x in (q, k, v))
            out = ring_attention_rank(ql, kl, vl, ranks, index, scale)
            return comm.gather_from(out, group, 1)
        return fn_process
    devices = mesh.axis_devices(axis_name)

    def fn(q, k, v):
        outs = ring_attention(shard_seq(q, devices), shard_seq(k, devices),
                              shard_seq(v, devices), scale)
        return gather_seq(outs, q.device)

    return fn
