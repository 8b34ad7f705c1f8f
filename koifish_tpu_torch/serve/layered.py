"""Per-layer decode cache and the decode step over it.

The JAX package keeps the decode cache as a tuple of per-layer arrays so
XLA can update each one in place; here each layer's buffers are plain
tensors that the step writes in place. On a quantized (INT8 or INT4)
cache the one-token write and the attention are one launch a layer
(``ops/kernels/decode_attn.decode_attention_write``: the new K/V quantized,
its codes and scales written at each lane's slot, then attention over the
updated cache), whether every lane sits at the same position or not, as
the reference's CUDA decode writes the KV slot in place (Pipe.hpp:160). A
BF16 cache keeps the two steps of ``layered.py:133-142`` of the JAX
package: a uniform batch writes its one slot with an in-place
``index_copy_``; per-lane slots (the continuous batcher's pool, and
``KVCache`` views for ``engine.decode_step``) go through the slot-write
kernel. A QJL cache writes the same way (key sketch, norm, INT8 value and
its scale) and attends with the estimated scores of
``ops/qjl.qjl_decode_attention``, plain PyTorch as in the JAX package
(``layered.py:205-222``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from koifish_tpu_torch.config import ModelCard
from koifish_tpu_torch.dtypes import QFormat
from koifish_tpu_torch.models.guppy import inject_rows
from koifish_tpu_torch.models.transformer import (
    Params, _linear_l, _norm, gather_embed, lm_head, mlp, qkv_project)
from koifish_tpu_torch.ops.attention import decode_attention
from koifish_tpu_torch.ops.kernels.decode_attn import decode_attention_write
from koifish_tpu_torch.ops.kernels.slotwrite import slot_write_many
from koifish_tpu_torch.ops.qjl import qjl_decode_attention, qjl_projection
from koifish_tpu_torch.ops.rope import rope_cos_sin_at, rope_inv_freq
from koifish_tpu_torch.serve import kvcache as kvc
from koifish_tpu_torch.serve.kvcache import KVCache
from koifish_tpu_torch.serve.stacked import unstack_layers


@dataclasses.dataclass
class LayeredKVCache:
    """KVCache split into per-layer tensors (decode representation)."""
    k: Tuple[torch.Tensor, ...]                   # L x [B, H, S, D(|/2)]
    v: Tuple[torch.Tensor, ...]
    k_scale: Optional[Tuple[torch.Tensor, ...]]   # L x [B, H, S]
    v_scale: Optional[Tuple[torch.Tensor, ...]]
    pos: torch.Tensor                             # [B] int32
    fmt: QFormat = QFormat.BF16
    sinks: int = 2
    # True when every lane shares the same position (plain generate)
    uniform: bool = True

    @property
    def size(self) -> int:
        return self.k[0].shape[2]

    @property
    def n_layers(self) -> int:
        return len(self.k)


def init_layered_cache(n_layers: int, batch: int, size: int, n_kv_head: int,
                       head_dim: int, fmt: QFormat = QFormat.BF16,
                       sinks: int = 2, v_head_dim: int = 0,
                       uniform: bool = True, device=None) -> LayeredKVCache:
    """Build the per-layer cache directly (no stacked [L, ...] copy)."""
    layers = [kvc.init_cache(1, batch, size, n_kv_head, head_dim, fmt, sinks,
                             v_head_dim, device=device)
              for _ in range(n_layers)]
    quant = fmt is not QFormat.BF16
    return LayeredKVCache(
        k=tuple(c.k[0] for c in layers), v=tuple(c.v[0] for c in layers),
        k_scale=tuple(c.k_scale[0] for c in layers) if quant else None,
        v_scale=tuple(c.v_scale[0] for c in layers) if quant else None,
        pos=layers[0].pos, fmt=fmt, sinks=sinks, uniform=uniform)


def split_cache(cache: KVCache, uniform: bool = True) -> LayeredKVCache:
    """[L, ...] cache -> per-layer views (no copy: writes reach both)."""
    L = cache.n_layers
    tup = (lambda a: tuple(a[layer] for layer in range(L))
           if a is not None else None)
    return LayeredKVCache(k=tup(cache.k), v=tup(cache.v),
                          k_scale=tup(cache.k_scale),
                          v_scale=tup(cache.v_scale), pos=cache.pos,
                          fmt=cache.fmt, sinks=cache.sinks, uniform=uniform)


def join_cache(lc: LayeredKVCache) -> KVCache:
    stk = lambda t: torch.stack(t) if t is not None else None
    return KVCache(k=stk(lc.k), v=stk(lc.v), k_scale=stk(lc.k_scale),
                   v_scale=stk(lc.v_scale), pos=lc.pos, fmt=lc.fmt,
                   sinks=lc.sinks)


def _write(pairs, slots: torch.Tensor, uniform: bool) -> None:
    """One-token write of each (buf [B, H, S, ...], val [B, H, ...]) pair at
    per-lane ``slots`` [B], in place."""
    if not uniform:
        slot_write_many(pairs, slots)
        return
    for buf, val in pairs:
        # every lane shares the slot: one in-place index write of the slot
        buf.index_copy_(2, slots[:1].long(), val.to(buf.dtype).unsqueeze(2))


def decode_step_layered(card: ModelCard, params: Params, token: torch.Tensor,
                        lc: LayeredKVCache, streaming: bool = True,
                        logits_dtype=torch.bfloat16
                        ) -> Tuple[torch.Tensor, LayeredKVCache]:
    """One decode step over per-layer cache tensors: token [B] -> logits
    [B, V] in ``logits_dtype`` (bf16: the sampler upcasts after its top-k
    cut; ``engine.decode_step`` takes f32). Params may hold a per-layer list
    or layer-stacked leaves (``serve/stacked.py``), which are taken apart
    here. ``streaming=False`` skips the per-step sink re-rope — sound
    whenever no row's pos can reach the window in this step."""
    params = unstack_layers(card, inject_rows(card, params, None))
    B = token.shape[0]
    dev = token.device
    # unclamped positions with direct rope, so angles keep advancing past
    # max_pos; inv_freq drives the per-step sink re-rope. An MLA card ropes
    # inside mla_qkv at clamped table positions, with no sink re-rope
    # (streaming past the window is the standard attention's only)
    positions = lc.pos[:, None]
    cos = sin = inv_freq = rope_pos = None
    if card.attn == "mla":
        rope_pos = torch.clamp(positions, max=card.max_pos - 1)
    elif card.pos_embed == "rope":
        scaling = card.rope_scaling_dict()
        cos, sin = rope_cos_sin_at(card.head_dim, positions, card.rope_theta,
                                   scaling)
        inv_freq, _ = rope_inv_freq(card.head_dim, card.rope_theta, scaling,
                                    dev)
    stream_rows = lc.pos >= lc.size                         # [B]
    x = gather_embed(params["wte"], token[:, None])
    if card.pos_embed == "learned":
        wpe_pos = torch.clamp(positions[:, 0], max=card.max_pos - 1).long()
        x = x + params["wpe"][wpe_pos][:, None]

    slots = kvc.ring_slot(lc.pos, lc.size, lc.sinks)        # [B]
    lengths = torch.clamp(lc.pos + 1, max=lc.size).to(torch.int32)
    quant = lc.fmt is not QFormat.BF16
    att_scale = 1.0 / (card.head_dim ** 0.5)

    for li, lp in enumerate(params["layers"]):
        kl, vl = lc.k[li], lc.v[li]
        ksl = lc.k_scale[li] if quant else None
        if streaming and inv_freq is not None:
            kvc.rotate_sink_keys_layer(kl, ksl, lc.fmt, lc.sinks,
                                       stream_rows, inv_freq)
        h = _norm(card, x, lp["ln1"], lp.get("ln1_b"))
        q, k, v = qkv_project(card, lp, h, cos, sin, rope_pos)
        if lc.fmt is QFormat.QJL:
            vsl = lc.v_scale[li]
            _write(kvc._token_pairs(kl, vl, ksl, vsl, lc.fmt, k[:, 0],
                                    v[:, 0]), slots, lc.uniform)
            vlf = (vl.to(torch.float32) * vsl[..., None]).to(torch.bfloat16)
            valid = (torch.arange(lc.size, device=dev)[None, :]
                     < lengths[:, None])
            proj = qjl_projection(card.head_dim,
                                  kvc.QJL_SKETCH_RATIO * card.head_dim,
                                  kvc.QJL_SEED, device=dev)
            a = qjl_decode_attention(q[:, 0], kl, ksl, vlf, valid, proj,
                                     att_scale)
        elif quant:
            # one launch: quantize and write the new K/V, then attend over
            # the INT8 / packed-INT4 codes
            a = decode_attention_write(q[:, 0], k[:, 0], v[:, 0], kl, vl,
                                       ksl, lc.v_scale[li], slots, lengths,
                                       att_scale)
        else:
            _write(kvc._token_pairs(kl, vl, None, None, lc.fmt, k[:, 0],
                                    v[:, 0]), slots, lc.uniform)
            valid = (torch.arange(lc.size, device=dev)[None, :]
                     < lengths[:, None])
            a = decode_attention(q[:, 0], kl.transpose(1, 2),
                                 vl.transpose(1, 2), valid)
        x = x + _linear_l(a.reshape(B, 1, -1), lp, "o")
        h = _norm(card, x, lp["ln2"], lp.get("ln2_b"))
        x = x + mlp(card, lp, h)

    x = _norm(card, x, params["ln_f"], params.get("ln_f_b"))
    logits = lm_head(card, params, x, out_dtype=logits_dtype)[:, 0]
    return logits, dataclasses.replace(lc, pos=lc.pos + 1)
