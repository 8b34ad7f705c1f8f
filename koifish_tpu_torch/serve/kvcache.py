"""Ring-buffer KV cache with StreamingLLM attention sinks + INT8/INT4/QJL KV.

The layout and slot policy of the JAX package's ``serve/kvcache.py``:
head-major ``[L, B, H, S, D]`` buffers, per-(position, head) f32 scales,
INT4 packed two codes per byte along D (byte i = element i low nibble,
element i + D/2 high nibble). A QJL cache keeps each key as the signs of
its JL sketch (m = ``QJL_SKETCH_RATIO``·D bits packed to uint8) with the
key's norm in ``k_scale``, and INT8 values (``ops/qjl.py``). Positions
``0..sinks-1`` are pinned; later
positions map to ``sinks + (pos - sinks) % (size - sinks)``. Keys are
stored RoPE'd at their absolute position.

Unlike the JAX package, writes update the cache buffers in place (the JAX
caller donates the cache, so the observable behaviour is the same). The
one-token write at per-lane slots (``ring_write``, ``write_token``) goes
through the slot-write kernel (``ops/kernels/slotwrite.py``); the decode
step writes quantized caches inside its attention launch
(``serve/layered.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from koifish_tpu_torch.dtypes import QFormat
from koifish_tpu_torch.ops.kernels.decode_attn import quant_kv, unpack_int4
from koifish_tpu_torch.ops.kernels.slotwrite import slot_write_many
from koifish_tpu_torch.ops.qjl import qjl_encode_keys, qjl_projection
from koifish_tpu_torch.utils.device import resolve_device

_unpack_int4 = unpack_int4

QJL_SKETCH_RATIO = 2   # sketch dim m = ratio * head_dim (QJL accuracy knob)
QJL_SEED = 20260713    # fixed projection seed (XI_CARD mask_seed default)


@dataclasses.dataclass
class KVCache:
    """Per-model cache: leading axis = layer. ``pos`` is the global position
    counter per sequence (monotonic, may exceed ``size``)."""

    k: torch.Tensor                      # [L,B,H,S,D] bf16 — or int8 codes
    v: torch.Tensor                      # [L,B,H,S,D]
    k_scale: Optional[torch.Tensor]      # [L,B,H,S] f32 (quantized KV only)
    v_scale: Optional[torch.Tensor]
    pos: torch.Tensor                    # [B] int32
    fmt: QFormat = QFormat.BF16
    sinks: int = 2

    @property
    def size(self) -> int:
        return self.k.shape[3]

    @property
    def n_layers(self) -> int:
        return self.k.shape[0]


def _buffers(kshape, vshape, fmt: QFormat, dev):
    """(k, v, k_scale, v_scale) zero buffers of one cache format."""
    if fmt is QFormat.BF16:
        return (torch.zeros(kshape, dtype=torch.bfloat16, device=dev),
                torch.zeros(vshape, dtype=torch.bfloat16, device=dev),
                None, None)
    if fmt is QFormat.INT8:
        k = torch.zeros(kshape, dtype=torch.int8, device=dev)
        v = torch.zeros(vshape, dtype=torch.int8, device=dev)
    elif fmt is QFormat.INT4:
        if kshape[-1] % 2 or vshape[-1] % 2:
            raise ValueError(f"INT4 KV needs even head dims, got "
                             f"{kshape[-1]}/{vshape[-1]}")
        k = torch.zeros(kshape[:-1] + (kshape[-1] // 2,), dtype=torch.uint8,
                        device=dev)
        v = torch.zeros(vshape[:-1] + (vshape[-1] // 2,), dtype=torch.uint8,
                        device=dev)
    elif fmt is QFormat.QJL:
        # keys: sign bits of the JL sketch + per-key norms in k_scale;
        # values INT8 (ops/qjl.py)
        m = QJL_SKETCH_RATIO * kshape[-1]
        k = torch.zeros(kshape[:-1] + (m // 8,), dtype=torch.uint8,
                        device=dev)
        v = torch.zeros(vshape, dtype=torch.int8, device=dev)
    else:
        raise ValueError(f"unsupported KV format {fmt}")
    return (k, v, torch.zeros(kshape[:-1], dtype=torch.float32, device=dev),
            torch.zeros(vshape[:-1], dtype=torch.float32, device=dev))


def init_cache(n_layers: int, batch: int, size: int, n_kv_head: int,
               head_dim: int, fmt: QFormat = QFormat.BF16, sinks: int = 2,
               v_head_dim: int = 0, device=None) -> KVCache:
    dev = resolve_device(device)
    vd = v_head_dim or head_dim
    k, v, ks, vs = _buffers((n_layers, batch, n_kv_head, size, head_dim),
                            (n_layers, batch, n_kv_head, size, vd), fmt, dev)
    return KVCache(k=k, v=v, k_scale=ks, v_scale=vs,
                   pos=torch.zeros((batch,), dtype=torch.int32, device=dev),
                   fmt=fmt, sinks=sinks)


def cache_for(card, batch: int, size: int, fmt: QFormat = QFormat.BF16,
              sinks: int = 2, layered: bool = False, device=None):
    """Cache sized from a ModelCard (an MLA card's V rows are
    ``v_head_dim`` wide). ``layered=True`` builds the per-layer form
    directly (``serve/layered.LayeredKVCache``)."""
    vd = card.v_head_dim if card.attn == "mla" else 0
    if layered:
        from koifish_tpu_torch.serve.layered import init_layered_cache
        return init_layered_cache(card.n_layer, batch, size, card.n_kv_head,
                                  card.head_dim, fmt=fmt, sinks=sinks,
                                  v_head_dim=vd, device=device)
    return init_cache(card.n_layer, batch, size, card.n_kv_head,
                      card.head_dim, fmt=fmt, sinks=sinks, v_head_dim=vd,
                      device=device)


def ring_slot(pos: torch.Tensor, size: int, sinks: int) -> torch.Tensor:
    """Map absolute position -> cache slot (sinks pinned, rest ring)."""
    wrapped = sinks + torch.remainder(pos - sinks, size - sinks)
    return torch.where(pos < size, pos, wrapped).to(torch.int32)


def _quant_kv(x: torch.Tensor, fmt: QFormat
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) absmax quantization of a K/V vector [..., D]
    (``ops/kernels/decode_attn.quant_kv``, the one definition, which the
    decode step's fused write matches on the card)."""
    return quant_kv(x, fmt)


def ring_write(buf: torch.Tensor, val: torch.Tensor,
               slots: torch.Tensor) -> torch.Tensor:
    """One-token ring write ``buf [B, H, S, ...] <- val [B, H, ...]`` at
    per-lane ``slots [B]``, in place through the slot-write kernel (the
    masked select of the JAX package on a CPU tensor). Returns ``buf``."""
    slot_write_many([(buf, val)], slots)
    return buf


def qjl_keys(k_new: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keys [..., D] -> (packed sketch signs, norms) under the cache's
    fixed projection (m = ``QJL_SKETCH_RATIO``·D, seed ``QJL_SEED``)."""
    d = k_new.shape[-1]
    return qjl_encode_keys(k_new, qjl_projection(
        d, QJL_SKETCH_RATIO * d, QJL_SEED, device=k_new.device))


def _quant_pair(k_new, v_new, fmt: QFormat):
    """(kq, k_scale, vq, v_scale) of new K/V in a quantized cache format:
    codes and per-(token, head) scales; a QJL cache's key sketch and norm
    with INT8 values."""
    if fmt is QFormat.QJL:
        kq, ksc = qjl_keys(k_new)
        vq, vsc = _quant_kv(v_new, QFormat.INT8)
    elif fmt in (QFormat.INT8, QFormat.INT4):
        kq, ksc = _quant_kv(k_new, fmt)
        vq, vsc = _quant_kv(v_new, fmt)
    else:
        raise ValueError(f"unsupported KV format {fmt}")
    return kq, ksc, vq, vsc


def _token_pairs(k_l, v_l, ks_l, vs_l, fmt: QFormat, k_new, v_new):
    """(buffer, value) pairs of one token's K/V write in a cache format:
    quantized formats write codes and per-(token, head) scales."""
    if fmt is QFormat.BF16:
        return [(k_l, k_new), (v_l, v_new)]
    kq, ksc, vq, vsc = _quant_pair(k_new, v_new, fmt)
    return [(k_l, kq), (v_l, vq), (ks_l, ksc), (vs_l, vsc)]


def write_token(cache, layer: int, k_new: torch.Tensor, v_new: torch.Tensor,
                rope_inv_freq: Optional[torch.Tensor] = None):
    """Write one token's K/V ([B, H, D]) of ``layer`` at each lane's own
    position, in place (one slot-write launch for the K and V codes and
    their scales). Does NOT advance ``pos``.
    ``rope_inv_freq`` turns on the StreamingLLM sink re-rope for rows past
    the window (``rotate_sink_keys_layer``). Accepts ``KVCache`` or
    ``LayeredKVCache``; returns the cache."""
    slots = ring_slot(cache.pos, cache.size, cache.sinks)      # [B]
    quant = cache.fmt is not QFormat.BF16
    ks_l = cache.k_scale[layer] if quant else None
    vs_l = cache.v_scale[layer] if quant else None
    if rope_inv_freq is not None:
        rotate_sink_keys_layer(cache.k[layer], ks_l, cache.fmt, cache.sinks,
                               cache.pos >= cache.size, rope_inv_freq)
    slot_write_many(_token_pairs(cache.k[layer], cache.v[layer], ks_l, vs_l,
                                 cache.fmt, k_new, v_new), slots)
    return cache


def advance(cache, n):
    """Advance the position counter by ``n`` (writes never move it)."""
    return dataclasses.replace(cache, pos=cache.pos + n)


def _rotate_half_step(kf: torch.Tensor, inv_freq: torch.Tensor,
                      steps: float = 1.0) -> torch.Tensor:
    """Rotate roped keys forward by ``steps`` rope positions (rotate-half)."""
    half = kf.shape[-1] // 2
    ang = inv_freq * steps
    c, s = torch.cos(ang), torch.sin(ang)
    x1, x2 = kf[..., :half], kf[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def rotate_sink_keys_layer(k_l: torch.Tensor, k_scale_l, fmt: QFormat,
                           sinks: int, mask: torch.Tensor,
                           inv_freq: Optional[torch.Tensor]):
    """StreamingLLM sink re-rope: once the ring wraps, rotate the pinned
    sink keys forward ONE rope position per generated token, in rows where
    ``mask`` [B] is set. Quantized caches rotate through
    dequant -> rotate -> requant. Updates ``k_l`` / ``k_scale_l`` in place
    and returns them. The JAX package skips the rewrite with a ``lax.cond``
    on ``any(mask)``; here the caller only asks for it in the streaming
    regime and the rows are selected with ``torch.where`` (no host sync).
    QJL keys are sign sketches, which a rope rotation cannot act on: they
    keep their absolute angles past the window (as in the JAX package)."""
    if sinks <= 0 or fmt is QFormat.QJL or inv_freq is None:
        return k_l, k_scale_l
    m = mask[:, None, None, None]
    sl = k_l[:, :, :sinks]                               # [B, H, sinks, Dc]
    if fmt is QFormat.BF16:
        rot = _rotate_half_step(sl.to(torch.float32), inv_freq)
        k_l[:, :, :sinks] = torch.where(m, rot.to(k_l.dtype), sl)
        return k_l, k_scale_l
    ssc = k_scale_l[:, :, :sinks]                        # [B, H, sinks]
    codes = unpack_int4(sl) if fmt is QFormat.INT4 else sl
    kf = codes.to(torch.float32) * ssc[..., None]
    q, sc = _quant_kv(_rotate_half_step(kf, inv_freq), fmt)
    new_k = torch.where(m, q, sl)
    new_s = torch.where(mask[:, None, None], sc, ssc)
    k_l[:, :, :sinks] = new_k
    k_scale_l[:, :, :sinks] = new_s
    return k_l, k_scale_l


def write_prefill(cache, layer: int, k_new: torch.Tensor,
                  v_new: torch.Tensor, start: int):
    """Write a [B, T, H, D] prefill chunk at absolute position ``start``
    (a host int, the same for all sequences; start + T <= size). Does NOT
    advance ``pos``. Accepts ``KVCache`` or ``LayeredKVCache``; the chosen
    layer's buffers are written in place."""
    T = k_new.shape[1]

    def upd(buf, val):
        # [B, T, H, ...] -> head-major [B, H, T, ...] into slots start..+T
        buf[layer][:, :, start:start + T] = val.transpose(1, 2).to(
            buf[layer].dtype)

    if cache.fmt is QFormat.BF16:
        upd(cache.k, k_new)
        upd(cache.v, v_new)
    else:
        kq, ksc, vq, vsc = _quant_pair(k_new, v_new, cache.fmt)
        upd(cache.k, kq)
        upd(cache.v, vq)
        upd(cache.k_scale, ksc)
        upd(cache.v_scale, vsc)
    return cache


def read_layer(cache, layer: int, extra: int = 0
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(k, v, valid_mask) for a layer: k/v [B,S,H,D] bf16, mask [B,S].
    ``extra`` counts tokens written this step but not yet in ``pos``.
    Quantized caches are dequantized here (plain path); QJL keys cannot
    be (``ops/qjl.qjl_decode_attention`` reads them)."""
    if cache.fmt is QFormat.QJL:
        raise ValueError("QJL keys are sign sketches — not reconstructible; "
                         "use ops.qjl.qjl_decode_attention")
    S = cache.size
    valid = (torch.arange(S, device=cache.pos.device)[None, :]
             < torch.clamp(cache.pos + extra, max=S)[:, None])
    k, v = cache.k[layer], cache.v[layer]          # [B, H, S, D]
    if cache.fmt is QFormat.INT4:
        k, v = unpack_int4(k), unpack_int4(v)
    if cache.fmt is not QFormat.BF16:
        k = (k.to(torch.float32) * cache.k_scale[layer][..., None]
             ).to(torch.bfloat16)
        v = (v.to(torch.float32) * cache.v_scale[layer][..., None]
             ).to(torch.bfloat16)
    return k.transpose(1, 2), v.transpose(1, 2), valid
