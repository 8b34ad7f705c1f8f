"""QJL — Quantized Johnson-Lindenstrauss KV-cache quantization (keys); the
JAX package's ``ops/qjl.py`` (the reference's Q_JL research mode,
``CU_QJL_key``, src/Device/CUDA/kernel/quantizer.cu:844-1050).

Method (QJL, Zandieh et al. 2024): project each key with a fixed random
Gaussian matrix P [D, m], store only the SIGN of the projection (1 bit per
sketch dim) plus the key's L2 norm. The attention score is the unbiased
estimator

    <q, k> ~= ||k|| * sqrt(pi/2) * mean_i sign((Pk)_i) * (Pq)_i

Keys cost m/8 bytes + 4 norm bytes instead of 2D bytes (D = 128, m = 256:
36 B vs 256 B). Values stay INT8. Plain PyTorch on both devices, as the JAX
package's is ``jnp``.

The projection is the JAX package's ``jax.random.normal(PRNGKey(seed),
(D, m), float32)``, drawn here without JAX (``_jax_normal``): the threefry
bits and uniform of ``utils/prng.py`` over the flat element index (JAX's
partitionable bits, the default), then ``sqrt(2)·erfinv(u)`` through the
polynomial XLA lowers ``erf_inv`` to (Giles' single-precision one), its
products and sums fused as FMAs are. The uint32 bits and the uniforms equal
JAX's exactly; the normals lie within a few f32 ulps of JAX's (XLA's CPU
``log1p`` rounds differently), so a cache that one package wrote continues
in the other (``tests/test_torch_qjl_lowrank.py``).
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from koifish_tpu_torch.utils import prng

_SQRT_PI_OVER_2 = 1.2533141373155003

# Giles' erfinv for f32 (the constants XLA's ErfInv32 uses): w < 5 and
# w >= 5 branches, highest degree first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def jax_random_bits(seed: int, shape) -> np.ndarray:
    """``jax.random.bits(PRNGKey(seed), shape, uint32)``: the key is (hi,
    lo) of the seed (``utils/prng.random_bits``)."""
    return prng.random_bits(_key(seed), shape)


def jax_uniform(seed: int, shape) -> np.ndarray:
    """``jax.random.uniform(PRNGKey(seed), shape, float32, nextafter(-1,
    0), 1)``, the draw under ``jax.random.normal`` (``utils/prng.uniform``).
    Over this range the span rounds to 2 in f32, so the scale is exact and
    the fused and the unfused scale-and-shift round alike."""
    return prng.uniform(_key(seed), shape,
                        np.nextafter(np.float32(-1.0), np.float32(0.0)), 1.0)


def _key(seed: int) -> np.ndarray:
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                    dtype=np.uint32)


def _erfinv_f32(x: np.ndarray) -> np.ndarray:
    """XLA's f32 ``erf_inv``: w = -log1p(-x²), a degree-8 polynomial in
    w - 2.5 (w < 5) or sqrt(w) - 3, times x; each step ``c + p·w`` rounded
    once, as an FMA."""
    w = (-np.log1p(-(x * x).astype(np.float64))).astype(np.float32)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5),
                 np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    pick = lambda i: np.where(lt, np.float32(_ERFINV_LT5[i]),
                              np.float32(_ERFINV_GE5[i])).astype(np.float32)
    p = pick(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = (pick(i).astype(np.float64)
             + p.astype(np.float64) * w.astype(np.float64)).astype(np.float32)
    out = (p * x).astype(np.float32)
    return np.where(np.abs(x) == 1, x * np.float32(np.inf), out)


@functools.lru_cache(maxsize=8)
def _jax_normal(d: int, m: int, seed: int) -> np.ndarray:
    u = jax_uniform(seed, (d, m))
    return (np.float32(np.sqrt(2.0)) * _erfinv_f32(u)).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _projection_on(d: int, m: int, seed: int, device: str) -> torch.Tensor:
    return torch.from_numpy(_jax_normal(d, m, seed).copy()).to(device)


def qjl_projection(d: int, m: int, seed: int = 20260713,
                   device=None) -> torch.Tensor:
    """Fixed Gaussian JL matrix [D, m] f32 (seed default = XI_CARD
    mask_seed), the JAX package's ``jax.random.normal`` draw, on
    ``device`` (default the CPU); one shared tensor per device, which
    callers must not write."""
    return _projection_on(d, m, seed, str(torch.device(device or "cpu")))


def qjl_encode_keys(k: torch.Tensor, proj: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k [..., D] -> (sign bits packed [..., m//8] uint8, norms [...] f32);
    bit j of byte i is the sign of sketch dim 8i + j."""
    kf = k.to(torch.float32)
    kp = torch.einsum("...d,dm->...m", kf, proj.to(torch.float32))
    m = proj.shape[1]
    bits = (kp >= 0).to(torch.int32).reshape(*kp.shape[:-1], m // 8, 8)
    weights = 1 << torch.arange(8, dtype=torch.int32, device=k.device)
    packed = (bits * weights).sum(dim=-1).to(torch.uint8)
    return packed, torch.linalg.vector_norm(kf, dim=-1)


def qjl_unpack_signs(packed: torch.Tensor) -> torch.Tensor:
    """[..., m//8] uint8 -> [..., m] f32 in {-1, +1}."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    bits = bits.reshape(*packed.shape[:-1], packed.shape[-1] * 8)
    return bits.to(torch.float32) * 2.0 - 1.0


def qjl_scores(q: torch.Tensor, ksign_packed: torch.Tensor,
               knorm: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """Estimated attention logits: q [B, H, D], ksign_packed [B, Hkv, S,
    m//8], knorm [B, Hkv, S] -> [B, H, S] (pre-softmax, not scaled by
    1/sqrt(D))."""
    b, hq, _ = q.shape
    hkv, s = ksign_packed.shape[1], ksign_packed.shape[2]
    g = hq // hkv
    m = proj.shape[1]
    qp = torch.einsum("bhd,dm->bhm", q.to(torch.float32),
                      proj.to(torch.float32))
    signs = qjl_unpack_signs(ksign_packed)                  # [B,Hkv,S,m]
    est = torch.einsum("bkgm,bksm->bkgs", qp.reshape(b, hkv, g, m), signs)
    est = est * (_SQRT_PI_OVER_2 / m) * knorm[:, :, None, :]
    return est.reshape(b, hq, s)


def qjl_decode_attention(q: torch.Tensor, ksign_packed: torch.Tensor,
                         knorm: torch.Tensor, v: torch.Tensor,
                         kv_mask: torch.Tensor, proj: torch.Tensor,
                         scale: float) -> torch.Tensor:
    """Decode attention with QJL-estimated key scores: q [B, Hq, D], the
    key sketches and norms, v [B, Hkv, S, Dv] (dequantized), kv_mask [B, S]
    bool -> [B, Hq, Dv] in q's dtype."""
    b, hq, _ = q.shape
    hkv = v.shape[1]
    g = hq // hkv
    logits = qjl_scores(q, ksign_packed, knorm, proj) * scale   # [B,Hq,S]
    logits = torch.where(kv_mask[:, None, :], logits,
                         torch.full_like(logits, -1e30))
    p = torch.softmax(logits.to(torch.float32), dim=-1)
    out = torch.einsum("bkgs,bksd->bkgd", p.reshape(b, hkv, g, -1),
                       v.to(torch.float32))
    return out.reshape(b, hq, v.shape[-1]).to(q.dtype)
