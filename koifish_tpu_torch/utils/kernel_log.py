"""Kernel-dispatch observability and launch counters.

The same contract as the JAX package's ``utils/kernel_log.py``:

- ``fallback(kernel, reason)``: a hand-written kernel was skipped for a
  case the kernel does not cover (asymmetric codes, other group sizes) and
  the plain PyTorch path ran instead — logged ONCE per (kernel, reason) to
  stderr. On by default when a CUDA device is present, silent otherwise.
  ``KOIFISH_DUMP_KERNELS=0`` silences, ``=2`` forces on everywhere.
- ``choice(kernel, desc)``: a kernel WAS taken (verbose mode only).

Launch counters: every kernel wrapper calls ``count(name)`` exactly where
it launches its CUDA kernel, so a run can show that its main path went
through the kernels (``reset_launches`` / ``launches``). The names:
``flash_fwd``, ``flash_bwd_dkv``, ``flash_bwd_dq``, ``qmm``, ``qmv``,
``qmm_book``, ``qmv_book``, ``decode_attn``, ``kv_write`` (a
``decode_attn`` launch that also quantized and wrote the new token's K/V),
``slot_write``,
``page_write``, ``paged_attn``, ``paged_attn_write`` (a ``paged_attn``
launch that also wrote the new token's K/V rows into their pages),
``fused_ce_fwd``, ``fused_ce_dlogits``, ``fused_ce_dx``,
``fused_ce_dw``, their int8 flavour ``fused_ce_fwd_int8``,
``fused_ce_dlogits_int8``, ``fused_ce_dx_int8``, ``fused_ce_dw_int8``,
``qdgrad_quant`` (the per-tile dgrad's quantize pass), ``qdgrad_int8_tile``
(its GEMM), ``rowquant``, ``colquant`` and ``qmv_int8``. ``fallbacks`` counts the fallbacks of each kernel since the
same reset, whether or not they were printed. A wrapper whose kernel takes
many reduction depths also passes ``k`` to ``count``, and
``launches_by_k`` gives the launches of each (kernel, K) since the reset,
so a run can show which of its launches had a given shape.
"""
from __future__ import annotations

import os
import sys
from typing import Dict, Optional, Set, Tuple

_seen: Set[Tuple[str, str]] = set()
_verbose: Optional[bool] = None   # None = read env lazily

#: kernel name -> launches since the last reset (plain ints)
LAUNCHES: Dict[str, int] = {}
#: (kernel name, reduction depth K) -> launches since the last reset
LAUNCHES_BY_K: Dict[Tuple[str, int], int] = {}
#: kernel name -> fallbacks to the plain path since the last reset
FALLBACKS: Dict[str, int] = {}


def _mode() -> int:
    """0 = silent, 1 = fallbacks on the GPU, 2 = everything everywhere."""
    env = os.environ.get("KOIFISH_DUMP_KERNELS", "1")
    try:
        lvl = int(env)
    except ValueError:
        lvl = 1
    if lvl == 0:
        return 0
    return 2 if _verbose else lvl


def set_verbose(on: bool) -> None:
    """Also log positive kernel picks."""
    global _verbose
    _verbose = bool(on) or None


def reset() -> None:
    """Forget logged keys (tests)."""
    _seen.clear()


def _on_device() -> bool:
    import torch
    return torch.cuda.is_available()


def _emit(tag: str, kernel: str, detail: str) -> None:
    key = (kernel, detail)
    if key in _seen:
        return
    _seen.add(key)
    print(f"[koifish] {tag}: {kernel} {detail}", file=sys.stderr, flush=True)


def fallback(kernel: str, reason: str) -> None:
    """The hand-written ``kernel`` was skipped for ``reason``."""
    FALLBACKS[kernel] = FALLBACKS.get(kernel, 0) + 1
    mode = _mode()
    if mode == 0 or (mode == 1 and not _on_device()):
        return
    _emit("kernel fallback -> torch", kernel, f"({reason})")


def choice(kernel: str, desc: str) -> None:
    """The hand-written ``kernel`` WAS dispatched (verbose mode only)."""
    if _mode() < 2:
        return
    _emit("kernel choice", kernel, f"({desc})")


def count(kernel: str, k: Optional[int] = None) -> None:
    """One launch of ``kernel`` (called by its wrapper at the launch), of
    reduction depth ``k`` where the wrapper gives it."""
    LAUNCHES[kernel] = LAUNCHES.get(kernel, 0) + 1
    if k is not None:
        key = (kernel, int(k))
        LAUNCHES_BY_K[key] = LAUNCHES_BY_K.get(key, 0) + 1


def reset_launches() -> None:
    LAUNCHES.clear()
    LAUNCHES_BY_K.clear()
    FALLBACKS.clear()


def launches() -> Dict[str, int]:
    return dict(LAUNCHES)


def launches_by_k() -> Dict[Tuple[str, int], int]:
    return dict(LAUNCHES_BY_K)


def fallbacks() -> Dict[str, int]:
    return dict(FALLBACKS)
