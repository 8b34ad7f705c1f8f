// Fused classifier cross-entropy for Hopper, int8 flavour: the C entry
// points of the kernels in fused_ce.cuh (which says what they compute, how
// and what bounds them). Replaces koifish_tpu/ops/pallas/fused_ce.py
// _fwd_call (:126), _dx_call (:217) and _dw_call (:302) with int8=True.
// xq [m, E] int8 + sx [m] f32; wq int8 in [V, E] storage (row stride ldw) +
// sw [V] f32; E a multiple of 64 up to 1280. Logits = (xq·wq)_int32·sx·sw;
// dx multiplies dlogits by bf16(wq·sw); dw multiplies the bf16 x by dlogits.
#include "fused_ce.cuh"

using namespace fce;

KOIFISH_API int koifish_fused_ce_int8_splits(int which, int m, int V) {
  if (which == 0) return splits_for((m + F_BM - 1) / F_BM, (V + F_BV - 1) / F_BV);
  return splits_for((m + T32 - 1) / T32, (V + T32 - 1) / T32);
}

KOIFISH_API int koifish_fused_ce_int8_fwd(const void* xq, const void* sx, const void* wq,
                                          const void* sw, const void* tgt, void* lse, void* gold,
                                          void* ws, int m, int E, int V, long long ldw,
                                          void* stream) {
  if (bad_shape(m, E, V) || ldw < E || ldw % 16) return cudaErrorInvalidValue;
  return launch_fwd<true, true>(xq, wq, static_cast<const float*>(sx),
                                static_cast<const float*>(sw), tgt, lse, gold, ws, m, E, V, 1,
                                ldw, static_cast<cudaStream_t>(stream));
}

KOIFISH_API int koifish_fused_ce_int8_dx(const void* xq, const void* sx, const void* wq,
                                         const void* sw, const void* tgt, const void* lse,
                                         const void* wtok, void* dx, void* ws, int m, int E, int V,
                                         long long ldw, void* stream) {
  if (bad_shape(m, E, V) || ldw < E || ldw % 16) return cudaErrorInvalidValue;
  return launch_dx<true, true>(xq, wq, static_cast<const float*>(sx),
                               static_cast<const float*>(sw), tgt, lse, wtok, dx, ws, m, E, V, 1,
                               ldw, static_cast<cudaStream_t>(stream));
}

KOIFISH_API int koifish_fused_ce_int8_dw(const void* x, const void* xq, const void* sx,
                                         const void* wq, const void* sw, const void* tgt,
                                         const void* lse, const void* wtok, void* dw, int m, int E,
                                         int V, long long ldw, long long sde, long long sdv,
                                         void* stream) {
  if (bad_shape(m, E, V) || ldw < E || ldw % 16 || (sde != 1 && sdv != 1))
    return cudaErrorInvalidValue;
  return launch_dw<true, true>(x, xq, wq, static_cast<const float*>(sx),
                               static_cast<const float*>(sw), tgt, lse, wtok, dw, m, E, V, 1, ldw,
                               sde, sdv, static_cast<cudaStream_t>(stream));
}
