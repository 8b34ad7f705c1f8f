// Fused classifier cross-entropy for Hopper, int8 flavour: the C entry
// points of the kernels in fused_ce.cuh (which says what they compute, how
// and what bounds them). Replaces koifish_tpu/ops/pallas/fused_ce.py
// _fwd_call (:126), _dx_call (:217) and _dw_call (:302) with int8=True.
// xq [m, E] int8 + sx [m] f32; wq int8 in [V, E] storage (row stride ldw, a
// multiple of 16) + sw [V] f32; E a multiple of 64 up to 8192. Logits =
// (xq·wq)_int32·sx·sw; dx multiplies dlogits by bf16(wq·sw); dw multiplies
// the bf16 x by dlogits.
#include "fused_ce.cuh"

static bool bad_codes(int m, int E, int V, long long ldw) {
  return bad_shape(m, E, V) || ldw < E || ldw % 16;
}

KOIFISH_API int koifish_fused_ce_int8_fwd(const void* xq, const void* sx, const void* wq,
                                          const void* sw, const void* tgt, void* lse, void* gold,
                                          void* ws, int m, int E, int V, long long ldw,
                                          int splits, void* stream) {
  if (bad_codes(m, E, V, ldw)) return cudaErrorInvalidValue;
  return launch_logits<true, true, false>(
      xq, wq, ldw, static_cast<const float*>(sx), static_cast<const float*>(sw), tgt, nullptr,
      nullptr, lse, gold, ws, nullptr, 0, m, E, V, 0, V, splits,
      static_cast<cudaStream_t>(stream));
}

KOIFISH_API int koifish_fused_ce_int8_dlogits(const void* xq, const void* sx, const void* wq,
                                              const void* sw, const void* tgt, const void* lse,
                                              const void* wtok, void* buf, long long ldb, int m,
                                              int E, int V, long long ldw, int c0, int vc,
                                              int splits, void* stream) {
  if (bad_codes(m, E, V, ldw) || ldb % 8 || ldb < (vc + BV - 1) / BV * BV)
    return cudaErrorInvalidValue;
  return launch_logits<true, true, true>(
      xq, wq, ldw, static_cast<const float*>(sx), static_cast<const float*>(sw), tgt, lse, wtok,
      nullptr, nullptr, nullptr, buf, ldb, m, E, V, c0, vc, splits,
      static_cast<cudaStream_t>(stream));
}

// dx (+)= buf[:, :vc] · bf16(wq · sw)[c0 : c0 + vc], the codes dequantized
// in the GEMM's stages
KOIFISH_API int koifish_fused_ce_int8_dx(const void* buf, long long ldb, const void* wq,
                                         const void* sw, void* dxf, void* dx, int m, int E,
                                         int V, long long ldw, int c0, int vc, int first,
                                         int last, void* stream) {
  if (bad_codes(m, E, V, ldw)) return cudaErrorInvalidValue;
  return launch_dx<true, true>(buf, ldb, wq, ldw, static_cast<const float*>(sw),
                               static_cast<float*>(dxf), static_cast<bf16*>(dx), m, E, V, c0, vc,
                               first, last, static_cast<cudaStream_t>(stream));
}

// dw[:, c0 : c0 + vc] = xᵀ · buf[:, :vc] with the bf16 x
KOIFISH_API int koifish_fused_ce_int8_dw(const void* buf, long long ldb, const void* x, void* dw,
                                         int m, int E, int V, int c0, int vc, long long sde,
                                         long long sdv, void* stream) {
  if (bad_shape(m, E, V)) return cudaErrorInvalidValue;
  return launch_dw(buf, ldb, x, dw, m, E, V, c0, vc, sde, sdv,
                   static_cast<cudaStream_t>(stream));
}
