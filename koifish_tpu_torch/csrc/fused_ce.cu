// Fused classifier cross-entropy for Hopper, bf16 flavour: the C entry
// points of the kernels in fused_ce.cuh (which says what they compute, how
// and what bounds them). Replaces koifish_tpu/ops/pallas/fused_ce.py
// _fwd_call (:126), _dx_call (:217) and _dw_call (:302) with int8=False.
// x [m, E] bf16, the head w [E, V] bf16 through strides (swe, swv), one of
// them 1; E a multiple of 64 up to 8192. The backward is the wrapper's loop
// over vocab chunks: dlogits of the chunk, then its dx and dw products.
#include "fused_ce.cuh"

// the row stride of the head's storage, or -1 if neither stride is 1
static long long head_ld(long long swe, long long swv) {
  return swe == 1 ? swv : swv == 1 ? swe : -1;
}

KOIFISH_API int koifish_fused_ce_fwd(const void* x, const void* w, const void* tgt, void* lse,
                                     void* gold, void* ws, int m, int E, int V, long long swe,
                                     long long swv, int splits, void* stream) {
  const long long ld = head_ld(swe, swv);
  if (bad_shape(m, E, V) || ld < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return swe == 1 ? launch_logits<false, true, false>(x, w, ld, nullptr, nullptr, tgt, nullptr,
                                                      nullptr, lse, gold, ws, nullptr, 0, m, E,
                                                      V, 0, V, splits, st)
                  : launch_logits<false, false, false>(x, w, ld, nullptr, nullptr, tgt, nullptr,
                                                       nullptr, lse, gold, ws, nullptr, 0, m, E,
                                                       V, 0, V, splits, st);
}

// dlogits of vocab columns [c0, c0 + vc) into buf [m, ldb] bf16
KOIFISH_API int koifish_fused_ce_dlogits(const void* x, const void* w, const void* tgt,
                                         const void* lse, const void* wtok, void* buf,
                                         long long ldb, int m, int E, int V, long long swe,
                                         long long swv, int c0, int vc, int splits,
                                         void* stream) {
  const long long ld = head_ld(swe, swv);
  if (bad_shape(m, E, V) || ld < 1 || ldb % 8 || ldb < (vc + BV - 1) / BV * BV)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return swe == 1 ? launch_logits<false, true, true>(x, w, ld, nullptr, nullptr, tgt, lse, wtok,
                                                     nullptr, nullptr, nullptr, buf, ldb, m, E,
                                                     V, c0, vc, splits, st)
                  : launch_logits<false, false, true>(x, w, ld, nullptr, nullptr, tgt, lse, wtok,
                                                      nullptr, nullptr, nullptr, buf, ldb, m, E,
                                                      V, c0, vc, splits, st);
}

// dx (+)= buf[:, :vc] · w[:, c0 : c0 + vc]ᵀ; dxf [m, E] f32 carries the sum
// between chunks (null when first and last), the last chunk writes dx
KOIFISH_API int koifish_fused_ce_dx(const void* buf, long long ldb, const void* w, void* dxf,
                                    void* dx, int m, int E, int V, long long swe, long long swv,
                                    int c0, int vc, int first, int last, void* stream) {
  const long long ld = head_ld(swe, swv);
  if (bad_shape(m, E, V) || ld < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* f = static_cast<float*>(dxf);
  bf16* o = static_cast<bf16*>(dx);
  return swe == 1 ? launch_dx<true, false>(buf, ldb, w, ld, nullptr, f, o, m, E, V, c0, vc,
                                           first, last, st)
                  : launch_dx<false, false>(buf, ldb, w, ld, nullptr, f, o, m, E, V, c0, vc,
                                            first, last, st);
}

// dw[:, c0 : c0 + vc] = xᵀ · buf[:, :vc], written through (sde, sdv)
KOIFISH_API int koifish_fused_ce_dw(const void* buf, long long ldb, const void* x, void* dw,
                                    int m, int E, int V, int c0, int vc, long long sde,
                                    long long sdv, void* stream) {
  if (bad_shape(m, E, V)) return cudaErrorInvalidValue;
  return launch_dw(buf, ldb, x, dw, m, E, V, c0, vc, sde, sdv,
                   static_cast<cudaStream_t>(stream));
}
