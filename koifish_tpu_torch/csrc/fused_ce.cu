// Fused classifier cross-entropy for Hopper, bf16 flavour: the C entry
// points of the kernels in fused_ce.cuh (which says what they compute, how
// and what bounds them). Replaces koifish_tpu/ops/pallas/fused_ce.py
// _fwd_call (:126), _dx_call (:217) and _dw_call (:302) with int8=False.
// x [m, E] bf16, the head w [E, V] bf16 through strides (swe, swv), one of
// them 1; E a multiple of 64 up to 1280.
#include "fused_ce.cuh"

using namespace fce;

// Vocab splits the forward (which = 0) or dx (which = 1) kernel uses for
// m rows: the caller allocates a [splits, m, 3] / [splits, m, E] f32
// workspace when this is above 1.
KOIFISH_API int koifish_fused_ce_splits(int which, int m, int V) {
  if (which == 0) return splits_for((m + F_BM - 1) / F_BM, (V + F_BV - 1) / F_BV);
  return splits_for((m + T32 - 1) / T32, (V + T32 - 1) / T32);
}

KOIFISH_API int koifish_fused_ce_fwd(const void* x, const void* w, const void* tgt, void* lse,
                                     void* gold, void* ws, int m, int E, int V, long long swe,
                                     long long swv, void* stream) {
  if (bad_shape(m, E, V) || (swe != 1 && swv != 1)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return swe == 1 ? launch_fwd<false, true>(x, w, nullptr, nullptr, tgt, lse, gold, ws, m, E, V,
                                            swe, swv, st)
                  : launch_fwd<false, false>(x, w, nullptr, nullptr, tgt, lse, gold, ws, m, E, V,
                                             swe, swv, st);
}

KOIFISH_API int koifish_fused_ce_dx(const void* x, const void* w, const void* tgt, const void* lse,
                                    const void* wtok, void* dx, void* ws, int m, int E, int V,
                                    long long swe, long long swv, void* stream) {
  if (bad_shape(m, E, V) || (swe != 1 && swv != 1)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return swe == 1 ? launch_dx<false, true>(x, w, nullptr, nullptr, tgt, lse, wtok, dx, ws, m, E,
                                           V, swe, swv, st)
                  : launch_dx<false, false>(x, w, nullptr, nullptr, tgt, lse, wtok, dx, ws, m, E,
                                            V, swe, swv, st);
}

KOIFISH_API int koifish_fused_ce_dw(const void* x, const void* w, const void* tgt, const void* lse,
                                    const void* wtok, void* dw, int m, int E, int V, long long swe,
                                    long long swv, long long sde, long long sdv, void* stream) {
  if (bad_shape(m, E, V) || (swe != 1 && swv != 1) || (sde != 1 && sdv != 1))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return swe == 1 ? launch_dw<false, true>(x, x, w, nullptr, nullptr, tgt, lse, wtok, dw, m, E,
                                           V, swe, swv, sde, sdv, st)
                  : launch_dw<false, false>(x, x, w, nullptr, nullptr, tgt, lse, wtok, dw, m, E,
                                            V, swe, swv, sde, sdv, st);
}
