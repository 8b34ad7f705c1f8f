// One-token GQA decode attention read straight from an INT8 or packed-INT4
// KV cache, for Hopper.
//
// Replaces the Pallas kernel of koifish_tpu/ops/pallas/decode_attn.py:
// _decode_kernel_call/_decode_kernel (:179/:200).
//
// Cache layout (serve/kvcache.py): codes [B, Hkv, S, D] int8, or
// [B, Hkv, S, D/2] uint8 for INT4 with byte i holding element i (low
// nibble) and element i + D/2 (high nibble), biased by 8; per-(position,
// head) f32 scales [B, Hkv, S]. K scales multiply the logits; V scales
// fold into p, which is rounded to bf16 before PV (as decode_attn.py:223,
// :236-238). d and dv may differ (MLA) and each is 64, 128, 192 or 256.
//
// What bounds it on the H100: each live cache position is read once
// (D + Dv code bytes plus 8 scale bytes per kv head) and meets
// 2·g·(D + Dv) flops — a few flops per byte, so reading the codes bounds
// it. Design: one block of 128 threads per (batch, kv head, up to G q
// heads of its group), so all q heads of a group share one read of the
// codes. The block walks the cache in tiles of 128 positions only up to
// lengths[b] (the Pallas kernel skips dead tiles the same way,
// decode_attn.py:144-153): a tile is copied to shared memory with 16-byte
// loads, thread t scores position t against every q head of the block, an
// online softmax (f32) runs across tiles, and for P·V thread t owns value
// columns t and t + 128.
#include "common.cuh"

namespace {

constexpr int BS = 128;         // cache positions per tile = threads
constexpr int NTHREADS = BS;
constexpr int NWARPS = NTHREADS / 32;
constexpr float NEG_INF = -1e30f;

struct Layout {
  // q [G][D] f32 | K tile [BS][DKB + 4] | V tile [BS][DVB] | p·vs [G][BS] f32
  // | two [NWARPS][G] reduction buffers
  size_t q, k, v, p, rmax, rsum, bytes;
  int ldk;
  __host__ __device__ Layout(int G, int D, int DKB, int DVB) {
    ldk = DKB + 4;   // odd word stride: thread-per-row reads hit distinct banks
    q = 0;
    k = q + sizeof(float) * G * D;
    v = k + static_cast<size_t>(BS) * ldk;
    p = v + static_cast<size_t>(BS) * DVB;
    rmax = p + sizeof(float) * G * BS;
    rsum = rmax + sizeof(float) * NWARPS * G;
    bytes = rsum + sizeof(float) * NWARPS * G;
  }
};

template <int G, bool INT4>
__global__ void __launch_bounds__(NTHREADS)
    decode_attn_kernel(const bf16* __restrict__ q, const uint8_t* __restrict__ kc,
                       const uint8_t* __restrict__ vc, const float* __restrict__ ks,
                       const float* __restrict__ vs, const int* __restrict__ lengths,
                       bf16* __restrict__ out, int Hq, int Hkv, int S, int D, int DV,
                       float scale) {
  const int DKB = INT4 ? D / 2 : D;     // code bytes per cached key
  const int DVB = INT4 ? DV / 2 : DV;
  const Layout ly(G, D, DKB, DVB);
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + ly.q);
  uint8_t* Kt = smem + ly.k;
  uint8_t* Vt = smem + ly.v;
  float* Pv = reinterpret_cast<float*>(smem + ly.p);
  float* Rmax = reinterpret_cast<float*>(smem + ly.rmax);
  float* Rsum = reinterpret_cast<float*>(smem + ly.rsum);

  const int bh = blockIdx.x;   // b * Hkv + kv head
  const int b = bh / Hkv, hk = bh % Hkv;
  const int g = Hq / Hkv;
  const int h0 = hk * g + blockIdx.y * G;   // first q head of this block
  const int nh = min(G, g - blockIdx.y * G);
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int len = max(0, min(lengths[b], S));

  for (int i = t; i < G * D; i += NTHREADS) {
    const int gi = i / D, d = i % D;
    Qs[i] = gi < nh ? __bfloat162float(q[(static_cast<size_t>(b) * Hq + h0 + gi) * D + d]) : 0.f;
  }
  float m_run[G], l_run[G], oacc[G][2];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m_run[gi] = NEG_INF;
    l_run[gi] = 0.f;
    oacc[gi][0] = oacc[gi][1] = 0.f;
  }

  const size_t row0 = static_cast<size_t>(bh) * S;   // this head's first cache row
  for (int s0 = 0; s0 < len; s0 += BS) {
    const int nvalid = min(BS, len - s0);
    __syncthreads();   // previous tile fully consumed
    // copy the live rows of the K and V tiles (16-byte loads)
    {
      const uint4* ksrc = reinterpret_cast<const uint4*>(kc + (row0 + s0) * DKB);
      const int kchunks = nvalid * DKB / 16;
      for (int i = t; i < kchunks; i += NTHREADS) {
        const uint4 val = ksrc[i];
        const int byte = i * 16, r = byte / DKB, c = byte % DKB;
        uint32_t* dst = reinterpret_cast<uint32_t*>(Kt + r * ly.ldk + c);
        dst[0] = val.x;
        dst[1] = val.y;
        dst[2] = val.z;
        dst[3] = val.w;
      }
      const uint4* vsrc = reinterpret_cast<const uint4*>(vc + (row0 + s0) * DVB);
      uint4* vdst = reinterpret_cast<uint4*>(Vt);
      const int vchunks = nvalid * DVB / 16;
      for (int i = t; i < vchunks; i += NTHREADS) vdst[i] = vsrc[i];
    }
    const bool live = t < nvalid;
    const float ksc = live ? ks[row0 + s0 + t] : 0.f;
    const float vsc = live ? vs[row0 + s0 + t] : 0.f;
    __syncthreads();

    // logits of position s0 + t against every q head of the block
    float logit[G];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) logit[gi] = 0.f;
    if (live) {
      const uint8_t* krow = Kt + t * ly.ldk;
      for (int c = 0; c < DKB; c += 4) {
        const uint32_t word = *reinterpret_cast<const uint32_t*>(krow + c);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t byte = (word >> (8 * j)) & 0xffu;
          if (INT4) {
            const float lo = static_cast<float>(static_cast<int>(byte & 0xfu) - 8);
            const float hi = static_cast<float>(static_cast<int>(byte >> 4) - 8);
            const int d = c + j;
#pragma unroll
            for (int gi = 0; gi < G; ++gi)
              logit[gi] += Qs[gi * D + d] * lo + Qs[gi * D + d + DKB] * hi;
          } else {
            const float val = static_cast<float>(static_cast<int8_t>(byte));
#pragma unroll
            for (int gi = 0; gi < G; ++gi) logit[gi] += Qs[gi * D + c + j] * val;
          }
        }
      }
    }
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      logit[gi] = live ? logit[gi] * ksc * scale : NEG_INF;
      const float wm = warp_max(logit[gi]);
      if (lane == 0) Rmax[warp * G + gi] = wm;
    }
    __syncthreads();
    float p[G], alpha[G];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      float tmax = Rmax[gi];
#pragma unroll
      for (int w = 1; w < NWARPS; ++w) tmax = fmaxf(tmax, Rmax[w * G + gi]);
      const float m_new = fmaxf(m_run[gi], tmax);
      p[gi] = expf(logit[gi] - m_new);
      alpha[gi] = expf(m_run[gi] - m_new);
      m_run[gi] = m_new;
      const float ws = warp_sum(p[gi]);
      if (lane == 0) Rsum[warp * G + gi] = ws;
      Pv[gi * BS + t] = __bfloat162float(__float2bfloat16(p[gi] * vsc));
    }
    __syncthreads();
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      float psum = 0.f;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) psum += Rsum[w * G + gi];
      l_run[gi] = l_run[gi] * alpha[gi] + psum;
    }

    // o = o·alpha + Σ_s p·vs · v[s, d]; thread t owns columns t and t + 128
#pragma unroll
    for (int ci = 0; ci < 2; ++ci) {
      const int d = t + ci * NTHREADS;
      if (d >= DV) break;
      int byte_col = d, shift = 0;
      if (INT4) {
        byte_col = d < DVB ? d : d - DVB;
        shift = d < DVB ? 0 : 4;
      }
#pragma unroll
      for (int gi = 0; gi < G; ++gi) oacc[gi][ci] *= alpha[gi];
      for (int s = 0; s < nvalid; ++s) {
        const uint32_t byte = Vt[s * DVB + byte_col];
        const float val = INT4 ? static_cast<float>(static_cast<int>((byte >> shift) & 0xfu) - 8)
                               : static_cast<float>(static_cast<int8_t>(byte));
#pragma unroll
        for (int gi = 0; gi < G; ++gi) oacc[gi][ci] += Pv[gi * BS + s] * val;
      }
    }
  }

#pragma unroll
  for (int ci = 0; ci < 2; ++ci) {
    const int d = t + ci * NTHREADS;
    if (d >= DV) break;
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      if (gi >= nh) break;
      const float l = fmaxf(l_run[gi], 1e-30f);
      out[(static_cast<size_t>(b) * Hq + h0 + gi) * DV + d] = __float2bfloat16(oacc[gi][ci] / l);
    }
  }
}

template <int G, bool INT4>
cudaError_t launch(const void* q, const void* kc, const void* vc, const void* ks, const void* vs,
                   const void* lengths, void* out, int B, int Hq, int Hkv, int S, int D, int DV,
                   float scale, cudaStream_t stream) {
  const Layout ly(G, D, INT4 ? D / 2 : D, INT4 ? DV / 2 : DV);
  // the largest layout (D = DV = 256, INT8) decides the opt-in once
  static cudaError_t attr = set_smem(decode_attn_kernel<G, INT4>, Layout(G, 256, 256, 256).bytes);
  if (attr != cudaSuccess) return attr;
  const int g = Hq / Hkv;
  dim3 grid(B * Hkv, (g + G - 1) / G);
  decode_attn_kernel<G, INT4><<<grid, NTHREADS, ly.bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const uint8_t*>(kc),
      static_cast<const uint8_t*>(vc), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(lengths), static_cast<bf16*>(out), Hq,
      Hkv, S, D, DV, scale);
  return cudaGetLastError();
}

template <bool INT4>
cudaError_t launch_g(int g, const void* q, const void* kc, const void* vc, const void* ks,
                     const void* vs, const void* lengths, void* out, int B, int Hq, int Hkv, int S,
                     int D, int DV, float scale, cudaStream_t stream) {
  if (g <= 1)
    return launch<1, INT4>(q, kc, vc, ks, vs, lengths, out, B, Hq, Hkv, S, D, DV, scale, stream);
  if (g <= 2)
    return launch<2, INT4>(q, kc, vc, ks, vs, lengths, out, B, Hq, Hkv, S, D, DV, scale, stream);
  if (g <= 4)
    return launch<4, INT4>(q, kc, vc, ks, vs, lengths, out, B, Hq, Hkv, S, D, DV, scale, stream);
  return launch<8, INT4>(q, kc, vc, ks, vs, lengths, out, B, Hq, Hkv, S, D, DV, scale, stream);
}

bool head_dim_ok(int d) { return d == 64 || d == 128 || d == 192 || d == 256; }

}  // namespace

KOIFISH_API int koifish_decode_attn(const void* q, const void* kc, const void* vc, const void* ks,
                                    const void* vs, const void* lengths, void* out, int B, int Hq,
                                    int Hkv, int S, int D, int DV, int int4, float scale,
                                    void* stream) {
  if (B < 1 || Hkv < 1 || Hq % Hkv != 0 || S < 1 || !head_dim_ok(D) || !head_dim_ok(DV))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int g = Hq / Hkv;
  if (int4)
    return launch_g<true>(g, q, kc, vc, ks, vs, lengths, out, B, Hq, Hkv, S, D, DV, scale, s);
  return launch_g<false>(g, q, kc, vc, ks, vs, lengths, out, B, Hq, Hkv, S, D, DV, scale, s);
}
