// One step of the sequence-parallel ring attention for Hopper: rank `my`'s
// query chunk against the K/V chunk in its slot, carrying the online
// softmax's (o, m, l) in f32 device memory from one launch to the next.
//
// Replaces koifish_tpu/parallel/ring_pallas.py:152 (ring_attention_pallas,
// kernel body _ring_kernel at :41). The TPU kernel runs the whole ring in
// one kernel per device: each step it starts a remote DMA of the chunk in
// hand to the right neighbour's other VMEM slot, attends over the chunk,
// acks the slot to the left neighbour and waits for its DMA. On the card
// the ring is driven from the host (ops/kernels/ring_attn.py): one launch
// of this kernel per rank per step on the rank's compute stream, the chunk
// copies (koifish_ring_copy) on the rank's copy stream, ordered by CUDA
// events (receive before compute, the right neighbour's ack and send before
// a copy into its slot). A persistent kernel spinning on flags would
// deadlock when the ranks share one card and their kernels are not all
// resident, so nothing here waits on another block or launch.
//
// What it computes, as the TPU kernel does: q and K cast to bf16, logits
// q·kᵀ·scale in f32, masked to -1e30 where kpos > qpos (qpos = q_off + row,
// kpos = k_off + key), an online softmax in f32 with p rounded to bf16 for
// P·V (f32 accumulate), and, at the rank's last launch (`last`), o / max(l,
// 1e-30) in q's dtype. The TPU kernel updates (m, l) once a chunk; this one
// once a 64-key tile (the plain version in ring_attn.py does the same). The
// first launch (`first`) starts from o = 0, m = -1e30, l = 0 without reading
// the state; it must be the diagonal chunk (k_off == q_off), so that every
// row's first tile holds an unmasked key and m is finite from then on.
//
// What bounds it on the H100: 4·D flops a (query, key) pair on the tensor
// cores against 2·D bytes a key (K and V, read once a q head through L2)
// and the state's 2·D·4 bytes a query row read and written a launch: the
// operations at T 8192 (~0.28 ms for the causal pairs at 989 TFLOP/s).
// Design, a simple flash-attention forward (FA2's shape) and no more: a
// block takes 64 query rows of one q head (4 warps of 16 rows, q in
// registers as mma A fragments), streams the chunk's 64-key K and V tiles
// of its kv head through a 2-stage cp.async ring (rows padded by 16 bytes:
// the ldmatrix reads are free of bank conflicts), S = Q·Kᵀ and O += P·V by
// mma.sync m16n8k16 (bf16 in, f32 accumulate; K by ldmatrix, V by
// ldmatrix.trans), and stops at the last tile its rows may see: fully
// masked tiles cost nothing (the host skips fully masked chunks).
#include "common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int NT = 32 * WARPS;
constexpr int BM = 16 * WARPS;   // query rows a block
constexpr int BN = 64;           // keys a tile
constexpr int STAGES = 2;
constexpr float NEG_INF = -1e30f;

template <int D>
struct Cfg {
  static constexpr int LD = D + 8;                 // staged row stride (bf16)
  static constexpr int TILE = BN * LD;             // one K or V tile (bf16)
  static constexpr int SMEM = STAGES * 2 * TILE * 2;
  static constexpr int CHUNKS = BN * D / 8;        // 16-byte chunks a tile
  static_assert(CHUNKS % NT == 0, "ring_attn: tile copy");
};

struct Args {
  const void* q;         // [B, Tl, Hq, D] bf16 or f32, batch stride q_sb
  const bf16* k;         // [B, Tl, Hkv, D] bf16, contiguous (the slot)
  const bf16* v;
  float* o;              // [B, Tl, Hq, D] f32
  float* m;              // [B, Hq, Tl] f32
  float* l;
  void* out;             // [B, Tl, Hq, D] q's dtype, batch stride out_sb
  long long q_sb, out_sb;
  int Tl, Hq, Hkv, q_off, k_off, first, last;
  float scale;
};

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices from shared memory, lanes 8i..8i+7 giving the
// row addresses of matrix i: lane l gets row l / 4, columns 2(l % 4)..+1 of
// each (TRANS: of its transpose)
template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  if constexpr (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr)
                 : "memory");
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr)
                 : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// two consecutive q entries of row `row`, column `col`, as a bf16 pair
template <bool QF32>
__device__ __forceinline__ uint32_t q_pair(const Args& a, int b, int row, int h, int col,
                                           int D) {
  if (row >= a.Tl) return 0u;
  const long long off = b * a.q_sb + (static_cast<long long>(row) * a.Hq + h) * D + col;
  if constexpr (QF32) {
    const float2 x = *reinterpret_cast<const float2*>(static_cast<const float*>(a.q) + off);
    return pack_bf16(x.x, x.y);
  } else {
    return *reinterpret_cast<const uint32_t*>(static_cast<const bf16*>(a.q) + off);
  }
}

// K and V tile t (keys t·64..+63 of the chunk, kv head hk) into stage st;
// keys past Tl are zero-filled
template <int D>
__device__ __forceinline__ void load_tile(const Args& a, bf16* sk, bf16* sv, int b, int hk,
                                          int t) {
  using C = Cfg<D>;
  constexpr int PER_ROW = D / 8;
#pragma unroll
  for (int i = 0; i < C::CHUNKS / NT; ++i) {
    const int c = static_cast<int>(threadIdx.x) + i * NT;
    const int r = c / PER_ROW, col = (c % PER_ROW) * 8;
    const int key = t * BN + r;
    const bool live = key < a.Tl;
    const long long src = (static_cast<long long>(b) * a.Tl + (live ? key : 0)) * a.Hkv * D +
                          static_cast<long long>(hk) * D + col;
    cp_async16(sk + r * C::LD + col, a.k + src, live ? 16 : 0);
    cp_async16(sv + r * C::LD + col, a.v + src, live ? 16 : 0);
  }
}

template <int D, bool QF32>
__global__ void __launch_bounds__(NT) ring_step_kernel(const Args a) {
  using C = Cfg<D>;
  constexpr int LD = C::LD, KS = D / 16, NO = D / 8;
  extern __shared__ __align__(16) unsigned char sm[];
  bf16* sk = reinterpret_cast<bf16*>(sm);                  // [STAGES][BN][LD]
  bf16* sv = sk + STAGES * C::TILE;                        // [STAGES][BN][LD]
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gi = lane / 4, ti = lane % 4;
  const int r0 = qt * BM + warp * 16 + gi, r1 = r0 + 8;   // this thread's two rows

  // the last key this block's rows may see: kpos <= qpos
  const long long lim = static_cast<long long>(a.q_off) - a.k_off + min(qt * BM + BM, a.Tl) - 1;
  const int ntiles = lim < 0 ? 0
                             : min((a.Tl + BN - 1) / BN, static_cast<int>(lim / BN) + 1);
  if (ntiles > 0) load_tile<D>(a, sk, sv, b, hk, 0);
  cp_async_commit();

  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    qa[kk][0] = q_pair<QF32>(a, b, r0, h, kk * 16 + 2 * ti, D);
    qa[kk][1] = q_pair<QF32>(a, b, r1, h, kk * 16 + 2 * ti, D);
    qa[kk][2] = q_pair<QF32>(a, b, r0, h, kk * 16 + 2 * ti + 8, D);
    qa[kk][3] = q_pair<QF32>(a, b, r1, h, kk * 16 + 2 * ti + 8, D);
  }

  // the carried state: o rows r0 / r1, columns 8j + 2ti..+1; m, l of both rows
  float acc[NO][4];
  float mr[2], lr[2];
  const long long orow0 = (static_cast<long long>(b) * a.Tl + r0) * a.Hq + h;
  const long long orow1 = (static_cast<long long>(b) * a.Tl + r1) * a.Hq + h;
  const long long mrow = (static_cast<long long>(b) * a.Hq + h) * a.Tl;
  if (a.first) {
#pragma unroll
    for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    mr[0] = mr[1] = NEG_INF;
    lr[0] = lr[1] = 0.f;
  } else {
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      float2 x0 = make_float2(0.f, 0.f), x1 = x0;
      if (r0 < a.Tl) x0 = *reinterpret_cast<const float2*>(a.o + orow0 * D + 8 * j + 2 * ti);
      if (r1 < a.Tl) x1 = *reinterpret_cast<const float2*>(a.o + orow1 * D + 8 * j + 2 * ti);
      acc[j][0] = x0.x;
      acc[j][1] = x0.y;
      acc[j][2] = x1.x;
      acc[j][3] = x1.y;
    }
    mr[0] = r0 < a.Tl ? a.m[mrow + r0] : NEG_INF;
    mr[1] = r1 < a.Tl ? a.m[mrow + r1] : NEG_INF;
    lr[0] = r0 < a.Tl ? a.l[mrow + r0] : 0.f;
    lr[1] = r1 < a.Tl ? a.l[mrow + r1] : 0.f;
  }

  const long long qpos0 = static_cast<long long>(a.q_off) + r0, qpos1 = qpos0 + 8;
  const uint32_t sk0 = static_cast<uint32_t>(__cvta_generic_to_shared(sk));
  const uint32_t sv0 = static_cast<uint32_t>(__cvta_generic_to_shared(sv));
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles)
      load_tile<D>(a, sk + ((t + 1) % STAGES) * C::TILE, sv + ((t + 1) % STAGES) * C::TILE, b,
                   hk, t + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const uint32_t kbase = sk0 + (t % STAGES) * C::TILE * 2;
    const uint32_t vbase = sv0 + (t % STAGES) * C::TILE * 2;

    // S = Q·Kᵀ over the tile's 64 keys: 8 n8 tiles
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        // matrices: keys 8j.. cols 16kk | 16kk+8, keys 8(j+1).. cols 16kk | 16kk+8
        const int mi = lane / 8, rr = lane % 8;
        const int key = 8 * (j + (mi >> 1)) + rr, col = 16 * kk + (mi & 1) * 8;
        uint32_t bk[4];
        ldsm_x4<false>(bk, kbase + (key * LD + col) * 2);
        mma16816(s[j], qa[kk], bk[0], bk[1]);
        mma16816(s[j + 1], qa[kk], bk[2], bk[3]);
      }
    }

    // logits, the mask, the online softmax (rows r0: entries 0, 1; r1: 2, 3)
    const long long kpos0 = static_cast<long long>(a.k_off) + t * BN;
    const bool masked = kpos0 + BN - 1 > static_cast<long long>(a.q_off) + qt * BM ||
                        t * BN + BN > a.Tl;
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * a.scale;
        if (masked) {
          const int key = t * BN + 8 * j + 2 * ti + (e & 1);
          const long long qp = e < 2 ? qpos0 : qpos1;
          if (key >= a.Tl || kpos0 + 8 * j + 2 * ti + (e & 1) > qp) x = NEG_INF;
        }
        s[j][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    const float mn0 = fmaxf(mr[0], mx0), mn1 = fmaxf(mr[1], mx1);
    const float al0 = __expf(mr[0] - mn0), al1 = __expf(mr[1] - mn1);
    float sum0 = 0.f, sum1 = 0.f;
    uint32_t pa[4][4];   // P as A fragments, one per 16-key step
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = __expf(s[j][0] - mn0), p1 = __expf(s[j][1] - mn0);
      const float p2 = __expf(s[j][2] - mn1), p3 = __expf(s[j][3] - mn1);
      sum0 += p0 + p1;
      sum1 += p2 + p3;
      pa[j / 2][(j & 1) * 2 + 0] = pack_bf16(p0, p1);
      pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, o);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, o);
    }
    lr[0] = lr[0] * al0 + sum0;
    lr[1] = lr[1] * al1 + sum1;
    mr[0] = mn0;
    mr[1] = mn1;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      acc[j][0] *= al0;
      acc[j][1] *= al0;
      acc[j][2] *= al1;
      acc[j][3] *= al1;
    }

    // O += P·V: 4 k16 steps over the keys, D/8 n8 tiles over the columns
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int j = 0; j < NO; j += 2) {
        // matrices: keys 16kk.. | 16kk+8.., columns 8j | 8(j+1), transposed
        const int mi = lane / 8, rr = lane % 8;
        const int key = 16 * kk + (mi & 1) * 8 + rr, col = 8 * (j + (mi >> 1));
        uint32_t bv[4];
        ldsm_x4<true>(bv, vbase + (key * LD + col) * 2);
        mma16816(acc[j], pa[kk], bv[0], bv[1]);
        mma16816(acc[j + 1], pa[kk], bv[2], bv[3]);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  if (a.last) {
    const float inv0 = 1.f / fmaxf(lr[0], 1e-30f), inv1 = 1.f / fmaxf(lr[1], 1e-30f);
    const long long ob0 = b * a.out_sb + (static_cast<long long>(r0) * a.Hq + h) * D;
    const long long ob1 = b * a.out_sb + (static_cast<long long>(r1) * a.Hq + h) * D;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int col = 8 * j + 2 * ti;
      const float y0 = acc[j][0] * inv0, y1 = acc[j][1] * inv0;
      const float y2 = acc[j][2] * inv1, y3 = acc[j][3] * inv1;
      if constexpr (QF32) {
        float* out = static_cast<float*>(a.out);
        if (r0 < a.Tl) *reinterpret_cast<float2*>(out + ob0 + col) = make_float2(y0, y1);
        if (r1 < a.Tl) *reinterpret_cast<float2*>(out + ob1 + col) = make_float2(y2, y3);
      } else {
        bf16* out = static_cast<bf16*>(a.out);
        if (r0 < a.Tl) *reinterpret_cast<uint32_t*>(out + ob0 + col) = pack_bf16(y0, y1);
        if (r1 < a.Tl) *reinterpret_cast<uint32_t*>(out + ob1 + col) = pack_bf16(y2, y3);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      if (r0 < a.Tl)
        *reinterpret_cast<float2*>(a.o + orow0 * D + 8 * j + 2 * ti) =
            make_float2(acc[j][0], acc[j][1]);
      if (r1 < a.Tl)
        *reinterpret_cast<float2*>(a.o + orow1 * D + 8 * j + 2 * ti) =
            make_float2(acc[j][2], acc[j][3]);
    }
    if (ti == 0) {
      if (r0 < a.Tl) {
        a.m[mrow + r0] = mr[0];
        a.l[mrow + r0] = lr[0];
      }
      if (r1 < a.Tl) {
        a.m[mrow + r1] = mr[1];
        a.l[mrow + r1] = lr[1];
      }
    }
  }
}

template <int D, bool QF32>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  auto kernel = ring_step_kernel<D, QF32>;
  // per call: the attribute is the current device's, and ranks may span cards
  const cudaError_t attr = set_smem(kernel, Cfg<D>::SMEM);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.Tl + BM - 1) / BM, a.Hq, B);
  kernel<<<grid, NT, Cfg<D>::SMEM, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// One ring step of rank `my` (q_off = my·Tl) on the chunk of rank src
// (k_off = src·Tl) in its slot: q [B, Tl, Hq, D] (bf16, or f32 with
// q_f32; rows contiguous, batch stride q_sb elements), k, v [B, Tl, Hkv, D]
// bf16 contiguous; the state o [B, Tl, Hq, D] and m, l [B, Hq, Tl] f32 is
// read (unless `first`) and written (unless `last`); with `last`, out
// [B, Tl, Hq, D] in q's dtype (batch stride out_sb) gets o / max(l, 1e-30).
KOIFISH_API int koifish_ring_attn_step(const void* q, int q_f32, long long q_sb, const void* k,
                                       const void* v, void* o, void* m, void* l, void* out,
                                       long long out_sb, int B, int Tl, int Hq, int Hkv, int D,
                                       int q_off, int k_off, float scale, int first, int last,
                                       void* stream) {
  if (B < 1 || B > 65535 || Tl < 1 || Hkv < 1 || Hq % Hkv != 0 || Hq > 65535 ||
      (last && out == nullptr))
    return cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.o = static_cast<float*>(o);
  a.m = static_cast<float*>(m);
  a.l = static_cast<float*>(l);
  a.out = out;
  a.q_sb = q_sb;
  a.out_sb = out_sb;
  a.Tl = Tl;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.q_off = q_off;
  a.k_off = k_off;
  a.first = first;
  a.last = last;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D * 2 + (q_f32 ? 1 : 0)) {
    case 128: return launch<64, false>(a, B, s);
    case 129: return launch<64, true>(a, B, s);
    case 256: return launch<128, false>(a, B, s);
    case 257: return launch<128, true>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}

// The ring's transfer: `bytes` from src on device src_dev to dst on device
// dst_dev, on `stream` (a peer copy between cards, a device copy within one).
KOIFISH_API int koifish_ring_copy(void* dst, int dst_dev, const void* src, int src_dev,
                                  long long bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dst_dev == src_dev ? cudaMemcpyAsync(dst, src, bytes, cudaMemcpyDeviceToDevice, s)
                         : cudaMemcpyPeerAsync(dst, dst_dev, src, src_dev, bytes, s);
  return err != cudaSuccess ? err : cudaGetLastError();
}
