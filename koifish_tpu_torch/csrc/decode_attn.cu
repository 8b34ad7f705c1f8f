// One-token GQA decode attention read straight from an INT8 or packed-INT4
// KV cache, for Hopper; optionally also quantizes the new token's K/V row and
// writes it into the cache in the same launch.
//
// Replaces the Pallas kernel of koifish_tpu/ops/pallas/decode_attn.py:
// _decode_kernel_call/_decode_kernel (:179/:200), and on the decode path the
// per-token K/V quantizer (koifish_tpu/serve/kvcache.py:116, _quant_kv) and
// the slot write after it (koifish_tpu/ops/pallas/slotwrite.py:87), as the
// reference's CUDA decode writes the KV slot in place.
//
// Cache layout (serve/kvcache.py): codes [B, Hkv, S, D] int8, or
// [B, Hkv, S, D/2] uint8 for INT4 with byte i holding element i (low
// nibble) and element i + D/2 (high nibble), biased by 8; per-(position,
// head) f32 scales [B, Hkv, S]. K scales multiply the logits; V scales fold
// into p, which is rounded to bf16 before PV (as decode_attn.py:223,
// :236-238). d and dv may differ (MLA) and each is 64, 128, 192 or 256.
//
// What bounds it on the H100: each live cache position is read once (D + Dv
// code bytes plus 8 scale bytes per kv head) and meets 2·g·(D + Dv) flops,
// a few flops per byte, so the bytes bound it; at decode sizes (a few MB a
// layer) the latency of the first bytes and the number of bytes in flight
// decide the time. Design:
//   - Flash-decoding over a thread-block cluster, one launch and no
//     workspace. The grid is (splits, B·Hkv, head groups of 8); the splits
//     of one (b, kv head, head group) are one cluster (1-8 blocks, chosen on
//     the host from B·Hkv, the head groups, S and the SM count, never from
//     the lengths). Each block derives its run of 64-position tiles from
//     lengths[b] on the device; ranks past the live tiles do nothing. Every
//     block folds its 4 warps' (m, l, o) in warp order; where two or more
//     ranks are live, each stores the result into its slot in rank 0's
//     shared memory (st.async, counted in bytes by rank 0's mbarrier) and
//     rank 0 merges the slots in rank order: a repeated launch gives the
//     same bits. On an H100 one block a SM timed best: a second one (more
//     splits, 2-block clusters) cost more than it saved at B = 32 and 8.
//   - Each warp streams its own 16 rows of every tile through a 2-stage
//     cp.async ring (K rows, V rows and both scale runs a stage; rows padded
//     by 16 bytes so that every fragment read below is free of bank
//     conflicts): the next tile is in flight while the current one is
//     scored, and the loop needs no block barrier.
//   - Both products run on the tensor cores (mma.sync m16n8k16, bf16 in, f32
//     accumulate) with the q heads on n8: S = codes·qᵀ (A: 16 positions x 16
//     d of codes, converted to bf16 in registers; B: q, in registers for the
//     whole launch) and Oᵀ = Vᵀ·Pᵀ (A: 16 dv x 16 positions of V codes; B:
//     bf16(p·v_scale), moved from S's accumulator layout into B's with one
//     movmatrix transpose). Every int8 and int4 code is exact in bf16 and q
//     is bf16, so each product is exact in f32; only the order of the f32
//     sums differs from the plain version. The k order of each product is
//     permuted so that a thread's operands are whole 4-byte words of the
//     staged rows; the row max, the row sum and the rescale stay in
//     registers (the sum is folded across the warp once, at the end).
//   - The write (knew != null): every block quantizes lane b's new K and V
//     rows for its kv head (a warp reduction each, bit for bit the plain
//     quantizer as PyTorch runs it on the card: scale = max(absmax ·
//     fl(1/qmax), 1e-12), code = clamp(rint(x / scale), -qmax - 1, qmax)),
//     and the warp whose rows hold slots[b] swaps the new row into its
//     staged tile in place of the copy (which it never reads from the
//     cache), so no block depends on another block's global store. Exactly
//     one block per (b, kv head) stores the codes and scales: head group 0,
//     the rank whose tiles hold the slot.
#include "sm90.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int NT = 32 * WARPS;
constexpr int ROWS = 16;           // cache rows a warp takes of each tile (one m16 tile)
constexpr int BS = WARPS * ROWS;   // positions a tile: the unit of the split (64)
constexpr int STAGES = 2;
constexpr int GN = 8;              // q heads a block: the mma's n8
constexpr int MAX_SPLITS = 8;      // blocks a cluster
constexpr float NEG_INF = -1e30f;

template <int D, int DV, bool INT4>
struct Cfg {
  static constexpr int DKB = INT4 ? D / 2 : D;   // code bytes a cached row
  static constexpr int DVB = INT4 ? DV / 2 : DV;
  static constexpr int LDK = DKB + 16, LDV = DVB + 16;   // staged row strides
  static constexpr int KSTEPS = D / 16;                  // k16 steps of S
  static constexpr int OT = DV / 16;                     // m16 tiles of Oᵀ
  // a warp's stage: K rows [ROWS][LDK] | V rows [ROWS][LDV] | ks [ROWS] | vs [ROWS]
  static constexpr int STAGE = ROWS * (LDK + LDV) + 2 * ROWS * 4;
  static constexpr int RING = WARPS * STAGES * STAGE;
  // a partial (m, l, o): m [GN], l [GN], o [GN][DV] f32
  static constexpr int PARTF = 2 * GN + GN * DV;
  static constexpr int PART = PARTF * 4;
  // the ring, reused for the warps' o once the loop is done
  static constexpr int BODY = RING > WARPS * GN * DV * 4 ? RING : WARPS * GN * DV * 4;
  static constexpr int NEWROW = BODY;   // the new row: K codes | V codes | ks | vs
  static constexpr int RBAR = NEWROW + ((DKB + DVB + 8 + 15) / 16) * 16;
  static constexpr int TABLE = RBAR + 16;   // the warps' and the block's (m, l)
  static constexpr int SLOTS = TABLE + (WARPS + 1) * 2 * GN * 4;   // rank 0: [splits][PARTF]
  static constexpr size_t bytes(int splits) {
    return SLOTS + static_cast<size_t>(splits) * PART;
  }
  static_assert(DKB % 32 == 0 && DVB % 32 == 0 && STAGE % 16 == 0 && PART % 16 == 0,
                "decode_attn: layout");
};

struct Args {
  const bf16* q;
  uint8_t* kc;
  uint8_t* vc;
  float* ks;
  float* vs;
  const int* lengths;
  bf16* out;
  const bf16* knew;   // null: attention only
  const bf16* vnew;
  const int* slots;
  int Hq, Hkv, S;
  float scale;
};

__device__ __forceinline__ uint32_t ld32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a · b for one m16n8k16 tile (bf16 in, f32 accumulate). Fragments
// (g = lane / 4, t = lane % 4): a0 A[g][2t..+1], a1 A[g+8][2t..+1], a2
// A[g][2t+8..+9], a3 A[g+8][2t+8..+9]; b0 B[2t..+1][g], b1 B[2t+8..+9][g];
// d {D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]}.
__device__ __forceinline__ void mma16816(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// the transpose of the warp's 8 x 8 bf16 matrix M, lane l holding
// M[l / 4][2(l % 4) .. +1] before and Mᵀ's entries there after
__device__ __forceinline__ uint32_t transpose8x8(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// byte `sel` (0x7440 + i: byte i) of u = codes ^ 0x80808080 as the exact f32
// of the int8 code: the bits of 2^23 + (code + 128), less 2^23 + 128
__device__ __forceinline__ float s8f(uint32_t u, uint32_t sel) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, sel)) - 8388736.f;
}

// two f32 small integers as a bf16 pair (x in the low half): their upper
// halves, exact because their lower 16 bits are zero
__device__ __forceinline__ uint32_t bf16x2_exact(float x, float y) {
  return __byte_perm(__float_as_uint(x), __float_as_uint(y), 0x7632);
}

// the INT4 codes (stored c + 8) in bits 0-3 and 16-19 of x as the bf16 pair
// c: the bf16 128 + (c + 8), less 136 (exact)
__device__ __forceinline__ uint32_t nib_pair(uint32_t x) {
  const uint32_t m = (x & 0x000F000Fu) | 0x43004300u;
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(m), "r"(0x3F803F80u), "r"(0xC308C308u));
  return r;
}

// prmt selector: byte i of the first word to byte 0, byte i of the second to byte 2
__device__ __forceinline__ uint32_t pair_sel(int i) {
  return static_cast<uint32_t>(i | (i << 4) | ((4 + i) << 8) | ((4 + i) << 12));
}

// One row of N values (the new token's K or V for one kv head) quantized by
// one warp as the plain quantizer does on the card, into `codes` (shared
// memory: N int8 codes, or N/2 INT4 bytes block-split) and `*scale`; the
// same bytes also to `gcodes` / `gscale` when they are not null.
template <int N, bool INT4>
__device__ __forceinline__ void quant_row(const bf16* __restrict__ x, unsigned char* codes,
                                          float* scale, uint8_t* gcodes, float* gscale) {
  constexpr int PER = N / 32;
  constexpr float QMAX = INT4 ? 7.f : 127.f;
  const int lane = threadIdx.x % 32;
  float v[PER];
  float am = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    v[i] = __bfloat162float(x[lane + 32 * i]);
    am = fmaxf(am, fabsf(v[i]));
  }
  am = warp_max(am);
  // PyTorch's CUDA division by a Python scalar multiplies by its f32
  // reciprocal; the division by the scale tensor divides
  const float s = fmaxf(__fmul_rn(am, __fdiv_rn(1.0f, QMAX)), 1e-12f);
  int c[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i)
    c[i] = static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(v[i], s)), -QMAX - 1.f), QMAX));
  // element d = lane + 32 i; its INT4 partner d + N/2 is element i + PER/2
  constexpr int NB = INT4 ? PER / 2 : PER;
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const uint8_t byte = INT4 ? static_cast<uint8_t>((c[i] + 8) | ((c[i + NB] + 8) << 4))
                              : static_cast<uint8_t>(static_cast<int8_t>(c[i]));
    codes[lane + 32 * i] = byte;
    if (gcodes != nullptr) gcodes[lane + 32 * i] = byte;
  }
  if (lane == 0) {
    *scale = s;
    if (gscale != nullptr) *gscale = s;
  }
}

template <int D, int DV, bool INT4>
__global__ void __launch_bounds__(NT) decode_attn_kernel(const Args a) {
  using C = Cfg<D, DV, INT4>;
  constexpr int DKB = C::DKB, DVB = C::DVB, LDK = C::LDK, LDV = C::LDV;
  extern __shared__ __align__(16) unsigned char sm[];
  const int rank = blockIdx.x, nsplit = gridDim.x;
  const int bh = blockIdx.y, b = bh / a.Hkv;
  const int g = a.Hq / a.Hkv;
  const int h0 = (bh % a.Hkv) * g + blockIdx.z * GN;   // first q head of this block
  const int nh = min(GN, g - static_cast<int>(blockIdx.z) * GN);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gi = lane / 4, ti = lane % 4;
  const bool write = a.knew != nullptr;
  const int S = a.S;
  const int len = max(0, min(a.lengths[b], S));
  const int slot = write ? a.slots[b] : -1;
  // this rank's tiles [t0, t1) of the ntiles live ones; nlive ranks have any
  const int ntiles = (len + BS - 1) / BS;
  const int tpr = max(1, (ntiles + nsplit - 1) / nsplit);
  const int t0 = rank * tpr, t1 = min(ntiles, t0 + tpr);
  const int nlive = min(nsplit, (ntiles + tpr - 1) / tpr);
  uint64_t* rbar = reinterpret_cast<uint64_t*>(sm + C::RBAR);
  if (nsplit > 1) {
    if (rank == 0 && tid == 0) {
      mbar_init(rbar, 1);
      mbar_fence_init();
      mbar_arrive_expect_tx(rbar, static_cast<uint32_t>(max(0, nlive - 1) * C::PART));
    }
    // arrive now, wait before the first store into rank 0: every block of
    // the cluster has started and rank 0's barrier is set up
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  }

  // this warp's steps: the tiles of [t0, t1) whose rows reach its 16
  const size_t row0 = static_cast<size_t>(bh) * S;
  int nsteps = max(0, t1 - t0);
  if (nsteps > 0 && (t1 - 1) * BS + warp * ROWS >= len) --nsteps;
  unsigned char* ring = sm + warp * STAGES * C::STAGE;
  auto fetch = [&](int k) {
    const int r0 = (t0 + k) * BS + warp * ROWS;
    const int nv = min(ROWS, len - r0);
    unsigned char* st = ring + (k % STAGES) * C::STAGE;
    const uint8_t* ksrc = a.kc + (row0 + r0) * DKB;
    const uint8_t* vsrc = a.vc + (row0 + r0) * DVB;
    // dead rows and the slot's row are zero-filled, nothing read
#pragma unroll
    for (int i = 0; i < DKB / 32; ++i) {
      const int c = lane + 32 * i, r = c / (DKB / 16), cc = c % (DKB / 16);
      const bool live = r < nv && r0 + r != slot;
      cp_async16(st + r * LDK + cc * 16, live ? ksrc + r * DKB + cc * 16 : ksrc, live ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < DVB / 32; ++i) {
      const int c = lane + 32 * i, r = c / (DVB / 16), cc = c % (DVB / 16);
      const bool live = r < nv && r0 + r != slot;
      cp_async16(st + ROWS * LDK + r * LDV + cc * 16, live ? vsrc + r * DVB + cc * 16 : vsrc,
                 live ? 16 : 0);
    }
    const int r = lane % ROWS;
    const bool live = r < nv && r0 + r != slot;
    const float* src = (lane < ROWS ? a.ks : a.vs) + row0 + r0 + (live ? r : 0);
    cp_async4(st + ROWS * (LDK + LDV) + lane * 4, src, live ? 4 : 0);
    cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {
    if (k < nsteps)
      fetch(k);
    else
      cp_async_commit();   // an empty group keeps the count
  }

  // the new row, quantized by warps 0 (K) and 1 (V) while the first tile
  // streams in; the block of head group 0 whose tiles hold the slot also
  // stores it to the cache
  unsigned char* nrow = sm + C::NEWROW;
  float* nscale = reinterpret_cast<float*>(nrow + DKB + DVB);
  if (write && warp < 2) {
    const int owner = min(nsplit - 1, (slot / BS) / tpr);
    const bool store = blockIdx.z == 0 && rank == owner && slot >= 0 && slot < S;
    const size_t at = row0 + (store ? slot : 0);
    if (warp == 0)
      quant_row<D, INT4>(a.knew + static_cast<size_t>(bh) * D, nrow, nscale,
                         store ? a.kc + at * DKB : nullptr, store ? a.ks + at : nullptr);
    else
      quant_row<DV, INT4>(a.vnew + static_cast<size_t>(bh) * DV, nrow + DKB, nscale + 1,
                          store ? a.vc + at * DVB : nullptr, store ? a.vs + at : nullptr);
  }

  // q as the B operand of S = codes·qᵀ for the whole launch: lane (gi, ti)
  // holds head gi's q at the d of its k slots. The k order is permuted so
  // that a lane's A operand is one 4-byte word of a staged row at byte
  // c = 16j + 4ti: INT8 step j takes d (c, c+1 | c+2, c+3); INT4 word j
  // gives two steps, the low nibbles d (c, c+2 | c+1, c+3) and the high
  // ones the same + D/2.
  uint32_t qf[C::KSTEPS][2];
  {
    const bool hv = gi < nh;
    const bf16* qrow = a.q + (static_cast<size_t>(b) * a.Hq + h0 + (hv ? gi : 0)) * D;
#pragma unroll
    for (int j = 0; j < DKB / 16; ++j) {
      const int c = 16 * j + 4 * ti;
      if constexpr (INT4) {
        const uint2 lo = hv ? *reinterpret_cast<const uint2*>(qrow + c) : make_uint2(0u, 0u);
        const uint2 hi = hv ? *reinterpret_cast<const uint2*>(qrow + c + D / 2) : make_uint2(0u, 0u);
        qf[2 * j][0] = __byte_perm(lo.x, lo.y, 0x5410);
        qf[2 * j][1] = __byte_perm(lo.x, lo.y, 0x7632);
        qf[2 * j + 1][0] = __byte_perm(hi.x, hi.y, 0x5410);
        qf[2 * j + 1][1] = __byte_perm(hi.x, hi.y, 0x7632);
      } else {
        const uint2 v = hv ? *reinterpret_cast<const uint2*>(qrow + c) : make_uint2(0u, 0u);
        qf[j][0] = v.x;
        qf[j][1] = v.y;
      }
    }
  }
  if (write) __syncthreads();   // the new row is in shared memory

  // Oᵀ accumulators: tile 2W + e, rows gi / gi + 8 -> dv 32W + 4gi + 2e / +1,
  // columns 2ti, 2ti + 1 -> q heads; m and l of heads 2ti, 2ti + 1
  float acc[C::OT][4];
#pragma unroll
  for (int i = 0; i < C::OT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  for (int k = 0; k < nsteps; ++k) {
    if (k + STAGES - 1 < nsteps)
      fetch(k + STAGES - 1);
    else
      cp_async_commit();   // an empty group keeps the count
    cp_async_wait<STAGES - 1>();
    __syncwarp();
    unsigned char* st = ring + (k % STAGES) * C::STAGE;
    const int r0 = (t0 + k) * BS + warp * ROWS;
    const int nv = min(ROWS, len - r0);
    const unsigned char* Ks = st;
    const unsigned char* Vs = st + ROWS * LDK;
    float* kss = reinterpret_cast<float*>(st + ROWS * (LDK + LDV));
    const float* vss = kss + ROWS;
    if (write && slot >= r0 && slot < r0 + nv) {   // swap the new row in
      const int r = slot - r0;
      for (int i = lane; i < DKB / 4; i += 32)
        reinterpret_cast<uint32_t*>(st + r * LDK)[i] = reinterpret_cast<const uint32_t*>(nrow)[i];
      for (int i = lane; i < DVB / 4; i += 32)
        reinterpret_cast<uint32_t*>(st + ROWS * LDK + r * LDV)[i] =
            reinterpret_cast<const uint32_t*>(nrow + DKB)[i];
      if (lane < 2) kss[r + lane * ROWS] = nscale[lane];
      __syncwarp();
    }

    // S = codes·qᵀ: rows gi, gi + 8 of the warp's 16, heads 2ti, 2ti + 1
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < DKB / 16; ++j) {
      const uint32_t w0 = ld32(Ks + gi * LDK + 16 * j + 4 * ti);
      const uint32_t w1 = ld32(Ks + (gi + 8) * LDK + 16 * j + 4 * ti);
      if constexpr (INT4) {
        mma16816(s, nib_pair(w0), nib_pair(w1), nib_pair(w0 >> 8), nib_pair(w1 >> 8),
                 qf[2 * j][0], qf[2 * j][1]);
        mma16816(s, nib_pair(w0 >> 4), nib_pair(w1 >> 4), nib_pair(w0 >> 12), nib_pair(w1 >> 12),
                 qf[2 * j + 1][0], qf[2 * j + 1][1]);
      } else {
        const uint32_t u0 = w0 ^ 0x80808080u, u1 = w1 ^ 0x80808080u;
        mma16816(s, bf16x2_exact(s8f(u0, 0x7440), s8f(u0, 0x7441)),
                 bf16x2_exact(s8f(u1, 0x7440), s8f(u1, 0x7441)),
                 bf16x2_exact(s8f(u0, 0x7442), s8f(u0, 0x7443)),
                 bf16x2_exact(s8f(u1, 0x7442), s8f(u1, 0x7443)), qf[j][0], qf[j][1]);
      }
    }
    const bool va = gi < nv, vb = gi + 8 < nv;
    const float ka = kss[gi], kb = kss[gi + 8];
    const float x0 = va ? s[0] * ka * a.scale : NEG_INF;
    const float x1 = va ? s[1] * ka * a.scale : NEG_INF;
    const float x2 = vb ? s[2] * kb * a.scale : NEG_INF;
    const float x3 = vb ? s[3] * kb * a.scale : NEG_INF;
    float mx0 = fmaxf(x0, x2), mx1 = fmaxf(x1, x3);
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    const float p0 = expf(x0 - mn0), p1 = expf(x1 - mn1);
    const float p2 = expf(x2 - mn0), p3 = expf(x3 - mn1);
    l0 = l0 * al0 + (p0 + p2);
    l1 = l1 * al1 + (p1 + p3);
    // P·v_scale in bf16, rows (positions) gi and gi + 8, moved into B's
    // layout: lane (gi, ti) gets positions 2ti, 2ti + 1 (and + 8) of head gi
    const float sa = vss[gi], sb = vss[gi + 8];
    const uint32_t pb0 = transpose8x8(pack_bf16(p0 * sa, p1 * sa));
    const uint32_t pb1 = transpose8x8(pack_bf16(p2 * sb, p3 * sb));
#pragma unroll
    for (int i = 0; i < C::OT; ++i) {
      acc[i][0] *= al0;
      acc[i][1] *= al1;
      acc[i][2] *= al0;
      acc[i][3] *= al1;
    }

    // Oᵀ += Vᵀ·Pᵀ: lane (gi, ti) reads the word at byte 4gi of each 32-byte
    // block of rows 2ti, 2ti + 1, 2ti + 8, 2ti + 9
    const unsigned char* vr = Vs + 2 * ti * LDV + 4 * gi;
#pragma unroll
    for (int wc = 0; wc < DVB / 32; ++wc) {
      const uint32_t wa = ld32(vr + 32 * wc), wb = ld32(vr + LDV + 32 * wc);
      const uint32_t wcc = ld32(vr + 8 * LDV + 32 * wc), wd = ld32(vr + 9 * LDV + 32 * wc);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if constexpr (INT4) {
          const uint32_t xa = __byte_perm(wa, wb, pair_sel(2 * e));
          const uint32_t xb = __byte_perm(wa, wb, pair_sel(2 * e + 1));
          const uint32_t xc = __byte_perm(wcc, wd, pair_sel(2 * e));
          const uint32_t xd = __byte_perm(wcc, wd, pair_sel(2 * e + 1));
          mma16816(acc[2 * wc + e], nib_pair(xa), nib_pair(xb), nib_pair(xc), nib_pair(xd), pb0,
                   pb1);
          mma16816(acc[DV / 32 + 2 * wc + e], nib_pair(xa >> 4), nib_pair(xb >> 4),
                   nib_pair(xc >> 4), nib_pair(xd >> 4), pb0, pb1);
        } else {
          const uint32_t ua = wa ^ 0x80808080u, ub = wb ^ 0x80808080u;
          const uint32_t uc = wcc ^ 0x80808080u, ud = wd ^ 0x80808080u;
          const uint32_t s0 = 0x7440 + 2 * e, s1 = s0 + 1;
          mma16816(acc[2 * wc + e], bf16x2_exact(s8f(ua, s0), s8f(ub, s0)),
                   bf16x2_exact(s8f(ua, s1), s8f(ub, s1)), bf16x2_exact(s8f(uc, s0), s8f(ud, s0)),
                   bf16x2_exact(s8f(uc, s1), s8f(ud, s1)), pb0, pb1);
        }
      }
    }
    __syncwarp();   // every lane is done with the stage before it is refilled
  }
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }

  // The block's partial: the warps' (m, l) through the table, each lane's
  // factors from them, each warp's o times its factor into the ring (every
  // warp is done with it), summed in warp order.
  float* tab = reinterpret_cast<float*>(sm + C::TABLE);   // [WARPS][m | l][GN]
  float* blk = tab + WARPS * 2 * GN;                       // the block's [m | l][GN]
  if (gi == 0) {
    tab[warp * 2 * GN + 2 * ti] = m0;
    tab[warp * 2 * GN + 2 * ti + 1] = m1;
    tab[warp * 2 * GN + GN + 2 * ti] = l0;
    tab[warp * 2 * GN + GN + 2 * ti + 1] = l1;
  }
  __syncthreads();
  {
    float M0 = NEG_INF, M1 = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      M0 = fmaxf(M0, tab[w * 2 * GN + 2 * ti]);
      M1 = fmaxf(M1, tab[w * 2 * GN + 2 * ti + 1]);
    }
    if (warp == 0 && gi == 0) {
      float L0 = 0.f, L1 = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        L0 += tab[w * 2 * GN + GN + 2 * ti] * expf(tab[w * 2 * GN + 2 * ti] - M0);
        L1 += tab[w * 2 * GN + GN + 2 * ti + 1] * expf(tab[w * 2 * GN + 2 * ti + 1] - M1);
      }
      blk[2 * ti] = M0;
      blk[2 * ti + 1] = M1;
      blk[GN + 2 * ti] = L0;
      blk[GN + 2 * ti + 1] = L1;
    }
    const float f0 = expf(m0 - M0), f1 = expf(m1 - M1);
    float* wo = reinterpret_cast<float*>(sm) + warp * GN * DV;
#pragma unroll
    for (int W = 0; W < DV / 32; ++W) {
      *reinterpret_cast<float4*>(wo + 2 * ti * DV + 32 * W + 4 * gi) =
          make_float4(acc[2 * W][0] * f0, acc[2 * W][2] * f0, acc[2 * W + 1][0] * f0,
                      acc[2 * W + 1][2] * f0);
      *reinterpret_cast<float4*>(wo + (2 * ti + 1) * DV + 32 * W + 4 * gi) =
          make_float4(acc[2 * W][1] * f1, acc[2 * W][3] * f1, acc[2 * W + 1][1] * f1,
                      acc[2 * W + 1][3] * f1);
    }
  }
  __syncthreads();
  auto fold = [&](int idx) {   // float4 idx of the block's o [GN][DV]
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float4 o = reinterpret_cast<const float4*>(sm)[w * (GN * DV / 4) + idx];
      v.x += o.x;
      v.y += o.y;
      v.z += o.z;
      v.w += o.w;
    }
    return v;
  };
  auto store = [&](int idx, float4 o, float l) {   // o / l as bf16, head idx / (DV / 4)
    const int h = idx / (DV / 4), d = 4 * (idx % (DV / 4));
    *reinterpret_cast<uint2*>(a.out + (static_cast<size_t>(b) * a.Hq + h0 + h) * DV + d) =
        make_uint2(pack_bf16(o.x / l, o.y / l), pack_bf16(o.z / l, o.w / l));
  };
  if (nsplit > 1) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (nlive <= 1) {   // one live rank (or none): rank 0 writes the output
    if (rank == 0)
      for (int idx = tid; idx < nh * (DV / 4); idx += NT)
        store(idx, fold(idx), fmaxf(blk[GN + idx / (DV / 4)], 1e-30f));
    return;
  }

  // Several live ranks: each stores its partial into its slot in rank 0's
  // shared memory (rank 0 in place, the others by st.async, counted by
  // rank 0's barrier); rank 0 merges the slots in rank order.
  float4* slots = reinterpret_cast<float4*>(sm + C::SLOTS);
  if (rank < nlive) {
    for (int idx = tid; idx < C::PARTF / 4; idx += NT) {
      const float4 v = idx < 4 ? reinterpret_cast<const float4*>(blk)[idx] : fold(idx - 4);
      if (rank == 0)
        slots[idx] = v;
      else
        st_async_in(slots + rank * (C::PARTF / 4) + idx, rbar, 0, v);
    }
  }
  if (rank != 0) return;
  __syncthreads();      // slot 0 is written
  mbar_wait(rbar, 0);   // every other live rank's slot has landed
  const float* sl = reinterpret_cast<const float*>(sm + C::SLOTS);
  for (int idx = tid; idx < nh * (DV / 4); idx += NT) {
    const int h = idx / (DV / 4);
    float m = NEG_INF;
    for (int r = 0; r < nlive; ++r) m = fmaxf(m, sl[r * C::PARTF + h]);
    float l = 0.f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < nlive; ++r) {
      const float f = expf(sl[r * C::PARTF + h] - m);
      l += sl[r * C::PARTF + GN + h] * f;
      const float4 v = reinterpret_cast<const float4*>(sl + r * C::PARTF + 2 * GN)[idx];
      o.x += v.x * f;
      o.y += v.y * f;
      o.z += v.z * f;
      o.w += v.w * f;
    }
    store(idx, o, fmaxf(l, 1e-30f));
  }
}

template <int D, int DV, bool INT4>
cudaError_t launch(const Args& a, int B, int splits, cudaStream_t stream) {
  using C = Cfg<D, DV, INT4>;
  auto kernel = decode_attn_kernel<D, DV, INT4>;
  static cudaError_t attr = set_smem(kernel, C::bytes(MAX_SPLITS));
  if (attr != cudaSuccess) return attr;
  const int g = a.Hq / a.Hkv;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, B * a.Hkv, (g + GN - 1) / GN);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = C::bytes(splits);
  cfg.stream = stream;
  cudaLaunchAttribute la[1];
  la[0].id = cudaLaunchAttributeClusterDimension;
  la[0].val.clusterDim.x = splits;
  la[0].val.clusterDim.y = 1;
  la[0].val.clusterDim.z = 1;
  cfg.attrs = la;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int D, bool INT4>
cudaError_t launch_dv(int DV, const Args& a, int B, int splits, cudaStream_t s) {
  switch (DV) {
    case 64: return launch<D, 64, INT4>(a, B, splits, s);
    case 128: return launch<D, 128, INT4>(a, B, splits, s);
    case 192: return launch<D, 192, INT4>(a, B, splits, s);
    case 256: return launch<D, 256, INT4>(a, B, splits, s);
    default: return cudaErrorInvalidValue;
  }
}

template <bool INT4>
cudaError_t launch_d(int D, int DV, const Args& a, int B, int splits, cudaStream_t s) {
  switch (D) {
    case 64: return launch_dv<64, INT4>(DV, a, B, splits, s);
    case 128: return launch_dv<128, INT4>(DV, a, B, splits, s);
    case 192: return launch_dv<192, INT4>(DV, a, B, splits, s);
    case 256: return launch_dv<256, INT4>(DV, a, B, splits, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// out [B, Hq, DV] bf16 = decode attention of q [B, Hq, D] over the first
// lengths[b] rows of the cache; the live rows are split over `splits` blocks
// of a cluster (1-8). With knew != null (then vnew and slots too: [B, Hkv,
// D] and [B, Hkv, DV] bf16, [B] int32) the new row of lane b is quantized
// and written at row slots[b] of the cache first (codes and scales, in
// place) and the attention reads it there.
KOIFISH_API int koifish_decode_attn(const void* q, void* kc, void* vc, void* ks, void* vs,
                                    const void* lengths, void* out, const void* knew,
                                    const void* vnew, const void* slots, int B, int Hq, int Hkv,
                                    int S, int D, int DV, int int4, float scale, int splits,
                                    void* stream) {
  if (B < 1 || Hkv < 1 || Hq % Hkv != 0 || S < 1 || splits < 1 || splits > MAX_SPLITS ||
      B * Hkv > 65535 || (knew != nullptr && (vnew == nullptr || slots == nullptr)))
    return cudaErrorInvalidValue;
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.kc = static_cast<uint8_t*>(kc);
  a.vc = static_cast<uint8_t*>(vc);
  a.ks = static_cast<float*>(ks);
  a.vs = static_cast<float*>(vs);
  a.lengths = static_cast<const int*>(lengths);
  a.out = static_cast<bf16*>(out);
  a.knew = static_cast<const bf16*>(knew);
  a.vnew = static_cast<const bf16*>(vnew);
  a.slots = static_cast<const int*>(slots);
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.S = S;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int4 ? launch_d<true>(D, DV, a, B, splits, s) : launch_d<false>(D, DV, a, B, splits, s);
}
