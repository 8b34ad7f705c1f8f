// One-token GQA decode attention read through a page table from bf16 K/V
// pages, for Hopper; optionally also writes each lane's new K/V row into its
// page in the same launch.
//
// Replaces the library Pallas kernel that koifish_tpu/serve/paged.py:173-177
// (_paged_attention) calls on the TPU,
// jax.experimental.pallas.ops.tpu.paged_attention (its
// paged_flash_attention_kernel), and on the paged decode path the page write
// before it (koifish_tpu/ops/pallas/slotwrite.py:140, page_write_or_none;
// koifish_tpu/serve/paged.py:136, _page_write).
//
// Layout (serve/paged.py): one K and one V pool a layer, [Hkv, NP, 128, D]
// bf16; page_table [B, MAXP] int32; position t of lane b is row t % 128 of
// page page_table[b, t / 128]. Lane b attends over its first lengths[b]
// positions (at most MAXP·128); pages past them are never read, whatever
// ids the table holds there. Ids of live pages must lie in [0, NP) (they
// are clamped into it, so a bad id reads a wrong page, never outside the
// pool). The softmax runs in f32 on logits q·k·scale; P·V takes p as a
// pair of bf16 products, hi = bf16(p) and lo = bf16(p - hi), so p keeps
// ~16 bits where row 7 (decode_attn.cu) rounds it to 8; one rounding of
// the output to bf16 at the end, as the plain version does.
//
// What bounds it on the H100: each live position is read once (2·D bf16
// a kv head) and meets 4·g·D flops, a few flops per byte, so the bytes
// bound it; at decode sizes (a few MB to ~25 MB a layer) the latency of the
// first bytes and the bytes in flight decide the time. Design (row 7's,
// decode_attn.cu, for bf16 pages):
//   - Flash-decoding over a thread-block cluster, one launch and no
//     workspace. The grid is (splits, B·Hkv, head groups of 8); the splits of
//     one (b, kv head, head group) are one cluster (1-8 blocks, chosen on the
//     host from the grid, MAXP·128 and the SM count, never from the lengths:
//     no host sync). Each block derives its run of 64-position tiles from
//     lengths[b] on the device; ranks past the live tiles do nothing; the
//     live ranks' (m, l, o) are merged in rank order in rank 0's shared
//     memory (st.async, counted by rank 0's mbarrier): a repeated launch
//     gives the same bits.
//   - A 64-row tile lies in one page (rows (t % 2)·64 of page
//     page_table[b, t / 2]), so a tile costs one table entry: each warp
//     holds 32 of its rank's page ids in a register across its lanes and
//     reads them by shuffle. Each warp streams its own 16 rows of every tile
//     (K and V, rows padded by 16 bytes: the ldmatrix reads below are free of
//     bank conflicts) through a 2-stage cp.async ring; the loop needs no
//     block barrier.
//   - Both products run on the tensor cores (mma.sync m16n8k16, bf16 in, f32
//     accumulate) with the q heads on n8: S = K·qᵀ (A: 16 positions x 16 d
//     by ldmatrix; B: q, in registers for the whole launch) and Oᵀ = Vᵀ·Pᵀ
//     (A: 16 d x 16 positions by ldmatrix.trans; B: p's bf16 hi and lo
//     parts, two products, each moved from S's accumulator layout into B's
//     with one movmatrix transpose). The row max, the row sum and the
//     rescale stay in registers.
//   - The write (knew != null): warps 0 and 1 of every block load lane b's
//     new K and V rows of its kv head into shared memory; a warp whose
//     staged tile holds (page_ids[b], rows[b]) skips that row's copy and
//     swaps the new row in, so no block reads a row that another block
//     stores. Exactly one block per (b, kv head) stores the rows to the
//     pools: rank 0 of head group 0. A page written in a launch is read in
//     it only by the lane that writes it (each lane owns its pages, as the
//     allocator hands them out).
#include "sm90.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int NT = 32 * WARPS;
constexpr int ROWS = 16;           // rows a warp takes of each tile (one m16 tile)
constexpr int BS = WARPS * ROWS;   // positions a tile: the unit of the split (64)
constexpr int PAGE = 128;          // positions a page: two tiles
constexpr int STAGES = 2;
constexpr int GN = 8;              // q heads a block: the mma's n8
constexpr int MAX_SPLITS = 8;      // blocks a cluster
constexpr float NEG_INF = -1e30f;

template <int D>
struct Cfg {
  static constexpr int ROWB = 2 * D;         // bytes a row
  static constexpr int LD = ROWB + 16;       // staged row stride
  static constexpr int KSTEPS = D / 16;      // k16 steps of S; m16 tiles of Oᵀ
  // a warp's stage: K rows [ROWS][LD] | V rows [ROWS][LD]
  static constexpr int STAGE = 2 * ROWS * LD;
  static constexpr int RING = WARPS * STAGES * STAGE;
  static constexpr int DP = D + 4;           // f32 stride of a warp's o rows
  // a partial (m, l, o): m [GN], l [GN], o [GN][D] f32
  static constexpr int PARTF = 2 * GN + GN * D;
  static constexpr int PART = PARTF * 4;
  // the ring, reused for the warps' o once the loop is done
  static constexpr int BODY = RING > WARPS * GN * DP * 4 ? RING : WARPS * GN * DP * 4;
  static constexpr int NEWROW = BODY;        // the new rows: K | V
  static constexpr int RBAR = NEWROW + 2 * ROWB;
  static constexpr int TABLE = RBAR + 16;    // the warps' and the block's (m, l)
  static constexpr int SLOTS = TABLE + (WARPS + 1) * 2 * GN * 4;   // rank 0: [splits][PARTF]
  static constexpr size_t bytes(int splits) {
    return SLOTS + static_cast<size_t>(splits) * PART;
  }
  static_assert(ROWB % 16 == 0 && (ROWS * ROWB / 16) % 32 == 0 && STAGE % 16 == 0 &&
                    PART % 16 == 0 && SLOTS % 16 == 0,
                "paged_attn: layout");
};

struct Args {
  const bf16* q;         // [B, Hq, D]
  bf16* kp;              // [Hkv, NP, PAGE, D]
  bf16* vp;
  const int* lengths;    // [B]
  const int* table;      // [B, MAXP]
  bf16* out;             // [B, Hq, D]
  const bf16* knew;      // [B, Hkv, D]; null: attention only
  const bf16* vnew;
  const int* page_ids;   // [B]
  const int* rows;       // [B]
  int Hq, Hkv, NP, MAXP;
  float scale;
};

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a · b for one m16n8k16 tile (bf16 in, f32 accumulate). Fragments
// (g = lane / 4, t = lane % 4): a0 A[g][2t..+1], a1 A[g+8][2t..+1], a2
// A[g][2t+8..+9], a3 A[g+8][2t+8..+9]; b0 B[2t..+1][g], b1 B[2t+8..+9][g];
// d {D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]}.
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

// the bf16 pair of x - hi.x, y - hi.y, hi the bf16 pair of x, y (pack_bf16)
__device__ __forceinline__ uint32_t pack_lo(float x, float y, uint32_t hi) {
  return pack_bf16(x - __uint_as_float(hi << 16), y - __uint_as_float(hi & 0xffff0000u));
}

// the transpose of the warp's 8 x 8 bf16 matrix M, lane l holding
// M[l / 4][2(l % 4) .. +1] before and Mᵀ's entries there after
__device__ __forceinline__ uint32_t transpose8x8(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

template <int D>
__global__ void __launch_bounds__(NT) paged_attn_kernel(const Args a) {
  using C = Cfg<D>;
  constexpr int LD = C::LD, ROWB = C::ROWB, DP = C::DP;
  extern __shared__ __align__(16) unsigned char sm[];
  const int rank = blockIdx.x, nsplit = gridDim.x;
  const int bh = blockIdx.y, b = bh / a.Hkv, h = bh % a.Hkv;
  const int g = a.Hq / a.Hkv;
  const int h0 = h * g + blockIdx.z * GN;   // first q head of this block
  const int nh = min(GN, g - static_cast<int>(blockIdx.z) * GN);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gi = lane / 4, ti = lane % 4;
  const bool write = a.knew != nullptr;
  const int len = max(0, min(a.lengths[b], a.MAXP * PAGE));
  // where the new row goes (no write: page -1 matches no tile)
  const int wpid = write ? a.page_ids[b] : -1;
  const int wrow = write ? a.rows[b] : -1;
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
  int nsteps = max(0, t1 - t0);
  if (nsteps > 0 && (t1 - 1) * BS + warp * ROWS >= len) --nsteps;
  // the page ids of the rank's tiles, 32 pages a load: lane i holds the id
  // of page p0 + 32·chunk + i of the lane's table
  const int* trow = a.table + static_cast<size_t>(b) * a.MAXP;
  const int p0 = t0 / 2;
  int chunk = -1, ids = 0;
  auto page_of = [&](int t) {   // warp-uniform t
    const int pi = t / 2 - p0;
    if (pi / 32 != chunk) {
      chunk = pi / 32;
      const int p = p0 + 32 * chunk + lane;
      ids = p < a.MAXP ? trow[p] : 0;
    }
    const int pid = __shfl_sync(0xffffffffu, ids, pi % 32);
    return min(max(pid, 0), a.NP - 1);
  };
  const size_t head0 = static_cast<size_t>(h) * a.NP;   // the kv head's first page
  unsigned char* ring = sm + warp * STAGES * C::STAGE;
  // stage step k's 16 rows; returns the row that holds the new one (its
  // copy skipped) or -1
  auto fetch = [&](int k) {
    const int t = t0 + k;
    const int pid = page_of(t);
    const int base = (t & 1) * BS + warp * ROWS;   // the warp's first row in the page
    const int nv = min(ROWS, len - t * BS - warp * ROWS);
    const int skip = pid == wpid && wrow >= base && wrow < base + ROWS ? wrow - base : -1;
    unsigned char* st = ring + (k % STAGES) * C::STAGE;
    const size_t row = (head0 + pid) * PAGE + base;
    const unsigned char* ksrc = reinterpret_cast<const unsigned char*>(a.kp + row * D);
    const unsigned char* vsrc = reinterpret_cast<const unsigned char*>(a.vp + row * D);
    constexpr int CH = ROWB / 16;   // 16-byte chunks a row
    // dead rows and the new row's are zero-filled, nothing read
#pragma unroll
    for (int i = 0; i < ROWS * CH / 32; ++i) {
      const int c = lane + 32 * i, r = c / CH, cc = c % CH;
      const bool live = r < nv && r != skip;
      const int off = r * ROWB + cc * 16;
      cp_async16(st + r * LD + cc * 16, live ? ksrc + off : ksrc, live ? 16 : 0);
      cp_async16(st + (ROWS + r) * LD + cc * 16, live ? vsrc + off : vsrc, live ? 16 : 0);
    }
    cp_async_commit();
    return skip;
  };
  int skip_next = -1;
  if (nsteps > 0) skip_next = fetch(0);

  // the new rows, by warps 0 (K) and 1 (V) while the first tile streams
  // in; rank 0 of head group 0 also stores them to the pools
  unsigned char* nrow = sm + C::NEWROW;
  if (write && warp < 2) {
    const bool store = rank == 0 && blockIdx.z == 0 && wpid >= 0 && wpid < a.NP && wrow >= 0 &&
                       wrow < PAGE;
    const uint4* src = reinterpret_cast<const uint4*>((warp == 0 ? a.knew : a.vnew) +
                                                      static_cast<size_t>(bh) * D);
    uint4* dst = reinterpret_cast<uint4*>(
        (warp == 0 ? a.kp : a.vp) + ((head0 + (store ? wpid : 0)) * PAGE + (store ? wrow : 0)) * D);
    uint4* sdst = reinterpret_cast<uint4*>(nrow + warp * ROWB);
    for (int i = lane; i < ROWB / 16; i += 32) {
      const uint4 v = src[i];
      sdst[i] = v;
      if (store) dst[i] = v;
    }
  }

  // q as the B operand of S = K·qᵀ for the whole launch: lane (gi, ti)
  // holds head gi's q at d 16j + 2ti (+1) and 16j + 2ti + 8 (+9)
  uint32_t qf[C::KSTEPS][2];
  {
    const bool hv = gi < nh;
    const bf16* qrow = a.q + (static_cast<size_t>(b) * a.Hq + h0 + (hv ? gi : 0)) * D;
#pragma unroll
    for (int j = 0; j < C::KSTEPS; ++j) {
      qf[j][0] = hv ? ld32(qrow + 16 * j + 2 * ti) : 0u;
      qf[j][1] = hv ? ld32(qrow + 16 * j + 2 * ti + 8) : 0u;
    }
  }
  if (write) __syncthreads();   // the new rows are in shared memory

  // ldmatrix row addresses, matrix i = lane / 8 giving fragment register i:
  // S's A (K: 16 positions x 16 d) is rows 8(i % 2).. x d 8(i / 2)..; Oᵀ's A
  // (Vᵀ: 16 d x 16 positions, read transposed) is positions 8(i / 2).. x d
  // 8(i % 2)..
  const int kr = (lane & 7) + 8 * ((lane >> 3) & 1), kc = (lane >> 4) * 16;
  const int vr = (lane & 7) + 8 * (lane >> 4), vc = ((lane >> 3) & 1) * 16;

  // Oᵀ accumulators: tile i, rows gi / gi + 8 -> d 16i + gi / + 8, columns
  // 2ti, 2ti + 1 -> q heads; m and l of heads 2ti, 2ti + 1
  float acc[C::KSTEPS][4];
#pragma unroll
  for (int i = 0; i < C::KSTEPS; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  for (int k = 0; k < nsteps; ++k) {
    const int skip = skip_next;
    if (k + 1 < nsteps)
      skip_next = fetch(k + 1);
    else
      cp_async_commit();   // an empty group keeps the count
    cp_async_wait<STAGES - 1>();
    __syncwarp();
    unsigned char* st = ring + (k % STAGES) * C::STAGE;
    const int nv = min(ROWS, len - (t0 + k) * BS - warp * ROWS);
    if (skip >= 0) {   // swap the new rows in
      for (int i = lane; i < 2 * ROWB / 16; i += 32) {
        const int half = i / (ROWB / 16), c = i % (ROWB / 16);
        *reinterpret_cast<uint4*>(st + (half * ROWS + skip) * LD + c * 16) =
            reinterpret_cast<const uint4*>(nrow + half * ROWB)[c];
      }
      __syncwarp();
    }

    // S = K·qᵀ: rows gi, gi + 8 of the warp's 16, heads 2ti, 2ti + 1
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    const uint32_t ka = smem_u32(st + kr * LD + kc);
#pragma unroll
    for (int j = 0; j < C::KSTEPS; ++j) {
      uint32_t af[4];
      ldsm_x4<false>(af, ka + 32 * j);
      mma16816(s, af, qf[j][0], qf[j][1]);
    }
    const bool va = gi < nv, vb = gi + 8 < nv;
    const float x0 = va ? s[0] * a.scale : NEG_INF;
    const float x1 = va ? s[1] * a.scale : NEG_INF;
    const float x2 = vb ? s[2] * a.scale : NEG_INF;
    const float x3 = vb ? s[3] * a.scale : NEG_INF;
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
    // P as bf16 hi and lo parts, rows (positions) gi and gi + 8, moved into
    // B's layout: lane (gi, ti) gets positions 2ti, 2ti + 1 (and + 8) of
    // head gi
    const uint32_t h01 = pack_bf16(p0, p1), h23 = pack_bf16(p2, p3);
    const uint32_t ph0 = transpose8x8(h01), ph1 = transpose8x8(h23);
    const uint32_t pl0 = transpose8x8(pack_lo(p0, p1, h01));
    const uint32_t pl1 = transpose8x8(pack_lo(p2, p3, h23));

    // Oᵀ += Vᵀ·Pᵀ
    const uint32_t va_ = smem_u32(st + (ROWS + vr) * LD + vc);
#pragma unroll
    for (int i = 0; i < C::KSTEPS; ++i) {
      acc[i][0] *= al0;
      acc[i][1] *= al1;
      acc[i][2] *= al0;
      acc[i][3] *= al1;
      uint32_t af[4];
      ldsm_x4<true>(af, va_ + 32 * i);
      mma16816(acc[i], af, ph0, ph1);
      mma16816(acc[i], af, pl0, pl1);
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
    float* wo = reinterpret_cast<float*>(sm) + warp * GN * DP;   // [GN][DP]
#pragma unroll
    for (int i = 0; i < C::KSTEPS; ++i) {
      wo[2 * ti * DP + 16 * i + gi] = acc[i][0] * f0;
      wo[(2 * ti + 1) * DP + 16 * i + gi] = acc[i][1] * f1;
      wo[2 * ti * DP + 16 * i + gi + 8] = acc[i][2] * f0;
      wo[(2 * ti + 1) * DP + 16 * i + gi + 8] = acc[i][3] * f1;
    }
  }
  __syncthreads();
  auto fold = [&](int idx) {   // float4 idx of the block's o [GN][D]
    const int hh = idx / (D / 4), c = 4 * (idx % (D / 4));
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float* wo = reinterpret_cast<const float*>(sm) + (w * GN + hh) * DP;
      const float4 o = *reinterpret_cast<const float4*>(wo + c);
      v.x += o.x;
      v.y += o.y;
      v.z += o.z;
      v.w += o.w;
    }
    return v;
  };
  auto store = [&](int idx, float4 o, float l) {   // o / l as bf16, head idx / (D / 4)
    const int hh = idx / (D / 4), d = 4 * (idx % (D / 4));
    *reinterpret_cast<uint2*>(a.out + (static_cast<size_t>(b) * a.Hq + h0 + hh) * D + d) =
        make_uint2(pack_bf16(o.x / l, o.y / l), pack_bf16(o.z / l, o.w / l));
  };
  if (nsplit > 1) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (nlive <= 1) {   // one live rank (or none): rank 0 writes the output
    if (rank == 0)
      for (int idx = tid; idx < nh * (D / 4); idx += NT)
        store(idx, fold(idx), fmaxf(blk[GN + idx / (D / 4)], 1e-30f));
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
  for (int idx = tid; idx < nh * (D / 4); idx += NT) {
    const int hh = idx / (D / 4);
    float m = NEG_INF;
    for (int r = 0; r < nlive; ++r) m = fmaxf(m, sl[r * C::PARTF + hh]);
    float l = 0.f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < nlive; ++r) {
      const float f = expf(sl[r * C::PARTF + hh] - m);
      l += sl[r * C::PARTF + GN + hh] * f;
      const float4 v = reinterpret_cast<const float4*>(sl + r * C::PARTF + 2 * GN)[idx];
      o.x += v.x * f;
      o.y += v.y * f;
      o.z += v.z * f;
      o.w += v.w * f;
    }
    store(idx, o, fmaxf(l, 1e-30f));
  }
}

template <int D>
cudaError_t launch(const Args& a, int B, int splits, cudaStream_t stream) {
  using C = Cfg<D>;
  auto kernel = paged_attn_kernel<D>;
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

}  // namespace

// out [B, Hq, D] bf16 = decode attention of q [B, Hq, D] over the first
// lengths[b] positions of lane b, read through page_table [B, MAXP] from the
// pools k_pages / v_pages [Hkv, NP, 128, D] bf16; the live tiles are split
// over `splits` blocks of a cluster (1-8). With knew != null (then vnew,
// page_ids and rows too: [B, Hkv, D] bf16, [B] int32) lane b's new K/V rows
// are written at row rows[b] of page page_ids[b] first (in place) and the
// attention reads them there.
KOIFISH_API int koifish_paged_attn(const void* q, void* k_pages, void* v_pages,
                                   const void* lengths, const void* page_table, void* out,
                                   const void* knew, const void* vnew, const void* page_ids,
                                   const void* rows, int B, int Hq, int Hkv, int NP, int MAXP,
                                   int D, float scale, int splits, void* stream) {
  if (B < 1 || Hkv < 1 || Hq % Hkv != 0 || NP < 1 || MAXP < 1 || splits < 1 ||
      splits > MAX_SPLITS || B * Hkv > 65535 || (Hq / Hkv + GN - 1) / GN > 65535 ||
      (knew != nullptr && (vnew == nullptr || page_ids == nullptr || rows == nullptr)))
    return cudaErrorInvalidValue;
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.kp = static_cast<bf16*>(k_pages);
  a.vp = static_cast<bf16*>(v_pages);
  a.lengths = static_cast<const int*>(lengths);
  a.table = static_cast<const int*>(page_table);
  a.out = static_cast<bf16*>(out);
  a.knew = static_cast<const bf16*>(knew);
  a.vnew = static_cast<const bf16*>(vnew);
  a.page_ids = static_cast<const int*>(page_ids);
  a.rows = static_cast<const int*>(rows);
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.NP = NP;
  a.MAXP = MAXP;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(a, B, splits, s);
    case 128: return launch<128>(a, B, splits, s);
    case 256: return launch<256>(a, B, splits, s);
    default: return cudaErrorInvalidValue;
  }
}
