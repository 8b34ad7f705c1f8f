// One step of the sequence-parallel ring attention for Hopper, for every
// rank that shares the card: each rank's query chunk against the K/V chunk
// in its slot, the online softmax's (o, m, l) carried in f32 device memory
// from one launch to the next, and the chunk passed on to the right
// neighbour's other slot from the same shared-memory tiles.
//
// Replaces koifish_tpu/parallel/ring_pallas.py:152 (ring_attention_pallas,
// kernel body _ring_kernel at :41). The TPU kernel runs the whole ring in
// one kernel a device: each step it starts a remote DMA of the chunk in
// hand to the right neighbour's other VMEM slot, attends over the chunk,
// acks the slot to the left neighbour and waits for its DMA. Here the host
// drives the ring (ops/kernels/ring_attn.py): one launch a step on each
// card's stream takes every rank of that card with work at that step, and
// the next step's launch on the same stream orders the slots' reuse (step s
// reads slot s % 2 and writes the neighbours' other slot, which they last
// read at step s - 1). Kernels of ranks that share a card need not be
// co-resident, so nothing here waits on another block or launch.
//
// What it computes, as the TPU kernel does: q and K in bf16 for the dot,
// logits q·kᵀ·scale in f32, masked where kpos > qpos (qpos = q_off + row,
// kpos = k_off + key), an online softmax in f32 with p rounded to bf16 for
// P·V (f32 accumulate), and, at a rank's last launch (`last`), o / max(l,
// 1e-30) in q's dtype, written straight into the caller's output rows. The
// TPU kernel updates (m, l) once a chunk; this one once a 128-key tile (the
// plain version in ring_attn.py does the same), in base 2: m is kept as
// max(q·k)·scale·log2(e) and p = 2^(q·k·scale·log2(e) - m), one FMA and one
// ex2 an entry, the scale folded in f32 after the dot (never into bf16 q).
// A rank's first launch (`first`) starts from o = 0, m = -1e30, l = 0
// without reading the state; it is the diagonal chunk (k_off == q_off), so
// every row's first tile holds a live key and m is finite from then on.
//
// What bounds it on the H100: 4·D flops a (query, key) pair on the tensor
// cores against 2·D bytes a key (K and V, read once a kv head through the
// shared tiles) and the state's (D + 2)·4 bytes a query row read and
// written a launch: the operations (~0.28 ms for the causal pairs of
// T 8192 at 989 TFLOP/s); the state is the design's own traffic.
//
// Design. A persistent launch of one 384-thread block an SM. A work item is
// (rank, batch, kv head, tile of packed rows): the TPU kernel's packing of a
// kv head's g q heads into (position, group member) rows, P = 128 / g
// positions a tile (g·P <= 128 rows; the last tile of a chunk is ragged),
// so every K/V tile is staged once for all g heads that read it. Items are
// numbered heaviest first (the last packed rows see the most keys), the
// order ring_attn.plan mirrors on the host. The producer warpgroup loads an
// item's q tile into the B128-swizzled q buffer (bf16 q by one 5-d TMA box
// of P positions x g heads a 64-column block; f32 q by its 128 threads,
// converted to bf16 on the way) and one of its threads streams the item's
// live 128-key K/V tiles from the rank's slot by TMA through a 3-stage ring
// of full and empty mbarriers that runs on across items. Two consumer
// warpgroups take 64 rows each: S = q·Kᵀ by wgmma into registers, the
// softmax in registers (the tiles with no masked entry of the warpgroup's
// rows in a loop without the mask; O is rescaled only when a row max of
// the warp moved), p as bf16 register fragments for O += P·V by wgmma, V
// read MN-major from the same tile. A warpgroup issues tile i's S product
// together with tile i-1's P·V (FA3's intra-warpgroup overlap), so its
// softmax of tile i runs while that P·V holds the tensor cores; nothing is
// in flight across a branch (ptxas would serialise the wgmmas). The two
// warpgroups take turns to issue (named barriers, ping-pong); on the H100
// the overlap made the ring faster and the turns alone did not measurably
// (PERF.md §6). The send: the item with a
// (rank, batch, kv head)'s last packed rows reads every K/V tile of the
// chunk, and another producer thread stores each of its tiles by TMA from
// shared memory into the right neighbour's other slot (when the neighbour
// lies on this card) before the stage is released: n(n-1)/2 chunk
// transfers a ring, none of them a separate copy.
#include "flash_ws.cuh"

#include <cmath>
#include <type_traits>

namespace {

constexpr int MAX_RANKS = 16;   // ranks a launch (its parameters stay under 4 KB)
constexpr float NEG_INF = -1e30f;

template <int D>
struct RingLy {
  static constexpr int BQ = 128, BN = 128, STAGES = 3;
  static constexpr uint32_t Q_TILE = BQ * D * 2, KV_TILE = BN * D * 2;
  // one q buffer (refilled once both warpgroups' last S product of an item
  // is done), then the K/V ring
  static constexpr uint32_t Q = 0, STAGE0 = Q_TILE;
  static constexpr uint32_t SK = 0, SV = KV_TILE, STAGE = 2 * KV_TILE;
  // full[S], empty[S], qfull, qempty
  static constexpr uint32_t BAR = STAGE0 + STAGES * STAGE;
  static constexpr uint32_t ALLOC = BAR + 8 * (2 * STAGES + 2) + 1024;
  static_assert(ALLOC <= 232448, "ring_attn: shared memory");
};

// One rank's part of a launch (the host's ring_attn._Rank has this layout).
struct Rank {
  const void* q;     // [B, Tl, Hq, D] bf16 or f32, rows contiguous, batch stride q_sb
  float* o;          // [B, Hkv, Tl·g, D] f32: the carried state, packed rows
  float* m;          // [B, Hkv, Tl·g] f32 (base-2 logits)
  float* l;          // [B, Hkv, Tl·g] f32
  void* out;         // [B, Tl, Hq, D] in q's dtype, batch stride out_sb (at `last`)
  long long q_sb, out_sb;
  int q_off, k_off;  // positions of the rank's rows and of the chunk it holds
  int slot, send;    // slot row read; slot row its chunk goes to (-1: none)
  int first, last;
};

struct Params {
  CUtensorMap qmap[MAX_RANKS];   // bf16 q: boxes of 64 columns x g heads x P positions
  CUtensorMap kmap, vmap;        // the card's slots [rows·B, Tl, Hkv, D]: boxes of 64 x 128 keys
  Rank rank[MAX_RANKS];
  int n_ranks, B, Tl, Hq, Hkv, g, P, NT;
  float sl2;                     // scale·log2(e)
};

// A work item: rank r's packed rows [p0, p0 + rows) of batch b and kv head
// hk (tile t of the chunk's NT), and its n live kv tiles (from the first);
// `send`: it holds the last rows, so it reads every tile and forwards them.
struct Item {
  int r, b, hk, t, p0, rows, n;
  bool send;
};

template <int BN>
__device__ __forceinline__ Item item_of(const Params& p, int w) {
  const int per = p.n_ranks * p.B * p.Hkv;
  Item it;
  it.t = p.NT - 1 - w / per;
  const int x = w % per;
  it.hk = x % p.Hkv;
  it.b = (x / p.Hkv) % p.B;
  it.r = x / (p.Hkv * p.B);
  const int t0 = it.t * p.P, t1 = min(t0 + p.P, p.Tl) - 1;
  it.p0 = t0 * p.g;
  it.rows = (t1 - t0 + 1) * p.g;
  const Rank& rk = p.rank[it.r];
  // key k of the chunk is live for position t iff k <= t + q_off - k_off
  it.n = min((p.Tl + BN - 1) / BN, (rk.q_off - rk.k_off + t1) / BN + 1);
  it.send = rk.send >= 0 && it.t == p.NT - 1;
  return it;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// a row's max and sum over the 4 threads of a quad that hold it
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The item's f32 q rows rounded to bf16 into the swizzled q tile (packed row
// rr: position (p0 + rr) / g, q head hk·g + (p0 + rr) % g); rows past the
// item are zero. Thread i0 of 128.
template <int D>
__device__ __forceinline__ void load_q_f32(unsigned char* tile, const Params& p, const Item& it,
                                           int i0) {
  constexpr int CH = D / 8;
  const Rank& rk = p.rank[it.r];
  const float* q = static_cast<const float*>(rk.q) + it.b * rk.q_sb;
#pragma unroll 1
  for (int i = i0; i < 128 * CH; i += 128) {
    const int rr = i / CH, c = i % CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (rr < it.rows) {
      const int pr = it.p0 + rr, t = pr / p.g;
      const float4* src = reinterpret_cast<const float4*>(
          q + (static_cast<long long>(t) * p.Hq + it.hk * p.g + (pr - t * p.g)) * D + c * 8);
      const float4 a = src[0], b = src[1];
      val = make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(b.x, b.y),
                       pack_bf16(b.z, b.w));
    }
    *reinterpret_cast<uint4*>(tile + sw128(rr, c, 128)) = val;
  }
}

// Named barriers: 1 the producer warpgroup (f32 q), 2 + w warpgroup w's
// turn to issue its S product.
constexpr int BAR_PRODUCER = 1, BAR_TURN = 2;

template <int D, bool QF32>
__global__ void __launch_bounds__(WS_THREADS, 1) ring_step_kernel(const __grid_constant__ Params p) {
  using LY = RingLy<D>;
  constexpr int BQ = LY::BQ, BN = LY::BN, S = LY::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_aligned(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + LY::BAR);
  uint64_t* empty = full + S;
  uint64_t* qfull = empty + S;
  uint64_t* qempty = qfull + 1;
  const int items = p.n_ranks * p.B * p.Hkv * p.NT;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 9);   // the 8 consumer warps and the send thread
    }
    mbar_init(qfull, 1);
    mbar_init(qempty, 8);
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, t128 = threadIdx.x % 128;
  if (wg == 2) {   // producer: thread 0 loads, thread 32 sends
    setmaxnreg_dec<PRODUCER_REGS>();
    int step = 0;   // ring steps before this item
    for (int w = blockIdx.x, k = 0; w < items; w += gridDim.x, ++k) {
      const Item it = item_of<BN>(p, w);
      const Rank& rk = p.rank[it.r];
      if constexpr (QF32) {
        mbar_wait(qempty, (k & 1) ^ 1);
        load_q_f32<D>(sm + LY::Q, p, it, t128);
        fence_proxy_async();
        named_bar_sync(BAR_PRODUCER, 128);
        if (t128 == 0) mbar_arrive(qfull);
      } else if (t128 == 0) {
        mbar_wait(qempty, (k & 1) ^ 1);
        mbar_arrive_expect_tx(qfull, (D / 64) * p.P * p.g * 128);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          tma_load_5d(sm + LY::Q + c * BQ * 128, &p.qmap[it.r], qfull, 64 * c, 0, it.hk,
                      it.t * p.P, it.b);
      }
      if (t128 == 0) {   // the item's live K/V tiles from the rank's slot
        const int row = rk.slot * p.B + it.b;
        for (int i = 0; i < it.n; ++i) {
          const int st = (step + i) % S;
          mbar_wait(&empty[st], (((step + i) / S) & 1) ^ 1);
          unsigned char* sp = sm + LY::STAGE0 + st * LY::STAGE;
          mbar_arrive_expect_tx(&full[st], 2 * LY::KV_TILE);
#pragma unroll
          for (int c = 0; c < D / 64; ++c) {
            tma_load_4d(sp + LY::SK + c * BN * 128, &p.kmap, &full[st], 64 * c, it.hk, i * BN, row);
            tma_load_4d(sp + LY::SV + c * BN * 128, &p.vmap, &full[st], 64 * c, it.hk, i * BN, row);
          }
        }
      } else if (t128 == 32) {   // a sender's tiles on to the neighbour's other slot
        const int row = rk.send * p.B + it.b;
        for (int i = 0; i < it.n; ++i) {
          const int st = (step + i) % S;
          mbar_wait(&full[st], ((step + i) / S) & 1);
          if (it.send) {
            const unsigned char* sp = sm + LY::STAGE0 + st * LY::STAGE;
#pragma unroll
            for (int c = 0; c < D / 64; ++c) {
              tma_store_4d(&p.kmap, sp + LY::SK + c * BN * 128, 64 * c, it.hk, i * BN, row);
              tma_store_4d(&p.vmap, sp + LY::SV + c * BN * 128, 64 * c, it.hk, i * BN, row);
            }
            bulk_commit();
            bulk_wait_read<0>();   // the stage may be refilled once the stores have read it
          }
          mbar_arrive(&empty[st]);
        }
      }
      step += it.n;
    }
    if (t128 == 32) bulk_wait<0>();
  } else {   // consumers
    setmaxnreg_inc<CONSUMER_REGS>();
    const int warp = t128 / 32, lane = t128 % 32;
    const int lr = wg * 64 + warp * 16 + lane / 4;   // this thread's rows lr, lr + 8 of the tile
    const uint32_t sQ = smem_u32(sm + LY::Q);
    const float sl2 = p.sl2;
    if (wg == 1) named_bar_arrive(BAR_TURN, 256);   // warpgroup 0 takes the first turn
    int step = 0;
    for (int w = blockIdx.x, k = 0; w < items; w += gridDim.x, ++k) {
      const Item it = item_of<BN>(p, w);
      const Rank& rk = p.rank[it.r];
      const int g = p.g;
      const int diag = rk.q_off - rk.k_off;   // key k is live for position t iff k <= t + diag
      bool in[2];
      int pos[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        in[e] = lr + 8 * e < it.rows;
        pos[e] = (it.p0 + lr + 8 * e) / g;
      }
      const bool wg_live = wg * 64 < it.rows;
      const int first_pos = (it.p0 + wg * 64) / g;
      const int last_pos = (it.p0 + min(wg * 64 + 63, it.rows - 1)) / g;
      // the carried state of rows lr, lr + 8: o columns 8j + 2(lane % 4) + {0, 1}
      const long long srow =
          (static_cast<long long>(it.b) * p.Hkv + it.hk) * p.Tl * g + it.p0 + lr;
      float oa[D / 2];
      float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};
      if (rk.first) {
        zero(oa);
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (in[e]) {
            m_run[e] = rk.m[srow + 8 * e];
            l_run[e] = rk.l[srow + 8 * e];
          }
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            float2 x = make_float2(0.f, 0.f);
            if (in[e])
              x = *reinterpret_cast<const float2*>(rk.o + (srow + 8 * e) * D + 8 * j +
                                                   2 * (lane % 4));
            oa[4 * j + 2 * e] = x.x;
            oa[4 * j + 2 * e + 1] = x.y;
          }
        }
      }
      mbar_wait(qfull, k & 1);
      fence_proxy_async();
      // this warpgroup's live tiles are [0, n_wg) (on the diagonal its rows
      // see fewer keys than the item's last rows), those from m0 on hold a
      // masked entry; `prev` is the stage of the tile whose P·V is pending
      const int n_wg = wg_live ? min(it.n, (last_pos + diag) / BN + 1) : 0;
      const int m0 = min(first_pos + diag + 1, p.Tl) / BN;
      float sa[BN / 2];
      uint32_t pf[BN / 16][4];
      int prev = 0;
      auto release = [&](int st) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[st]);
      };
      // the online softmax of S (rows lr: entries e < 2; lr + 8: e >= 2) in
      // base 2, into p in place; a masked entry is -inf, so its p is 0
      auto softmax = [&](int k0, auto masked, float (&alpha)[2]) {
        if constexpr (decltype(masked)::value) {
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = k0 + j * 8 + (lane % 4) * 2 + (e & 1);
              if (key >= p.Tl || key > pos[e >> 1] + diag) sa[4 * j + e] = -INFINITY;
            }
        }
        float mx[2] = {-INFINITY, -INFINITY}, rs[2] = {0.f, 0.f}, neg[2];
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sa[4 * j + e]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float m_new = fmaxf(m_run[r], quad_max(mx[r]) * sl2);
          alpha[r] = ex2(m_run[r] - m_new);
          m_run[r] = m_new;
          neg[r] = -m_new;
        }
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pe = ex2(fmaf(sa[4 * j + e], sl2, neg[e >> 1]));
            sa[4 * j + e] = pe;
            rs[e >> 1] += pe;
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + quad_sum(rs[r]);
      };
      // O rescaled to the new row max (only when one of the warp moved),
      // then p as bf16 fragments for the next P·V
      auto rescale_to_frags = [&](const float (&alpha)[2]) {
        if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
          for (int j = 0; j < D / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) oa[4 * j + e] *= alpha[e >> 1];
        }
        acc_to_frags<BN>(pf, sa);
      };
      auto v_tile = [&](int st) { return smem_u32(sm + LY::STAGE0 + st * LY::STAGE + LY::SV); };
      // tile i >= 1: in this warpgroup's turn it issues S = q·K_iᵀ and the
      // previous tile's O += P·V together; the softmax of tile i runs while
      // that P·V is on the tensor cores
      auto tile = [&](int i, auto masked) {
        const int st = (step + i) % S;
        mbar_wait(&full[st], ((step + i) / S) & 1);
        named_bar_sync(BAR_TURN + wg, 256);
        wgmma_fence();
        qk_t<D, BN>(sa, sQ, BQ, wg * 64,
                    smem_u32(sm + LY::STAGE0 + st * LY::STAGE + LY::SK), BN);
        wgmma_commit();
        pv<D, BN / 16>(oa, pf, v_tile(prev), BN);
        wgmma_commit();
        named_bar_arrive(BAR_TURN + 1 - wg, 256);
        wgmma_wait<1>();
        fence_regs(sa);
        float alpha[2];
        softmax(i * BN, masked, alpha);
        wgmma_wait<0>();
        fence_regs(oa);
        release(prev);
        rescale_to_frags(alpha);
        prev = st;
      };
      if (n_wg > 0) {   // tile 0 alone, then the unmasked and masked tiles
        const int st = step % S;
        mbar_wait(&full[st], (step / S) & 1);
        named_bar_sync(BAR_TURN + wg, 256);
        wgmma_fence();
        qk_t<D, BN>(sa, sQ, BQ, wg * 64,
                    smem_u32(sm + LY::STAGE0 + st * LY::STAGE + LY::SK), BN);
        wgmma_commit();
        named_bar_arrive(BAR_TURN + 1 - wg, 256);
        wgmma_wait<0>();
        fence_regs(sa);
        float alpha[2];
        if (m0 > 0)
          softmax(0, std::false_type{}, alpha);
        else
          softmax(0, std::true_type{}, alpha);
        rescale_to_frags(alpha);
        prev = st;
        int i = 1;
        for (; i < min(m0, n_wg); ++i) tile(i, std::false_type{});
        for (; i < n_wg; ++i) tile(i, std::true_type{});
      }
      __syncwarp();   // the q tile is free for the next item
      if (lane == 0) mbar_arrive(qempty);
      if (n_wg > 0) {   // the last tile's P·V
        wgmma_fence();
        pv<D, BN / 16>(oa, pf, v_tile(prev), BN);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(oa);
        release(prev);
      }
      for (int i = n_wg; i < it.n; ++i) {   // tiles past this warpgroup's rows
        const int st = (step + i) % S;
        mbar_wait(&full[st], ((step + i) / S) & 1);
        named_bar_sync(BAR_TURN + wg, 256);
        named_bar_arrive(BAR_TURN + 1 - wg, 256);
        release(st);
      }
      step += it.n;
      if (!wg_live) continue;
      if (rk.last) {
        // o / max(l, 1e-30) in q's dtype into the caller's rows
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (!in[e]) continue;
          const float inv = __frcp_rn(fmaxf(l_run[e], 1e-30f));
          const int pr = it.p0 + lr + 8 * e, t = pos[e];
          const long long ob =
              it.b * rk.out_sb +
              (static_cast<long long>(t) * p.Hq + it.hk * g + (pr - t * g)) * D + 2 * (lane % 4);
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            const float y0 = oa[4 * j + 2 * e] * inv, y1 = oa[4 * j + 2 * e + 1] * inv;
            if constexpr (QF32)
              *reinterpret_cast<float2*>(static_cast<float*>(rk.out) + ob + 8 * j) =
                  make_float2(y0, y1);
            else
              *reinterpret_cast<uint32_t*>(static_cast<bf16*>(rk.out) + ob + 8 * j) =
                  pack_bf16(y0, y1);
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (!in[e]) continue;
#pragma unroll
          for (int j = 0; j < D / 8; ++j)
            *reinterpret_cast<float2*>(rk.o + (srow + 8 * e) * D + 8 * j + 2 * (lane % 4)) =
                make_float2(oa[4 * j + 2 * e], oa[4 * j + 2 * e + 1]);
          if (lane % 4 == 0) {
            rk.m[srow + 8 * e] = m_run[e];
            rk.l[srow + 8 * e] = l_run[e];
          }
        }
      }
    }
  }
}

// A bf16 TMA map in the 128-byte swizzle: `rank` dims (innermost first),
// strides in bytes of dims 1.., boxes of `box`; elements past the extents
// read as zero and are not written.
cudaError_t bf16_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                     const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D, bool QF32>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using LY = RingLy<D>;
  auto kernel = ring_step_kernel<D, QF32>;
  // per call: the attribute is the current device's, and ranks may span cards
  const cudaError_t attr = set_smem(kernel, LY::ALLOC);
  if (attr != cudaSuccess) return attr;
  const long long items = static_cast<long long>(p.n_ranks) * p.B * p.Hkv * p.NT;
  const unsigned grid = static_cast<unsigned>(items < sm_count() ? items : sm_count());
  kernel<<<grid, WS_THREADS, LY::ALLOC, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// One ring step on one card: ranks[0 .. n_ranks) (each its q, state, output
// and offsets, the slot row it reads and the row its chunk is sent to, -1
// for none) against the card's slots kslots, vslots [n_slots, B, Tl, Hkv,
// D] bf16 contiguous; P = 128 / (Hq / Hkv) positions a work item; sl2 =
// scale·log2(e) in f32; q_f32: q (and the output) are f32, else bf16.
KOIFISH_API int koifish_ring_attn_step(const void* ranks, int n_ranks, const void* kslots,
                                       const void* vslots, int n_slots, int B, int Tl, int Hq,
                                       int Hkv, int D, int P, int q_f32, float sl2,
                                       void* stream) {
  if (n_ranks < 1 || n_ranks > MAX_RANKS || B < 1 || Tl < 1 || Hkv < 1 || Hq % Hkv != 0 ||
      n_slots < 1 || (D != 64 && D != 128))
    return cudaErrorInvalidValue;
  const int g = Hq / Hkv;
  if (g > 128 || P != 128 / g) return cudaErrorInvalidValue;
  static_assert(sizeof(Params) <= 4096, "ring_attn: kernel parameters");
  Params p;
  p.n_ranks = n_ranks;
  p.B = B;
  p.Tl = Tl;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.g = g;
  p.P = P;
  p.NT = (Tl + P - 1) / P;
  p.sl2 = sl2;
  if (static_cast<long long>(n_ranks) * B * Hkv * p.NT > (1ll << 31) - 1)
    return cudaErrorInvalidValue;
  const Rank* rk = static_cast<const Rank*>(ranks);
  for (int i = 0; i < n_ranks; ++i) {
    const Rank& r = rk[i];
    if (r.slot < 0 || r.slot >= n_slots || r.send < -1 || r.send >= n_slots ||
        r.k_off > r.q_off || (r.last && r.out == nullptr) ||
        ((!r.first || !r.last) && (r.o == nullptr || r.m == nullptr || r.l == nullptr)))
      return cudaErrorInvalidValue;
    p.rank[i] = r;
  }
  const cuuint32_t kv_box[4] = {64, 1, 128, 1};
  const cuuint64_t kv_dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(Hkv),
                                 static_cast<cuuint64_t>(Tl),
                                 static_cast<cuuint64_t>(n_slots) * B};
  const cuuint64_t kv_st[3] = {static_cast<cuuint64_t>(D) * 2,
                               static_cast<cuuint64_t>(Hkv) * D * 2,
                               static_cast<cuuint64_t>(Tl) * Hkv * D * 2};
  cudaError_t err = bf16_map(&p.kmap, kslots, 4, kv_dims, kv_st, kv_box);
  if (err == cudaSuccess) err = bf16_map(&p.vmap, vslots, 4, kv_dims, kv_st, kv_box);
  for (int i = 0; i < n_ranks && err == cudaSuccess && !q_f32; ++i) {
    // q as [B, Tl, Hkv, g, D]: a box is P positions x g heads of one kv head
    const cuuint64_t dims[5] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(g),
                                static_cast<cuuint64_t>(Hkv), static_cast<cuuint64_t>(Tl),
                                static_cast<cuuint64_t>(B)};
    const cuuint64_t st[4] = {static_cast<cuuint64_t>(D) * 2, static_cast<cuuint64_t>(g) * D * 2,
                              static_cast<cuuint64_t>(Hq) * D * 2,
                              static_cast<cuuint64_t>(rk[i].q_sb) * 2};
    const cuuint32_t box[5] = {64, static_cast<cuuint32_t>(g), 1, static_cast<cuuint32_t>(P), 1};
    err = bf16_map(&p.qmap[i], rk[i].q, 5, dims, st, box);
  }
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D * 2 + (q_f32 ? 1 : 0)) {
    case 128: return launch<64, false>(p, s);
    case 129: return launch<64, true>(p, s);
    case 256: return launch<128, false>(p, s);
    default: return launch<128, true>(p, s);
  }
}

// The ring's transfer between cards: `bytes` from src on device src_dev to
// dst on device dst_dev, on `stream` (a peer copy; on one card the chunk
// travels inside the step's launch).
KOIFISH_API int koifish_ring_copy(void* dst, int dst_dev, const void* src, int src_dev,
                                  long long bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dst_dev == src_dev ? cudaMemcpyAsync(dst, src, bytes, cudaMemcpyDeviceToDevice, s)
                         : cudaMemcpyPeerAsync(dst, dst_dev, src, src_dev, bytes, s);
  return err != cudaSuccess ? err : cudaGetLastError();
}
