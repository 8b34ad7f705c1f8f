// Dequant-fused GEMV for Hopper (m <= 32): y = Σ_g (x_g @ codes_g) · s_g.
//
// Replaces the Pallas kernels of koifish_tpu/ops/pallas/matmul.py:
// _qmv/_qmv_kernel (:201/:224, the GEMV, m <= 32) and its learned-codebook
// variant _qmv_book/_qmv_book_kernel (:389/:419), with 32 x 64 output tiles;
// the BOOK flag swaps the constant NF decode for a lookup in the tensor's
// own book. The GEMM shape (m > 32: _qmm, _qmm_book) is qmm.cu.
//
// Codes: [K/cpb, N] bytes (INT8: int8 [K, N]) in the group-local
// block-split order of quant/packing.py — within each 128-row group, byte
// row r holds rows r, r + 128/cpb, ... (lowest bits first). Decoding
// follows _unpack_block (matmul.py:155-189): signed formats are stored
// biased by 2^(bits-1), TERNARY is raw-1, BINARY is 2·raw-1, NF4/NF3 come
// from the same constants, rounded to bf16 (qcodes.cuh). Integer codes are
// exact in bf16. The group scale multiplies each group's f32 partial
// product, never the weights. Learned codebooks (BOOK, NF4/NF3 code layouts
// only): code c of weight row k decodes to bf16(book[k][c]) from an f32
// book of 2^bits entries per row ([K, 2^bits], MINI) or one book for all
// rows ([2^bits], k-means: per_row = 0). A block stages the group's book
// rows (or the one book, once) in shared memory beside the codes.
//
// What bounds it on the H100: the decode GEMV (m = 32) does 2·32 flops per
// weight against half a byte of INT4 codes — 128 flops per byte, under the
// ~295 bf16 flops/byte ridge, so reading the codes once bounds it. Design:
// one block of 4 warps per (output tile, K split). Per 128-row group it
// stages the x tile and the group's codes, decoded to bf16, in shared
// memory; each warp multiplies its 32-row slice on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulate, operands through ldmatrix)
// into a register partial, and adds partial · scale into its register
// accumulators. The output tiles alone cannot fill the card (m <= 32, N ~
// 1-3K), so K is split across blocks into an f32 workspace that a second
// pass sums in a fixed order and rounds to bf16.
#include "qcodes.cuh"

namespace {

constexpr int NTHREADS = 128;   // 4 warps

// Tile shape: BM x BN outputs per block, 4 warps as WM x WN, each warp
// 32 rows (two m16 tiles) x WTN columns (NT n8 tiles).
template <int BM, int BN>
struct Tile {
  static constexpr int WM = BM / 32;
  static constexpr int WN = 4 / WM;
  static constexpr int WTN = BN / WN;
  static constexpr int MT = 2;
  static constexpr int NT = WTN / 8;
  // rows padded by 16 bytes: the 8 row addresses of an ldmatrix hit
  // distinct banks
  static constexpr int LDX = GROUP + 8;   // bf16 x tile [BM][LDX]
  static constexpr int LDW = BN + 8;      // bf16 decoded codes [GROUP][LDW]
  static constexpr size_t X = 0;
  static constexpr size_t W = X + sizeof(bf16) * BM * LDX;
  static constexpr size_t S = W + sizeof(bf16) * GROUP * LDW;
  static constexpr size_t BYTES = S + sizeof(float) * BN;
  static_assert(BM % 32 == 0 && WM * WN == 4 && NT % 2 == 0, "tile shape");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a · b for one m16n8k16 tile (bf16 in, f32 accumulate)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int FMT, int BM, int BN, bool BOOK>
__global__ void __launch_bounds__(NTHREADS)
    qmm_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ codes,
               const float* __restrict__ scales, const float* __restrict__ book, int per_row,
               bf16* __restrict__ out, float* __restrict__ partial, int m, int K, int N,
               int groups_per_split) {
  using C = Codes<FMT>;
  using TL = Tile<BM, BN>;
  constexpr int NB = Book<FMT, BOOK>::NB;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Xs = reinterpret_cast<bf16*>(smem + TL::X);
  bf16* Ws = reinterpret_cast<bf16*>(smem + TL::W);
  float* Ss = reinterpret_cast<float*>(smem + TL::S);
  float* Bs = reinterpret_cast<float*>(smem + TL::BYTES);   // BOOK only

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int split = blockIdx.z;
  const int ng = K / GROUP;
  const int g_begin = split * groups_per_split;
  const int g_end = min(ng, g_begin + groups_per_split);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wr = (warp / TL::WN) * 32;        // this warp's first row in the tile
  const int wc = (warp % TL::WN) * TL::WTN;   // and first column

  float acc[TL::MT][TL::NT][4];
#pragma unroll
  for (int i = 0; i < TL::MT; ++i)
#pragma unroll
    for (int j = 0; j < TL::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  if constexpr (BOOK) {
    if (!per_row) {   // one book for every row: stage it once
      for (int i = tid; i < NB; i += NTHREADS) Bs[i] = book[i];
      __syncthreads();
    }
  }

  for (int gi = g_begin; gi < g_end; ++gi) {
    if constexpr (BOOK) {
      if (per_row) {   // the group's 128 book rows, [128, NB] contiguous
        for (int i = tid; i < GROUP * NB; i += NTHREADS)
          Bs[i] = book[static_cast<size_t>(gi) * GROUP * NB + i];
        __syncthreads();
      }
    }
    // code value of raw code c at group-local weight row `row`, as bf16 bits
    auto value = [&](uint32_t c, int row) -> uint32_t {
      if constexpr (BOOK)
        return __bfloat16_as_ushort(
            __float2bfloat16(Bs[(per_row ? row * NB : 0) + (c & (NB - 1))]));
      else
        return __bfloat16_as_ushort(C::value(c));
    };
    // x tile [BM, 128] (rows past m are zero), 16-byte chunks
    for (int i = tid; i < BM * (GROUP / 8); i += NTHREADS) {
      const int r = i / (GROUP / 8), c = (i % (GROUP / 8)) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (m0 + r < m)
        val = *reinterpret_cast<const uint4*>(x + static_cast<size_t>(m0 + r) * K +
                                              gi * GROUP + c);
      *reinterpret_cast<uint4*>(Xs + r * TL::LDX + c) = val;
    }
    // decode the group's codes: byte row r, code slot j -> weight row
    // j·SUB + r; a 4-byte word holds 4 columns, stored as 4 packed bf16
    for (int i = tid; i < C::SUB * (BN / 4); i += NTHREADS) {
      const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
      uint32_t word = 0;
      if (n0 + c < N)   // N % 4 == 0: the 4 columns are all in or all out
        word = *reinterpret_cast<const uint32_t*>(
            codes + static_cast<size_t>(gi * C::SUB + r) * N + n0 + c);
#pragma unroll
      for (int j = 0; j < C::CPB; ++j) {
        constexpr uint32_t mask = (1u << C::BITS) - 1u;
        uint32_t v[4];
#pragma unroll
        for (int b = 0; b < 4; ++b)
          v[b] = value((word >> (8 * b + C::BITS * j)) & mask, j * C::SUB + r);
        *reinterpret_cast<uint2*>(Ws + (j * C::SUB + r) * TL::LDW + c) =
            make_uint2(v[0] | (v[1] << 16), v[2] | (v[3] << 16));
      }
    }
    if (tid < BN) Ss[tid] = n0 + tid < N ? scales[static_cast<size_t>(gi) * N + n0 + tid] : 0.f;
    __syncthreads();

    // partial = x_g @ codes_g for this warp's 32 x WTN slice
    float part[TL::MT][TL::NT][4];
#pragma unroll
    for (int i = 0; i < TL::MT; ++i)
#pragma unroll
      for (int j = 0; j < TL::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < GROUP; kk += 16) {
      uint32_t a[TL::MT][4];
#pragma unroll
      for (int i = 0; i < TL::MT; ++i)
        ldmatrix_x4(a[i], Xs + (wr + i * 16 + lane % 16) * TL::LDX + kk + (lane / 16) * 8);
#pragma unroll
      for (int j = 0; j < TL::NT; j += 2) {
        uint32_t b[4];   // b0, b1 of n8 tile j, then of tile j + 1
        ldmatrix_x4_trans(b, Ws + (kk + lane % 16) * TL::LDW + wc + j * 8 + (lane / 16) * 8);
#pragma unroll
        for (int i = 0; i < TL::MT; ++i) {
          mma_bf16(part[i][j], a[i], b[0], b[1]);
          mma_bf16(part[i][j + 1], a[i], b[2], b[3]);
        }
      }
    }
    // group scale on the partial sums; lane holds columns 2·(lane%4), +1
#pragma unroll
    for (int j = 0; j < TL::NT; ++j) {
      const int c = wc + j * 8 + (lane % 4) * 2;
      const float s0 = Ss[c], s1 = Ss[c + 1];
#pragma unroll
      for (int i = 0; i < TL::MT; ++i) {
        acc[i][j][0] += part[i][j][0] * s0;
        acc[i][j][1] += part[i][j][1] * s1;
        acc[i][j][2] += part[i][j][2] * s0;
        acc[i][j][3] += part[i][j][3] * s1;
      }
    }
    __syncthreads();   // everyone is done with Xs / Ws / Ss
  }

  // lane holds rows lane/4 and lane/4 + 8 of each m16 tile, two columns
#pragma unroll
  for (int i = 0; i < TL::MT; ++i)
#pragma unroll
    for (int j = 0; j < TL::NT; ++j) {
      const int gn = n0 + wc + j * 8 + (lane % 4) * 2;
      if (gn >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gm = m0 + wr + i * 16 + lane / 4 + h * 8;
        if (gm >= m) continue;
        const size_t at = static_cast<size_t>(gm) * N + gn;
        if (partial != nullptr)
          *reinterpret_cast<float2*>(partial + static_cast<size_t>(split) * m * N + at) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        else
          *reinterpret_cast<__nv_bfloat162*>(out + at) =
              __floats2bfloat162_rn(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
}

// the GEMV's 32 x 64 tiles (ops/kernels/matmul.py::TILES)
template <int FMT, bool BOOK = false>
cudaError_t launch(const void* x, const void* codes, const void* scales, void* out, void* work,
                   int m, int K, int N, int gps, cudaStream_t stream, const void* book = nullptr,
                   int per_row = 0) {
  constexpr int BM = 32, BN = 64;
  using TL = Tile<BM, BN>;
  constexpr size_t bytes = TL::BYTES + Book<FMT, BOOK>::BYTES;
  static cudaError_t attr = set_smem(qmm_kernel<FMT, BM, BN, BOOK>, bytes);
  if (attr != cudaSuccess) return attr;
  const int ng = K / GROUP;
  const int splits = (ng + gps - 1) / gps;
  dim3 grid((N + BN - 1) / BN, (m + BM - 1) / BM, splits);
  float* partial = splits > 1 ? static_cast<float*>(work) : nullptr;
  if (splits > 1 && partial == nullptr) return cudaErrorInvalidValue;
  qmm_kernel<FMT, BM, BN, BOOK><<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const uint8_t*>(codes),
      static_cast<const float*>(scales), static_cast<const float*>(book), per_row,
      static_cast<bf16*>(out), partial, m, K, N, gps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t mn = static_cast<size_t>(m) * N;
  splitk_reduce<<<static_cast<unsigned>((mn + 255) / 256), 256, 0, stream>>>(
      partial, static_cast<bf16*>(out), splits, mn);
  return cudaGetLastError();
}

}  // namespace

KOIFISH_API int koifish_qmatmul(const void* x, const void* codes, const void* scales, void* out,
                                void* work, int m, int K, int N, int fmt, int gps, void* stream) {
  if (m < 1 || K % GROUP != 0 || N % 4 != 0 || gps < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case INT8: return launch<INT8>(x, codes, scales, out, work, m, K, N, gps, s);
    case INT4: return launch<INT4>(x, codes, scales, out, work, m, K, N, gps, s);
    case NF4: return launch<NF4>(x, codes, scales, out, work, m, K, N, gps, s);
    case INT3: return launch<INT3>(x, codes, scales, out, work, m, K, N, gps, s);
    case NF3: return launch<NF3>(x, codes, scales, out, work, m, K, N, gps, s);
    case INT2: return launch<INT2>(x, codes, scales, out, work, m, K, N, gps, s);
    case TERNARY: return launch<TERNARY>(x, codes, scales, out, work, m, K, N, gps, s);
    case BINARY: return launch<BINARY>(x, codes, scales, out, work, m, K, N, gps, s);
    default: return cudaErrorInvalidValue;
  }
}

// Learned-codebook codes (NF4 or NF3 layouts): book is f32 [K, 2^bits]
// (per_row = 1) or [2^bits] (per_row = 0), contiguous.
KOIFISH_API int koifish_qmatmul_book(const void* x, const void* codes, const void* scales,
                                     const void* book, void* out, void* work, int m, int K,
                                     int N, int fmt, int per_row, int gps, void* stream) {
  if (m < 1 || K % GROUP != 0 || N % 4 != 0 || gps < 1 || book == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case NF4:
      return launch<NF4, true>(x, codes, scales, out, work, m, K, N, gps, s, book, per_row);
    case NF3:
      return launch<NF3, true>(x, codes, scales, out, work, m, K, N, gps, s, book, per_row);
    default: return cudaErrorInvalidValue;
  }
}
