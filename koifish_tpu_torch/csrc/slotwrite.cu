// Per-lane KV row writes for Hopper: the slot write and the page write.
//
// Replaces the Pallas kernels of koifish_tpu/ops/pallas/slotwrite.py:
// _slot_write_call/_kernel (:74/:55, row 8) and page_write_or_none/
// _page_kernel (:112/:99, row 9).
//
// Slot mode: buf [B, H, S, Dc] <- val [B, H, Dc] at row slots[b] of lane b
// (the non-uniform decode of the continuous batcher: every lane sits at its
// own position). Page mode: pages [H, NP, P, D] <- val [B, H, D] at
// (page_ids[b], rows[b]) (serve/paged.py; lanes own distinct pages, so no
// two lanes write one row). Elements are opaque bytes: int8 codes, packed
// INT4 bytes, bf16, or f32 scales (a [B, H, S] scale buffer is Dc = 1).
// A lane whose index lies outside the buffer writes nothing, as the masked
// select of the plain version does.
//
// What bounds it on the H100: nothing but the launch. A decode step writes
// B·H rows of D bytes per buffer (32·8·128 = 32 KB for INT8 K codes) —
// microseconds of the card's 3.35 TB/s, far below one launch's cost. The
// Pallas kernel copies a whole 32-row block per lane because a TPU moves
// VMEM blocks; here each row is written where it lies and nothing else is
// read or written. Design: one launch takes up to four buffers that share
// (B, H, S) — a layer's K codes, V codes and both scale buffers — so a
// decode step pays one launch per layer instead of four. Block (b, buffer)
// copies lane b's H rows with 16-, 4- or 1-byte accesses, whichever the row
// size and the pointers allow.
#include "common.cuh"

namespace {

constexpr int MAX_BUFS = 4;
constexpr int NTHREADS = 128;

struct RowWrite {
  unsigned char* buf[MAX_BUFS];
  const unsigned char* val[MAX_BUFS];
  long long row_bytes[MAX_BUFS];
};

template <typename T>
__device__ __forceinline__ void copy_rows(unsigned char* dst, const unsigned char* src,
                                          long long dst_stride, long long row_bytes, int H) {
  // H rows of row_bytes each: src rows are contiguous, dst rows dst_stride apart
  const long long per_row = row_bytes / static_cast<long long>(sizeof(T));
  const long long total = per_row * H;
  for (long long i = threadIdx.x; i < total; i += NTHREADS) {
    const long long h = i / per_row, e = i % per_row;
    reinterpret_cast<T*>(dst + h * dst_stride)[e] =
        reinterpret_cast<const T*>(src + h * row_bytes)[e];
  }
}

// rows == nullptr: slot mode, dst row of (b, h) is (b·H + h)·S + idx[b].
// Otherwise page mode, dst row of (b, h) is (h·NP + idx[b])·S + rows[b],
// with S the page size P.
__global__ void __launch_bounds__(NTHREADS)
    row_write_kernel(RowWrite a, const int* __restrict__ idx, const int* __restrict__ rows, int H,
                     int S, int NP) {
  const int b = blockIdx.x, d = blockIdx.y;
  const long long rb = a.row_bytes[d];
  const int i = idx[b];
  long long first, stride;   // dst row of head 0, and rows between heads
  if (rows == nullptr) {
    if (i < 0 || i >= S) return;
    first = (static_cast<long long>(b) * H) * S + i;
    stride = S;
  } else {
    const int r = rows[b];
    if (i < 0 || i >= NP || r < 0 || r >= S) return;
    first = static_cast<long long>(i) * S + r;
    stride = static_cast<long long>(NP) * S;
  }
  unsigned char* dst = a.buf[d] + first * rb;
  const unsigned char* src = a.val[d] + static_cast<long long>(b) * H * rb;
  const unsigned long long al = reinterpret_cast<unsigned long long>(dst) |
                                reinterpret_cast<unsigned long long>(src) |
                                static_cast<unsigned long long>(rb);
  if (al % 16 == 0)
    copy_rows<uint4>(dst, src, stride * rb, rb, H);
  else if (al % 4 == 0)
    copy_rows<uint32_t>(dst, src, stride * rb, rb, H);
  else
    copy_rows<unsigned char>(dst, src, stride * rb, rb, H);
}

}  // namespace

// n buffers (1..4) in one launch. bufs/vals/row_bytes are host arrays of n
// entries; idx [B] and rows [B] (page mode only, else null) are int32 on the
// device. Slot mode: S is the slot count and NP is unused; page mode: S is
// the page size and NP the pool's page count.
KOIFISH_API int koifish_row_write(int n, const unsigned long long* bufs,
                                  const unsigned long long* vals, const long long* row_bytes,
                                  const void* idx, const void* rows, int B, int H, int S, int NP,
                                  void* stream) {
  if (n < 1 || n > MAX_BUFS || B < 1 || H < 1 || S < 1) return cudaErrorInvalidValue;
  RowWrite a{};
  for (int d = 0; d < n; ++d) {
    if (row_bytes[d] < 1) return cudaErrorInvalidValue;
    a.buf[d] = reinterpret_cast<unsigned char*>(bufs[d]);
    a.val[d] = reinterpret_cast<const unsigned char*>(vals[d]);
    a.row_bytes[d] = row_bytes[d];
  }
  dim3 grid(B, n);
  row_write_kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const int*>(idx), static_cast<const int*>(rows), H, S, NP);
  return cudaGetLastError();
}
