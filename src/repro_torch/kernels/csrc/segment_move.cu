// segment_move: the compaction move of the paged engine, for the K and V
// pools together: pool_p[l, dst[i]] = pool_p[l, src[i]] for p in {K, V} and
// every layer l.
//
// Replaces the data path of src/repro/serving/engine.py::_move_pages_fn
// (segment_compact gathers every layer's source pages of K, then of V, into
// fresh arrays; XLA scatters them to the destinations).  Its TPU kernel is
// src/repro/kernels/segment_compact.py::segment_compact.
//
// Bound on the H100: device memory bandwidth.  Every moved byte is read once
// and written once, so the least time is 2 * 2 * L * M * row_bytes /
// 3.35 TB/s for M moves of L layers in each pool.
//
// Design: one launch copies both pools (grid.y) and every layer; a block
// copies its share of one page row with copy_rows.cuh (opaque bytes, so
// exact for any dtype; 16-byte vectors or the re-aligning copy; 64 bytes in
// flight per thread).  The plan's page ids ride in the kernel's parameters
// (up to kMaxMoves per launch), so nothing is uploaded before the copy.  A
// side without page ids addresses a staging buffer of (L, total moves) rows,
// so the one kernel serves the three forms the wrapper uses:
//   direct  — page ids on both sides, pool to pool: one launch, for a plan
//             whose sources and destinations are disjoint;
//   gather  — source page ids into the staging buffer, then
//   scatter — the staging buffer to the destination page ids: the two
//             launches of a plan in which some destination is another move's
//             source, so that every source is read before any destination
//             is written.
//
// C interface (ctypes): returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a page id outside [0, n_pages) or too many moves.

#include <cuda_runtime.h>
#include <stdint.h>

#include "copy_rows.cuh"

namespace {

constexpr int kMaxMoves = 2048;  // 16 KB of page ids in the parameters

struct Move {
  const char* src[2];  // K and V source bases
  char* dst[2];        // K and V destination bases
  long long n_pages;   // rows per layer of a pool
  long long total;     // moves of the whole plan (staging rows per layer)
  long long m0, n;     // this launch's moves: [m0, m0 + n)
  long long row_bytes;
  int has_src, has_dst;  // page ids on that side, else the staging buffer
  int src_page[kMaxMoves];
  int dst_page[kMaxMoves];
};

template <typename C>
__global__ void __launch_bounds__(rows::kThreads)
move_rows(const __grid_constant__ Move mv) {
  const long long l = blockIdx.x / mv.n, m = blockIdx.x % mv.n;
  const long long staged = l * mv.total + mv.m0 + m;
  const long long s = mv.has_src ? l * mv.n_pages + mv.src_page[m] : staged;
  const long long d = mv.has_dst ? l * mv.n_pages + mv.dst_page[m] : staged;
  // selects, not an index: a runtime index into the parameters would copy
  // them to local memory
  const char* S = (blockIdx.y ? mv.src[1] : mv.src[0]) + s * mv.row_bytes;
  char* D = (blockIdx.y ? mv.dst[1] : mv.dst[0]) + d * mv.row_bytes;
  rows::copy(C{}, S, D, mv.row_bytes, blockIdx.z, gridDim.z);
}

template <typename C>
cudaError_t launch(const Move& mv, long long layers, cudaStream_t stream) {
  dim3 grid((unsigned)(layers * mv.n), 2, rows::parts<C>(mv.row_bytes));
  move_rows<C><<<grid, rows::kThreads, 0, stream>>>(mv);
  return cudaGetLastError();
}

}  // namespace

// src0/src1 and dst0/dst1: the K and V bases of each side, (layers,
// n_pages, row_bytes) pools or (layers, total, row_bytes) staging buffers.
// src_pages / dst_pages: host arrays of this launch's n page ids (moves
// m0 .. m0 + n of the plan), or null for the staging side.
extern "C" int segment_move(const void* src0, const void* src1, void* dst0,
                            void* dst1, const int* src_pages,
                            const int* dst_pages, long long layers,
                            long long n_pages, long long total, long long m0,
                            long long n, long long row_bytes, void* stream) {
  if (n == 0 || layers == 0 || row_bytes == 0) return 0;
  if (n < 0 || n > kMaxMoves || m0 < 0 || m0 + n > total
      || layers * n > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  Move mv;
  mv.src[0] = static_cast<const char*>(src0);
  mv.src[1] = static_cast<const char*>(src1);
  mv.dst[0] = static_cast<char*>(dst0);
  mv.dst[1] = static_cast<char*>(dst1);
  mv.n_pages = n_pages;
  mv.total = total;
  mv.m0 = m0;
  mv.n = n;
  mv.row_bytes = row_bytes;
  mv.has_src = src_pages != nullptr;
  mv.has_dst = dst_pages != nullptr;
  for (long long i = 0; i < n; ++i) {
    mv.src_page[i] = src_pages ? src_pages[i] : 0;
    mv.dst_page[i] = dst_pages ? dst_pages[i] : 0;
    if (mv.src_page[i] < 0 || mv.src_page[i] >= n_pages
        || mv.dst_page[i] < 0 || mv.dst_page[i] >= n_pages)
      return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the widest copy the row length and every base allow
  const uintptr_t align = (uintptr_t)src0 | (uintptr_t)src1 | (uintptr_t)dst0
                          | (uintptr_t)dst1 | (uintptr_t)row_bytes;
  if (align % 16 == 0) return (int)launch<rows::Vec<uint4>>(mv, layers, st);
  if (align % 4 == 0) return (int)launch<rows::Realign>(mv, layers, st);
  if (align % 2 == 0) return (int)launch<rows::Vec<uint16_t>>(mv, layers, st);
  return (int)launch<rows::Vec<uint8_t>>(mv, layers, st);
}
