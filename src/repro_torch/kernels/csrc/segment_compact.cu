// segment_compact: the cleaner's data path, out[i, :] = pool[src[i], :].
//
// Replaces the TPU kernel src/repro/kernels/segment_compact.py::segment_compact
// (a Pallas gather-copy over a (1, tile) VMEM window, src ids in scalar
// prefetch).
//
// Bound on the H100: device memory bandwidth.  Every moved byte is read once
// and written once and nothing is computed, so the least time is
// 2 * M * row_bytes / 3.35 TB/s.
//
// Design: rows are opaque bytes, so one kernel serves every dtype and the
// copy is exact; no padding, so any E works (the TPU kernel padded E to 128
// lanes).  Rows run on grid.x and the blocks that share a row on grid.y.
// The row copy is copy_rows.cuh's: 16-byte vectors when the bases and the
// row length allow, a re-aligning 16-byte copy for 4-byte-aligned rows (an
// int32 row of 16,383 elements), element by element otherwise; 64 bytes in
// flight per thread.  A source id outside [0, N) copies nothing (the
// wrapper's caller validates ids on the host; the guard only keeps the read
// in bounds).
//
// C interface (ctypes): returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "copy_rows.cuh"

namespace {

template <typename C>
__global__ void __launch_bounds__(rows::kThreads)
compact_rows(const char* __restrict__ pool, const int* __restrict__ src,
             char* __restrict__ out, long long n_rows, long long row_bytes) {
  const long long i = blockIdx.x;  // destination row
  const long long s = src[i];
  if (s < 0 || s >= n_rows) return;
  rows::copy(C{}, pool + s * row_bytes, out + i * row_bytes, row_bytes,
             blockIdx.y, gridDim.y);
}

template <typename C>
cudaError_t launch(const void* pool, const int* src, void* out, long long n_rows,
                   long long m_rows, long long row_bytes, cudaStream_t stream) {
  dim3 grid((unsigned)m_rows, rows::parts<C>(row_bytes));
  compact_rows<C><<<grid, rows::kThreads, 0, stream>>>(
      static_cast<const char*>(pool), src, static_cast<char*>(out), n_rows,
      row_bytes);
  return cudaGetLastError();
}

}  // namespace

extern "C" int segment_compact(const void* pool, const void* src, void* out,
                               long long n_rows, long long m_rows,
                               long long row_bytes, void* stream) {
  if (m_rows == 0 || row_bytes == 0) return 0;
  if (m_rows > 2147483647LL) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* s = static_cast<const int*>(src);
  const uintptr_t align = (uintptr_t)pool | (uintptr_t)out | (uintptr_t)row_bytes;
  if (align % 16 == 0)
    return (int)launch<rows::Vec<uint4>>(pool, s, out, n_rows, m_rows, row_bytes, st);
  if (align % 4 == 0)
    return (int)launch<rows::Realign>(pool, s, out, n_rows, m_rows, row_bytes, st);
  if (align % 2 == 0)
    return (int)launch<rows::Vec<uint16_t>>(pool, s, out, n_rows, m_rows, row_bytes, st);
  return (int)launch<rows::Vec<uint8_t>>(pool, s, out, n_rows, m_rows, row_bytes, st);
}
