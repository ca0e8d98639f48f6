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
// copy is exact.  Each row is copied with the widest vector (16, 8, 4, 2 or 1
// bytes) that divides the row length and the alignment of both buffers, so
// any E works, including one that is not a multiple of the 16-byte width.
// Rows run on grid.x, column chunks on grid.y, and each thread strides over
// its row so adjacent threads touch adjacent vectors (coalesced).  A source
// id outside [0, N) copies nothing (the wrapper's caller validates ids on the
// host; the guard only keeps the read in bounds).
//
// C interface (ctypes): returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename V>
__global__ void compact_rows(const char* __restrict__ pool,
                             const int* __restrict__ src,
                             char* __restrict__ out, long long n_rows,
                             long long row_bytes) {
  const long long i = blockIdx.x;  // destination row
  const long long s = src[i];
  if (s < 0 || s >= n_rows) return;
  const long long n_vec = row_bytes / (long long)sizeof(V);
  const V* in_row = reinterpret_cast<const V*>(pool + s * row_bytes);
  V* out_row = reinterpret_cast<V*>(out + i * row_bytes);
  for (long long c = (long long)blockIdx.y * kThreads + threadIdx.x;
       c < n_vec; c += (long long)gridDim.y * kThreads) {
    out_row[c] = in_row[c];
  }
}

template <typename V>
cudaError_t launch(const void* pool, const int* src, void* out, long long n_rows,
                   long long m_rows, long long row_bytes, cudaStream_t stream) {
  const long long n_vec = row_bytes / (long long)sizeof(V);
  long long chunks = (n_vec + kThreads - 1) / kThreads;
  if (chunks > 65535) chunks = 65535;  // grid.y limit; threads stride the rest
  dim3 grid((unsigned)m_rows, (unsigned)chunks);
  compact_rows<V><<<grid, kThreads, 0, stream>>>(
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
  // widest vector dividing the row length and both base addresses
  const uintptr_t align = (uintptr_t)pool | (uintptr_t)out | (uintptr_t)row_bytes;
  if (align % 16 == 0) return (int)launch<uint4>(pool, s, out, n_rows, m_rows, row_bytes, st);
  if (align % 8 == 0) return (int)launch<uint2>(pool, s, out, n_rows, m_rows, row_bytes, st);
  if (align % 4 == 0) return (int)launch<unsigned int>(pool, s, out, n_rows, m_rows, row_bytes, st);
  if (align % 2 == 0) return (int)launch<unsigned short>(pool, s, out, n_rows, m_rows, row_bytes, st);
  return (int)launch<unsigned char>(pool, s, out, n_rows, m_rows, row_bytes, st);
}
