// mdc_priority: the paper's §5.1.3 declining-cost cleaning key per segment,
//
//   key = -1                                    if C == 0 (empty: free to clean)
//       = +inf                                  if A = S - C <= 0 (full)
//       = (C / A)^2 / (max(C, 1) * max(u_now - up2, 1))   otherwise
//
// with C = live pages, all in f32.  Victim selection takes the k smallest.
//
// Replaces the TPU kernel src/repro/kernels/mdc_priority.py::mdc_priority
// (body _priority_kernel: one elementwise pass over (8, 128) VMEM tiles, N
// padded to a tile multiple with live = S so that pad rows key +inf).
//
// Bound on the H100: device memory bandwidth.  Each segment reads 8 bytes
// (live, up2) and writes 4 for ~10 flops, so the least time is
// 12 * N / 3.35 TB/s; at the paper's 51,200 segments that is 0.18 us, far
// below the cost of a launch.
//
// Design: one grid-stride pass.  Where all three pointers are 16-byte
// aligned, each thread loads and stores float4 (four segments), adjacent
// threads on adjacent vectors; the n % 4 tail, or the whole array when a
// pointer is not aligned, goes element by element.  No padding: the kernel
// bounds-checks n and writes exactly n keys.
//
// Parity with the JAX kernel (rtol 1e-6, same -1 / +inf pattern) rests on
// the f32 arithmetic being the same: IEEE round-to-nearest division (the
// build must not pass --use_fast_math), the square as t * t, one division by
// the product max(C, 1) * interval, u_now already rounded to f32 by the
// caller, and both branches as selects that always store.
//
// C interface (ctypes): returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 4096;  // grid-stride beyond ~31 blocks / SM

__device__ __forceinline__ float key(float C, float up2, float u_now, float S) {
  const float A = S - C;
  const float interval = fmaxf(u_now - up2, 1.0f);
  const float r = C / fmaxf(A, 1e-12f);
  const float decline = A > 0.0f ? r * r / (fmaxf(C, 1.0f) * interval) : INFINITY;
  return C == 0.0f ? -1.0f : decline;
}

template <bool kVec4>
__global__ void priority(const float* __restrict__ live,
                         const float* __restrict__ up2,
                         float* __restrict__ out, long long n, float u_now,
                         float S) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long done = 0;
  if (kVec4) {
    const long long n4 = n / 4;
    const float4* live4 = reinterpret_cast<const float4*>(live);
    const float4* up24 = reinterpret_cast<const float4*>(up2);
    float4* out4 = reinterpret_cast<float4*>(out);
    for (long long i = t; i < n4; i += stride) {
      const float4 c = live4[i];
      const float4 u = up24[i];
      out4[i] = make_float4(key(c.x, u.x, u_now, S), key(c.y, u.y, u_now, S),
                            key(c.z, u.z, u_now, S), key(c.w, u.w, u_now, S));
    }
    done = n4 * 4;
  }
  for (long long i = done + t; i < n; i += stride) {
    out[i] = key(live[i], up2[i], u_now, S);
  }
}

}  // namespace

extern "C" int mdc_priority(const void* live, const void* up2, void* out,
                            long long n, float u_now, int S, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec4 = (((uintptr_t)live | (uintptr_t)up2 | (uintptr_t)out) % 16) == 0;
  const long long work = vec4 ? (n + 3) / 4 : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const float* l = static_cast<const float*>(live);
  const float* u = static_cast<const float*>(up2);
  float* o = static_cast<float*>(out);
  if (vec4) {
    priority<true><<<(unsigned)blocks, kThreads, 0, st>>>(l, u, o, n, u_now, (float)S);
  } else {
    priority<false><<<(unsigned)blocks, kThreads, 0, st>>>(l, u, o, n, u_now, (float)S);
  }
  return (int)cudaGetLastError();
}
