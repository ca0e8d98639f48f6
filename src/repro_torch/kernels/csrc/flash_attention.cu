// flash_attention: GQA attention forward, causal or not, online softmax.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_bhsd (body _fa_kernel): a Pallas grid (B, H, q blocks,
// kv blocks) with the kv axis innermost and (m, l, acc) in VMEM scratch.
//
// Bound on the H100: arithmetic.  A causal prefill of S tokens does
// 4 * B * H * D * S(S+1)/2 flops on 2 * (B*H + B*Kh) * S * D elements, so at
// S = 1024 it sits far above the ~295 flops/byte ridge: the least time is the
// flops over the tensor-core peak (989 TFLOP/s bf16).  This simple kernel
// runs on the CUDA cores (67 TFLOP/s f32), so it cannot reach that bound;
// wgmma tiles are later work.
//
// Design (simple first): one block of 128 threads per (32 query rows, head,
// batch).  The kv axis, sequential on the TPU, is the loop inside the block.
// The Q tile stays in shared memory; each step loads a 32-row K tile and V
// tile with 16-byte loads, widened to f32 (rows padded by 4 floats so the
// float4 reads below are bank-conflict free).  Four threads share a query
// row: each computes 8 of the 32 logits, the row max and sum come from two
// warp shuffles, p goes through shared memory, and each thread keeps D/4
// output columns of the row in f32 registers.  Query head h reads kv head
// h / G (no head broadcast in memory).  Causal kv tiles wholly above the
// diagonal are never loaded; masked logits are -inf with the TPU kernel's
// guards (alpha = 0 when the running max is -inf, p = 0 when the new max is
// -inf, l floored at 1e-30); the output is written once, at the end.
//
// C interface (ctypes): returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a head dim the kernel was not instantiated for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int BQ = 32;  // query rows per block (4 threads per row)
constexpr int BK = 32;  // kv rows per step (8 logits per thread)

template <typename T> struct VecT;
template <> struct VecT<float> { static constexpr int N = 4; };
template <> struct VecT<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ void load_vec(const float* p, float (&o)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  o[0] = u.x; o[1] = u.y; o[2] = u.z; o[3] = u.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&o)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned int w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 -> f32 is a 16-bit shift, exact
    o[2 * i] = __uint_as_float(w[i] << 16);
    o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// rows [r0, r0 + 32) of a (S, D) row-major matrix into a padded f32 tile;
// rows at or past S are zero (they are masked or never written back)
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* __restrict__ base, int r0,
                                          int S, float* __restrict__ dst) {
  constexpr int VEC = VecT<T>::N;
  constexpr int VPR = D / VEC;  // 16-byte vectors per row
  constexpr int DP = D + 4;
  for (int idx = threadIdx.x; idx < 32 * VPR; idx += kThreads) {
    const int rr = idx / VPR, cv = idx % VPR;
    float f[VEC];
    if (r0 + rr < S) {
      load_vec(base + (size_t)(r0 + rr) * D + cv * VEC, f);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) f[e] = 0.f;
    }
    float* d = dst + rr * DP + cv * VEC;
#pragma unroll
    for (int e = 0; e < VEC; e += 4)
      *reinterpret_cast<float4*>(d + e) = make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
  }
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)(BQ + 2 * BK) * (D + 4) + (size_t)BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out, int H, int Kh, int Sq,
          int Skv, float scale, int causal) {
  constexpr int DP = D + 4;
  constexpr int NV = D / 16;  // float4 column chunks per thread
  static_assert(D % 16 == 0, "D must be a multiple of 16");

  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // [BQ][DP]
  float* sK = sQ + BQ * DP;                     // [BK][DP]
  float* sV = sK + BK * DP;                     // [BK][DP]
  float* sP = sV + BK * DP;                     // [BQ][BK + 1]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / Kh);
  const int tid = threadIdx.x;
  const int r = tid >> 2;  // query row within the tile
  const int t4 = tid & 3;  // quarter of the row this thread owns
  const int row = q0 + r;

  const T* qb = q + (size_t)(b * H + h) * Sq * D;
  const T* kb = k + (size_t)(b * Kh + kvh) * Skv * D;
  const T* vb = v + (size_t)(b * Kh + kvh) * Skv * D;
  load_tile<T, D>(qb, q0, Sq, sQ);

  float m = -INFINITY, l = 0.f;
  float acc[NV * 4];
#pragma unroll
  for (int j = 0; j < NV * 4; ++j) acc[j] = 0.f;

  int n_kt = (Skv + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (q0 + BQ - 1) / BK + 1);  // skip tiles above the diagonal

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile is consumed (and sQ is loaded)
    load_tile<T, D>(kb, k0, Skv, sK);
    load_tile<T, D>(vb, k0, Skv, sV);
    __syncthreads();

    float s[BK / 4];
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) s[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(sQ + r * DP + d);
#pragma unroll
      for (int i = 0; i < BK / 4; ++i) {
        const float4 kv = *reinterpret_cast<const float4*>(sK + (t4 + 4 * i) * DP + d);
        s[i] = fmaf(qv.x, kv.x, s[i]);
        s[i] = fmaf(qv.y, kv.y, s[i]);
        s[i] = fmaf(qv.z, kv.z, s[i]);
        s[i] = fmaf(qv.w, kv.w, s[i]);
      }
    }

    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) {
      const int col = k0 + t4 + 4 * i;
      const bool ok = col < Skv && (!causal || col <= row);
      s[i] = ok ? s[i] * scale : -INFINITY;
      mx = fmaxf(mx, s[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float alpha = m == -INFINITY ? 0.f : expf(m - m_new);
    float rs = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) {
      const float p = m_new == -INFINITY ? 0.f : expf(s[i] - m_new);
      sP[r * (BK + 1) + t4 + 4 * i] = p;
      rs += p;
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l = l * alpha + rs;
#pragma unroll
    for (int j = 0; j < NV * 4; ++j) acc[j] *= alpha;
    __syncwarp();  // the row's p values come from the 4 lanes of this warp

    for (int c = 0; c < BK; ++c) {
      const float p = sP[r * (BK + 1) + c];
#pragma unroll
      for (int jj = 0; jj < NV; ++jj) {
        const float4 vv = *reinterpret_cast<const float4*>(sV + c * DP + t4 * 4 + 16 * jj);
        acc[jj * 4 + 0] = fmaf(p, vv.x, acc[jj * 4 + 0]);
        acc[jj * 4 + 1] = fmaf(p, vv.y, acc[jj * 4 + 1]);
        acc[jj * 4 + 2] = fmaf(p, vv.z, acc[jj * 4 + 2]);
        acc[jj * 4 + 3] = fmaf(p, vv.w, acc[jj * 4 + 3]);
      }
    }
    m = m_new;
  }

  if (row < Sq) {
    const float denom = fmaxf(l, 1e-30f);
    T* ob = out + ((size_t)(b * H + h) * Sq + row) * D;
#pragma unroll
    for (int jj = 0; jj < NV; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store(ob + t4 * 4 + 16 * jj + e, acc[jj * 4 + e] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int H, int Kh, int Sq, int Skv, float scale,
                   int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, Kh, Sq, Skv, scale,
      causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_d(int D, const void* q, const void* k, const void* v, void* out,
                 int B, int H, int Kh, int Sq, int Skv, float scale, int causal,
                 cudaStream_t st) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, out, B, H, Kh, Sq, Skv, scale, causal, st);
    case 32: return launch<T, 32>(q, k, v, out, B, H, Kh, Sq, Skv, scale, causal, st);
    case 64: return launch<T, 64>(q, k, v, out, B, H, Kh, Sq, Skv, scale, causal, st);
    case 128: return launch<T, 128>(q, k, v, out, B, H, Kh, Sq, Skv, scale, causal, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q/out (B, H, Sq, D); k/v (B, Kh, Skv, D)
// with H % Kh == 0.  All contiguous and 16-byte aligned.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int H, int Kh, int Sq,
                               int Skv, int D, float scale, int causal,
                               int dtype, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)by_d<float>(D, q, k, v, out, B, H, Kh, Sq, Skv, scale, causal, st);
  if (dtype == 1)
    return (int)by_d<__nv_bfloat16>(D, q, k, v, out, B, H, Kh, Sq, Skv, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}
