// paged_attention: one-query decode attention through block tables.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py::
// paged_attention_bkgd (body _pa_kernel): a Pallas grid (B, Kh, pages) whose
// page fetches ride on block tables in scalar prefetch, with the online
// softmax state carried in VMEM scratch across the page axis.
//
// Bound on the H100: device memory bandwidth.  Each decode step reads every
// live K and V row of the sequence once (2 * seq_len * Kh * D elements) and
// does 4 flops per element read, far below the ~295 flops/byte where the card
// stops being memory bound.  Least time = K/V bytes / 3.35 TB/s.
//
// Design (simple first): one block of 128 threads per (b, kh) walks the
// sequence's pages through its block-table row; the TPU's sequential page
// axis becomes the loop inside the block.  A token's D values are read by
// D/VEC adjacent lanes with 16-byte loads (VEC = 8 bf16 or 4 f32), so the
// block reads 128*16 contiguous-per-token bytes per step.  The G query rows
// of the kv head sit in registers.  Per page: logits to shared memory (lane
// reduction by warp shuffles), then every thread updates the running max and
// sum identically, and each token group accumulates p * V for its tokens in
// f32 registers; the groups' partial sums are added once at the end.  The
// softmax keeps the TPU kernel's guards: alpha = 0 when the running max is
// -inf, p = 0 when the new max is -inf, and l floored at 1e-30.
// B * Kh blocks underfill the 132 SMs at small batch: split-KV is later work.
//
// C interface (ctypes): returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a shape the kernel was not instantiated for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <typename T> struct VecT;
template <> struct VecT<float> { static constexpr int N = 4; };
template <> struct VecT<__nv_bfloat16> { static constexpr int N = 8; };

// one 16-byte load, widened to f32
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

template <typename T, int G, int D>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ seq_lens, T* __restrict__ out,
                       int Kh, int page_T, int P, float scale) {
  constexpr int VEC = VecT<T>::N;
  constexpr int LPT = D / VEC;         // lanes per token (divides 32)
  constexpr int NG = kThreads / LPT;   // token groups per block
  static_assert(D % VEC == 0 && LPT <= 32 && (32 % LPT) == 0, "bad D");

  extern __shared__ float smem[];
  float* s_logit = smem;               // [G][page_T]
  float* s_l = s_logit + G * page_T;   // [G]
  float* s_red = s_l + G;              // [NG][G][D]

  const int b = blockIdx.x / Kh;
  const int kh = blockIdx.x % Kh;
  const int tid = threadIdx.x;
  const int li = tid % LPT;
  const int grp = tid / LPT;
  const int seq_len = seq_lens[b];
  int n_pages = seq_len > 0 ? (seq_len + page_T - 1) / page_T : 0;
  if (n_pages > P) n_pages = P;

  float qv[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g)
    load_vec(q + ((size_t)(b * Kh + kh) * G + g) * D + li * VEC, qv[g]);

  float m[G], l[G], acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  }

  const size_t tok_stride = (size_t)Kh * D;
  const size_t page_stride = (size_t)page_T * tok_stride;
  const int* bt_row = block_tables + (size_t)b * P;

  for (int j = 0; j < n_pages; ++j) {
    const size_t page = (size_t)bt_row[j];
    const int valid = min(page_T, seq_len - j * page_T);
    const T* kbase = k_pool + page * page_stride + (size_t)kh * D + li * VEC;
    const T* vbase = v_pool + page * page_stride + (size_t)kh * D + li * VEC;

    // logits of this page: the trip count is uniform across the warp so the
    // shuffles below always run with every lane present
    for (int t0 = 0; t0 < page_T; t0 += NG) {
      const int t = t0 + grp;
      float part[G];
#pragma unroll
      for (int g = 0; g < G; ++g) part[g] = 0.f;
      if (t < valid) {
        float kv[VEC];
        load_vec(kbase + (size_t)t * tok_stride, kv);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int e = 0; e < VEC; ++e) part[g] = fmaf(qv[g][e], kv[e], part[g]);
      }
#pragma unroll
      for (int off = LPT / 2; off > 0; off >>= 1)
#pragma unroll
        for (int g = 0; g < G; ++g)
          part[g] += __shfl_xor_sync(0xffffffffu, part[g], off);
      if (li == 0 && t < page_T)
#pragma unroll
        for (int g = 0; g < G; ++g)
          s_logit[g * page_T + t] = t < valid ? part[g] * scale : -INFINITY;
    }
    __syncthreads();

    // online softmax update, computed identically by every thread
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float* sl = s_logit + g * page_T;
      float pm = -INFINITY;
      for (int t = 0; t < page_T; ++t) pm = fmaxf(pm, sl[t]);
      const float m_new = fmaxf(m[g], pm);
      const float alpha = m[g] == -INFINITY ? 0.f : expf(m[g] - m_new);
      float rs = 0.f;
      if (m_new != -INFINITY)
        for (int t = 0; t < page_T; ++t) rs += expf(sl[t] - m_new);
      l[g] = l[g] * alpha + rs;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[g][e] *= alpha;
      m[g] = m_new;
    }

    // p * V over this thread's tokens
    for (int t = grp; t < valid; t += NG) {
      float vv[VEC];
      load_vec(vbase + (size_t)t * tok_stride, vv);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = m[g] == -INFINITY ? 0.f : expf(s_logit[g * page_T + t] - m[g]);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(p, vv[e], acc[g][e]);
      }
    }
    __syncthreads();  // s_logit is rewritten by the next page
  }

  // add the token groups' partial accumulators, normalise, write once
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      s_red[(grp * G + g) * D + li * VEC + e] = acc[g][e];
  if (tid == 0)
#pragma unroll
    for (int g = 0; g < G; ++g) s_l[g] = l[g];
  __syncthreads();
  for (int idx = tid; idx < G * D; idx += kThreads) {
    const int g = idx / D, d = idx % D;
    float sum = 0.f;
    for (int r = 0; r < NG; ++r) sum += s_red[(r * G + g) * D + d];
    store(out + ((size_t)(b * Kh + kh) * G + g) * D + d,
          sum / fmaxf(s_l[g], 1e-30f));
  }
}

template <typename T, int G, int D>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* bt, const void* lens, void* out, int B, int Kh,
                   int page_T, int P, float scale, cudaStream_t stream) {
  constexpr int LPT = D / VecT<T>::N;
  constexpr int NG = kThreads / LPT;
  const size_t smem = sizeof(float) * ((size_t)G * page_T + G + (size_t)NG * G * D);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  paged_attention_kernel<T, G, D><<<B * Kh, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(bt),
      static_cast<const int*>(lens), static_cast<T*>(out), Kh, page_T, P, scale);
  return cudaGetLastError();
}

template <typename T, int G>
cudaError_t by_d(int D, const void* q, const void* k, const void* v,
                 const void* bt, const void* lens, void* out, int B, int Kh,
                 int page_T, int P, float scale, cudaStream_t st) {
  switch (D) {
    case 32: return launch<T, G, 32>(q, k, v, bt, lens, out, B, Kh, page_T, P, scale, st);
    case 64: return launch<T, G, 64>(q, k, v, bt, lens, out, B, Kh, page_T, P, scale, st);
    case 128: return launch<T, G, 128>(q, k, v, bt, lens, out, B, Kh, page_T, P, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t by_g(int G, int D, const void* q, const void* k, const void* v,
                 const void* bt, const void* lens, void* out, int B, int Kh,
                 int page_T, int P, float scale, cudaStream_t st) {
  switch (G) {
    case 1: return by_d<T, 1>(D, q, k, v, bt, lens, out, B, Kh, page_T, P, scale, st);
    case 2: return by_d<T, 2>(D, q, k, v, bt, lens, out, B, Kh, page_T, P, scale, st);
    case 4: return by_d<T, 4>(D, q, k, v, bt, lens, out, B, Kh, page_T, P, scale, st);
    case 8: return by_d<T, 8>(D, q, k, v, bt, lens, out, B, Kh, page_T, P, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q/out (B, Kh, G, D); pools
// (num_pages, page_T, Kh, D); block_tables (B, P) int32 in [0, num_pages);
// seq_lens (B,) int32.  All contiguous and 16-byte aligned.
extern "C" int paged_attention(const void* q, const void* k_pool,
                               const void* v_pool, const void* block_tables,
                               const void* seq_lens, void* out, int B, int Kh,
                               int G, int D, int page_T, int P, float scale,
                               int dtype, void* stream) {
  if (B == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)by_g<float>(G, D, q, k_pool, v_pool, block_tables, seq_lens,
                            out, B, Kh, page_T, P, scale, st);
  if (dtype == 1)
    return (int)by_g<__nv_bfloat16>(G, D, q, k_pool, v_pool, block_tables,
                                    seq_lens, out, B, Kh, page_T, P, scale, st);
  return (int)cudaErrorInvalidValue;
}
