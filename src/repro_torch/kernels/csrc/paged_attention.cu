// paged_attention: one-query decode attention through block tables, as one
// split-KV launch per call.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py::
// paged_attention_bkgd (body _pa_kernel): a Pallas grid (B, Kh, pages) whose
// page fetches ride on block tables in scalar prefetch, with the online
// softmax state carried in VMEM scratch across the page axis.
//
// Bound on the H100: device memory bandwidth.  Each decode step reads every
// live K and V row of the sequence once (2 * seq_len * Kh * D elements) and
// does 4 flops per element read (2 per bf16 byte), far below the ~20 flops
// per byte at which even the f32 CUDA cores would be the limit: no tensor
// cores.  Least time = K/V bytes / 3.35 TB/s.  The work is to keep enough
// bytes in flight to reach that rate.
//
// Design.  The TPU's sequential page axis is split over a thread-block
// cluster of kSplit = 8 CTAs per (b, kh), so the grid is B * Kh * 8 CTAs,
// fixed by host-known shapes (never by seq_lens, which live on the device).
// CTA r of the cluster takes the logical pages j = r (mod 8), and warp w of
// the CTA the pages j = r + 8 w (mod 32): strided, so every split has work
// once a sequence has 8 pages, whatever the table's width P.  A warp reads
// the table entries of its next 32 pages at once, one per lane.  It issues
// the 16-byte loads of a whole chunk of K and V (up to 16 tokens, one engine
// page) before it uses any of them; a token's D values lie on D/VEC adjacent
// lanes, so one round of loads covers 32 / (D/VEC) tokens.  Logits are
// reduced over a token's lanes by xor shuffles, then the chunk's max and sum
// over the warp's token groups by xor shuffles too (every lane ends with the
// same bits), and each lane accumulates p * V for its own tokens in f32.
// The TPU kernel's guards stay: alpha = 0 when the running max is -inf,
// p = 0 when the new max is -inf, l floored at 1e-30 (a zero-length
// sequence gives zeros).
//
// Combine, inside the same launch and in a fixed order: the token groups of
// a warp fold by shuffles, the warps of a CTA in warp order through shared
// memory into the CTA's partial (m[G], l[G], acc[G][D]); then cluster.sync(),
// and each output element (striped over the cluster's threads) reads the 8
// partials through distributed shared memory in rank order.  A second
// cluster.sync() keeps every CTA resident while its partial is read.  The
// split count and every order depend on nothing but constants, so a
// sequence's output is bitwise the same whatever B, P and the other rows are.
// A CTA with no live page takes part in both syncs with an empty partial.
//
// Table entries are clamped to [0, num_pages) here, as
// repro.kernels.ops.paged_attention clips them before its kernel.
//
// C interface (ctypes): returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a shape the kernel was not instantiated for.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kSplit = 8;  // CTAs per (b, kh): one cluster
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

template <typename T> struct VecT;
template <> struct VecT<float> { static constexpr int N = 4; };
template <> struct VecT<__nv_bfloat16> { static constexpr int N = 8; };

// one 16-byte load, kept raw until it is used
__device__ __forceinline__ uint4 ld16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void widen(const uint4& u, float (&o)[4]) {
  o[0] = __uint_as_float(u.x); o[1] = __uint_as_float(u.y);
  o[2] = __uint_as_float(u.z); o[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void widen(const uint4& u, float (&o)[8]) {
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

// weight of a partial whose max is m in a sum whose max is M
__device__ __forceinline__ float rescale(float m, float M) {
  return m == -INFINITY ? 0.f : expf(m - M);
}

template <typename T, int G, int D>
struct Tile {
  static constexpr int VEC = VecT<T>::N;
  static constexpr int LPT = D / VEC;   // lanes per token (divides 32)
  static constexpr int TPW = 32 / LPT;  // tokens per round of a warp's loads
  // rounds per chunk: a chunk is at most 16 tokens (one engine page), fewer
  // at G = 8, where q and the accumulator take the registers
  static constexpr int R_MAX = G >= 8 ? 4 : 8;
  static constexpr int R = 16 / TPW < 1 ? 1 : (16 / TPW > R_MAX ? R_MAX : 16 / TPW);
  static_assert(D % VEC == 0 && LPT <= 32 && 32 % LPT == 0, "bad D");
};

template <typename T, int G, int D>
__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ seq_lens, T* __restrict__ out,
                       int Kh, int page_T, int P, int num_pages, float scale) {
  using Tl = Tile<T, G, D>;
  constexpr int VEC = Tl::VEC, LPT = Tl::LPT, TPW = Tl::TPW, R = Tl::R;

  __shared__ float w_m[kWarps][G], w_l[kWarps][G];
  __shared__ float w_acc[kWarps][G][D];
  __shared__ float c_m[G], c_l[G];  // this CTA's partial
  __shared__ float c_acc[G * D];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int bk = blockIdx.x / kSplit;  // b * Kh + kh
  const int b = bk / Kh, kh = bk % Kh;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int li = lane % LPT, grp = lane / LPT;
  // the table entries of the warp's pages, one per lane and 32 pages at a
  // time: the first 32 are read beside seq_len, not after it
  constexpr int kStride = kSplit * kWarps;  // between a warp's pages
  const int j0 = rank + kSplit * warp;
  const int* bt_row = block_tables + (size_t)b * P;
  int lane_page = j0 + lane * kStride < P ? bt_row[j0 + lane * kStride] : 0;
  const int seq_len = seq_lens[b];
  int n_pages = seq_len > 0 ? seq_len / page_T + (seq_len % page_T != 0) : 0;
  if (n_pages > P) n_pages = P;

  float qv[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g)
    widen(ld16(q + ((size_t)bk * G + g) * D + li * VEC), qv[g]);

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

  // every bound below is uniform across the warp, so the shuffles always
  // run with all lanes present
  for (int i = 0, j = j0; j < n_pages; ++i, j += kStride) {
    if (i % 32 == 0 && i > 0)
      lane_page = j + lane * kStride < P ? bt_row[j + lane * kStride] : 0;
    const int page = min(max(__shfl_sync(0xffffffffu, lane_page, i % 32), 0),
                         num_pages - 1);
    const int valid = min(page_T, seq_len - j * page_T);
    const size_t base = (size_t)page * page_stride + (size_t)kh * D + li * VEC;
    for (int t0 = 0; t0 < valid; t0 += TPW * R) {
      // all of the chunk's loads first; a slot past the last live token
      // rereads that token (cached) and is masked below
      uint4 kr[R], vr[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const size_t off = base + (size_t)min(t0 + r * TPW + grp, valid - 1) * tok_stride;
        kr[r] = ld16(k_pool + off);
        vr[r] = ld16(v_pool + off);
      }
      float s[R][G];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float kv[VEC];
        widen(kr[r], kv);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) part = fmaf(qv[g][e], kv[e], part);
          s[r][g] = part;
        }
      }
#pragma unroll
      for (int off = LPT / 2; off > 0; off >>= 1)
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int g = 0; g < G; ++g)
            s[r][g] += __shfl_xor_sync(0xffffffffu, s[r][g], off);

      // online softmax over the chunk: lanes of one token hold the same
      // logit, so the max and the sum run over the token groups only
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float cm = -INFINITY;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          s[r][g] = t0 + r * TPW + grp < valid ? s[r][g] * scale : -INFINITY;
          cm = fmaxf(cm, s[r][g]);
        }
#pragma unroll
        for (int off = LPT; off < 32; off <<= 1)
          cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, off));
        const float m_new = fmaxf(m[g], cm);
        const float alpha = rescale(m[g], m_new);
        float rs = 0.f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          s[r][g] = m_new == -INFINITY ? 0.f : expf(s[r][g] - m_new);
          rs += s[r][g];
        }
#pragma unroll
        for (int off = LPT; off < 32; off <<= 1)
          rs += __shfl_xor_sync(0xffffffffu, rs, off);
        l[g] = l[g] * alpha + rs;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] *= alpha;
        m[g] = m_new;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float vv[VEC];
        widen(vr[r], vv);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(s[r][g], vv[e], acc[g][e]);
      }
    }
  }

  // fold the warp's token groups (same m, so a plain sum), then the CTA's
  // warps in warp order into its partial
#pragma unroll
  for (int off = LPT; off < 32; off <<= 1)
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);
  if (grp == 0)
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < VEC; ++e) w_acc[warp][g][li * VEC + e] = acc[g][e];
  if (lane == 0)
#pragma unroll
    for (int g = 0; g < G; ++g) {
      w_m[warp][g] = m[g];
      w_l[warp][g] = l[g];
    }
  __syncthreads();
  for (int idx = tid; idx < G * D; idx += kThreads) {
    const int g = idx / D, d = idx % D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, w_m[w][g]);
    float a = 0.f, ls = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = rescale(w_m[w][g], M);
      a += f * w_acc[w][g][d];
      ls += f * w_l[w][g];
    }
    c_acc[idx] = a;
    if (d == 0) {
      c_m[g] = M;
      c_l[g] = ls;
    }
  }

  // the cluster's partials, in rank order, through distributed shared memory
  cluster.sync();
  for (int idx = rank * kThreads + tid; idx < G * D; idx += kSplit * kThreads) {
    const int g = idx / D;
    float ms[kSplit];
    float M = -INFINITY;
#pragma unroll
    for (int r = 0; r < kSplit; ++r) {
      ms[r] = cluster.map_shared_rank(&c_m[0], r)[g];
      M = fmaxf(M, ms[r]);
    }
    float a = 0.f, ls = 0.f;
#pragma unroll
    for (int r = 0; r < kSplit; ++r) {
      const float f = rescale(ms[r], M);
      a += f * cluster.map_shared_rank(&c_acc[0], r)[idx];
      ls += f * cluster.map_shared_rank(&c_l[0], r)[g];
    }
    store(out + (size_t)bk * G * D + idx, a / fmaxf(ls, 1e-30f));
  }
  cluster.sync();  // no CTA leaves while another may read its partial
}

template <typename T, int G, int D>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* bt, const void* lens, void* out, int B, int Kh,
                   int page_T, int P, int num_pages, float scale,
                   cudaStream_t stream) {
  paged_attention_kernel<T, G, D><<<B * Kh * kSplit, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(bt),
      static_cast<const int*>(lens), static_cast<T*>(out), Kh, page_T, P,
      num_pages, scale);
  return cudaGetLastError();
}

template <typename T, int G>
cudaError_t by_d(int D, const void* q, const void* k, const void* v,
                 const void* bt, const void* lens, void* out, int B, int Kh,
                 int page_T, int P, int np, float scale, cudaStream_t st) {
  switch (D) {
    case 32: return launch<T, G, 32>(q, k, v, bt, lens, out, B, Kh, page_T, P, np, scale, st);
    case 64: return launch<T, G, 64>(q, k, v, bt, lens, out, B, Kh, page_T, P, np, scale, st);
    case 128: return launch<T, G, 128>(q, k, v, bt, lens, out, B, Kh, page_T, P, np, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t by_g(int G, int D, const void* q, const void* k, const void* v,
                 const void* bt, const void* lens, void* out, int B, int Kh,
                 int page_T, int P, int np, float scale, cudaStream_t st) {
  switch (G) {
    case 1: return by_d<T, 1>(D, q, k, v, bt, lens, out, B, Kh, page_T, P, np, scale, st);
    case 2: return by_d<T, 2>(D, q, k, v, bt, lens, out, B, Kh, page_T, P, np, scale, st);
    case 4: return by_d<T, 4>(D, q, k, v, bt, lens, out, B, Kh, page_T, P, np, scale, st);
    case 8: return by_d<T, 8>(D, q, k, v, bt, lens, out, B, Kh, page_T, P, np, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q/out (B, Kh, G, D); pools
// (num_pages, page_T, Kh, D); block_tables (B, P) int32, clamped here to
// [0, num_pages); seq_lens (B,) int32.  All contiguous and 16-byte aligned.
extern "C" int paged_attention(const void* q, const void* k_pool,
                               const void* v_pool, const void* block_tables,
                               const void* seq_lens, void* out, int B, int Kh,
                               int G, int D, int page_T, int P, int num_pages,
                               float scale, int dtype, void* stream) {
  if (B == 0) return 0;
  if (num_pages < 1 || page_T < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)by_g<float>(G, D, q, k_pool, v_pool, block_tables, seq_lens,
                            out, B, Kh, page_T, P, num_pages, scale, st);
  if (dtype == 1)
    return (int)by_g<__nv_bfloat16>(G, D, q, k_pool, v_pool, block_tables,
                                    seq_lens, out, B, Kh, page_T, P, num_pages,
                                    scale, st);
  return (int)cudaErrorInvalidValue;
}
