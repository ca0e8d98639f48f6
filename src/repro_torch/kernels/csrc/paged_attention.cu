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
// Types.  q and out share one element type (Tq), the two pools another
// (Tkv), each f32 or bf16: the four pairs are instantiated.  The arithmetic
// is the reference's (src/repro/kernels/ref.py: paged_attention_ref): q and
// K widened to f32 as they are loaded (exact for bf16), Q.K^T, the softmax
// and the P.V sum in f32, the result stored in q's type.  Where q is wider
// than the pools, P is rounded to the pools' type before P.V, as the
// reference casts p to v's dtype.  At equal types P stays in f32, as this
// kernel always kept it: those instances are bitwise the kernel before it
// took two types.  bf16 q over f32 pools is thus "widen q, run f32, round
// the output to bf16", in the same single launch.
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

// one lane's VEC elements of q, widened to f32 (exact for both types): one
// 16-byte load where q's type matches the pools', else the same values
// from two 16-byte loads (f32 q, VEC 8) or one 8-byte load (bf16 q, VEC 4)
template <int VEC>
__device__ __forceinline__ void load_q(const float* p, float (&o)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC / 4; ++i) {
    float t[4];
    widen(ld16(p + 4 * i), t);
#pragma unroll
    for (int e = 0; e < 4; ++e) o[4 * i + e] = t[e];
  }
}

template <int VEC>
__device__ __forceinline__ void load_q(const __nv_bfloat16* p, float (&o)[VEC]) {
  if constexpr (VEC == 8) {
    widen(ld16(p), o);
  } else {
    static_assert(VEC == 4, "bf16 q: VEC 8 or 4");
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    o[0] = __uint_as_float(u.x << 16);
    o[1] = __uint_as_float(u.x & 0xffff0000u);
    o[2] = __uint_as_float(u.y << 16);
    o[3] = __uint_as_float(u.y & 0xffff0000u);
  }
}

// P as the P.V product takes it: rounded to the pools' type where q is
// wider (the reference's p.astype(v.dtype)), else kept in f32
template <typename Tq, typename Tkv>
__device__ __forceinline__ float p_for_v(float p) {
  if constexpr (sizeof(Tq) > sizeof(Tkv))
    return __bfloat162float(__float2bfloat16_rn(p));
  else
    return p;
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
struct Tile {  // T: the pools' type, which sets the lanes' layout
  static constexpr int VEC = VecT<T>::N;
  static constexpr int LPT = D / VEC;   // lanes per token (divides 32)
  static constexpr int TPW = 32 / LPT;  // tokens per round of a warp's loads
  // rounds per chunk: a chunk is at most 16 tokens (one engine page), fewer
  // at G = 8, where q and the accumulator take the registers
  static constexpr int R_MAX = G >= 8 ? 4 : 8;
  static constexpr int R = 16 / TPW < 1 ? 1 : (16 / TPW > R_MAX ? R_MAX : 16 / TPW);
  static_assert(D % VEC == 0 && LPT <= 32 && 32 % LPT == 0, "bad D");
};

template <typename Tq, typename Tkv, int G, int D>
__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kThreads)
paged_attention_kernel(const Tq* __restrict__ q, const Tkv* __restrict__ k_pool,
                       const Tkv* __restrict__ v_pool,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ seq_lens, Tq* __restrict__ out,
                       int Kh, int page_T, int P, int num_pages, float scale) {
  using Tl = Tile<Tkv, G, D>;
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
    load_q(q + ((size_t)bk * G + g) * D + li * VEC, qv[g]);

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
        for (int g = 0; g < G; ++g) {
          const float p = p_for_v<Tq, Tkv>(s[r][g]);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(p, vv[e], acc[g][e]);
        }
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

template <typename Tq, typename Tkv, int G, int D>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* bt, const void* lens, void* out, int B, int Kh,
                   int page_T, int P, int num_pages, float scale,
                   cudaStream_t stream) {
  paged_attention_kernel<Tq, Tkv, G, D><<<B * Kh * kSplit, kThreads, 0, stream>>>(
      static_cast<const Tq*>(q), static_cast<const Tkv*>(k_pool),
      static_cast<const Tkv*>(v_pool), static_cast<const int*>(bt),
      static_cast<const int*>(lens), static_cast<Tq*>(out), Kh, page_T, P,
      num_pages, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- any (G, D)
//
// The kernel above takes G 1 / 2 / 4 / 8 at D 32 / 64 / 128: a compile-time
// G, and a token's D / VEC lanes dividing the warp.  Every other shape runs
// paged_attention_any_kernel, a second instance family whose head tile and
// lane layout do not depend on (G, D):
//
// * Heads.  A CTA holds a compile-time tile of kHeadTile query heads and
//   masks the tail: the host splits a group of G heads into
//   ceil(G / kHeadTile) chunks of equal size (G 12: two of 6), and each
//   chunk is a cluster of its own, so the grid is B * Kh * chunks * kSplit.
//   A group of more than kHeadTile heads reads its K/V once per chunk.
// * Lanes.  A token's D elements lie on LPU lanes of EPL elements each (one
//   or two 16-byte vectors: two at f32 D 192), padded to a power of two
//   LPT, so the xor-shuffle reductions run over whole lane groups; a pad
//   lane holds zero q and zero K/V and loads nothing.  D 192 bf16: 24 of
//   32 lanes; D 48 bf16: 6 of 8, four tokens per round.
//
// Everything else is the kernel above: the strided page split over the
// cluster, the chunk's loads before their use, the online softmax with its
// guards, the fold in warp order and the cluster combine in rank order, so
// a sequence's output is bitwise independent of B, P and the other rows.

constexpr int kHeadTile = 8;

template <typename T, int D>
struct AnyTile {  // T: the pools' type
  static constexpr int VEC = VecT<T>::N;
  static constexpr int NV = (D / VEC + 31) / 32;  // 16-byte vectors per lane
  static constexpr int EPL = NV * VEC;            // elements per lane
  static constexpr int LPU = D / EPL;             // lanes a token uses
  static constexpr int LPT = LPU <= 1 ? 1 : LPU <= 2 ? 2 : LPU <= 4 ? 4
                           : LPU <= 8 ? 8 : LPU <= 16 ? 16 : 32;
  static constexpr int TPW = 32 / LPT;            // tokens per round
  static constexpr int R_MAX = 4 / NV;            // registers: q, acc and loads
  static constexpr int R = 16 / TPW < 1 ? 1 : (16 / TPW > R_MAX ? R_MAX : 16 / TPW);
  static_assert(D % VEC == 0 && D % EPL == 0 && LPU <= 32, "bad D");
};

template <typename Tq, typename Tkv, int D>
__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kThreads)
paged_attention_any_kernel(const Tq* __restrict__ q,
                           const Tkv* __restrict__ k_pool,
                           const Tkv* __restrict__ v_pool,
                           const int* __restrict__ block_tables,
                           const int* __restrict__ seq_lens,
                           Tq* __restrict__ out, int Kh, int G, int chunks,
                           int per_chunk, int page_T, int P, int num_pages,
                           float scale) {
  using Tl = AnyTile<Tkv, D>;
  constexpr int GT = kHeadTile;
  constexpr int VEC = Tl::VEC, NV = Tl::NV, EPL = Tl::EPL, LPU = Tl::LPU,
                LPT = Tl::LPT, TPW = Tl::TPW, R = Tl::R;

  __shared__ float w_m[kWarps][GT], w_l[kWarps][GT];
  __shared__ float w_acc[kWarps][GT][D];
  __shared__ float c_m[GT], c_l[GT];  // this CTA's partial
  __shared__ float c_acc[GT * D];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cta = blockIdx.x / kSplit;  // (b * Kh + kh) * chunks + chunk
  const int bk = cta / chunks;          // b * Kh + kh
  const int b = bk / Kh, kh = bk % Kh;
  const int h0 = (cta % chunks) * per_chunk;  // the chunk's first head
  const int gn = min(per_chunk, G - h0);      // its live heads, >= 1
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int li = lane % LPT, grp = lane / LPT;
  const bool on = li < LPU;  // a lane that holds elements of its token
  constexpr int kStride = kSplit * kWarps;
  const int j0 = rank + kSplit * warp;
  const int* bt_row = block_tables + (size_t)b * P;
  int lane_page = j0 + lane * kStride < P ? bt_row[j0 + lane * kStride] : 0;
  const int seq_len = seq_lens[b];
  int n_pages = seq_len > 0 ? seq_len / page_T + (seq_len % page_T != 0) : 0;
  if (n_pages > P) n_pages = P;

  const Tq* q_row = q + ((size_t)bk * G + h0) * D + li * EPL;
  float qv[GT][EPL];
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      float t[VEC];
      if (on && g < gn) {
        load_q(q_row + (size_t)g * D + v * VEC, t);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) t[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) qv[g][v * VEC + e] = t[e];
    }

  float m[GT], l[GT], acc[GT][EPL];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  const size_t tok_stride = (size_t)Kh * D;
  const size_t page_stride = (size_t)page_T * tok_stride;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int i = 0, j = j0; j < n_pages; ++i, j += kStride) {
    if (i % 32 == 0 && i > 0)
      lane_page = j + lane * kStride < P ? bt_row[j + lane * kStride] : 0;
    const int page = min(max(__shfl_sync(0xffffffffu, lane_page, i % 32), 0),
                         num_pages - 1);
    const int valid = min(page_T, seq_len - j * page_T);
    const size_t base = (size_t)page * page_stride + (size_t)kh * D + li * EPL;
    for (int t0 = 0; t0 < valid; t0 += TPW * R) {
      uint4 kr[R][NV], vr[R][NV];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const size_t off = base + (size_t)min(t0 + r * TPW + grp, valid - 1) * tok_stride;
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          kr[r][v] = on ? ld16(k_pool + off + v * VEC) : zero;
          vr[r][v] = on ? ld16(v_pool + off + v * VEC) : zero;
        }
      }
      float s[R][GT];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float kv[EPL];
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          float t[VEC];
          widen(kr[r][v], t);
#pragma unroll
          for (int e = 0; e < VEC; ++e) kv[v * VEC + e] = t[e];
        }
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) part = fmaf(qv[g][e], kv[e], part);
          s[r][g] = part;
        }
      }
#pragma unroll
      for (int off = LPT / 2; off > 0; off >>= 1)
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int g = 0; g < GT; ++g)
            s[r][g] += __shfl_xor_sync(0xffffffffu, s[r][g], off);

#pragma unroll
      for (int g = 0; g < GT; ++g) {
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
        for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
        m[g] = m_new;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float vv[EPL];
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          float t[VEC];
          widen(vr[r][v], t);
#pragma unroll
          for (int e = 0; e < VEC; ++e) vv[v * VEC + e] = t[e];
        }
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          const float p = p_for_v<Tq, Tkv>(s[r][g]);
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(p, vv[e], acc[g][e]);
        }
      }
    }
  }

#pragma unroll
  for (int off = LPT; off < 32; off <<= 1)
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);
  if (grp == 0 && on)
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int e = 0; e < EPL; ++e) w_acc[warp][g][li * EPL + e] = acc[g][e];
  if (lane == 0)
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      w_m[warp][g] = m[g];
      w_l[warp][g] = l[g];
    }
  __syncthreads();
  for (int idx = tid; idx < gn * D; idx += kThreads) {
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

  cluster.sync();
  Tq* out_row = out + ((size_t)bk * G + h0) * D;
  for (int idx = rank * kThreads + tid; idx < gn * D; idx += kSplit * kThreads) {
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
    store(out_row + idx, a / fmaxf(ls, 1e-30f));
  }
  cluster.sync();
}

template <typename Tq, typename Tkv, int D>
cudaError_t launch_any(const void* q, const void* k_pool, const void* v_pool,
                       const void* bt, const void* lens, void* out, int B,
                       int Kh, int G, int page_T, int P, int num_pages,
                       float scale, cudaStream_t stream) {
  // equal chunks of at most kHeadTile heads, none empty
  const int per_chunk = (G + (G + kHeadTile - 1) / kHeadTile - 1)
                        / ((G + kHeadTile - 1) / kHeadTile);
  const int chunks = (G + per_chunk - 1) / per_chunk;
  const long long ctas = (long long)B * Kh * chunks * kSplit;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  paged_attention_any_kernel<Tq, Tkv, D><<<(unsigned)ctas, kThreads, 0, stream>>>(
      static_cast<const Tq*>(q), static_cast<const Tkv*>(k_pool),
      static_cast<const Tkv*>(v_pool), static_cast<const int*>(bt),
      static_cast<const int*>(lens), static_cast<Tq*>(out), Kh, G, chunks,
      per_chunk, page_T, P, num_pages, scale);
  return cudaGetLastError();
}

template <typename Tq, typename Tkv>
cudaError_t any_d(int G, int D, const void* q, const void* k, const void* v,
                  const void* bt, const void* lens, void* out, int B, int Kh,
                  int page_T, int P, int np, float scale, cudaStream_t st) {
  switch (D) {
#define PAGED_ANY_D(DD) \
    case DD: return launch_any<Tq, Tkv, DD>(q, k, v, bt, lens, out, B, Kh, G, page_T, P, np, scale, st);
    PAGED_ANY_D(16) PAGED_ANY_D(32) PAGED_ANY_D(48) PAGED_ANY_D(64)
    PAGED_ANY_D(80) PAGED_ANY_D(96) PAGED_ANY_D(112) PAGED_ANY_D(128)
    PAGED_ANY_D(192)
#undef PAGED_ANY_D
    default: return cudaErrorInvalidValue;
  }
}

// the instances of the first kernel, kept as they were
bool first_family(int G, int D) {
  return (D == 32 || D == 64 || D == 128) && (G == 1 || G == 2 || G == 4 || G == 8);
}

template <typename Tq, typename Tkv, int G>
cudaError_t by_d(int D, const void* q, const void* k, const void* v,
                 const void* bt, const void* lens, void* out, int B, int Kh,
                 int page_T, int P, int np, float scale, cudaStream_t st) {
  switch (D) {
    case 32: return launch<Tq, Tkv, G, 32>(q, k, v, bt, lens, out, B, Kh, page_T, P, np, scale, st);
    case 64: return launch<Tq, Tkv, G, 64>(q, k, v, bt, lens, out, B, Kh, page_T, P, np, scale, st);
    case 128: return launch<Tq, Tkv, G, 128>(q, k, v, bt, lens, out, B, Kh, page_T, P, np, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename Tq, typename Tkv>
cudaError_t by_g(int G, int D, const void* q, const void* k, const void* v,
                 const void* bt, const void* lens, void* out, int B, int Kh,
                 int page_T, int P, int np, float scale, cudaStream_t st) {
  switch (G) {
    case 1: return by_d<Tq, Tkv, 1>(D, q, k, v, bt, lens, out, B, Kh, page_T, P, np, scale, st);
    case 2: return by_d<Tq, Tkv, 2>(D, q, k, v, bt, lens, out, B, Kh, page_T, P, np, scale, st);
    case 4: return by_d<Tq, Tkv, 4>(D, q, k, v, bt, lens, out, B, Kh, page_T, P, np, scale, st);
    case 8: return by_d<Tq, Tkv, 8>(D, q, k, v, bt, lens, out, B, Kh, page_T, P, np, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename Tq>
cudaError_t by_kv(int kv_dtype, int G, int D, const void* q, const void* k,
                  const void* v, const void* bt, const void* lens, void* out,
                  int B, int Kh, int page_T, int P, int np, float scale,
                  cudaStream_t st) {
  switch (kv_dtype) {
    case 0: return first_family(G, D)
        ? by_g<Tq, float>(G, D, q, k, v, bt, lens, out, B, Kh, page_T, P, np, scale, st)
        : any_d<Tq, float>(G, D, q, k, v, bt, lens, out, B, Kh, page_T, P, np, scale, st);
    case 1: return first_family(G, D)
        ? by_g<Tq, __nv_bfloat16>(G, D, q, k, v, bt, lens, out, B, Kh, page_T, P, np, scale, st)
        : any_d<Tq, __nv_bfloat16>(G, D, q, k, v, bt, lens, out, B, Kh, page_T, P, np, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; q_dtype is q's and out's,
// kv_dtype both pools'.  q/out (B, Kh, G, D); pools (num_pages, page_T, Kh,
// D); block_tables (B, P) int32, clamped here to [0, num_pages); seq_lens
// (B,) int32.  All contiguous and 16-byte aligned.
extern "C" int paged_attention(const void* q, const void* k_pool,
                               const void* v_pool, const void* block_tables,
                               const void* seq_lens, void* out, int B, int Kh,
                               int G, int D, int page_T, int P, int num_pages,
                               float scale, int q_dtype, int kv_dtype,
                               void* stream) {
  if (B == 0) return 0;
  if (num_pages < 1 || page_T < 1 || G < 1 || Kh < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    return (int)by_kv<float>(kv_dtype, G, D, q, k_pool, v_pool, block_tables,
                             seq_lens, out, B, Kh, page_T, P, num_pages, scale,
                             st);
  if (q_dtype == 1)
    return (int)by_kv<__nv_bfloat16>(kv_dtype, G, D, q, k_pool, v_pool,
                                     block_tables, seq_lens, out, B, Kh,
                                     page_T, P, num_pages, scale, st);
  return (int)cudaErrorInvalidValue;
}
