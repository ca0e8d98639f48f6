// flash_attention: GQA attention forward, causal or not, online softmax.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_bhsd (body _fa_kernel): a Pallas grid (B, H, q blocks,
// kv blocks) with the kv axis innermost and (m, l, acc) in VMEM scratch.
//
// Bound on the H100: arithmetic.  A causal prefill of S tokens does
// 4 * B * H * D * S(S+1)/2 flops on 2 * (B*H + B*Kh) * S * D elements, so at
// S = 1024 it sits far above the ~295 flops/byte ridge: the least time is the
// flops over the tensor-core peak (989 TFLOP/s bf16), or, in f32, over the
// CUDA cores' (67 TFLOP/s).
//
// Two routes, chosen by the wrapper from (dtype, D) and passed in `route`:
//
// * tensor cores (route 1: bf16, D a multiple of 16 from 64 to 128, or 192)
//   — the prefill's route.  A CTA
//   owns 128 query rows of one (b, h): two consumer warpgroups of 64 rows and
//   one producer warpgroup.  One producer thread keeps Q and a two-stage ring
//   of K and V tiles (128 rows; 64 at D 192, for shared memory) in flight
//   with TMA (128-byte swizzle, completion
//   on mbarriers), while the consumers run S = Q.K^T as wgmma m64nBNk16 with
//   both operands in shared memory (K-major), the online softmax in registers
//   on the accumulator's layout (a row lives in a quad of lanes: two
//   shuffles), and O += P.V as wgmma with P converted to bf16 in registers
//   (the accumulator fragment of the first product is the A fragment of the
//   second) and V read MN-major from shared memory.  P is rounded to bf16
//   before the product, as the plain version rounds it to v.dtype.  The
//   producer gives up its registers with setmaxnreg.  Causal kv tiles wholly
//   above the diagonal are never loaded, only tiles that cross it (or the
//   ragged end of Skv) are masked, and CTAs take q tiles heaviest first.
//   Ragged Sq and Skv come from TMA's zero fill and clipping, not padding;
//   so does a head dim between 64 and 128: the tensor maps are built at D,
//   the tile is D rounded up to 64 columns, TMA zero-fills the columns past
//   D, Q.K^T runs D/16 k-steps, P.V runs at the tile's width, and the store
//   clips the columns past D (D 112 is bit for bit the D 128 launch over
//   zero-padded copies at the same scale).
//   The output is staged in the warpgroup's own Q rows and written by a TMA
//   store.  Operands are read through 4-D tensor maps built from element
//   strides, so (B, S, H, D) and (B, H, S, D) inputs need no copies.
// * CUDA cores (route 0: f32 at every multiple of 16 up to 128 and at 192,
//   bf16 below 64), register-tiled as a SIMT SGEMM: 256 threads own 64 query
//   rows; per 64-row kv tile each thread computes a 4 x 4 tile of S and a
//   4 x D/16 tile of O, reading Q, K, P and V from shared memory as float4,
//   so each float read feeds 4 FMAs or more.  K/V tiles arrive by cp.async,
//   V's while S is computed and the next K's while O accumulates.  f32 stays
//   IEEE: plain FMAs in d order and expf; TF32 tensor cores would break the
//   2e-5 parity bar.
//
// Both: query row i sits at absolute position q_offset + i and, when causal,
// attends keys 0 .. q_offset + i (a continuation prefill after a cached
// prefix of q_offset tokens; q_offset = 0 is a whole prompt).  The kv tiles
// and their ascending order depend only on Skv (and the route's tile for
// D), and a tile fully masked for
// a row adds exactly nothing to it (alpha = 1, p = 0), so a row's result
// depends, bit for bit, only on its absolute position, its query and the
// keys: not on which other rows share its call or its tile.  Query head h
// reads kv head h / G (no head broadcast in memory);
// masked logits are -inf with the TPU kernel's guards (alpha = 0 when the
// running max is -inf, p = 0 when the new max is -inf, l floored at 1e-30);
// the output is written once, at the end.
//
// C interface (ctypes): returns cudaGetLastError() after the launch,
// cudaErrorInvalidValue for a (route, dtype, D) the kernel was not
// instantiated for or a layout a tensor map refuses, cudaErrorNotSupported
// when the driver has no cuTensorMapEncodeTiled.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// element strides of one (B, S, heads, D) operand; D itself is contiguous
struct Strides {
  long long b, s, h;
};
struct Layout {
  Strides q, k, v, o;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- CUDA cores

namespace simt {

constexpr int kThreads = 256;
constexpr int TPR = 16;                  // threads per row group (lanes of one warp)
constexpr int RS = kThreads / TPR;       // row groups; a thread's rows are RS apart
constexpr int NI = 4;                    // query rows per thread
constexpr int BQ = RS * NI;              // 64 query rows per block
constexpr int BK = 64;                   // kv rows per tile
constexpr int NJ = BK / TPR;             // logits per row and thread
constexpr int PP = BK + 16;              // padded row of P: the two row groups
                                         // of a warp write 16 banks apart

template <int D>
struct Geom {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  // Q and K rows padded by 4 floats: D + 4 is an odd multiple of 4 modulo
  // 32, so the 16 K rows (and the 2 Q rows) a warp reads at one d cover the
  // banks in the fewest passes
  static constexpr int DP = D + 4;
  static constexpr int CPT = D / TPR;  // output columns per thread
  static constexpr int VW = CPT % 4 == 0 ? 4 : CPT % 2 == 0 ? 2 : 1;
  static constexpr int NV = CPT / VW;  // vectors of V (and O) per row
  static constexpr size_t smem =
      sizeof(float) * ((size_t)(BQ + BK) * DP + (size_t)BK * D + (size_t)BQ * PP);
};

// 16 bytes from global to shared memory, asynchronously; zeros when !in
__device__ __forceinline__ void cp_async16(float* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(smem_addr(dst)), "l"(src), "r"(in ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// rows [r0, r0 + ROWS) of an (S, D) operand whose rows are `stride`
// elements apart, into f32 rows `ld` floats apart; rows at or past S are
// zero (they are masked or never written back).  f32 goes by cp.async and
// completes at cp_async_wait_all(); bf16 is widened through registers
// (a 16-bit shift, exact) and is in place on return.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(const float* __restrict__ base, int r0,
                                          int S, long long stride, float* dst,
                                          int ld) {
  constexpr int CPR = D / 4;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < ROWS * CPR; idx += kThreads) {
    const int rr = idx / CPR, c = idx % CPR;
    const bool in = r0 + rr < S;
    cp_async16(dst + rr * ld + 4 * c, in ? base + (r0 + rr) * stride + 4 * c : base, in);
  }
}

template <int D, int ROWS>
__device__ __forceinline__ void load_tile(const __nv_bfloat16* __restrict__ base,
                                          int r0, int S, long long stride,
                                          float* dst, int ld) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < ROWS * CPR; idx += kThreads) {
    const int rr = idx / CPR, c = idx % CPR;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (r0 + rr < S)
      u = *reinterpret_cast<const uint4*>(base + (r0 + rr) * stride + 8 * c);
    const unsigned int w[4] = {u.x, u.y, u.z, u.w};
    float f[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
    float4* d = reinterpret_cast<float4*>(dst + rr * ld + 8 * c);
    d[0] = make_float4(f[0], f[1], f[2], f[3]);
    d[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int VW>
__device__ __forceinline__ void load_row(const float* p, float (&o)[VW]) {
  if constexpr (VW == 4) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    o[0] = u.x; o[1] = u.y; o[2] = u.z; o[3] = u.w;
  } else if constexpr (VW == 2) {
    const float2 u = *reinterpret_cast<const float2*>(p);
    o[0] = u.x; o[1] = u.y;
  } else {
    o[0] = *p;
  }
}

__device__ __forceinline__ float lane(const float4& x, int c) {
  return c == 0 ? x.x : c == 1 ? x.y : c == 2 ? x.z : x.w;
}

// A block of 256 threads owns 64 query rows of one (b, h); 16 row groups
// of 16 lanes, each group 4 rows 16 apart.  Per 64-row kv tile a thread
// computes a 4 x 4 tile of S (kv columns tx + 16 j) from float4 reads of
// Q and K along d, the online softmax of its rows (max and sum across the
// group by shuffles), writes its p to shared memory, and accumulates a
// 4 x D/16 tile of O from float4 reads of P (4 kv rows at once) and V.
// Each K or V tile is read from L2 once per 64 rows.  There is one K and
// one V buffer: V's tile loads while S is computed from K, and the next K
// tile while O accumulates from V.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out, Layout L, int B,
          int H, int Kh, int Sq, int Skv, float scale, int causal,
          int q_offset) {
  using G = Geom<D>;
  constexpr int DP = G::DP, VW = G::VW, NV = G::NV;

  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // [BQ][DP]
  float* sK = sQ + BQ * DP;                     // [BK][DP]
  float* sV = sK + BK * DP;                     // [BK][D]
  float* sP = sV + BK * D;                      // [BQ][PP]

  const int n_qt = (Sq + BQ - 1) / BQ;
  const int bh = blockIdx.x % (B * H);
  const int qt = n_qt - 1 - blockIdx.x / (B * H);  // heaviest q tiles first
  const int h = bh % H, b = bh / H;
  const int kvh = h / (H / Kh);
  const int q0 = qt * BQ;
  const int rg = threadIdx.x / TPR, tx = threadIdx.x % TPR;

  const T* qb = q + b * L.q.b + h * L.q.h;
  const T* kb = k + b * L.k.b + kvh * L.k.h;
  const T* vb = v + b * L.v.b + kvh * L.v.h;

  int n_kt = (Skv + BK - 1) / BK;
  if (causal)  // skip tiles above the diagonal of the block's last row
    n_kt = min(n_kt, (q_offset + q0 + BQ - 1) / BK + 1);

  load_tile<D, BQ>(qb, q0, Sq, L.q.s, sQ, DP);
  load_tile<D, BK>(kb, 0, Skv, L.k.s, sK, DP);
  cp_async_commit();

  float o[NI][NV * VW];
  float m[NI], l[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NV * VW; ++c) o[i][c] = 0.f;
  }
  cp_async_wait_all();
  __syncthreads();

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    load_tile<D, BK>(vb, k0, Skv, L.v.s, sV, D);  // lands while S is computed
    cp_async_commit();

    // S = Q . K^T: d in ascending order for every (row, column)
    float s[NI][NJ];
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; d += 4) {
      float4 qv[NI], kv[NJ];
#pragma unroll
      for (int i = 0; i < NI; ++i)
        qv[i] = *reinterpret_cast<const float4*>(sQ + (rg + RS * i) * DP + d);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        kv[j] = *reinterpret_cast<const float4*>(sK + (tx + TPR * j) * DP + d);
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // only a tile that crosses the block's first row's diagonal or the end
    // of Skv has masked entries
    const bool crosses = k0 + BK > Skv || (causal && k0 + BK - 1 > q_offset + q0);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int row = q_offset + q0 + rg + RS * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = k0 + tx + TPR * j;
        const bool ok = !crosses || (col < Skv && (!causal || col <= row));
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < TPR; off *= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = m[i] == -INFINITY ? 0.f : expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float p = m_new == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        sP[(rg + RS * i) * PP + tx + TPR * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 1; off < TPR; off *= 2)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int c = 0; c < NV * VW; ++c) o[i][c] *= alpha;
      m[i] = m_new;
    }
    cp_async_wait_all();
    __syncthreads();  // V and P in place; every thread is done with K

    if (kt + 1 < n_kt) {  // the next K tile lands while O accumulates
      load_tile<D, BK>(kb, k0 + BK, Skv, L.k.s, sK, DP);
      cp_async_commit();
    }

    // O += P . V: kv rows in ascending order
#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float4 pv[NI];
#pragma unroll
      for (int i = 0; i < NI; ++i)
        pv[i] = *reinterpret_cast<const float4*>(sP + (rg + RS * i) * PP + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vr = sV + (c + cc) * D + tx * VW;
#pragma unroll
        for (int jj = 0; jj < NV; ++jj) {
          float vv[VW];
          load_row<VW>(vr + TPR * VW * jj, vv);
#pragma unroll
          for (int i = 0; i < NI; ++i) {
            const float p = lane(pv[i], cc);
#pragma unroll
            for (int e = 0; e < VW; ++e)
              o[i][jj * VW + e] = fmaf(p, vv[e], o[i][jj * VW + e]);
          }
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();  // the next K in place; every thread is done with V, P
  }

  T* ob = out + b * L.o.b + h * L.o.h;
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int row = q0 + rg + RS * i;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = ob + row * L.o.s + tx * VW;
#pragma unroll
    for (int jj = 0; jj < NV; ++jj)
#pragma unroll
      for (int e = 0; e < VW; ++e)
        store(orow + TPR * VW * jj + e, o[i][jj * VW + e] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const Layout& L, int B, int H, int Kh, int Sq, int Skv,
                   float scale, int causal, int q_offset, cudaStream_t stream) {
  constexpr size_t smem = Geom<D>::smem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long grid = (long long)((Sq + BQ - 1) / BQ) * B * H;
  if (grid > 2147483647LL) return cudaErrorInvalidValue;
  flash_fwd<T, D><<<(unsigned)grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), L, B, H, Kh, Sq, Skv,
      scale, causal, q_offset);
  return cudaGetLastError();
}

#define FLASH_SIMT_CASE(T, DD)                                              \
  case DD:                                                                  \
    return launch<T, DD>(q, k, v, out, L, B, H, Kh, Sq, Skv, scale, causal, \
                         q_offset, st);

// f32 at every multiple of 16 up to 128 and at 192; bf16 below 64 (the
// tensor cores take it from 64)
cudaError_t by_d_f32(int D, const void* q, const void* k, const void* v,
                     void* out, const Layout& L, int B, int H, int Kh, int Sq,
                     int Skv, float scale, int causal, int q_offset,
                     cudaStream_t st) {
  switch (D) {
    FLASH_SIMT_CASE(float, 16) FLASH_SIMT_CASE(float, 32)
    FLASH_SIMT_CASE(float, 48) FLASH_SIMT_CASE(float, 64)
    FLASH_SIMT_CASE(float, 80) FLASH_SIMT_CASE(float, 96)
    FLASH_SIMT_CASE(float, 112) FLASH_SIMT_CASE(float, 128)
    FLASH_SIMT_CASE(float, 192)
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t by_d_bf16(int D, const void* q, const void* k, const void* v,
                      void* out, const Layout& L, int B, int H, int Kh, int Sq,
                      int Skv, float scale, int causal, int q_offset,
                      cudaStream_t st) {
  switch (D) {
    FLASH_SIMT_CASE(__nv_bfloat16, 16) FLASH_SIMT_CASE(__nv_bfloat16, 32)
    FLASH_SIMT_CASE(__nv_bfloat16, 48)
    default: return cudaErrorInvalidValue;
  }
}

#undef FLASH_SIMT_CASE

}  // namespace simt

// -------------------------------------------------------------- tensor cores

namespace tc {

constexpr int BM = 128;         // query rows per CTA
constexpr int kStages = 2;      // K/V ring depth
constexpr int kConsumers = 2;   // warpgroups of 64 query rows
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer warpgroup
constexpr int kProducerRegs = 24, kConsumerRegs = 240;

// The tiling of one head dim D (a multiple of 16 from 64 to 128, or 192).
// A tile is NDB blocks of [rows][64] bf16; columns D .. DP - 1 of the last
// block are TMA's zero fill on loads and clipped on the store, so a head
// dim between the instances is read and written at D with no copies.  At
// D 192, BN 128 would need 240 KB of shared memory for Q and two stages of
// K and V, over the 227 KB a block may have: the kv tile is 64 rows there.
template <int D>
struct Geom {
  static_assert(D % 16 == 0 && ((D >= 64 && D <= 128) || D == 192),
                "tensor-core head dims: multiples of 16 from 64 to 128, and 192");
  static constexpr int NDB = (D + 63) / 64;    // 64-column blocks of a tile
  static constexpr int DP = NDB * 64;          // the tile's width in columns
  static constexpr int BN = D > 128 ? 64 : 128;  // kv rows per tile
};

// Every tile is NDB blocks of [rows][64] bf16: 128-byte rows in TMA's
// 128-byte swizzle, each block 1024-byte aligned.  q doubles as the output
// staging of each warpgroup's own 64 rows.
template <int D>
struct alignas(1024) Smem {
  static constexpr int NDB = Geom<D>::NDB, BN = Geom<D>::BN;
  __nv_bfloat16 q[NDB][BM * 64];
  __nv_bfloat16 k[kStages][NDB][BN * 64];
  __nv_bfloat16 v[kStages][NDB][BN * 64];
  uint64_t q_full, k_full[kStages], v_full[kStages], kv_empty[kStages];
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_addr(bar)) : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// one box of a 4-D tensor map (coordinates innermost first) into shared
// memory, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(src)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 = 128B
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4)
         | ((uint64_t)(lbo >> 4) << 16)
         | ((uint64_t)(sbo >> 4) << 32)
         | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keep reads and writes of wgmma operand registers on their side of the
// wait (the products run asynchronously)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x 128, f32) (+)= A (64 x 16, smem) . B (16 x 128, smem); A and B K-major
__device__ __forceinline__ void wgmma_ss_m64n128k16(float (&d)[64], uint64_t da,
                                                  uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64, f32) (+)= A (64 x 16, smem) . B (16 x 64, smem); A and B K-major
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t da,
                                                  uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 128, f32) += A (64 x 16, bf16 registers) . B (16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, f32) += A (64 x 16, bf16 registers) . B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 192, f32) += A (64 x 16, bf16 registers) . B (16 x 192, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_m64n192k16(float (&d)[96], const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// S (64 x BN) (+)= Q . K^T, one k-step
template <int BN>
__device__ __forceinline__ void wgmma_qk(float (&d)[BN / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (BN == 128) wgmma_ss_m64n128k16(d, da, db, accumulate);
  else wgmma_ss_m64n64k16(d, da, db, accumulate);
}

// O (64 x DP) += P . V, one k-step
template <int DP>
__device__ __forceinline__ void wgmma_pv(float (&o)[DP / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (DP == 192) wgmma_rs_m64n192k16(o, a, db);
  else if constexpr (DP == 128) wgmma_rs_m64n128k16(o, a, db);
  else wgmma_rs_m64n64k16(o, a, db);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tc(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             const __grid_constant__ CUtensorMap to, int B, int H, int Kh,
             int Sq, int Skv, float scale_log2, int causal, int q_offset) {
  constexpr int NDB = Geom<D>::NDB, DP = Geom<D>::DP, BN = Geom<D>::BN;
  // bytes of one Q and of one K or V tile, the zero-filled columns included
  constexpr uint32_t kQBytes = BM * DP * 2, kKVBytes = BN * DP * 2;
  extern __shared__ uint8_t smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int n_qt = (Sq + BM - 1) / BM;
  const int bh = blockIdx.x % (B * H);
  const int qt = n_qt - 1 - blockIdx.x / (B * H);  // heaviest q tiles first
  const int h = bh % H, b = bh / H;
  const int kvh = h / (H / Kh);
  const int q0 = qt * BM;
  int n_kt = (Skv + BN - 1) / BN;
  if (causal)  // skip tiles above the diagonal of the CTA's last row
    n_kt = min(n_kt, (q_offset + q0 + BM - 1) / BN + 1);

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.kv_empty[s], kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(kProducerRegs));
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(&sm.q_full, kQBytes);
#pragma unroll
      for (int db = 0; db < NDB; ++db)
        tma_load(sm.q[db], &tq, &sm.q_full, db * 64, q0, h, b);
      for (int t = 0; t < n_kt; ++t) {
        const int s = t % kStages, u = t / kStages;
        if (u > 0) mbar_wait(&sm.kv_empty[s], (u - 1) & 1);
        mbar_expect_tx(&sm.k_full[s], kKVBytes);
#pragma unroll
        for (int db = 0; db < NDB; ++db)
          tma_load(sm.k[s][db], &tk, &sm.k_full[s], db * 64, t * BN, kvh, b);
        mbar_expect_tx(&sm.v_full[s], kKVBytes);
#pragma unroll
        for (int db = 0; db < NDB; ++db)
          tma_load(sm.v[s][db], &tv, &sm.v_full[s], db * 64, t * BN, kvh, b);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(kConsumerRegs));
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int r_lo = (tid / 32) * 16 + lane / 4;  // rows r_lo, r_lo + 8 of the 64
    // absolute positions of this thread's two rows
    const int row0 = q_offset + q0 + wg * 64 + r_lo, row1 = row0 + 8;
    const int col_off = 2 * (lane % 4);
    const char* q_rows = reinterpret_cast<const char*>(sm.q[0]) + wg * 64 * 128;

    // 64 x DP accumulator: o[4j + {0,1}] row0, o[4j + {2,3}] row1; the
    // columns from D on stay zero and are never stored
    float o[DP / 2];
    float sc[BN / 2];  // 64 x BN scores, same layout over kv columns
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY;  // running max, log2 domain
    float l0 = 0.f, l1 = 0.f;  // this thread's share of the row sums

    mbar_wait(&sm.q_full, 0);
    for (int t = 0; t < n_kt; ++t) {
      const int s = t % kStages;
      const uint32_t par = (t / kStages) & 1;
      const int k0 = t * BN;

      // S = Q . K^T: 64 x BN, D/16 k-steps of 32 bytes along the swizzled
      // rows (none over the zero-filled columns)
      mbar_wait(&sm.k_full[s], par);
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int db = kk / 4, kb = (kk % 4) * 32;
        const uint64_t da = sw128_desc(q_rows + db * BM * 128 + kb, 0, 1024);
        const uint64_t dk = sw128_desc(
            reinterpret_cast<const char*>(sm.k[s][db]) + kb, 0, 1024);
        wgmma_qk<BN>(sc, da, dk, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // mask only the tiles that cross the diagonal of this warpgroup's
      // first (absolute) row or the end of Skv
      const bool crosses = k0 + BN > Skv
                           || (causal && k0 + BN - 1 > q_offset + q0 + wg * 64);
      if (crosses) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = k0 + 8 * j + col_off + e;
            if (col >= Skv || (causal && col > row0)) sc[4 * j + e] = -INFINITY;
            if (col >= Skv || (causal && col > row1)) sc[4 * j + 2 + e] = -INFINITY;
          }
      }

      // online softmax on the accumulator's layout: a row is a quad of lanes
      float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        t0 = fmaxf(t0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        t1 = fmaxf(t1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, 1));
      t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, 1));
      t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, 2));
      t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, 2));
      const float mn0 = fmaxf(m0, t0 * scale_log2);
      const float mn1 = fmaxf(m1, t1 * scale_log2);
      const float a0 = m0 == -INFINITY ? 0.f : ex2(m0 - mn0);
      const float a1 = m1 == -INFINITY ? 0.f : ex2(m1 - mn1);
      // p = 0 when the new max is -inf: then every logit of the row is -inf
      // and ex2(-inf + 0) = 0
      const float nm0 = mn0 == -INFINITY ? 0.f : -mn0;
      const float nm1 = mn1 == -INFINITY ? 0.f : -mn1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[4 * j + e] = ex2(fmaf(sc[4 * j + e], scale_log2, nm0));
          sc[4 * j + 2 + e] = ex2(fmaf(sc[4 * j + 2 + e], scale_log2, nm1));
          rs0 += sc[4 * j + e];
          rs1 += sc[4 * j + 2 + e];
        }
      l0 = l0 * a0 + rs0;
      l1 = l1 * a1 + rs1;
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= a0;
        o[4 * j + 1] *= a0;
        o[4 * j + 2] *= a1;
        o[4 * j + 3] *= a1;
      }
      // P in bf16: the accumulator fragment of 16 kv columns is the A
      // fragment of one k-step of P . V
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }

      // O += P . V: V MN-major (D contiguous); a k-step is 16 kv rows (2048
      // bytes), the 64-column blocks of DP are BN * 128 bytes apart
      mbar_wait(&sm.v_full[s], par);
      fence_regs(o);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint64_t dv = sw128_desc(
            reinterpret_cast<const char*>(sm.v[s][0]) + kk * 16 * 128, BN * 128, 1024);
        wgmma_pv<DP>(o, pa[kk], dv);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      fence_regs(pa);
      mbar_arrive(&sm.kv_empty[s]);
    }

    // epilogue: normalise, stage in this warpgroup's own Q rows in the
    // swizzled layout of the output map, one TMA store per column block
    // (clipped at D)
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / fmaxf(l0, 1e-30f);
    const float inv1 = 1.f / fmaxf(l1, 1e-30f);
    char* stage = reinterpret_cast<char*>(sm.q[0]) + wg * 64 * 128;
    const int sw = lane / 4;  // (row % 8) of both rows, for the swizzle
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int db = j / 8, chunk = (j % 8) ^ sw;
      char* base = stage + db * BM * 128 + chunk * 16 + col_off * 2;
      *reinterpret_cast<uint32_t*>(base + r_lo * 128) =
          pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      *reinterpret_cast<uint32_t*>(base + (r_lo + 8) * 128) =
          pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" :: "r"(1 + wg) : "memory");
    if (tid == 0) {
#pragma unroll
      for (int db = 0; db < NDB; ++db)
        tma_store(&to, stage + db * BM * 128, db * 64, q0 + wg * 64, h, b);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, through the runtime: no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 4-D map (D, S, heads, B) over an operand with element strides `st`:
// boxes of 64 columns x `rows` rows of one head, 128-byte swizzle, zero
// fill out of bounds
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* base, int B,
              int S, int heads, int D, const Strides& st, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)heads,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.s * 2, (cuuint64_t)st.h * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const Layout& L, int B, int H, int Kh, int Sq, int Skv,
                   float scale, int causal, int q_offset, cudaStream_t stream) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  constexpr int BN = Geom<D>::BN;
  CUtensorMap tq, tk, tv, to;
  if (!make_map(enc, &tq, q, B, Sq, H, D, L.q, BM)
      || !make_map(enc, &tk, k, B, Skv, Kh, D, L.k, BN)
      || !make_map(enc, &tv, v, B, Skv, Kh, D, L.v, BN)
      || !make_map(enc, &to, out, B, Sq, H, D, L.o, 64))
    return cudaErrorInvalidValue;
  constexpr int smem = (int)sizeof(Smem<D>) + 1024;  // + alignment slack
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long grid = (long long)((Sq + BM - 1) / BM) * B * H;
  if (grid > 2147483647LL) return cudaErrorInvalidValue;
  flash_fwd_tc<D><<<(unsigned)grid, kThreads, smem, stream>>>(
      tq, tk, tv, to, B, H, Kh, Sq, Skv, scale * 1.4426950408889634f, causal,
      q_offset);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// q/out (B, Sq, H, D), k/v (B, Skv, Kh, D) as element strides: `strides`
// holds (batch, sequence, head) for q, k, v and out in that order; D is
// contiguous, every other stride a multiple of 16 bytes, every base 16-byte
// aligned.  dtype: 0 = float32, 1 = bfloat16.  route: 0 = CUDA cores (f32 at
// D in {16, 32, ..., 128, 192}, bf16 at D in {16, 32, 48}), 1 = tensor cores
// (bf16, D in {64, 80, 96, 112, 128, 192}).  H % Kh == 0, Skv > 0.  q_offset
// >= 0 is the absolute position of query row 0.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, const long long* strides, int B,
                               int H, int Kh, int Sq, int Skv, int D,
                               float scale, int causal, int q_offset, int dtype,
                               int route, void* stream) {
  if (B == 0 || Sq == 0 || H == 0) return 0;
  if (Kh <= 0 || H % Kh || Skv <= 0 || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Layout L = {{strides[0], strides[1], strides[2]},
                    {strides[3], strides[4], strides[5]},
                    {strides[6], strides[7], strides[8]},
                    {strides[9], strides[10], strides[11]}};
  if (route == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    switch (D) {
      case 64: return (int)tc::launch<64>(q, k, v, out, L, B, H, Kh, Sq, Skv, scale, causal, q_offset, st);
      case 80: return (int)tc::launch<80>(q, k, v, out, L, B, H, Kh, Sq, Skv, scale, causal, q_offset, st);
      case 96: return (int)tc::launch<96>(q, k, v, out, L, B, H, Kh, Sq, Skv, scale, causal, q_offset, st);
      case 112: return (int)tc::launch<112>(q, k, v, out, L, B, H, Kh, Sq, Skv, scale, causal, q_offset, st);
      case 128: return (int)tc::launch<128>(q, k, v, out, L, B, H, Kh, Sq, Skv, scale, causal, q_offset, st);
      case 192: return (int)tc::launch<192>(q, k, v, out, L, B, H, Kh, Sq, Skv, scale, causal, q_offset, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)simt::by_d_f32(D, q, k, v, out, L, B, H, Kh, Sq, Skv, scale, causal, q_offset, st);
  if (dtype == 1)
    return (int)simt::by_d_bf16(D, q, k, v, out, L, B, H, Kh, Sq, Skv, scale, causal, q_offset, st);
  return (int)cudaErrorInvalidValue;
}
