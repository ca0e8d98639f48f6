// Row copies shared by segment_compact.cu and segment_move.cu.
//
// A row is opaque bytes, so a copy is exact for any dtype.  The blocks that
// share a row (`parts` of them) split it into strided 16-byte vectors, and
// each thread keeps 64 bytes in flight: all its loads are issued before its
// stores.  Adjacent threads touch adjacent vectors (coalesced).  A block of
// 512 threads covers a 32 KB row (a 16-token page of 8 heads x 128 in bf16)
// in one pass: on the H100 that measured ~1% faster than two blocks of 256
// per row, which matched torch.index_select.
//
// Which copy a launch uses follows from the alignment of its bases and the
// row length (each kernel's C entry picks it):
//   Vec<uint4> — everything 16-byte aligned: 16-byte loads and stores;
//   Realign    — everything 4-byte aligned, but a row's source and
//                destination may sit at different offsets within 16 bytes
//                (an int32 row of 16,383 elements): 16-byte stores to the
//                destination's aligned body, each built from two aligned
//                16-byte loads of the source shifted by whole words; the
//                head and tail (under 16 bytes each) go word by word;
//   Vec<uint16_t> / Vec<uint8_t> — the rest, element by element.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rows {

constexpr int kThreads = 512;

template <typename V>
struct Vec {};
struct Realign {};

// bytes of a row one block covers per pass
template <typename C> struct PerBlock;
template <typename V> struct PerBlock<Vec<V>> {
  static constexpr int kUnroll = sizeof(V) >= 4 ? 64 / (int)sizeof(V) : 16;
  static constexpr long long kBytes = (long long)kThreads * kUnroll * sizeof(V);
};
template <> struct PerBlock<Realign> {
  static constexpr int kUnroll = 2;  // two pairs of 16-byte loads: 64 bytes
  static constexpr long long kBytes = (long long)kThreads * kUnroll * 16;
};

// the blocks that share a row (grid y or z, so at most 65,535: threads
// stride the rest)
template <typename C>
inline unsigned parts(long long row_bytes) {
  long long n = (row_bytes + PerBlock<C>::kBytes - 1) / PerBlock<C>::kBytes;
  return (unsigned)(n < 1 ? 1 : n > 65535 ? 65535 : n);
}

template <typename V>
__device__ __forceinline__ void copy(Vec<V>, const char* S, char* D,
                                     long long row_bytes, int part, int n_parts) {
  constexpr int U = PerBlock<Vec<V>>::kUnroll;
  const V* in = reinterpret_cast<const V*>(S);
  V* out = reinterpret_cast<V*>(D);
  const long long n = row_bytes / (long long)sizeof(V);
  const long long step = (long long)n_parts * kThreads;
  for (long long c0 = (long long)part * kThreads + threadIdx.x; c0 < n;
       c0 += step * U) {
    V buf[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (c0 + u * step < n) buf[u] = in[c0 + u * step];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (c0 + u * step < n) out[c0 + u * step] = buf[u];
  }
}

// words sh .. sh + 3 of the 8 words of (a, b)
__device__ __forceinline__ uint4 shift_words(uint4 a, uint4 b, int sh) {
  switch (sh) {
    case 0: return a;
    case 1: return make_uint4(a.y, a.z, a.w, b.x);
    case 2: return make_uint4(a.z, a.w, b.x, b.y);
    default: return make_uint4(a.w, b.x, b.y, b.z);
  }
}

__device__ __forceinline__ void copy(Realign, const char* S, char* D,
                                     long long row_bytes, int part, int n_parts) {
  constexpr int U = PerBlock<Realign>::kUnroll;
  long long head = (long long)((16 - ((uintptr_t)D & 15)) & 15);
  if (head > row_bytes) head = row_bytes;
  const long long body = (row_bytes - head) / 16;
  const long long tail = row_bytes - head - body * 16;
  if (part == 0 && threadIdx.x < head / 4)
    reinterpret_cast<unsigned*>(D)[threadIdx.x] =
        reinterpret_cast<const unsigned*>(S)[threadIdx.x];
  if (part == n_parts - 1 && threadIdx.x < tail / 4) {
    const long long off = head + body * 16 + 4 * threadIdx.x;
    *reinterpret_cast<unsigned*>(D + off) =
        *reinterpret_cast<const unsigned*>(S + off);
  }
  // the source of the first aligned destination vector, in whole words past
  // an aligned address; the second load of the last vector stays inside the
  // aligned 16 bytes that hold the row's last body byte
  const char* Sa = S + head;
  const int sh = (int)(((uintptr_t)Sa & 15) >> 2);
  const uint4* in = reinterpret_cast<const uint4*>((uintptr_t)Sa & ~(uintptr_t)15);
  uint4* out = reinterpret_cast<uint4*>(D + head);
  const long long step = (long long)n_parts * kThreads;
  for (long long c0 = (long long)part * kThreads + threadIdx.x; c0 < body;
       c0 += step * U) {
    uint4 a[U], b[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (c0 + u * step < body) {
        a[u] = in[c0 + u * step];
        b[u] = sh ? in[c0 + u * step + 1] : a[u];
      }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (c0 + u * step < body) out[c0 + u * step] = shift_words(a[u], b[u], sh);
  }
}

}  // namespace rows
