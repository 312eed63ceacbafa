// Raw-byte copy helpers shared by scatter_save.cu, masked_restore.cu and
// arena_scatter.cu.
//
// The kernels move whole blocks of bytes whatever the element type, so
// they are written on an unsigned carrier V of 16, 8, 4, 2 or 1 bytes. The
// host picks the widest V that divides every offset and base address it
// will use, so neighbouring threads touch neighbouring 16-byte words on the
// common, aligned path.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr int kCopyThreads = 256;
constexpr int64_t kCopyChunk = 64 * 1024;   // bytes per CTA (multiple of 16)

__device__ __forceinline__ int64_t imin(int64_t x, int64_t y) { return x < y ? x : y; }

// Copy bytes [lo, hi) of src into dst; lo and hi are multiples of sizeof(V).
template <typename V>
__device__ __forceinline__ void copy_bytes(uint8_t* __restrict__ dst,
                                           const uint8_t* __restrict__ src,
                                           int64_t lo, int64_t hi) {
  V* d = reinterpret_cast<V*>(dst);
  const V* s = reinterpret_cast<const V*>(src);
  const int64_t end = hi / static_cast<int64_t>(sizeof(V));
  for (int64_t i = lo / static_cast<int64_t>(sizeof(V)) + threadIdx.x; i < end;
       i += blockDim.x) {
    d[i] = s[i];
  }
}

// Widest carrier (16, 8, 4, 2 or 1 bytes) that divides every value given.
inline int carrier_width(const uint64_t* values, int n) {
  uint64_t acc = 16;
  for (int i = 0; i < n; ++i) acc |= values[i];
  for (int w = 16; w > 1; w >>= 1) {
    if (acc % static_cast<uint64_t>(w) == 0) return w;
  }
  return 1;
}

}  // namespace repro_torch
