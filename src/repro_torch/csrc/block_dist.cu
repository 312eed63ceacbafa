// Per-block squared-L2 distance: out[b] = sum_e (a[b, e] - b[b, e])^2.
//
// Replaces repro/kernels/block_dist/kernel.py::block_dist_pallas, SCAR's
// priority score (the l2 norm of repro/core/norms.py).
//
// Bound on an H100: bytes. Every element of both inputs is read once
// (8 bytes per element in f32) for 3 flops, far below the card's
// 295 flops-per-byte balance point, so the least time is the bytes over
// 3.35 TB/s.
//
// Design. The TPU kernel walks each block's E in order and carries a
// running sum in VMEM from one grid step to the next. On Hopper nothing
// carries over between CTAs, and a leaf of a 1.5 B model may have only a
// dozen blocks of ~200 k elements, so one CTA per block would leave most
// of the 132 SMs idle. Pass 1 therefore splits every block into chunks of
// kChunk elements, one CTA each; threads read 16 bytes at a time where the
// row and the bases allow it, sum in f32, and reduce with warp shuffles to
// one partial per chunk. Pass 2 sums each block's partials, one warp per
// block, in a fixed order. No atomics: the result is the same on every run,
// which matters because a top-k selection sits downstream.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kChunk = 8192;   // elements per pass-1 CTA (multiple of 4)

__device__ __forceinline__ int64_t imin(int64_t x, int64_t y) { return x < y ? x : y; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// grid: (n_blocks, n_chunks). Writes partials[b * n_chunks + c].
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
block_dist_partials(const float* __restrict__ a, const float* __restrict__ b,
                    float* __restrict__ partials, int64_t elems) {
  const int64_t blk = blockIdx.x;
  const int64_t chunk = blockIdx.y;
  const int64_t base = blk * elems;
  const int64_t lo = chunk * kChunk;
  const int64_t hi = imin(lo + kChunk, elems);
  float acc = 0.f;
  if (kVec) {
    // elems % 4 == 0 and 16-byte aligned bases, so lo, hi and base are
    // multiples of 4 elements.
    const float4* a4 = reinterpret_cast<const float4*>(a + base);
    const float4* b4 = reinterpret_cast<const float4*>(b + base);
    for (int64_t i = lo / 4 + threadIdx.x; i < hi / 4; i += kThreads) {
      const float4 x = __ldg(a4 + i);
      const float4 y = __ldg(b4 + i);
      float d = x.x - y.x; acc = fmaf(d, d, acc);
      d = x.y - y.y; acc = fmaf(d, d, acc);
      d = x.z - y.z; acc = fmaf(d, d, acc);
      d = x.w - y.w; acc = fmaf(d, d, acc);
    }
  } else {
    for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads) {
      const float d = __ldg(a + base + i) - __ldg(b + base + i);
      acc = fmaf(d, d, acc);
    }
  }
  __shared__ float warp_part[kThreads / 32];
  acc = warp_sum(acc);
  if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += warp_part[w];
    partials[blk * gridDim.y + chunk] = s;
  }
}

// One warp per block sums that block's n_chunks partials in a fixed order.
__global__ void block_dist_finish(const float* __restrict__ partials,
                                  float* __restrict__ out, int64_t n_blocks,
                                  int64_t n_chunks) {
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_blocks) return;   // whole warps leave together
  float acc = 0.f;
  for (int64_t c = lane; c < n_chunks; c += 32) acc += partials[warp * n_chunks + c];
  acc = warp_sum(acc);
  if (lane == 0) out[warp] = acc;
}

}  // namespace

extern "C" int64_t block_dist_chunks(int64_t elems) {
  return (elems + kChunk - 1) / kChunk;
}

// a, b: (n_blocks, elems) f32, contiguous. partials: n_blocks * chunks f32
// scratch; out: (n_blocks,) f32. Returns cudaGetLastError() after launch.
extern "C" int block_dist_f32(const float* a, const float* b, float* partials,
                              float* out, int64_t n_blocks, int64_t elems,
                              cudaStream_t stream) {
  const int64_t n_chunks = block_dist_chunks(elems);
  const dim3 grid(static_cast<unsigned>(n_blocks), static_cast<unsigned>(n_chunks));
  const bool vec = elems % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  if (vec) {
    block_dist_partials<true><<<grid, kThreads, 0, stream>>>(a, b, partials, elems);
  } else {
    block_dist_partials<false><<<grid, kThreads, 0, stream>>>(a, b, partials, elems);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t threads = n_blocks * 32;
  block_dist_finish<<<static_cast<unsigned>((threads + 255) / 256), 256, 0, stream>>>(
      partials, out, n_blocks, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
