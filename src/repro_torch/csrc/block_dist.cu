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
//
// Grouped form (block_dist_tree_f32), the one the main path runs. The
// per-leaf form costs a whole tree (338 leaves for qwen2-1.5b) one Python
// wrapper call, a padding copy of every ragged leaf and two launches per
// leaf, and the host's share of that exceeded the card's. The grouped form
// walks a leaf table in device memory, as a grouped GEMM walks its pointer
// array, in one launch of each pass:
//   geom[4 l .. 4 l + 3]  item_start, chunks per block (cpb), block_elems
//                         and numel of leaf l;
//   ptrs[2 l], [2 l + 1]  the a and b base addresses of leaf l (f32, or
//                         bf16 with bit 0 set in both, contiguous), the
//                         one column that changes with the tensors;
//   item_leaf[g]          the leaf of work item g.
// Item g of leaf l is chunk c of block k, g - item_start = k * cpb + c, and
// reads elements [k * block_elems + c * kChunk, min(+ kChunk, (k + 1) *
// block_elems, numel)) of the leaf in place: the padding rows of the
// per-leaf view would add 0, so none is made. Whether an item takes 16-byte
// loads (8-byte for bf16: four values either way) is read on the card from
// its leaf's bases and pitch. A bf16 leaf pair is read in place and widened
// exactly (its 16 bits are the high half of the f32), each thread taking
// the same elements in the same order as from an f32 copy, so the scores
// are those of the copy, without the copy: a served bf16 tree of 22 GB
// would otherwise stage 90 GB of f32 copies (both trees, 4 bytes a value). Pass 2 is one
// warp per global block j: segs[2 s], segs[2 s + 1] (first partial, count),
// s in [seg_start[j], seg_start[j + 1]), one segment per leaf that holds
// block j, in leaf order. Each segment is summed as block_dist_finish sums
// a block and the segments are added in that order, so colocated leaves
// accumulate as block_scores adds them, and every run gives the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kChunk = 8192;   // elements per pass-1 CTA (multiple of 4)
constexpr int kVecLoads = kChunk / 4 / kThreads;   // float4s a thread reads per input

constexpr uint64_t kBf16Flag = 1;  // bit 0 of a pointer: the leaf is bf16

__device__ __forceinline__ int64_t imin(int64_t x, int64_t y) { return x < y ? x : y; }

// bf16 to f32, exact: the low and high bf16 of a little-endian 32-bit word,
// and one value read alone.
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ float bf16_at(const uint16_t* p, int64_t i) {
  return __uint_as_float(static_cast<uint32_t>(__ldg(p + i)) << 16);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Sum of (a[i] - b[i])^2 over elements [lo, hi) on this thread (thread t
// takes every kThreads-th element or float4 from lo + t). With vec, a and b
// are 16-byte aligned and lo is a multiple of 4; a chunk of whole float4s
// has its loads unrolled, the tail past the last whole float4 (at a leaf's
// end) is read one element at a time.
__device__ __forceinline__ float chunk_sq_dist(const float* __restrict__ a,
                                               const float* __restrict__ b,
                                               int64_t lo, int64_t hi, bool vec) {
  float acc = 0.f;
  if (!vec) {
    for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads) {
      const float d = __ldg(a + i) - __ldg(b + i);
      acc = fmaf(d, d, acc);
    }
    return acc;
  }
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const float4* b4 = reinterpret_cast<const float4*>(b);
  const int64_t q_lo = lo / 4, q_hi = hi / 4;
  if (q_hi - q_lo == kChunk / 4) {
    float4 x[kVecLoads], y[kVecLoads];
#pragma unroll
    for (int u = 0; u < kVecLoads; ++u) {
      x[u] = __ldg(a4 + q_lo + threadIdx.x + u * kThreads);
      y[u] = __ldg(b4 + q_lo + threadIdx.x + u * kThreads);
    }
#pragma unroll
    for (int u = 0; u < kVecLoads; ++u) {
      float d = x[u].x - y[u].x; acc = fmaf(d, d, acc);
      d = x[u].y - y[u].y; acc = fmaf(d, d, acc);
      d = x[u].z - y[u].z; acc = fmaf(d, d, acc);
      d = x[u].w - y[u].w; acc = fmaf(d, d, acc);
    }
  } else {
    for (int64_t i = q_lo + threadIdx.x; i < q_hi; i += kThreads) {
      const float4 x = __ldg(a4 + i);
      const float4 y = __ldg(b4 + i);
      float d = x.x - y.x; acc = fmaf(d, d, acc);
      d = x.y - y.y; acc = fmaf(d, d, acc);
      d = x.z - y.z; acc = fmaf(d, d, acc);
      d = x.w - y.w; acc = fmaf(d, d, acc);
    }
  }
  for (int64_t i = 4 * q_hi + threadIdx.x; i < hi; i += kThreads) {
    const float d = __ldg(a + i) - __ldg(b + i);
    acc = fmaf(d, d, acc);
  }
  return acc;
}

// chunk_sq_dist on bf16 inputs: the same elements on each thread in the same
// order, four values (8 bytes) a load where a and b are 8-byte aligned.
__device__ __forceinline__ float chunk_sq_dist_bf16(const uint16_t* __restrict__ a,
                                                    const uint16_t* __restrict__ b,
                                                    int64_t lo, int64_t hi, bool vec) {
  float acc = 0.f;
  if (!vec) {
    for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads) {
      const float d = bf16_at(a, i) - bf16_at(b, i);
      acc = fmaf(d, d, acc);
    }
    return acc;
  }
  const uint2* a4 = reinterpret_cast<const uint2*>(a);
  const uint2* b4 = reinterpret_cast<const uint2*>(b);
  const int64_t q_lo = lo / 4, q_hi = hi / 4;
  auto fold4 = [&acc](uint2 x, uint2 y) {
    float d = bf16_lo(x.x) - bf16_lo(y.x); acc = fmaf(d, d, acc);
    d = bf16_hi(x.x) - bf16_hi(y.x); acc = fmaf(d, d, acc);
    d = bf16_lo(x.y) - bf16_lo(y.y); acc = fmaf(d, d, acc);
    d = bf16_hi(x.y) - bf16_hi(y.y); acc = fmaf(d, d, acc);
  };
  if (q_hi - q_lo == kChunk / 4) {
    uint2 x[kVecLoads], y[kVecLoads];
#pragma unroll
    for (int u = 0; u < kVecLoads; ++u) {
      x[u] = __ldg(a4 + q_lo + threadIdx.x + u * kThreads);
      y[u] = __ldg(b4 + q_lo + threadIdx.x + u * kThreads);
    }
#pragma unroll
    for (int u = 0; u < kVecLoads; ++u) fold4(x[u], y[u]);
  } else {
    for (int64_t i = q_lo + threadIdx.x; i < q_hi; i += kThreads) fold4(__ldg(a4 + i), __ldg(b4 + i));
  }
  for (int64_t i = 4 * q_hi + threadIdx.x; i < hi; i += kThreads) {
    const float d = bf16_at(a, i) - bf16_at(b, i);
    acc = fmaf(d, d, acc);
  }
  return acc;
}

// The CTA's sum of every thread's acc, on thread 0, in a fixed order.
__device__ __forceinline__ float cta_sum(float acc) {
  __shared__ float warp_part[kThreads / 32];
  acc = warp_sum(acc);
  if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x >> 5] = acc;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += warp_part[w];
  }
  return s;
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
  // elems % 4 == 0 and 16-byte aligned bases under kVec, so base is a
  // multiple of 4 elements
  const float s = cta_sum(chunk_sq_dist(a + base, b + base, lo, hi, kVec));
  if (threadIdx.x == 0) partials[blk * gridDim.y + chunk] = s;
}

// Grouped pass 1, grid: (n_items). Writes partials[g] (see the note above).
__global__ void __launch_bounds__(kThreads)
block_dist_tree_partials(const int64_t* __restrict__ geom,
                         const uint64_t* __restrict__ ptrs,
                         const int32_t* __restrict__ item_leaf,
                         float* __restrict__ partials) {
  const int64_t g = blockIdx.x;
  const int64_t leaf = item_leaf[g];
  const int64_t local = g - geom[4 * leaf];
  const int64_t cpb = geom[4 * leaf + 1];
  const int64_t block_elems = geom[4 * leaf + 2];
  const int64_t numel = geom[4 * leaf + 3];
  const uint64_t pa = ptrs[2 * leaf], pb = ptrs[2 * leaf + 1];
  const int64_t k = local / cpb;
  const int64_t block_lo = k * block_elems;
  const int64_t lo = block_lo + (local - k * cpb) * kChunk;
  const int64_t hi = imin(imin(lo + kChunk, block_lo + block_elems), numel);
  float acc = 0.f;
  if (lo < hi && (pa & kBf16Flag)) {
    const uint64_t a = pa & ~kBf16Flag, b = pb & ~kBf16Flag;
    acc = chunk_sq_dist_bf16(reinterpret_cast<const uint16_t*>(a),
                             reinterpret_cast<const uint16_t*>(b), lo, hi,
                             ((a | b) & 7) == 0 && block_elems % 4 == 0);
  } else if (lo < hi) {
    acc = chunk_sq_dist(reinterpret_cast<const float*>(pa),
                        reinterpret_cast<const float*>(pb), lo, hi,
                        ((pa | pb) & 15) == 0 && block_elems % 4 == 0);
  }
  const float s = cta_sum(acc);
  if (threadIdx.x == 0) partials[g] = s;
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

// Grouped pass 2: one warp per global block, its segments in order.
__global__ void block_dist_tree_finish(const float* __restrict__ partials,
                                       const int64_t* __restrict__ seg_start,
                                       const int64_t* __restrict__ segs,
                                       float* __restrict__ out, int64_t n_blocks) {
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_blocks) return;   // whole warps leave together
  float acc = 0.f;
  for (int64_t s = seg_start[warp]; s < seg_start[warp + 1]; ++s) {
    const int64_t first = segs[2 * s], count = segs[2 * s + 1];
    float v = 0.f;
    for (int64_t c = lane; c < count; c += 32) v += partials[first + c];
    acc += warp_sum(v);
  }
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

// The grouped form over a whole tree (tables as in the note at the top).
// partials: n_items f32 scratch; out: (n_blocks,) f32, the tree's global
// blocks. Returns cudaGetLastError() after the launches.
extern "C" int block_dist_tree_f32(const int64_t* geom, const uint64_t* ptrs,
                                   const int32_t* item_leaf, int64_t n_items,
                                   const int64_t* seg_start, const int64_t* segs,
                                   float* partials, float* out, int64_t n_blocks,
                                   cudaStream_t stream) {
  if (n_items > 0) {
    block_dist_tree_partials<<<static_cast<unsigned>(n_items), kThreads, 0, stream>>>(
        geom, ptrs, item_leaf, partials);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t threads = n_blocks * 32;
  block_dist_tree_finish<<<static_cast<unsigned>((threads + 255) / 256), 256, 0, stream>>>(
      partials, seg_start, segs, out, n_blocks);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
