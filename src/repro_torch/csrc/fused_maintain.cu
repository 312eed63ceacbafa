// One leaf's maintenance sweep: the replica copy, one drift score per
// block, and the leaf's XOR parity folded into the codec's parity, all
// from one read of the live leaf x (and of the checkpoint leaf z).
//
// Replaces repro/kernels/fused_maintain/kernel.py::fused_maintain_pallas
// and the epilogue of its caller (fused_maintain/ops.py:117,
// make_fused_maintain_fn), which scatters the leaf's compact parity rows
// into the (n_groups, frame_elems) parity at the leaf's columns.
//
// The leaf is viewed as S blocks of E elements (block_rows rows each, the
// last block ragged: elements past the leaf's end are zeros), every block
// packed into `width` 32-bit words (core/blocks.py::leaf_block_words). A
// word-packable dtype packs `ratio` = 4 / element size raw elements per
// word, element 0 in the low-order bytes. Every other dtype the port holds
// (bool, f64, int64, complex64, complex128) stores one f32 image per word:
// the element converted as torch's .to(float32) converts it (round to
// nearest; complex: its real part), and the replica gets the element in
// its own width.
// The block's parity group is its row of the leaf's LeafGroupMeta: row r
// holds the local blocks members[r][...] of group touched[r].
//
// Bound on an H100: bytes. x and z are read once, the replica written once,
// the parity words of the touched rows read and written once (the fold
// XORs into what earlier leaves of the same groups left there), for a few
// operations per word: far below the card's balance point.
//
// Design. The TPU kernel visits blocks in group order on a sequential grid
// and carries each parity row in VMEM from its first member to its last.
// Here one CTA owns one (parity row, chunk of kChunk words) of the leaf: it
// walks the row's members itself, keeps the XOR of each of its words in
// registers, and writes the replica words and one score partial per
// (member, chunk) from the same read. It then XORs the folded words into
// parity[touched[r]][col + w]. Within a launch no two CTAs touch one parity
// word (a block belongs to one row, rows of one leaf are distinct groups,
// and the leaf's columns are its own); across leaves the launches are
// ordered on the stream, so colocated or column-sharing leaves fold in turn
// into a parity buffer zeroed once per maintenance. Scores: per-chunk
// partials reduced in a fixed order inside the CTA, then a second kernel
// sums each block's partials in a fixed order, one warp per block. No
// atomics, so scores are bit-identical from run to run.
#include <cuda_runtime.h>
#include <stdint.h>

#include "word_decode.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 8;                       // words per thread
constexpr int64_t kChunk = kThreads * kPer;   // words per CTA

struct Leaf {
  const void* x;            // live leaf, contiguous
  const void* z;            // checkpoint leaf (same dtype), or null
  void* replica;            // replica leaf (same dtype)
  uint32_t* parity;         // (n_groups * frame_elems) parity, or null
  float* partials;          // (S * n_chunks), or null when z is
  const int32_t* members;   // (n_out, m_hat) local block ids, -1 padded
  const int32_t* touched;   // (n_out,) group of each row
  int64_t m_hat;
  int64_t E;                // elements per block
  int64_t numel;            // elements of the leaf
  int64_t width;            // words per block
  int64_t col;              // the leaf's first frame column
  int64_t frame_elems;
  int64_t n_chunks;
  int code;                 // dtype code (word_decode.cuh)
};

// Element loaders, the `loader` argument of fused_maintain: kRaw1/2/4
// pack 4 / B raw elements of B bytes per word; the others load one element
// and return its f32 image.
enum : int { kRaw1 = 1, kRaw2 = 2, kRaw4 = 4, kBool = 5, kF64 = 6, kI64 = 7, kC64 = 8,
             kC128 = 9 };

// The f32 image of element e, copied to the replica when `rep` is set.
template <int L>
__device__ __forceinline__ float load_image(const void* src, void* rep, int64_t e) {
  if constexpr (L == kBool) {
    const uint8_t b = static_cast<const uint8_t*>(src)[e];
    if (rep) static_cast<uint8_t*>(rep)[e] = b;
    return b ? 1.f : 0.f;
  } else if constexpr (L == kF64 || L == kI64) {
    const unsigned long long b = static_cast<const unsigned long long*>(src)[e];
    if (rep) static_cast<unsigned long long*>(rep)[e] = b;
    if constexpr (L == kF64) return static_cast<float>(__longlong_as_double(b));
    else return static_cast<float>(static_cast<long long>(b));
  } else if constexpr (L == kC64) {
    const uint2 b = static_cast<const uint2*>(src)[e];          // (re, im) f32
    if (rep) static_cast<uint2*>(rep)[e] = b;
    return __uint_as_float(b.x);
  } else {                                                      // (re, im) f64
    const unsigned long long* p = static_cast<const unsigned long long*>(src) + 2 * e;
    const unsigned long long re = p[0], im = p[1];
    if (rep) {
      unsigned long long* q = static_cast<unsigned long long*>(rep) + 2 * e;
      q[0] = re;
      q[1] = im;
    }
    return static_cast<float>(__longlong_as_double(re));
  }
}

// Word w of block s; elements past the block or the leaf are zero bits.
// Also writes the word's elements to the replica when `rep` is set.
template <int L>
__device__ __forceinline__ uint32_t load_word(const void* src, void* rep, int64_t s,
                                              int64_t w, int64_t E, int64_t numel) {
  if constexpr (L == kRaw4 || L >= kBool) {                     // one element per word
    const int64_t e = s * E + w;
    if (e >= numel) return 0u;
    if constexpr (L == kRaw4) {
      const uint32_t v = static_cast<const uint32_t*>(src)[e];
      if (rep) static_cast<uint32_t*>(rep)[e] = v;
      return v;
    } else {
      return __float_as_uint(load_image<L>(src, rep, e));
    }
  } else {
    constexpr int R = 4 / L;
    uint32_t v = 0u;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int64_t ie = w * R + k;
      const int64_t e = s * E + ie;
      if (ie < E && e < numel) {
        uint32_t b;
        if constexpr (L == kRaw2) {
          b = static_cast<const uint16_t*>(src)[e];
          if (rep) static_cast<uint16_t*>(rep)[e] = static_cast<uint16_t>(b);
        } else {
          b = static_cast<const uint8_t*>(src)[e];
          if (rep) static_cast<uint8_t*>(rep)[e] = static_cast<uint8_t>(b);
        }
        v |= b << (8 * L * k);
      }
    }
    return v;
  }
}

template <int L>
__global__ void __launch_bounds__(kThreads) fused_leaf_kernel(const Leaf a) {
  __shared__ float red[kThreads / 32];
  const int64_t r = blockIdx.x;
  const int64_t c = blockIdx.y;
  const int64_t lo = c * kChunk;
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  uint32_t acc[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) acc[k] = 0u;
  for (int64_t mi = 0; mi < a.m_hat; ++mi) {
    const int64_t s = a.members[r * a.m_hat + mi];
    if (s < 0) break;                          // rows are -1 padded at the end
    float sc = 0.f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int64_t w = lo + threadIdx.x + k * kThreads;
      if (w >= a.width) continue;
      const uint32_t xv = load_word<L>(a.x, a.replica, s, w, a.E, a.numel);
      acc[k] ^= xv;
      if (a.z) sc += word_sq(a.code, xv, load_word<L>(a.z, nullptr, s, w, a.E, a.numel));
    }
    if (a.z) {                                 // uniform across the CTA
      sc = warp_sum(sc);
      if (lane == 0) red[wib] = sc;
      __syncthreads();
      if (threadIdx.x == 0) {
        float t = 0.f;
        for (int i = 0; i < kThreads / 32; ++i) t += red[i];
        a.partials[s * a.n_chunks + c] = t;
      }
      __syncthreads();
    }
  }
  if (!a.parity) return;
  uint32_t* out = a.parity + static_cast<int64_t>(a.touched[r]) * a.frame_elems + a.col;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int64_t w = lo + threadIdx.x + k * kThreads;
    if (w < a.width) out[w] ^= acc[k];
  }
}

// One warp per block: the sum of its chunk partials, in chunk order
// strided over the lanes, then a fixed shuffle tree.
__global__ void fused_scores_kernel(const float* __restrict__ partials,
                                    float* __restrict__ scores, int64_t n_blocks,
                                    int64_t n_chunks) {
  const int64_t s = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (s >= n_blocks) return;   // whole warps leave together
  float acc = 0.f;
  for (int64_t j = lane; j < n_chunks; j += 32) acc += partials[s * n_chunks + j];
  acc = warp_sum(acc);
  if (lane == 0) scores[s] = acc;
}

}  // namespace

extern "C" int64_t fused_maintain_chunks(int64_t width) {
  return (width + kChunk - 1) / kChunk;
}

// x, z, replica: the leaf's elements, read by `loader` (kRaw1/2/4 for the
// word-packable dtypes, kBool..kC128 for the f32-image ones); z may be
// null (no scores: partials and scores unused). code: the dtype code the
// scores decode words by (0, f32, for the image loaders). parity: int32 words or null
// (no parity). members (n_out, m_hat) and touched (n_out,): the leaf's
// LeafGroupMeta rows. n_blocks: S. Every block must sit in exactly one row.
// Returns cudaGetLastError() after the launches.
extern "C" int fused_maintain(const void* x, const void* z, void* replica, void* parity,
                              float* partials, float* scores, const int32_t* members,
                              const int32_t* touched, int64_t n_out, int64_t m_hat,
                              int64_t n_blocks, int64_t E, int64_t numel, int64_t width,
                              int64_t col, int64_t frame_elems, int64_t loader,
                              int64_t code, cudaStream_t stream) {
  if (n_out <= 0 || width <= 0) return 0;
  const int64_t n_chunks = fused_maintain_chunks(width);
  const Leaf a{x, z, replica, static_cast<uint32_t*>(parity), z ? partials : nullptr,
               members, touched, m_hat, E, numel, width, col, frame_elems, n_chunks,
               static_cast<int>(code)};
  const dim3 grid(static_cast<unsigned>(n_out), static_cast<unsigned>(n_chunks));
  switch (loader) {
    case kRaw4: fused_leaf_kernel<kRaw4><<<grid, kThreads, 0, stream>>>(a); break;
    case kRaw2: fused_leaf_kernel<kRaw2><<<grid, kThreads, 0, stream>>>(a); break;
    case kRaw1: fused_leaf_kernel<kRaw1><<<grid, kThreads, 0, stream>>>(a); break;
    case kBool: fused_leaf_kernel<kBool><<<grid, kThreads, 0, stream>>>(a); break;
    case kF64: fused_leaf_kernel<kF64><<<grid, kThreads, 0, stream>>>(a); break;
    case kI64: fused_leaf_kernel<kI64><<<grid, kThreads, 0, stream>>>(a); break;
    case kC64: fused_leaf_kernel<kC64><<<grid, kThreads, 0, stream>>>(a); break;
    case kC128: fused_leaf_kernel<kC128><<<grid, kThreads, 0, stream>>>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (z && n_blocks > 0) {
    const int64_t threads = n_blocks * 32;
    fused_scores_kernel<<<static_cast<unsigned>((threads + 255) / 256), 256, 0, stream>>>(
        partials, scores, n_blocks, n_chunks);
  }
  return static_cast<int>(cudaGetLastError());
}
