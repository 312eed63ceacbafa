// In-place partial save over the flat word arena: copy the selected blocks'
// arena segments from src into dst.
//
// Replaces repro/kernels/fused_maintain/kernel.py::arena_scatter_pallas and
// the word-level move its driver (fused_maintain/ops.py::arena_scatter_save)
// adds for tail-packed blocks: the whole arena partial save is one launch.
//
// Bound on an H100: bytes. One read and one write of the moved bytes,
// 4096 per selected tile plus 4 per selected tail word (the
// ArenaLayout.seg_bytes_for_blocks count), over 3.35 TB/s; unselected
// words are never touched.
//
// Design. The save is a list of word ranges: a main-region block's whole
// tiles (its own, never shared) or a tail-packed block's payload words
// (tail blocks share tiles, so a tile copy would clobber unselected
// tile-mates). The host hands over one (offset, length) pair per selected
// block, the prefix sum of the ranges' 4 KB chunks and each chunk's range
// (ops.py::scatter_plan, built once per save). One CTA per chunk, a 1-D
// grid with no idle CTAs, one 16-byte access per thread where the range is
// 4-word aligned (every main-region range is; a chunk is then exactly one
// tile) and a word at a time otherwise. The reference's power-of-two
// padding of the selection (it bounded recompiles) has no counterpart.
#include "byte_copy.cuh"

namespace {

using namespace repro_torch;

constexpr int64_t kChunkBytes = 4096;   // one tile

__global__ void __launch_bounds__(kCopyThreads)
arena_scatter_kernel(uint8_t* __restrict__ dst, const uint8_t* __restrict__ src,
                     const int64_t* __restrict__ off, const int32_t* __restrict__ len,
                     const int64_t* __restrict__ chunk_ptr,
                     const int32_t* __restrict__ chunk_range) {
  const int64_t b = blockIdx.x;
  const int32_t r = chunk_range[b];
  const int64_t w0 = off[r], n = len[r];
  const int64_t lo = w0 * 4 + (b - chunk_ptr[r]) * kChunkBytes;
  const int64_t hi = imin(lo + kChunkBytes, (w0 + n) * 4);
  if (((w0 | n) & 3) == 0) {
    copy_bytes<uint4>(dst, src, lo, hi);
  } else {
    copy_bytes<uint32_t>(dst, src, lo, hi);
  }
}

}  // namespace

// dst, src: the arenas' words (16-byte aligned); off / len: (n_ranges,)
// word offset (int64) and word count (int32, > 0) of each range;
// chunk_ptr: (n_ranges + 1,) prefix sum of the ranges' 4 KB chunk counts;
// chunk_range: (n_chunks,) the range of each chunk. Returns
// cudaGetLastError() after the launch.
extern "C" int arena_scatter(void* dst, const void* src, const int64_t* off,
                             const int32_t* len, const int64_t* chunk_ptr,
                             const int32_t* chunk_range, int64_t n_chunks,
                             cudaStream_t stream) {
  if (n_chunks <= 0) return 0;
  arena_scatter_kernel<<<static_cast<unsigned>(n_chunks), kCopyThreads, 0, stream>>>(
      static_cast<uint8_t*>(dst), static_cast<const uint8_t*>(src), off, len,
      chunk_ptr, chunk_range);
  return static_cast<int>(cudaGetLastError());
}
