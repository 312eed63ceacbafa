// In-place partial save: copy k selected row-blocks of a leaf src -> dst.
//
// Replaces repro/kernels/fused_maintain/kernel.py::scatter_save_pallas, the
// fabric-less in-place partial checkpoint (repro/core/controller.py,
// inplace_save, through fused_maintain/ops.py::tree_scatter_save).
//
// Layout: dst and src are a leaf's raw (R, W) row matrix, row-major, so
// block b -- rows [b * block_rows, min((b + 1) * block_rows, R)) -- is one
// contiguous byte range. The element type does not matter: bytes are
// copied as they are, so every 1/2/4/8-byte dtype is bit-exact.
//
// Bound on an H100: bytes. The least traffic is one read and one write of
// the selected blocks' bytes (2 x the `moved` that tree_scatter_save
// reports), over 3.35 TB/s. Unselected blocks are never touched.
//
// Design. Grid (k, chunks): each CTA copies one kCopyChunk-byte chunk of
// one selected block, reading its block id itself (the TPU kernel took the
// ids through scalar prefetch), clamping the ragged last block to R rows,
// and using 16-byte accesses where the block pitch, the leaf size and both
// bases are 16-byte aligned. Duplicate ids are harmless: they write the
// same bytes. Ids outside [0, n_blocks) are skipped, so a bad id cannot
// write out of bounds (the Python wrapper rejects them before launch).
//
// Grouped form (scatter_save_tree_bytes), the one the main path runs: one
// launch over every selected (leaf, block) pair of a tree, in place of one
// wrapper call, one host-to-device copy of the ids and one launch per
// touched leaf. The host uploads one table per save:
//   leaves[4 l .. 4 l + 3]  dst and src base addresses, block_bytes and
//                           total_bytes of leaf l (zeros where untouched);
//   pairs[3 p .. 3 p + 2]   leaf, local block and first work item of pair p
//                           (a colocated id is one pair per leaf that
//                           shares it: their bytes are disjoint);
//   item_pair[g]            the pair of work item g.
// Item g copies bytes [c * kCopyChunk, min(+ kCopyChunk, len)) of its
// pair's block, c = g - first, len the block's bytes clamped to the leaf's
// total. The carrier (16/8/4/2/1 bytes) is the widest that divides the
// pair's two block addresses and len, read on the card per pair, so views
// at odd offsets stay bit-exact and aligned leaves keep 16-byte accesses.
#include "byte_copy.cuh"

namespace {

using namespace repro_torch;

template <typename V>
__global__ void __launch_bounds__(kCopyThreads)
scatter_save_kernel(uint8_t* __restrict__ dst, const uint8_t* __restrict__ src,
                    const int32_t* __restrict__ rows, int64_t n_blocks,
                    int64_t block_bytes, int64_t total_bytes) {
  const int64_t b = rows[blockIdx.x];
  if (b < 0 || b >= n_blocks) return;
  const int64_t block_lo = b * block_bytes;
  const int64_t block_hi = imin(block_lo + block_bytes, total_bytes);
  const int64_t lo = block_lo + static_cast<int64_t>(blockIdx.y) * kCopyChunk;
  const int64_t hi = imin(lo + kCopyChunk, block_hi);
  if (lo >= hi) return;
  copy_bytes<V>(dst, src, lo, hi);
}

template <typename V>
void launch(uint8_t* dst, const uint8_t* src, const int32_t* rows, int64_t k,
            int64_t n_blocks, int64_t block_bytes, int64_t total_bytes,
            cudaStream_t stream) {
  const int64_t chunks = (block_bytes + kCopyChunk - 1) / kCopyChunk;
  const dim3 grid(static_cast<unsigned>(k), static_cast<unsigned>(chunks));
  scatter_save_kernel<V><<<grid, kCopyThreads, 0, stream>>>(
      dst, src, rows, n_blocks, block_bytes, total_bytes);
}

// Grouped form, grid: (n_items). See the note at the top.
__global__ void __launch_bounds__(kCopyThreads)
scatter_save_tree_kernel(const int64_t* __restrict__ leaves,
                         const int64_t* __restrict__ pairs,
                         const int32_t* __restrict__ item_pair) {
  const int64_t g = blockIdx.x;
  const int64_t p = item_pair[g];
  const int64_t leaf = pairs[3 * p], b = pairs[3 * p + 1], first = pairs[3 * p + 2];
  const int64_t block_bytes = leaves[4 * leaf + 2];
  const int64_t block_lo = b * block_bytes;
  const int64_t len = imin(block_lo + block_bytes, leaves[4 * leaf + 3]) - block_lo;
  const int64_t lo = (g - first) * kCopyChunk;
  const int64_t hi = imin(lo + kCopyChunk, len);
  if (b < 0 || lo >= hi) return;
  uint8_t* dst = reinterpret_cast<uint8_t*>(leaves[4 * leaf]) + block_lo;
  const uint8_t* src = reinterpret_cast<const uint8_t*>(leaves[4 * leaf + 1]) + block_lo;
  const uint64_t bits = reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src) |
                        static_cast<uint64_t>(len) | 16u;
  switch (bits & (~bits + 1)) {   // the lowest set bit: the carrier's width
    case 16: copy_bytes<uint4>(dst, src, lo, hi); break;
    case 8: copy_bytes<uint2>(dst, src, lo, hi); break;
    case 4: copy_bytes<uint32_t>(dst, src, lo, hi); break;
    case 2: copy_bytes<uint16_t>(dst, src, lo, hi); break;
    default: copy_bytes<uint8_t>(dst, src, lo, hi); break;
  }
}

}  // namespace

// dst, src: the leaf's bytes (total_bytes each); rows: (k,) int32 block ids
// on the device; block_bytes = block_rows * W * itemsize. Returns
// cudaGetLastError() after the launch.
extern "C" int scatter_save_bytes(void* dst, const void* src, const int32_t* rows,
                                  int64_t k, int64_t block_bytes,
                                  int64_t total_bytes, cudaStream_t stream) {
  if (k <= 0 || total_bytes <= 0) return 0;
  const int64_t n_blocks = (total_bytes + block_bytes - 1) / block_bytes;
  const uint64_t parts[4] = {static_cast<uint64_t>(block_bytes),
                             static_cast<uint64_t>(total_bytes),
                             reinterpret_cast<uintptr_t>(dst),
                             reinterpret_cast<uintptr_t>(src)};
  auto* d = static_cast<uint8_t*>(dst);
  auto* s = static_cast<const uint8_t*>(src);
  switch (carrier_width(parts, 4)) {
    case 16: launch<uint4>(d, s, rows, k, n_blocks, block_bytes, total_bytes, stream); break;
    case 8: launch<uint2>(d, s, rows, k, n_blocks, block_bytes, total_bytes, stream); break;
    case 4: launch<uint32_t>(d, s, rows, k, n_blocks, block_bytes, total_bytes, stream); break;
    case 2: launch<uint16_t>(d, s, rows, k, n_blocks, block_bytes, total_bytes, stream); break;
    default: launch<uint8_t>(d, s, rows, k, n_blocks, block_bytes, total_bytes, stream); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// The grouped form over a tree's selected pairs (tables as in the note at
// the top, on the device). Returns cudaGetLastError() after the launch.
extern "C" int scatter_save_tree_bytes(const int64_t* leaves, const int64_t* pairs,
                                       const int32_t* item_pair, int64_t n_items,
                                       cudaStream_t stream) {
  if (n_items <= 0) return 0;
  scatter_save_tree_kernel<<<static_cast<unsigned>(n_items), kCopyThreads, 0, stream>>>(
      leaves, pairs, item_pair);
  return static_cast<int>(cudaGetLastError());
}
