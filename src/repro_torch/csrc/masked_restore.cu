// Partial restore: block b of out = mask[b] ? block b of src : block b of dst.
//
// Replaces repro/kernels/masked_restore/kernel.py::masked_restore_pallas,
// the kernel form of select_blocks that PARTIAL recovery runs
// (repro/core/recovery.py).
//
// Layout: dst, src and out are a leaf's raw (R, W) row matrix, row-major,
// so block b -- rows [b * block_rows, min((b + 1) * block_rows, R)) -- is
// one contiguous byte range. The TPU kernel's (n_blocks, E) form is the
// case block_rows = 1. The leaf is not padded to whole blocks: the ragged
// last block is clamped, as in scatter_save.cu.
//
// Bound on an H100: bytes. The function must read, for each block, the one
// side the mask picks and write the output: N bytes read and N written for
// an N-byte tree, over 3.35 TB/s. The TPU kernel reads both src and dst
// for every element, which would cost 3N here.
//
// Design. Grid (n_blocks, chunks): each CTA reads mask[b] first and then
// streams only the chosen side's kCopyChunk-byte chunk of block b into the
// output, 16 bytes per access where the block pitch, the leaf size and the
// three bases are 16-byte aligned. Bytes are copied as they are, so every
// 1/2/4/8-byte dtype is bit-exact. The output is a new buffer, as in the
// reference.
//
// Grouped form (masked_restore_tree_bytes), the one the main paths run: one
// launch restores every leaf of a tree, in place of one wrapper call and
// one launch per leaf. Two tables in device memory
// (repro_torch/kernels/leaf_table.py):
//   geom[5 l .. 5 l + 4]  item_start, chunks per block, block_bytes,
//                         total_bytes and the global mask offset of leaf l
//                         (static per partition and leaf dtypes);
//   ptrs[4 l .. 4 l + 3]  dst, src and out base addresses and src's block
//                         pitch in bytes (per call; out = 0 leaves leaf l
//                         untouched).
// item_leaf[g] is the leaf of work item g (one CTA): chunk c of block k,
// g - item_start = k * chunks + c. The CTA reads its block's mask bit at
// mask[offset + k] (colocated leaves share offsets, so they read the bits
// of the blocks they share), then copies bytes [c * kCopyChunk, +
// kCopyChunk) of the block -- clamped to the leaf's total -- from src (at
// k * pitch: the block pitch for a tree, the segment pitch for an arena
// read in place) or from dst (at k * block_bytes). The carrier (16/8/4/2/1
// bytes) is the widest that divides the output's and the chosen side's
// block addresses and the block's length, decided on the card per item, so
// views at odd offsets stay bit-exact and aligned leaves keep 16-byte
// accesses.
#include "byte_copy.cuh"

namespace {

using namespace repro_torch;

template <typename V>
__global__ void __launch_bounds__(kCopyThreads)
masked_restore_kernel(const uint8_t* __restrict__ dst, const uint8_t* __restrict__ src,
                      const bool* __restrict__ mask, uint8_t* __restrict__ out,
                      int64_t block_bytes, int64_t total_bytes) {
  const int64_t b = blockIdx.x;
  const int64_t block_lo = b * block_bytes;
  const int64_t block_hi = imin(block_lo + block_bytes, total_bytes);
  const int64_t lo = block_lo + static_cast<int64_t>(blockIdx.y) * kCopyChunk;
  const int64_t hi = imin(lo + kCopyChunk, block_hi);
  if (lo >= hi) return;
  copy_bytes<V>(out, mask[b] ? src : dst, lo, hi);
}

template <typename V>
void launch(const uint8_t* dst, const uint8_t* src, const bool* mask, uint8_t* out,
            int64_t n_blocks, int64_t block_bytes, int64_t total_bytes,
            cudaStream_t stream) {
  const int64_t chunks = (block_bytes + kCopyChunk - 1) / kCopyChunk;
  const dim3 grid(static_cast<unsigned>(n_blocks), static_cast<unsigned>(chunks));
  masked_restore_kernel<V><<<grid, kCopyThreads, 0, stream>>>(
      dst, src, mask, out, block_bytes, total_bytes);
}

// Grouped form, grid: (n_items). See the note at the top.
__global__ void __launch_bounds__(kCopyThreads)
masked_restore_tree_kernel(const int64_t* __restrict__ geom, const int64_t* __restrict__ ptrs,
                           const int32_t* __restrict__ item_leaf,
                           const bool* __restrict__ mask) {
  const int64_t g = blockIdx.x;
  const int64_t leaf = item_leaf[g];
  const int64_t* lg = geom + 5 * leaf;
  const int64_t* lp = ptrs + 4 * leaf;
  uint8_t* out = reinterpret_cast<uint8_t*>(lp[2]);
  if (out == nullptr) return;
  const int64_t chunks = lg[1], block_bytes = lg[2];
  const int64_t local = g - lg[0];
  const int64_t k = local / chunks;
  const int64_t block_lo = k * block_bytes;
  const int64_t len = imin(block_bytes, lg[3] - block_lo);
  const int64_t lo = (local - k * chunks) * kCopyChunk;
  const int64_t hi = imin(lo + kCopyChunk, len);
  if (lo >= hi) return;
  const uint8_t* from = mask[lg[4] + k]
                            ? reinterpret_cast<const uint8_t*>(lp[1]) + k * lp[3]
                            : reinterpret_cast<const uint8_t*>(lp[0]) + block_lo;
  out += block_lo;
  const uint64_t bits = reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(from) |
                        static_cast<uint64_t>(len) | 16u;
  switch (bits & (~bits + 1)) {   // the lowest set bit: the carrier's width
    case 16: copy_bytes<uint4>(out, from, lo, hi); break;
    case 8: copy_bytes<uint2>(out, from, lo, hi); break;
    case 4: copy_bytes<uint32_t>(out, from, lo, hi); break;
    case 2: copy_bytes<uint16_t>(out, from, lo, hi); break;
    default: copy_bytes<uint8_t>(out, from, lo, hi); break;
  }
}

}  // namespace

// dst, src, out: the leaf's bytes (total_bytes each); mask: one bool per
// block on the device; block_bytes = block_rows * W * itemsize. Returns
// cudaGetLastError() after the launch.
extern "C" int masked_restore_bytes(const void* dst, const void* src, const bool* mask,
                                    void* out, int64_t block_bytes,
                                    int64_t total_bytes, cudaStream_t stream) {
  if (block_bytes <= 0 || total_bytes <= 0) return 0;
  const int64_t n_blocks = (total_bytes + block_bytes - 1) / block_bytes;
  const uint64_t parts[5] = {static_cast<uint64_t>(block_bytes),
                             static_cast<uint64_t>(total_bytes),
                             reinterpret_cast<uintptr_t>(dst),
                             reinterpret_cast<uintptr_t>(src),
                             reinterpret_cast<uintptr_t>(out)};
  auto* d = static_cast<const uint8_t*>(dst);
  auto* s = static_cast<const uint8_t*>(src);
  auto* o = static_cast<uint8_t*>(out);
  switch (carrier_width(parts, 5)) {
    case 16: launch<uint4>(d, s, mask, o, n_blocks, block_bytes, total_bytes, stream); break;
    case 8: launch<uint2>(d, s, mask, o, n_blocks, block_bytes, total_bytes, stream); break;
    case 4: launch<uint32_t>(d, s, mask, o, n_blocks, block_bytes, total_bytes, stream); break;
    case 2: launch<uint16_t>(d, s, mask, o, n_blocks, block_bytes, total_bytes, stream); break;
    default: launch<uint8_t>(d, s, mask, o, n_blocks, block_bytes, total_bytes, stream); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// The grouped form over a whole tree (tables as in the note at the top, on
// the device; mask: one bool per global block). Returns cudaGetLastError()
// after the launch.
extern "C" int masked_restore_tree_bytes(const int64_t* geom, const int64_t* ptrs,
                                         const int32_t* item_leaf, int64_t n_items,
                                         const bool* mask, cudaStream_t stream) {
  if (n_items <= 0) return 0;
  masked_restore_tree_kernel<<<static_cast<unsigned>(n_items), kCopyThreads, 0, stream>>>(
      geom, ptrs, item_leaf, mask);
  return static_cast<int>(cudaGetLastError());
}
