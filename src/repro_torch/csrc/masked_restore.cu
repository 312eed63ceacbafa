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
