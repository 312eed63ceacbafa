// XOR parity rows read straight from the flat word arena:
//   out[row][i] = base[row][i] ^ XOR over the row's terms t covering i of
//                 src[t.src + i - t.dst]
//
// Replaces repro/kernels/parity_xor/kernel.py::parity_xor_pallas, which
// computes out[j] = base[j] ^ XOR_{i: keep[j, i]} frames[j, i] over
// (n_groups, g, E) member frames. Here the member frames are never built:
// a member's frame is the side-by-side of its arena segments at their frame
// columns, so each kept member contributes one term per arena segment
// (destination column, arena word offset, length), and the kernel reads the
// words where they lie. Encode (base = 0, terms = every member's segments,
// rows = the groups' parity frames) and single-erasure reconstruction
// (base = the group's parity, terms = the survivors' segments that overlap
// the lost segment, rows = the lost arena segments, so the output is the
// lost blocks' arena words, ready to decode) are the same launch. Nothing of
// size (total_blocks, frame_elems) or (n_groups, g, frame_elems) exists.
//
// Bound on an H100: bytes. One read of every term's source words and of the
// base, one write of every output word, over 3.35 TB/s.
//
// Design. Grid (row, chunk): each CTA produces kChunk consecutive words of
// one row; each thread walks the row's few terms for each of its words, so
// neighbouring threads read neighbouring source words. XOR is exact and
// order-free, so the result is bit-exact whatever the order of the terms.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kChunk = 4096;   // output words per CTA

__global__ void __launch_bounds__(kThreads)
parity_xor_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ src,
                  const uint32_t* __restrict__ base,
                  const int64_t* __restrict__ row_out, const int32_t* __restrict__ row_len,
                  const int64_t* __restrict__ row_base, const int64_t* __restrict__ term_ptr,
                  const int32_t* __restrict__ term_dst, const int64_t* __restrict__ term_src,
                  const int32_t* __restrict__ term_len) {
  const int64_t r = blockIdx.x;
  const int64_t lo = static_cast<int64_t>(blockIdx.y) * kChunk;
  const int64_t len = row_len[r];
  if (lo >= len) return;
  const int64_t hi = lo + kChunk < len ? lo + kChunk : len;
  const int64_t b0 = row_base[r];
  const int64_t t0 = term_ptr[r], t1 = term_ptr[r + 1];
  uint32_t* o = out + row_out[r];
  for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads) {
    uint32_t acc = b0 >= 0 ? base[b0 + i] : 0u;
    for (int64_t t = t0; t < t1; ++t) {
      const int64_t d = i - term_dst[t];
      if (d >= 0 && d < term_len[t]) acc ^= src[term_src[t] + d];
    }
    o[i] = acc;
  }
}

}  // namespace

extern "C" int64_t parity_xor_chunks(int64_t max_len) {
  return (max_len + kChunk - 1) / kChunk;
}

// out, src, base: device words (base may be null when every row_base is
// -1). Row r writes out[row_out[r] : row_out[r] + row_len[r]]; its terms are
// term_ptr[r] .. term_ptr[r + 1]. max_len: the largest row_len. Returns
// cudaGetLastError() after the launch.
extern "C" int parity_xor(void* out, const void* src, const void* base,
                          const int64_t* row_out, const int32_t* row_len,
                          const int64_t* row_base, const int64_t* term_ptr,
                          const int32_t* term_dst, const int64_t* term_src,
                          const int32_t* term_len, int64_t n_rows, int64_t max_len,
                          cudaStream_t stream) {
  if (n_rows <= 0 || max_len <= 0) return 0;
  const dim3 grid(static_cast<unsigned>(n_rows),
                  static_cast<unsigned>(parity_xor_chunks(max_len)));
  parity_xor_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<uint32_t*>(out), static_cast<const uint32_t*>(src),
      static_cast<const uint32_t*>(base), row_out, row_len, row_base, term_ptr,
      term_dst, term_src, term_len);
  return static_cast<int>(cudaGetLastError());
}
