// GF(256) multiply-accumulate over packed int32 words, read in place from
// the flat word arena (and, for a decode, from the stored parity rows):
//   out[row][q][i] = base[row][q][i] ^ XOR over the row's terms t covering i
//                    of gf_mul(coef[t][q], src_t[t.src + i - t.dst])
// where every 32-bit word carries four GF(256) symbols (polynomial 0x11D)
// and gf_mul scales each byte of the word.
//
// Replaces repro/kernels/gf256_mac/kernel.py::gf256_mac_pallas, which
// computes out[j] = base[j] ^ XOR_i gf_mul(coeff[j, i], frames[j, i]) over
// (n_groups, g, E) member frames, once per parity row. Here, as in
// parity_xor.cu, no frames buffer exists: a member's frame is the
// side-by-side of its arena segments at their frame columns, one term per
// segment (destination column, source offset, length), now with one
// coefficient byte per output row. So:
//   - the RS(k, m) encode is one launch with m outputs per group row: each
//     member word is read once and folded into m accumulators (the TPU
//     version reads the members m times, one dispatch per row);
//   - the scrub's syndromes are the same launch with the stored parity as
//     the base, over a range of rows (a batch of groups) written into a
//     scratch buffer (out_shift moves the rows' offsets into it);
//   - an erasure decode has one output per row (a lost arena segment); its
//     terms read either a surviving member in the arena (src) or a stored
//     parity row (src2), chosen per term by term_sel, with the weights the
//     host solved (rs_decode_weights);
//   - XOR parity is the case of coefficient 1.
//
// Bound on an H100. Bytes: every term's source word read once, every base
// and output word moved once. Operations (32-bit integer, 132 SMs x 64
// lanes x the SM clock): the multiply is SWAR shift-and-add on the whole
// word, four symbols at once,
//     msb = (w >> 7) & 0x01010101;  w = ((w << 1) & 0xFEFEFEFE) ^ msb * 0x1D
// six operations per doubling (xtime), taken only up to the highest set
// bit of the term's coefficients (the doublings are shared by the m
// outputs), plus one XOR per set coefficient bit. Per source word that is
// 6 * hb + sum_q popcount(c_q) operations, hb the index of the highest set
// bit of any c_q: about 47 for RS(4, 2) encode terms (row 0's coefficient
// is 1), 7 for XOR. chip_smoke.py counts them from the plan's coefficients
// and takes the larger of the two times as the bound.
//
// Design. Grid (row, chunk): each CTA produces kChunk consecutive words of
// every output of one row; each thread walks the row's terms for each of
// its words, so neighbouring threads read neighbouring source words. The
// coefficients are per term, so the branches on their bits are uniform
// across a warp. XOR is exact and order-free: the result is bit-exact
// whatever the order of the terms.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kChunk = 4096;   // words of each output per CTA
constexpr int kMaxM = 8;           // outputs per row the launcher takes

__device__ __forceinline__ uint32_t xtime(uint32_t w) {
  const uint32_t msb = (w >> 7) & 0x01010101u;
  return ((w << 1) & 0xFEFEFEFEu) ^ (msb * 0x1Du);
}

struct Args {
  uint32_t* out;
  const uint32_t* src;
  const uint32_t* src2;
  const uint32_t* base;
  const int64_t* row_out;
  const int32_t* row_len;
  const int64_t* row_base;
  const int64_t* term_ptr;
  const int32_t* term_dst;
  const int64_t* term_src;
  const int32_t* term_len;
  const int8_t* term_sel;
  const uint8_t* term_coef;   // (n_terms, M)
  int64_t out_stride;
  int64_t base_stride;
  int64_t row0;
  int64_t out_shift;
};

template <int M>
__global__ void __launch_bounds__(kThreads) gf256_mac_kernel(const Args a) {
  const int64_t r = a.row0 + blockIdx.x;
  const int64_t lo = static_cast<int64_t>(blockIdx.y) * kChunk;
  const int64_t len = a.row_len[r];
  if (lo >= len) return;
  const int64_t hi = lo + kChunk < len ? lo + kChunk : len;
  const int64_t b0 = a.row_base[r];
  const int64_t t0 = a.term_ptr[r], t1 = a.term_ptr[r + 1];
  uint32_t* o = a.out + (a.row_out[r] - a.out_shift);
  for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads) {
    uint32_t acc[M];
#pragma unroll
    for (int q = 0; q < M; ++q) acc[q] = b0 >= 0 ? a.base[b0 + q * a.base_stride + i] : 0u;
    for (int64_t t = t0; t < t1; ++t) {
      const int64_t d = i - a.term_dst[t];
      if (d < 0 || d >= a.term_len[t]) continue;
      uint32_t w = (a.term_sel[t] ? a.src2 : a.src)[a.term_src[t] + d];
      uint32_t c[M];
      uint32_t any = 0;
#pragma unroll
      for (int q = 0; q < M; ++q) {
        c[q] = a.term_coef[t * M + q];
        any |= c[q];
      }
#pragma unroll
      for (int bit = 0; bit < 8; ++bit) {
#pragma unroll
        for (int q = 0; q < M; ++q)
          if ((c[q] >> bit) & 1u) acc[q] ^= w;
        if ((any >> (bit + 1)) == 0u) break;
        w = xtime(w);
      }
    }
#pragma unroll
    for (int q = 0; q < M; ++q) o[q * a.out_stride + i] = acc[q];
  }
}

template <int M>
int launch(const Args& a, int64_t n_rows, int64_t max_len, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(n_rows),
                  static_cast<unsigned>((max_len + kChunk - 1) / kChunk));
  gf256_mac_kernel<M><<<grid, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int64_t gf256_mac_chunks(int64_t max_len) {
  return (max_len + kChunk - 1) / kChunk;
}

extern "C" int64_t gf256_mac_max_m() { return kMaxM; }

// Rows [row0, row0 + n_rows) of the plan. Output q of row r writes
// out[row_out[r] - out_shift + q * out_stride + i] for i < row_len[r],
// seeded from base[row_base[r] + q * base_stride + i] (zeros where
// row_base[r] is -1; base may be null when none has one). Term k of the
// row (term_ptr[r] .. term_ptr[r + 1]) reads src (term_sel 0) or src2
// (term_sel 1) and has m coefficient bytes term_coef[k * m .. k * m + m).
// 1 <= m <= 8. Returns cudaGetLastError() after the launch.
extern "C" int gf256_mac(void* out, const void* src, const void* src2, const void* base,
                         const int64_t* row_out, const int32_t* row_len,
                         const int64_t* row_base, const int64_t* term_ptr,
                         const int32_t* term_dst, const int64_t* term_src,
                         const int32_t* term_len, const int8_t* term_sel,
                         const uint8_t* term_coef, int64_t m, int64_t out_stride,
                         int64_t base_stride, int64_t row0, int64_t n_rows,
                         int64_t out_shift, int64_t max_len, cudaStream_t stream) {
  if (n_rows <= 0 || max_len <= 0) return 0;
  const Args a{static_cast<uint32_t*>(out), static_cast<const uint32_t*>(src),
               static_cast<const uint32_t*>(src2), static_cast<const uint32_t*>(base),
               row_out, row_len, row_base, term_ptr, term_dst, term_src, term_len,
               term_sel, term_coef, out_stride, base_stride, row0, out_shift};
  switch (m) {
    case 1: return launch<1>(a, n_rows, max_len, stream);
    case 2: return launch<2>(a, n_rows, max_len, stream);
    case 3: return launch<3>(a, n_rows, max_len, stream);
    case 4: return launch<4>(a, n_rows, max_len, stream);
    case 5: return launch<5>(a, n_rows, max_len, stream);
    case 6: return launch<6>(a, n_rows, max_len, stream);
    case 7: return launch<7>(a, n_rows, max_len, stream);
    case 8: return launch<8>(a, n_rows, max_len, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
