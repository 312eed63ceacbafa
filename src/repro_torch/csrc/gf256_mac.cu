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
// lanes x the SM clock), counted per (source word, output) of a term by
// its coefficient c: none for c = 0, one XOR for c = 1, and for any other
// c the split-table multiply of erasure_pieces.cuh::gf_mul_word, 14
// operations (a PRMT to swap bytes 1 and 2; per 3-bit field a mask, and a
// shift where it is not at bit 0, and one LEA.HI that packs it into
// selector nibbles: 8; three PRMT lookups; two LOP3 into the accumulator).
// GFPlan.int_ops (kernels/gf256_mac/ops.py) counts the same; chip_smoke.py
// takes the larger of the bytes and the operations time as the bound.
//
// Design: the piece-driven body of erasure_pieces.cuh, which parity_xor.cu
// shares, with M outputs a row and two sources. The host splits every row
// into pieces (runs of words that one set of terms covers) and tiles; a CTA
// folds one tile, its terms' pointers and product tables read once into
// shared memory, with 16-byte streaming loads and stores and the next
// term's loads in flight. Each source vector is read once and folded into
// the M accumulators; a coefficient of 1 is a plain XOR. XOR is exact and
// order-free: the result is bit-exact whatever the order of the terms.
#include "erasure_pieces.cuh"

extern "C" int64_t gf256_mac_max_m() { return erasure::kMaxM; }

// The tiles [tile0, tile0 + n_tiles) of the plan's pieces
// (kernels/parity_xor/ops.py::build_pieces, on a GFPlan's rows). Piece p's
// output q writes out[pc_out[p] - out_shift + q * out_stride + i] for
// i < pc_len[p], seeded from base[pc_base[p] + q * base_stride + i]
// (zeros where pc_base[p] is -1; base may be null when no piece has one).
// Entry e (pc_term[p] .. pc_term[p + 1]) reads src (en_sel 0) or src2
// (en_sel 1) from en_src[e] at the piece's word 0 and has m coefficient
// bytes en_coef[e * m .. e * m + m). 1 <= m <= 8. Returns
// cudaGetLastError() after the launch.
extern "C" int gf256_mac(void* out, const void* src, const void* src2, const void* base,
                         const int64_t* pc_out, const int32_t* pc_len,
                         const int64_t* pc_base, const int64_t* pc_term,
                         const int64_t* en_src, const int8_t* en_sel,
                         const uint8_t* en_coef, const int32_t* tile_piece,
                         const int32_t* tile_lo, int64_t m, int64_t out_stride,
                         int64_t base_stride, int64_t out_shift, int64_t tile0,
                         int64_t n_tiles, int64_t tile_words, cudaStream_t stream) {
  const erasure::Pieces a{
      static_cast<uint32_t*>(out), static_cast<const uint32_t*>(src),
      static_cast<const uint32_t*>(src2), static_cast<const uint32_t*>(base),
      pc_out, pc_len, pc_base, pc_term, en_src, en_sel, en_coef, tile_piece,
      tile_lo, out_stride, base_stride, out_shift, tile0, tile_words};
  switch (m) {
    case 1: return erasure::launch<1, true>(a, n_tiles, stream);
    case 2: return erasure::launch<2, true>(a, n_tiles, stream);
    case 3: return erasure::launch<3, true>(a, n_tiles, stream);
    case 4: return erasure::launch<4, true>(a, n_tiles, stream);
    case 5: return erasure::launch<5, true>(a, n_tiles, stream);
    case 6: return erasure::launch<6, true>(a, n_tiles, stream);
    case 7: return erasure::launch<7, true>(a, n_tiles, stream);
    case 8: return erasure::launch<8, true>(a, n_tiles, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
