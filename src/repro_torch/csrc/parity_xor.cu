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
// Design: the XOR instance (M = 1, no multiply) of the piece-driven body in
// erasure_pieces.cuh, which gf256_mac.cu shares: one CTA per tile of a
// piece (a run of a row's words that one set of terms covers), the piece's
// term pointers in shared memory, 16-byte streaming loads and stores, the
// next term's loads in flight while this term is folded. XOR is exact and
// order-free, so the result is bit-exact whatever the order of the terms.
#include "erasure_pieces.cuh"

// out, src, base: device words (base may be null when no piece has a
// base). The launch runs the tiles [0, n_tiles) of the plan's pieces
// (kernels/parity_xor/ops.py::build_pieces): piece p writes
// out[pc_out[p] : pc_out[p] + pc_len[p]], seeded from base[pc_base[p]:]
// (zeros where -1), XOR the entries pc_term[p] .. pc_term[p + 1], entry e
// read from src[en_src[e]:]. Returns cudaGetLastError() after the launch.
extern "C" int parity_xor(void* out, const void* src, const void* base,
                          const int64_t* pc_out, const int32_t* pc_len,
                          const int64_t* pc_base, const int64_t* pc_term,
                          const int64_t* en_src, const int32_t* tile_piece,
                          const int32_t* tile_lo, int64_t n_tiles,
                          int64_t tile_words, cudaStream_t stream) {
  const erasure::Pieces a{
      static_cast<uint32_t*>(out), static_cast<const uint32_t*>(src), nullptr,
      static_cast<const uint32_t*>(base), pc_out, pc_len, pc_base, pc_term,
      en_src, nullptr, nullptr, tile_piece, tile_lo, 0, 0, 0, 0, tile_words};
  return erasure::launch<1, false>(a, n_tiles, stream);
}
