// The erasure-code kernels' shared body: parity_xor.cu (XOR, one output a
// row) and gf256_mac.cu (GF(256) multiply-accumulate, M outputs a row) fold
//   out[q][i] = base[q][i] ^ XOR over the terms t covering word i of
//               coef[t][q] * src_t[t.src + i - t.dst]
// over a plan's rows, driven by the plan's pieces (kernels/parity_xor/
// ops.py::build_pieces) instead of a walk over a row's terms for every
// word. A piece is a maximal run of a row's words that one set of terms
// covers; the host lists each piece's terms with their source offsets at
// its first word, and cuts every piece into tiles of tile_words words.
//
// Design (for the H100's memory system):
//   - One CTA folds one tile of one piece. It reads the piece's term
//     descriptors once into shared memory (a source pointer each, and for
//     the multiply the split product tables of each term and output), so
//     every read of them is a warp-uniform broadcast; no word is range
//     checked, since every term covers the whole piece.
//   - 16-byte loads and stores where the piece's output, base and source
//     pointers are congruent modulo 16 bytes (arena offsets and frame
//     columns are tile-aligned, so on the main path all are); the ragged
//     head and tail of a tile, and a piece whose streams are not congruent,
//     take the same body with 4-byte accesses.
//   - A thread holds V vectors of every output in registers and walks the
//     terms with the next term's V loads issued before this term's
//     arithmetic, so 2 x V x 16 bytes per thread are in flight.
//     Source reads are streaming (ld.global.cs); stores are streaming.
//   - A piece with more than kMaxTerms terms is folded in batches of
//     terms, each batch after the first seeded from the output it wrote.
//   - Multiply (kMul): the product c * b of a byte b is linear over GF(2)
//     in b, so it is the XOR of c * (b & 7), c * (b & 0x38) and
//     c * (b & 0xC0): three lookups in 8-, 8- and 4-entry byte tables of
//     c's products, held in five 32-bit words, done for all four bytes of a
//     word at once by PRMT with the bytes' 3-bit fields packed into its
//     selector nibbles. See gf_mul_word for the count.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace erasure {
namespace {   // each translation unit keeps its own instances

constexpr int kThreads = 256;
constexpr int kMaxTerms = 32;   // term descriptors a CTA holds at once
constexpr int kMaxM = 8;        // outputs per row

struct Pieces {
  uint32_t* __restrict__ out;
  const uint32_t* __restrict__ src;
  const uint32_t* __restrict__ src2;         // a term with selector 1 reads this
  const uint32_t* __restrict__ base;
  const int64_t* __restrict__ pc_out;        // per piece: output offset of word 0
  const int32_t* __restrict__ pc_len;        //   its words
  const int64_t* __restrict__ pc_base;       //   base offset of word 0, or -1
  const int64_t* __restrict__ pc_term;       //   its entries [pc_term[p], pc_term[p + 1])
  const int64_t* __restrict__ en_src;        // per entry: source offset at word 0
  const int8_t* __restrict__ en_sel;         //   0: src, 1: src2 (gf256_mac only)
  const uint8_t* __restrict__ en_coef;       //   M coefficient bytes (gf256_mac only)
  const int32_t* __restrict__ tile_piece;    // per tile: its piece
  const int32_t* __restrict__ tile_lo;       //   its first word in the piece
  int64_t out_stride;           // words between a row's outputs
  int64_t base_stride;
  int64_t out_shift;            // subtracted from every output offset
  int64_t tile0;                // the launch's first tile
  int64_t tile_words;
};

// The five table words of c: words 0-1 hold c * e for e = 0..7, words 2-3
// c * (e << 3) for e = 0..7, word 4 c * (e << 6) for e = 0..3, one byte
// an entry (polynomial 0x11D). Built from c's powers c * x^i.
__device__ __forceinline__ void gf_tables(uint32_t c, uint32_t* t) {
  uint32_t p[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    p[i] = c;
    c = (c << 1) ^ ((c & 0x80u) ? 0x11Du : 0u);
  }
#pragma unroll
  for (int w = 0; w < 5; ++w) {
    const int g = w < 2 ? 0 : (w < 4 ? 3 : 6);     // the field's first bit
    const int e0 = w < 4 ? 4 * (w & 1) : 0;
    uint32_t word = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = e0 + k;
      uint32_t v = 0;
#pragma unroll
      for (int b = 0; b < 3; ++b)
        if (((e >> b) & 1) && g + b < 8) v ^= p[g + b];
      word |= v << (8 * k);
    }
    t[w] = word;
  }
}

// PTX prmt.b32 in its default mode: byte n of the result is the byte of
// {y, x} that nibble n of s[15:0] selects (its bit 3 replicates the sign).
// __byte_perm masks the selector with 0x7777 first, one operation that the
// selectors below do not need: their nibbles' bit 3 is always 0.
__device__ __forceinline__ uint32_t prmt(uint32_t x, uint32_t y, uint32_t s) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(x), "r"(y), "r"(s));
  return r;
}

// The four GF(256) bytes of w times the coefficient whose tables t holds.
// Bytes 1 and 2 are swapped first, so that v + (v >> 12) (one LEA.HI)
// packs a 3-bit field of bytes 0, 1, 2, 3 into selector nibbles 0, 1, 2,
// 3. Operations per (source word, output), with the XOR into the
// accumulator: 1 PRMT; per field a mask, a shift where the field is not at
// bit 0, and the pack (8); 3 PRMT; 2 LOP3. 14 in all (gf256_mac.cu).
__device__ __forceinline__ uint32_t gf_mul_word(const uint32_t* t, uint32_t w) {
  const uint32_t v = prmt(w, 0u, 0x3120u);
  const uint32_t a0 = v & 0x07070707u;
  const uint32_t a1 = (v >> 3) & 0x07070707u;
  const uint32_t a2 = (v >> 6) & 0x03030303u;
  return prmt(t[0], t[1], a0 + (a0 >> 12)) ^ prmt(t[2], t[3], a1 + (a1 >> 12)) ^
         prmt(t[4], 0u, a2 + (a2 >> 12));
}

template <int W>
__device__ __forceinline__ void load_words(const uint32_t* p, uint32_t* d) {
  if constexpr (W == 4) {
    const uint4 v = __ldcs(reinterpret_cast<const uint4*>(p));
    d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
  } else {
    d[0] = __ldcs(p);
  }
}

// The output of an earlier batch: L2, not L1 (another thread may have
// written it when the earlier batch took the other access width).
template <int W>
__device__ __forceinline__ void reload_words(const uint32_t* p, uint32_t* d) {
  if constexpr (W == 4) {
    const uint4 v = __ldcg(reinterpret_cast<const uint4*>(p));
    d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
  } else {
    d[0] = __ldcg(p);
  }
}

template <int W>
__device__ __forceinline__ void store_words(uint32_t* p, const uint32_t* d) {
  if constexpr (W == 4) {
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(d[0], d[1], d[2], d[3]));
  } else {
    __stcs(p, d[0]);
  }
}

// Shared state of one tile: the batch's term descriptors.
template <int M, bool kMul>
struct Smem {
  const uint32_t* src[kMaxTerms];
  uint32_t tab[kMul ? kMaxTerms : 1][kMul ? M : 1][5];
  uint8_t kind[kMul ? kMaxTerms : 1][kMul ? M : 1];   // 0 skip, 1 XOR, 2 mul
};

// Vectors of W words a thread holds per output and per pass.
template <int M>
constexpr int kVectors = M <= 2 ? 4 : (M <= 4 ? 2 : 1);

// Fold n units of W words starting at word w0 of the tile's piece. o, b:
// the piece's output and base at word 0 (b null: zeros); from_out: seed
// from the output (a later batch of terms).
template <int M, bool kMul, int W>
__device__ __forceinline__ void fold(const Smem<M, kMul>& s, int n_terms,
                                     uint32_t* __restrict__ o,
                                     const uint32_t* __restrict__ b,
                                     int64_t ostr, int64_t bstr, int64_t w0,
                                     int64_t n, bool from_out) {
  constexpr int V = kVectors<M>;
  constexpr int N = V * W;
  for (int64_t u0 = threadIdx.x; u0 < n; u0 += static_cast<int64_t>(kThreads) * V) {
    bool ok[V];
    int64_t at[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      ok[j] = u0 + j * kThreads < n;
      at[j] = w0 + (u0 + j * kThreads) * W;
    }
    uint32_t acc[M][N];
#pragma unroll
    for (int q = 0; q < M; ++q)
#pragma unroll
      for (int j = 0; j < V; ++j) {
        uint32_t* d = &acc[q][j * W];
#pragma unroll
        for (int e = 0; e < W; ++e) d[e] = 0u;
        if (!ok[j]) continue;
        if (from_out) reload_words<W>(o + q * ostr + at[j], d);
        else if (b != nullptr) load_words<W>(b + q * bstr + at[j], d);
      }
    uint32_t cur[N], nxt[N];
#pragma unroll
    for (int i = 0; i < N; ++i) cur[i] = nxt[i] = 0u;
    if (n_terms > 0) {
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (ok[j]) load_words<W>(s.src[0] + at[j], &cur[j * W]);
    }
    for (int k = 0; k < n_terms; ++k) {
      if (k + 1 < n_terms) {
        const uint32_t* p = s.src[k + 1];
#pragma unroll
        for (int j = 0; j < V; ++j)
          if (ok[j]) load_words<W>(p + at[j], &nxt[j * W]);
      }
      if constexpr (!kMul) {
#pragma unroll
        for (int i = 0; i < N; ++i) acc[0][i] ^= cur[i];
      } else {
#pragma unroll
        for (int q = 0; q < M; ++q) {
          const uint32_t kind = s.kind[k][q];
          if (kind == 1u) {
#pragma unroll
            for (int i = 0; i < N; ++i) acc[q][i] ^= cur[i];
          } else if (kind == 2u) {
            uint32_t t[5];
#pragma unroll
            for (int w = 0; w < 5; ++w) t[w] = s.tab[k][q][w];
#pragma unroll
            for (int i = 0; i < N; ++i) acc[q][i] ^= gf_mul_word(t, cur[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < N; ++i) cur[i] = nxt[i];
    }
#pragma unroll
    for (int q = 0; q < M; ++q)
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (ok[j]) store_words<W>(o + q * ostr + at[j], &acc[q][j * W]);
  }
}

// One CTA per tile. kMul: the GF(256) multiply-accumulate with M outputs
// and two sources; otherwise XOR of one source into one output.
template <int M, bool kMul>
__global__ void __launch_bounds__(kThreads) erasure_pieces_kernel(const Pieces a) {
  __shared__ Smem<M, kMul> s;
  const int64_t tile = a.tile0 + blockIdx.x;
  const int64_t p = a.tile_piece[tile];
  const int64_t lo = a.tile_lo[tile];
  const int64_t len = a.pc_len[p];
  const int64_t hi = lo + a.tile_words < len ? lo + a.tile_words : len;
  const int64_t e0 = a.pc_term[p], e1 = a.pc_term[p + 1];
  uint32_t* __restrict__ o = a.out + (a.pc_out[p] - a.out_shift);
  const int64_t bo = a.pc_base[p];
  const uint32_t* __restrict__ b = bo >= 0 ? a.base + bo : nullptr;
  const int64_t ostr = M > 1 ? a.out_stride : 0;
  const int64_t bstr = M > 1 ? a.base_stride : 0;
  const uintptr_t oa = reinterpret_cast<uintptr_t>(o);
  // misalignment of the streams every thread sees alike
  uintptr_t mis = ((ostr | bstr) & 3) != 0;
  if (b != nullptr) mis |= (reinterpret_cast<uintptr_t>(b) - oa) & 15u;
  // words from word 0 to the output's first 16-byte boundary
  const int64_t head = static_cast<int64_t>(((16u - (oa & 15u)) & 15u) >> 2);
  int64_t eb = e0;
  do {
    const int n_terms = static_cast<int>(e1 - eb < kMaxTerms ? e1 - eb : kMaxTerms);
    __syncthreads();                    // the previous batch is done with s
    uintptr_t my = 0;
    if (threadIdx.x < n_terms) {
      const int64_t e = eb + threadIdx.x;
      const uint32_t* src = (kMul && a.en_sel[e]) ? a.src2 : a.src;
      s.src[threadIdx.x] = src + a.en_src[e];
      my = (reinterpret_cast<uintptr_t>(s.src[threadIdx.x]) - oa) & 15u;
    }
    if constexpr (kMul) {
      for (int i = threadIdx.x; i < n_terms * M; i += kThreads) {
        const int k = i / M, q = i % M;
        const uint32_t c = a.en_coef[(eb + k) * M + q];
        gf_tables(c, s.tab[k][q]);
        s.kind[k][q] = c == 0u ? 0 : (c == 1u ? 1 : 2);
      }
    }
    const bool vec = !__syncthreads_or(static_cast<int>(my | mis));
    const bool from_out = eb != e0;
    if (vec) {
      int64_t vlo = lo + ((head - lo) & 3);
      vlo = vlo < hi ? vlo : hi;
      const int64_t nv = (hi - vlo) >> 2;
      fold<M, kMul, 1>(s, n_terms, o, b, ostr, bstr, lo, vlo - lo, from_out);
      fold<M, kMul, 4>(s, n_terms, o, b, ostr, bstr, vlo, nv, from_out);
      fold<M, kMul, 1>(s, n_terms, o, b, ostr, bstr, vlo + 4 * nv,
                       hi - vlo - 4 * nv, from_out);
    } else {
      fold<M, kMul, 1>(s, n_terms, o, b, ostr, bstr, lo, hi - lo, from_out);
    }
    eb += kMaxTerms;
  } while (eb < e1);
}

template <int M, bool kMul>
int launch(const Pieces& a, int64_t n_tiles, cudaStream_t stream) {
  if (n_tiles <= 0) return 0;
  if (n_tiles > 0x7FFFFFFF || a.tile_words <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  erasure_pieces_kernel<M, kMul>
      <<<static_cast<unsigned>(n_tiles), kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace erasure
