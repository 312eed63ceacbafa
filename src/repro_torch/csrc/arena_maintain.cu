// One maintenance sweep over the flat word arena: XOR parity of every
// parity destination tile, per-tile drift-score partials, per-gid scores.
//
// Replaces repro/kernels/fused_maintain/kernel.py::arena_maintain_pallas
// and the epilogues its driver (fused_maintain/ops.py::ArenaMaintainProgram)
// runs around it: the segment-sum into per-block scores, the scatter of the
// compact parity tiles into the (n_groups, frame_elems) codec layout, the
// tail region's word XOR and, on the resident path, the replica copy.
//
// Bound on an H100: bytes. Each live word and each checkpoint word is read
// once, each parity word written once (plus the replica copy on the
// resident path), for a few integer and float operations per word: far
// below the card's balance point, so the least time is the bytes over
// 3.35 TB/s.
//
// Design. The TPU kernel walks tiles in destination order and relies on the
// sequential grid to seed a parity tile on its first member and fold the
// rest into it. Hopper CTAs run in no order, so here one warp owns one
// parity destination tile (1024 words) and walks that destination's member
// list itself: it loads each member tile of the live arena (and of the
// checkpoint arena) once, 16 bytes per lane, keeps the XOR fold in
// registers, writes one score partial per member tile, and, when a replica
// pointer is given, writes the replica tile from the same read. The folded
// tile is written straight into the codec's parity at its frame position,
// so no compact-tile buffer and no scatter epilogue exist. Destinations are
// disjoint, so no two warps write one word. Tail-region words (blocks that
// share tiles) fold into the destination tile they land in through a
// shared-memory stage, one lane per word position, so the same launch
// covers them. Score partials of tail blocks come from extra warps, one per
// tail block. A second pass sums each gid's partials in a fixed order, one
// warp per gid: no atomics anywhere, so scores are bit-identical from run
// to run and the top-k downstream is stable. Words are decoded by their
// tile's dtype code (the arena's codes, core/arena.py::dtype_code) for the
// score; the XOR does not depend on the dtype.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileWords = 1024;
constexpr int kTileVecs = kTileWords / 4;     // uint4 per tile
constexpr int kVecsPerLane = kTileVecs / 32;  // 8

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// fp8 formats with E exponent bits, M mantissa bits and bias B. kFn: no
// infinities, all-ones exponent and mantissa is NaN (e4m3fn). kFnuz: the
// byte 0x80 is NaN, no negative zero, no infinities. Otherwise IEEE-like
// (e5m2: all-ones exponent is inf or NaN).
template <int E, int M, int B, bool kFn, bool kFnuz>
__device__ __forceinline__ float fp8_to_float(uint32_t b) {
  b &= 0xffu;
  if (kFnuz && b == 0x80u) return __int_as_float(0x7fc00000);
  const uint32_t sign = (b >> 7) & 1u;
  const uint32_t exp = (b >> M) & ((1u << E) - 1u);
  const uint32_t man = b & ((1u << M) - 1u);
  float v;
  if (!kFn && !kFnuz && exp == (1u << E) - 1u) {
    v = man ? __int_as_float(0x7fc00000) : __int_as_float(0x7f800000);
  } else if (kFn && exp == (1u << E) - 1u && man == (1u << M) - 1u) {
    v = __int_as_float(0x7fc00000);
  } else if (exp == 0) {
    v = ldexpf(static_cast<float>(man), 1 - B - M);
  } else {
    v = ldexpf(static_cast<float>(man + (1u << M)), static_cast<int>(exp) - B - M);
  }
  return sign ? -v : v;
}

__device__ __forceinline__ float e8m0_to_float(uint32_t b) {
  b &= 0xffu;
  if (b == 0xffu) return __int_as_float(0x7fc00000);
  return ldexpf(1.f, static_cast<int>(b) - 127);
}

// Element k of a word, decoded by the arena dtype code (the order of
// core/blocks.py::WORD_DTYPE_NAMES).
__device__ __forceinline__ float decode(int code, uint32_t w, int k) {
  switch (code) {
    case 1: return __uint_as_float(k ? (w & 0xffff0000u) : (w << 16));   // bf16
    case 2: return __half2float(__ushort_as_half(static_cast<unsigned short>(w >> (16 * k))));
    case 3: return fp8_to_float<4, 3, 7, true, false>(w >> (8 * k));    // e4m3fn
    case 4: return fp8_to_float<5, 2, 15, false, false>(w >> (8 * k));  // e5m2
    case 5: return fp8_to_float<4, 3, 8, false, true>(w >> (8 * k));    // e4m3fnuz
    case 6: return fp8_to_float<5, 2, 16, false, true>(w >> (8 * k));   // e5m2fnuz
    case 7: return e8m0_to_float(w >> (8 * k));                         // e8m0fnu
    case 8: return static_cast<float>(static_cast<int8_t>(w >> (8 * k)));
    case 9: return static_cast<float>(static_cast<uint8_t>(w >> (8 * k)));
    case 10: return static_cast<float>(static_cast<int16_t>(w >> (16 * k)));
    case 11: return static_cast<float>(static_cast<uint16_t>(w >> (16 * k)));
    case 12: return static_cast<float>(static_cast<int32_t>(w));
    case 13: return static_cast<float>(w);
    default: return __uint_as_float(w);                                 // f32
  }
}

__device__ __forceinline__ int elems_per_word(int code) {
  return (code >= 3 && code <= 9) ? 4 : ((code == 1 || code == 2 || code == 10 || code == 11) ? 2 : 1);
}

// Squared difference of one word pair, summed over the word's elements.
__device__ __forceinline__ float word_sq(int code, uint32_t a, uint32_t b) {
  if (code == 0) {
    const float d = __uint_as_float(a) - __uint_as_float(b);
    return d * d;
  }
  const int r = elems_per_word(code);
  float s = 0.f;
  for (int k = 0; k < r; ++k) {
    const float d = decode(code, a, k) - decode(code, b, k);
    s = fmaf(d, d, s);
  }
  return s;
}

__device__ __forceinline__ float vec_sq(int code, uint4 a, uint4 b) {
  return word_sq(code, a.x, b.x) + word_sq(code, a.y, b.y) +
         word_sq(code, a.z, b.z) + word_sq(code, a.w, b.w);
}

__device__ __forceinline__ uint4 xor4(uint4 a, uint4 b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}

struct Sweep {
  const uint32_t* x;        // live arena words
  const uint32_t* z;        // checkpoint arena words, or null: no scores
  uint32_t* replica;        // replica copy of the routed tiles, or null
  uint32_t* parity;         // (n_groups * frame_elems) parity, or null
  float* partials;          // n_tiles tile partials, then n_tb tail partials
  const int8_t* tile_code;  // (n_tiles,) dtype code per tile
  const int32_t* dest_tile; // (n_dest,) parity tile index per destination
  const int64_t* mem_ptr;   // (n_dest + 1,) CSR into mem_tile
  const int32_t* mem_tile;  // arena tile ids, destination-major
  const int64_t* tail_ptr;  // (n_dest + 1,) CSR into tail_pos / tail_word
  const int32_t* tail_pos;  // word position inside the destination tile
  const int64_t* tail_word; // arena word folded into that position
  int64_t n_dest;
  const int64_t* tb_off;    // (n_tb,) tail block word offset
  const int32_t* tb_len;    // (n_tb,) tail block payload words
  const int8_t* tb_code;    // (n_tb,) tail block dtype code
  int64_t n_tb;
  int64_t n_tiles;
};

__global__ void __launch_bounds__(kThreads) arena_sweep_kernel(Sweep s) {
  __shared__ __align__(16) uint32_t stage[kWarps][kTileWords];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kWarps + wib;
  if (w < s.n_dest) {
    uint4 acc[kVecsPerLane];
#pragma unroll
    for (int i = 0; i < kVecsPerLane; ++i) acc[i] = make_uint4(0u, 0u, 0u, 0u);
    for (int64_t m = s.mem_ptr[w]; m < s.mem_ptr[w + 1]; ++m) {
      const int64_t t = s.mem_tile[m];
      const uint4* xt = reinterpret_cast<const uint4*>(s.x + t * kTileWords);
      uint4 v[kVecsPerLane];
#pragma unroll
      for (int i = 0; i < kVecsPerLane; ++i) v[i] = xt[i * 32 + lane];
      if (s.parity) {
#pragma unroll
        for (int i = 0; i < kVecsPerLane; ++i) acc[i] = xor4(acc[i], v[i]);
      }
      if (s.replica) {
        uint4* rt = reinterpret_cast<uint4*>(s.replica + t * kTileWords);
#pragma unroll
        for (int i = 0; i < kVecsPerLane; ++i) rt[i * 32 + lane] = v[i];
      }
      if (s.z) {
        const uint4* zt = reinterpret_cast<const uint4*>(s.z + t * kTileWords);
        const int code = s.tile_code[t];
        float sc = 0.f;
#pragma unroll
        for (int i = 0; i < kVecsPerLane; ++i) sc += vec_sq(code, v[i], zt[i * 32 + lane]);
        sc = warp_sum(sc);
        if (lane == 0) s.partials[t] = sc;
      }
    }
    if (!s.parity) return;
    uint4* out = reinterpret_cast<uint4*>(s.parity + static_cast<int64_t>(s.dest_tile[w]) * kTileWords);
    const int64_t p0 = s.tail_ptr[w], p1 = s.tail_ptr[w + 1];
    if (p0 == p1) {
#pragma unroll
      for (int i = 0; i < kVecsPerLane; ++i) out[i * 32 + lane] = acc[i];
      return;
    }
    // tail words land inside this tile: fold them in through shared memory,
    // each word position owned by one lane (position % 32), so no two lanes
    // touch one position
    uint4* st = reinterpret_cast<uint4*>(stage[wib]);
#pragma unroll
    for (int i = 0; i < kVecsPerLane; ++i) st[i * 32 + lane] = acc[i];
    __syncwarp();
    for (int64_t p = p0; p < p1; ++p) {
      const int pos = s.tail_pos[p];
      if ((pos & 31) == lane) stage[wib][pos] ^= s.x[s.tail_word[p]];
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kVecsPerLane; ++i) out[i * 32 + lane] = st[i * 32 + lane];
    return;
  }
  const int64_t tb = w - s.n_dest;
  if (tb >= s.n_tb || !s.z) return;
  const int64_t off = s.tb_off[tb];
  const int code = s.tb_code[tb];
  float sc = 0.f;
  for (int64_t j = lane; j < s.tb_len[tb]; j += 32) sc += word_sq(code, s.x[off + j], s.z[off + j]);
  sc = warp_sum(sc);
  if (lane == 0) s.partials[s.n_tiles + tb] = sc;
}

// One warp per gid: the sum of the partials of its arena blocks' segments
// (main blocks: their tiles; tail blocks: one partial each), in block order
// and a fixed lane order.
__global__ void arena_scores_kernel(const float* __restrict__ partials,
                                    float* __restrict__ scores,
                                    const int64_t* __restrict__ gid_ptr,
                                    const int32_t* __restrict__ gid_ab,
                                    const int64_t* __restrict__ ab_seg0,
                                    const int32_t* __restrict__ ab_nseg,
                                    int64_t n_gid) {
  const int64_t g = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (g >= n_gid) return;   // whole warps leave together
  float acc = 0.f;
  for (int64_t a = gid_ptr[g]; a < gid_ptr[g + 1]; ++a) {
    const int32_t ab = gid_ab[a];
    const int64_t s0 = ab_seg0[ab];
    for (int64_t j = lane; j < ab_nseg[ab]; j += 32) acc += partials[s0 + j];
  }
  acc = warp_sum(acc);
  if (lane == 0) scores[g] = acc;
}

}  // namespace

// All pointers are device pointers; x, z, replica and parity 16-byte
// aligned. z, replica and parity may be null. Launches the sweep and, when
// z is given, the per-gid pass. Returns cudaGetLastError() after launch.
extern "C" int arena_maintain(
    const void* x, const void* z, void* replica, void* parity, float* partials,
    float* scores, const int8_t* tile_code, const int32_t* dest_tile,
    const int64_t* mem_ptr, const int32_t* mem_tile, const int64_t* tail_ptr,
    const int32_t* tail_pos, const int64_t* tail_word, int64_t n_dest,
    const int64_t* tb_off, const int32_t* tb_len, const int8_t* tb_code,
    int64_t n_tb, int64_t n_tiles, const int64_t* gid_ptr, const int32_t* gid_ab,
    const int64_t* ab_seg0, const int32_t* ab_nseg, int64_t n_gid,
    cudaStream_t stream) {
  Sweep s{static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(z),
          static_cast<uint32_t*>(replica), static_cast<uint32_t*>(parity),
          partials, tile_code, dest_tile, mem_ptr, mem_tile, tail_ptr,
          tail_pos, tail_word, n_dest, tb_off, tb_len, tb_code, n_tb, n_tiles};
  const int64_t warps = n_dest + n_tb;
  if (warps > 0) {
    const int64_t ctas = (warps + kWarps - 1) / kWarps;
    arena_sweep_kernel<<<static_cast<unsigned>(ctas), kThreads, 0, stream>>>(s);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (z && n_gid > 0) {
    const int64_t threads = n_gid * 32;
    arena_scores_kernel<<<static_cast<unsigned>((threads + 255) / 256), 256, 0, stream>>>(
        partials, scores, gid_ptr, gid_ab, ab_seg0, ab_nseg, n_gid);
  }
  return static_cast<int>(cudaGetLastError());
}
