// Word decoding shared by the sweeps (arena_maintain.cu, fused_maintain.cu):
// the elements of a 32-bit word decoded to float by the arena's dtype code
// (core/blocks.py::WORD_DTYPE_NAMES, the order of core/arena.py::dtype_code),
// the squared difference of two words summed over their elements, and a
// warp sum. Each including unit gets its own copy (anonymous namespace).
#pragma once
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

}  // namespace
