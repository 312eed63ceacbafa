// Banded causal GQA attention with an online softmax: for query row i of
// group member g, keys j with j <= i and i - j < window,
//
//   out[bh][g][i] = sum_j softmax_j(q_i . k_j / sqrt(Dh)) v_j     (f32)
//
// q: (BH, G, S, Dh); k, v: (BH, S, Dh); f32 or bf16 in, f32 out. A window
// of S is plain causal attention.
//
// Replaces repro/kernels/sw_attention/kernel.py::sw_attention_pallas.
//
// Bound on an H100: operations. Each visible (query, key) pair costs 4 Dh
// FLOPs for a few bytes; the least time is those FLOPs over the dense
// bf16 tensor-core rate (989 TFLOP/s), which this first kernel, in f32 FMA
// on the CUDA cores, cannot reach: its own ceiling is 67 TFLOP/s.
//
// Design. The TPU kernel keeps a (G * 128, Dh) f32 accumulator in VMEM
// across its kv grid axis (393 KB at qwen2-1.5b): far above what a CTA
// holds. Here one CTA owns (bh, g, 64 query rows) and walks, in a loop, the
// 64-key tiles the band reaches: from floor((q0 - window) / 64), clamped at
// 0 as _kv_start_block does, to the diagonal, so a causal prefill visits
// only the lower triangle. Four threads share a query row, each holding a
// quarter of q and of the output row in registers (its float4 chunks c with
// c % 4 == its lane, so the four read adjacent 16-byte words of a key row:
// no bank conflicts). A tile of K and V is loaded as f32 into shared
// memory; pass 1 takes the 64 scores of each row (partial dot products
// joined by two shuffles) and the tile's maximum, pass 2 rescales the
// running sums once and adds exp(s - m) v. Rows and keys past S, and keys
// outside the band, are masked by position arithmetic, not by padded
// copies. l is clamped at 1e-30 before the division, as the reference
// does. No atomics: the same inputs give the same bits on every run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;        // query rows per CTA: 4 threads per row
constexpr int kKeys = 64;        // keys per shared-memory tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ bool visible(int qpos, int kpos, int window, int S) {
  return kpos < S && kpos <= qpos && qpos - kpos < window;
}

// grid: (ceil(S / kRows), G, BH)
template <int DH, typename T>
__global__ void __launch_bounds__(kThreads)
sw_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, float* __restrict__ out, int G,
                    int S, int window, float scale) {
  constexpr int kChunks = DH / 16;        // float4 chunks per thread
  extern __shared__ float smem[];
  float* k_s = smem;                      // kKeys x DH
  float* v_s = k_s + kKeys * DH;          // kKeys x DH
  float* s_s = v_s + kKeys * DH;          // kRows x (kKeys + 1)

  const int g = blockIdx.y;
  const int64_t bh = blockIdx.z;
  const int q0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int row = tid >> 2, lane4 = tid & 3;
  const int qpos = q0 + row;
  const bool q_ok = qpos < S;

  float qr[DH / 4], acc[DH / 4];
  const T* q_row = q + ((bh * G + g) * S + (q_ok ? qpos : 0)) * DH;
#pragma unroll
  for (int t = 0; t < kChunks; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qr[4 * t + e] = q_ok ? to_f32(q_row[4 * (lane4 + 4 * t) + e]) : 0.f;
      acc[4 * t + e] = 0.f;
    }
  }
  float m = kNegInf, l = 0.f;

  const T* k_bh = k + bh * S * DH;
  const T* v_bh = v + bh * S * DH;
  const int k_begin = max(0, (q0 - window) / kKeys) * kKeys;
  const int k_end = min(S, q0 + kRows);
  for (int kt = k_begin; kt < k_end; kt += kKeys) {
    __syncthreads();                      // the last tile is consumed
    const int64_t base = static_cast<int64_t>(kt) * DH;
    for (int e = tid; e < kKeys * DH; e += kThreads) {
      const bool ok = kt + e / DH < S;
      k_s[e] = ok ? to_f32(k_bh[base + e]) : 0.f;
      v_s[e] = ok ? to_f32(v_bh[base + e]) : 0.f;
    }
    __syncthreads();

    // pass 1: this row's scores and the tile's maximum
    float mt = kNegInf;
    float* s_row = s_s + row * (kKeys + 1);
#pragma unroll 4
    for (int j = 0; j < kKeys; ++j) {
      const float4* kj = reinterpret_cast<const float4*>(k_s + j * DH);
      float part = 0.f;
#pragma unroll
      for (int t = 0; t < kChunks; ++t) {
        const float4 kv = kj[lane4 + 4 * t];
        part = fmaf(qr[4 * t], kv.x, part);
        part = fmaf(qr[4 * t + 1], kv.y, part);
        part = fmaf(qr[4 * t + 2], kv.z, part);
        part = fmaf(qr[4 * t + 3], kv.w, part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const float s = visible(qpos, kt + j, window, S) ? part * scale : kNegInf;
      mt = fmaxf(mt, s);
      if (lane4 == 0) s_row[j] = s;
    }
    __syncwarp();

    // pass 2: rescale once, then add exp(s - m_new) v_j
    const float m_new = fmaxf(m, mt);
    const float r = expf(m - m_new);
    l *= r;
#pragma unroll
    for (int d = 0; d < DH / 4; ++d) acc[d] *= r;
#pragma unroll 4
    for (int j = 0; j < kKeys; ++j) {
      const float p = visible(qpos, kt + j, window, S)
                          ? expf(s_row[j] - m_new) : 0.f;
      l += p;
      const float4* vj = reinterpret_cast<const float4*>(v_s + j * DH);
#pragma unroll
      for (int t = 0; t < kChunks; ++t) {
        const float4 vv = vj[lane4 + 4 * t];
        acc[4 * t] = fmaf(p, vv.x, acc[4 * t]);
        acc[4 * t + 1] = fmaf(p, vv.y, acc[4 * t + 1]);
        acc[4 * t + 2] = fmaf(p, vv.z, acc[4 * t + 2]);
        acc[4 * t + 3] = fmaf(p, vv.w, acc[4 * t + 3]);
      }
    }
    m = m_new;
  }

  if (q_ok) {
    const float lc = fmaxf(l, 1e-30f);
    float* o_row = out + ((bh * G + g) * S + qpos) * DH;
#pragma unroll
    for (int t = 0; t < kChunks; ++t) {
      float4 o;
      o.x = acc[4 * t] / lc;
      o.y = acc[4 * t + 1] / lc;
      o.z = acc[4 * t + 2] / lc;
      o.w = acc[4 * t + 3] / lc;
      reinterpret_cast<float4*>(o_row)[lane4 + 4 * t] = o;
    }
  }
}

template <int DH, typename T>
int launch(const void* q, const void* k, const void* v, float* out,
           int64_t BH, int64_t G, int64_t S, int64_t window, float scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * kKeys * DH + kRows * (kKeys + 1));
  auto kernel = sw_attention_kernel<DH, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((S + kRows - 1) / kRows),
                  static_cast<unsigned>(G), static_cast<unsigned>(BH));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), out, static_cast<int>(G), static_cast<int>(S),
      static_cast<int>(window), scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (BH, G, S, Dh); k, v: (BH, S, Dh), contiguous, float32 (bf16 == 0) or
// bfloat16 (bf16 == 1); out: (BH, G, S, Dh) f32, 16-byte aligned; Dh is 64
// or 128; window >= 1. Returns the CUDA error code of the launch.
extern "C" int sw_attention(const void* q, const void* k, const void* v,
                            float* out, int64_t BH, int64_t G, int64_t S,
                            int64_t Dh, int64_t window, int64_t bf16,
                            float scale, cudaStream_t stream) {
  if (BH < 1 || G < 1 || S < 1 || window < 1 || BH > 65535 || G > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (Dh == 64) {
    return bf16 ? launch<64, __nv_bfloat16>(q, k, v, out, BH, G, S, window, scale, stream)
                : launch<64, float>(q, k, v, out, BH, G, S, window, scale, stream);
  }
  if (Dh == 128) {
    return bf16 ? launch<128, __nv_bfloat16>(q, k, v, out, BH, G, S, window, scale, stream)
                : launch<128, float>(q, k, v, out, BH, G, S, window, scale, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
