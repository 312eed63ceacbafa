// Mamba2 SSD intra-chunk dual form [arXiv:2405.21060], per (batch, chunk,
// head):
//
//   cum     = cumsum(la)                                 (Q,)
//   M[i][j] = exp(cum_i - cum_j) * (C_i . B_j) * dt_j     for j <= i, else 0
//   y       = M x                                         (Q, P)
//   w_j     = exp(cum_{Q-1} - cum_j) * dt_j
//   state   = B^T (x * w)                                 (N, P)
//
// Replaces repro/kernels/ssd_scan/kernel.py::ssd_intra_pallas, the
// quadratic part of the SSD scan (kernels/ssd_scan/ops.py adds the
// inter-chunk recurrence).
//
// Bound on an H100: operations. At mamba2-370m (Q = N = 128, P = 64) one
// cell does about 2.6 M multiply-adds for 48 KB of input, far above the
// card's balance point; the least time is the f32 FLOPs over 67 TFLOP/s.
//
// Design. One CTA per (b, c, h), as the TPU grid has it; the C B^T
// products are recomputed per head (sharing them across heads is a later
// design). The chunk's C rows, B transposed (row stride Q + 1, so the
// transposing store and the column reads hit 32 distinct banks) and the
// head's x rows sit in dynamic shared memory (174 KB at the full shapes,
// above the 48 KB static limit). The TPU kernel holds the (Q, Q) matrix M
// in VMEM; here M is built 16 rows at a time: thread t owns column
// j = t % 128 and computes its entries only for j <= i, so exp(cum_i -
// cum_j) is never taken above the diagonal (it can overflow there, and
// inf * 0 would be NaN) and whole warps above it skip the N-long dot
// product. Then y's 16 rows are M's rows times x; last, x is scaled by w in
// place and state = B^T (x * w). All arithmetic is f32 FMA from shared
// memory; no atomics, so every run gives the same bits. The cumsum is a warp
// scan: its f32 sums run in another order than jnp.cumsum's.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxQ = 128;       // the score pass maps column j to t % kMaxQ
constexpr int kRowBlock = 16;    // rows of M in shared memory at a time

__global__ void __launch_bounds__(kThreads)
ssd_intra_kernel(const float* __restrict__ la, const float* __restrict__ dt,
                 const float* __restrict__ x, const float* __restrict__ bm,
                 const float* __restrict__ cm, float* __restrict__ y,
                 float* __restrict__ state, int Q, int H, int P, int N) {
  extern __shared__ float smem[];
  const int bstride = Q + 1;
  float* c_s = smem;                      // Q x N
  float* bt_s = c_s + Q * N;              // N x (Q + 1): B transposed
  float* x_s = bt_s + N * bstride;        // Q x P
  float* cum_s = x_s + Q * P;             // Q
  float* dt_s = cum_s + Q;                // Q
  float* w_s = dt_s + Q;                  // Q
  float* m_s = w_s + Q;                   // kRowBlock x Q

  const int64_t cell = blockIdx.x;        // (b * nc + c) * H + h
  const int h = static_cast<int>(cell % H);
  const int64_t bc = cell / H;            // b * nc + c
  const int tid = threadIdx.x;

  // la, dt strided by H; x rows strided by H * P; B, C rows contiguous
  const float* c_g = cm + bc * Q * N;
  const float* b_g = bm + bc * Q * N;
  for (int e = tid; e < Q * N; e += kThreads) {
    c_s[e] = c_g[e];
    bt_s[(e % N) * bstride + e / N] = b_g[e];
  }
  for (int e = tid; e < Q * P; e += kThreads) {
    x_s[e] = x[((bc * Q + e / P) * H + h) * P + e % P];
  }
  for (int j = tid; j < Q; j += kThreads) {
    dt_s[j] = dt[(bc * Q + j) * H + h];
    cum_s[j] = la[(bc * Q + j) * H + h];
  }
  __syncthreads();

  // cum = cumsum(la): warp 0, 32 positions at a time, carrying the sum
  if (tid < 32) {
    float carry = 0.f;
    for (int base = 0; base < Q; base += 32) {
      const int j = base + tid;
      float v = j < Q ? cum_s[j] : 0.f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, off);
        if (tid >= off) v += u;
      }
      v += carry;
      if (j < Q) cum_s[j] = v;
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }
  __syncthreads();
  for (int j = tid; j < Q; j += kThreads) {
    w_s[j] = expf(cum_s[Q - 1] - cum_s[j]) * dt_s[j];
  }

  // y = M x, M built kRowBlock rows at a time
  const int j = tid % kMaxQ;
  for (int i0 = 0; i0 < Q; i0 += kRowBlock) {
    const int rows = min(kRowBlock, Q - i0);
    for (int r = tid / kMaxQ; r < rows; r += kThreads / kMaxQ) {
      const int i = i0 + r;
      if (j < Q) {
        float mij = 0.f;
        if (j <= i) {
          const float* ci = c_s + i * N;
          const float* bj = bt_s + j;
          float s = 0.f;
          for (int n = 0; n < N; ++n) s = fmaf(ci[n], bj[n * bstride], s);
          mij = expf(cum_s[i] - cum_s[j]) * s * dt_s[j];
        }
        m_s[r * Q + j] = mij;
      }
    }
    __syncthreads();
    for (int o = tid; o < rows * P; o += kThreads) {
      const int r = o / P, p = o % P;
      const int i = i0 + r;
      const float* mr = m_s + r * Q;
      float acc = 0.f;
      for (int jj = 0; jj <= i; ++jj) acc = fmaf(mr[jj], x_s[jj * P + p], acc);
      y[((bc * Q + i) * H + h) * P + p] = acc;
    }
    __syncthreads();
  }

  // state = B^T (x * w)
  for (int e = tid; e < Q * P; e += kThreads) x_s[e] *= w_s[e / P];
  __syncthreads();
  for (int o = tid; o < N * P; o += kThreads) {
    const int n = o / P, p = o % P;
    const float* bn = bt_s + n * bstride;
    float acc = 0.f;
    for (int jj = 0; jj < Q; ++jj) acc = fmaf(bn[jj], x_s[jj * P + p], acc);
    state[(cell * N + n) * P + p] = acc;
  }
}

}  // namespace

// la, dt: (B, nc, Q, H); x: (B, nc, Q, H, P); bm, cm: (B, nc, Q, N); f32,
// contiguous, Q <= 128. y: (B, nc, Q, H, P); state: (B, nc, H, N, P).
// Returns the CUDA error code of the launch (0 on success).
extern "C" int ssd_intra(const float* la, const float* dt, const float* x,
                         const float* bm, const float* cm, float* y,
                         float* state, int64_t B, int64_t nc, int64_t Q,
                         int64_t H, int64_t P, int64_t N, cudaStream_t stream) {
  if (Q < 1 || Q > kMaxQ || N < 1 || P < 1 || H < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float) *
      static_cast<size_t>(Q * N + N * (Q + 1) + Q * P + 3 * Q + kRowBlock * Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_intra_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t cells = B * nc * H;
  if (cells == 0) return 0;
  ssd_intra_kernel<<<static_cast<unsigned>(cells), kThreads, smem, stream>>>(
      la, dt, x, bm, cm, y, state, static_cast<int>(Q), static_cast<int>(H),
      static_cast<int>(P), static_cast<int>(N));
  return static_cast<int>(cudaGetLastError());
}
