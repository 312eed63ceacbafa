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
// Bound on an H100: bytes. At mamba2-370m (Q = N = 128, H = 32, P = 64)
// a (batch, chunk) reads 1.1 MB and writes 2 MB; its products, done as
// three TF32 products each, take less time on the tensor cores (495
// TFLOP/s) than those bytes take at 3.35 TB/s.
//
// Design. One CTA per (batch, chunk), looping over the H heads: C B^T does
// not depend on the head, so G = C B^T is computed once, over its causal
// half, and kept in shared memory for all heads. Per head, M is formed in
// registers from G as each A fragment is loaded (exp(cum_i - cum_j) only
// for j <= i: above the diagonal it can overflow, and inf * 0 would be
// NaN), then y = M x and state = B^T (x w). While a head computes, the next
// head's x, la and dt arrive by cp.async into the other half of a double
// buffer that reuses C's space once G is done. Shared memory at the full
// shapes: B, G and two x buffers, 214 KB. Where two x buffers do not fit
// (P > 64 at Q = N = 128) x is single-buffered: the next head's x is
// fetched after the current head is done. The kernel takes P <= 128 at
// Q = N = 128.
//
// Products run on the tensor cores as mma.sync m16n8k8 TF32 with f32
// accumulation, each split in three: a = hi + lo with hi = tf32(a) and
// lo = a - hi (read as TF32), and a b ~ lo_a hi_b + hi_a lo_b + hi_a hi_b
// (the lo lo term, ~2^-22 relative, is dropped). TF32 rather than a bf16 split:
// a bf16x3 product errs by ~2^-16 relative, which on y's cancelling sums of
// 128 terms of magnitude ~10 exceeds an absolute 2e-4; 3xTF32 errs by
// ~2^-22, near f32's own rounding. mma.sync rather than wgmma: wgmma takes
// TF32 operands K-major only (its transpose bit is for 16-bit types), and
// B^T, x and M would each need a transposed copy in shared memory, which
// does not fit beside G; mma.sync fragments load from any layout, and the
// split happens in registers as they load. Row strides are padded so the
// fragment loads hit 32 distinct banks (C, G: stride = 4 mod 32; B, x:
// 8 mod 32). All dimensions are padded with zeros to the MMA tiles in
// shared memory; the causal mask is by index. No atomics: every run gives
// the same bits. The cumsum is a warp scan: its f32 sums run in another
// order than torch.cumsum's.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQ = 128;       // 16-row blocks of y: at most one a warp
constexpr int kChunkTiles = 8;   // n-tiles (8 columns of P) per pass
constexpr size_t kSmemLimit = 232448;  // bytes of shared memory a CTA may use

__host__ __device__ __forceinline__ int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

struct Dims {
  int Q, H, P, N;
  int Qp, Np, Pp;                // padded: Q and N to 16, P to 64
  int ldb, ldc, ldg, ldx;        // row strides in floats
  int xbufs;                     // x buffers: 2, or 1 where 2 do not fit
};

__host__ __device__ inline size_t x_buffer_floats(const Dims& d) {
  return static_cast<size_t>(d.Qp) * d.ldx;
}

// floats of shared memory: B, G, the region C shares with the x buffers,
// and la, dt (two buffers each), cum, w
__host__ __device__ inline size_t smem_floats(const Dims& d) {
  const size_t b = static_cast<size_t>(d.Qp) * d.ldb;
  const size_t g = static_cast<size_t>(d.Qp) * d.ldg;
  const size_t c = static_cast<size_t>(d.Qp) * d.ldc;
  const size_t xs = d.xbufs * x_buffer_floats(d);
  return b + g + (c > xs ? c : xs) + 6 * static_cast<size_t>(d.Qp);
}

__host__ __device__ inline Dims make_dims(int Q, int H, int P, int N) {
  Dims d;
  d.Q = Q; d.H = H; d.P = P; d.N = N;
  d.Qp = round_up(Q, 16);
  d.Np = round_up(N, 16);
  d.Pp = round_up(P, 8 * kChunkTiles);
  d.ldb = round_up(d.Np, 32) + 8;
  d.ldc = round_up(d.Np, 32) + 4;
  d.ldg = round_up(d.Qp, 32) + 4;
  d.ldx = round_up(d.Pp, 32) + 8;
  d.xbufs = 2;
  if (sizeof(float) * smem_floats(d) > kSmemLimit) d.xbufs = 1;
  return d;
}

// v = hi + lo: hi is v rounded to TF32 (to nearest, ties away, as
// cvt.rna does; v is finite), lo = v - hi exactly. lo goes to the tensor
// core as it is, which reads its top 19 bits: lo truncated to TF32, an
// error below 2^-21 |v|.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// e^x for x <= 0 by the SFU's exp2 (relative error ~2^-21 over M's range;
// expf's range reduction would cost as much as the products it feeds)
__device__ __forceinline__ float exp_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// An A fragment split once into its TF32 high and low parts.
struct SplitA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ explicit SplitA(const float (&a)[4]) {
#pragma unroll
    for (int r = 0; r < 4; ++r) split(a[r], hi[r], lo[r]);
  }
};

// c += a b in three TF32 products, the small ones first
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const SplitA& a,
                                           float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma_tf32(c, a.lo, bh0, bh1);
  mma_tf32(c, a.hi, bl0, bl1);
  mma_tf32(c, a.hi, bh0, bh1);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(d),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// row[p], row[p + 1] = v0, v1 where p, p + 1 < P: one 8-byte store when
// the pair is aligned (P even)
__device__ __forceinline__ void store_pair(float* row, int p, int P, float v0,
                                           float v1) {
  if (P % 2 == 0) {
    if (p < P) *reinterpret_cast<float2*>(row + p) = make_float2(v0, v1);
  } else {
    if (p < P) row[p] = v0;
    if (p + 1 < P) row[p + 1] = v1;
  }
}

// head h's x rows (Q x P, row stride H * P in global), la and dt (stride H)
__device__ __forceinline__ void prefetch_head(
    const Dims& d, int64_t bc, int h, const float* __restrict__ la,
    const float* __restrict__ dt, const float* __restrict__ x, float* x_s,
    float* la_s, float* dt_s) {
  const int tid = threadIdx.x;
  const float* x_g = x + (bc * d.Q * d.H + h) * d.P;
  const int64_t row = static_cast<int64_t>(d.H) * d.P;
  if (d.P % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    const int vecs = d.P / 4;
    for (int e = tid; e < d.Q * vecs; e += kThreads) {
      const int j = e / vecs, p = 4 * (e % vecs);
      cp_async16(x_s + j * d.ldx + p, x_g + j * row + p);
    }
  } else {
    for (int e = tid; e < d.Q * d.P; e += kThreads) {
      const int j = e / d.P, p = e % d.P;
      cp_async4(x_s + j * d.ldx + p, x_g + j * row + p);
    }
  }
  for (int j = tid; j < d.Q; j += kThreads) {
    cp_async4(la_s + j, la + (bc * d.Q + j) * d.H + h);
    cp_async4(dt_s + j, dt + (bc * d.Q + j) * d.H + h);
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kThreads, 1)
ssd_intra_kernel(const float* __restrict__ la, const float* __restrict__ dt,
                 const float* __restrict__ x, const float* __restrict__ bm,
                 const float* __restrict__ cm, float* __restrict__ y,
                 float* __restrict__ state, int Q, int H, int P, int N) {
  extern __shared__ __align__(16) float smem[];
  const Dims d = make_dims(Q, H, P, N);
  float* b_s = smem;                              // Qp x ldb: B rows
  float* g_s = b_s + d.Qp * d.ldb;                // Qp x ldg: G = C B^T
  float* c_s = g_s + d.Qp * d.ldg;                // Qp x ldc: C rows ...
  float* x_buf = c_s;                             // ... then xbufs x Qp x ldx
  const size_t c_floats = static_cast<size_t>(d.Qp) * d.ldc;
  const size_t xs = d.xbufs * x_buffer_floats(d);
  float* la_buf = c_s + (c_floats > xs ? c_floats : xs);   // 2 x Qp
  float* dt_buf = la_buf + 2 * d.Qp;                       // 2 x Qp
  float* cum_s = dt_buf + 2 * d.Qp;                        // Qp
  float* w_s = cum_s + d.Qp;                               // Qp

  const int64_t bc = blockIdx.x;                  // b * nc + c
  const int tid = threadIdx.x;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);  // warp-uniform
  const int lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;        // fragment row, column

  // B and C rows of the chunk, zero-padded to (Qp, Np)
  const float* b_g = bm + bc * Q * N;
  const float* c_g = cm + bc * Q * N;
  for (int e = tid; e < d.Qp * d.Np; e += kThreads) {
    const int j = e / d.Np, n = e % d.Np;
    const bool ok = j < Q && n < N;
    b_s[j * d.ldb + n] = ok ? b_g[j * N + n] : 0.f;
    c_s[j * d.ldc + n] = ok ? c_g[j * N + n] : 0.f;
  }
  __syncthreads();

  // G = C B^T over the causal half: (16-row block, 8-column tile) items
  const int n_rb = d.Qp / 16, n_ct = d.Qp / 8;
  for (int item = warp; item < n_rb * n_ct; item += kWarps) {
    const int rb = item / n_ct, ct = item % n_ct;
    const int i0 = 16 * rb, j0 = 8 * ct;
    if (j0 > i0 + 15) continue;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < d.Np; k0 += 8) {
      const float* ca = c_s + (i0 + gq) * d.ldc + k0 + tq;
      const float a[4] = {ca[0], ca[8 * d.ldc], ca[4], ca[8 * d.ldc + 4]};
      const float* bb = b_s + (j0 + gq) * d.ldb + k0 + tq;
      mma_3xtf32(acc, SplitA(a), bb[0], bb[4]);
    }
    float* gr = g_s + (i0 + gq) * d.ldg + j0 + 2 * tq;
    gr[0] = acc[0];
    gr[1] = acc[1];
    gr[8 * d.ldg] = acc[2];
    gr[8 * d.ldg + 1] = acc[3];
  }
  __syncthreads();

  // C's space becomes the x buffers: zero them (the padding stays 0)
  for (size_t e = tid; e < xs; e += kThreads) x_buf[e] = 0.f;
  for (int j = tid; j < 2 * d.Qp; j += kThreads) {
    la_buf[j] = 0.f;
    dt_buf[j] = 0.f;
  }
  __syncthreads();
  prefetch_head(d, bc, 0, la, dt, x, x_buf, la_buf, dt_buf);

  const int64_t row_y = static_cast<int64_t>(H) * P;
  for (int h = 0; h < H; ++h) {
    const int cur = h & 1;
    float* x_s = x_buf + (d.xbufs == 2 ? cur : 0) * x_buffer_floats(d);
    const float* dtv = dt_buf + cur * d.Qp;
    cp_async_wait_all();
    __syncthreads();             // head h landed; head h - 1 is done
    if (d.xbufs == 2 && h + 1 < H) {
      prefetch_head(d, bc, h + 1, la, dt, x,
                    x_buf + (cur ^ 1) * x_buffer_floats(d),
                    la_buf + (cur ^ 1) * d.Qp, dt_buf + (cur ^ 1) * d.Qp);
    }
    // cum = cumsum(la): warp 0, 32 positions at a time, carrying the sum
    if (warp == 0) {
      const float* lav = la_buf + cur * d.Qp;
      float carry = 0.f;
      for (int base = 0; base < d.Qp; base += 32) {
        const int j = base + lane;
        float v = j < Q ? lav[j] : 0.f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, off);
          if (lane >= off) v += u;
        }
        v += carry;
        if (j < d.Qp) cum_s[j] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();
    for (int j = tid; j < d.Qp; j += kThreads) {
      w_s[j] = j < Q ? expf(cum_s[Q - 1] - cum_s[j]) * dtv[j] : 0.f;
    }
    __syncthreads();

    // y = M x. Warp w < n_rb takes row block w with the first half of a
    // chunk's n-tiles and row block n_rb - 1 - w with the second half, so
    // the causal rows' work is even across warps.
    for (int p0 = 0; p0 < d.Pp; p0 += 8 * kChunkTiles) {
      constexpr int half = kChunkTiles / 2;
      if (warp < n_rb) {
#pragma unroll 1
        for (int part = 0; part < 2; ++part) {
          const int rb = part == 0 ? warp : n_rb - 1 - warp;
          const int t0 = part == 0 ? 0 : half;
          const int i0 = 16 * rb;
          float acc[half][4];
#pragma unroll
          for (int t = 0; t < half; ++t) {
            acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
          }
          const int ia = i0 + gq, ib = ia + 8;
          const float cum_a = cum_s[ia], cum_b = cum_s[ib];
          for (int j0 = 0; j0 <= i0 + 8; j0 += 8) {
            // M's A fragment: rows ia, ib; columns j0 + tq, j0 + tq + 4
            float a[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int i = (r & 1) ? ib : ia;
              const int j = j0 + tq + ((r & 2) ? 4 : 0);
              const float ci = (r & 1) ? cum_b : cum_a;
              a[r] = (j <= i && j < Q)
                  ? g_s[i * d.ldg + j] * exp_approx(ci - cum_s[j]) * dtv[j]
                  : 0.f;
            }
            const SplitA m(a);
            const float* xb = x_s + (j0 + tq) * d.ldx + p0 + gq;
#pragma unroll
            for (int t = 0; t < half; ++t) {
              mma_3xtf32(acc[t], m, xb[8 * (t0 + t)],
                         xb[4 * d.ldx + 8 * (t0 + t)]);
            }
          }
          float* y_h = y + static_cast<int64_t>(h) * P;
#pragma unroll
          for (int t = 0; t < half; ++t) {
            const int p = p0 + 8 * (t0 + t) + 2 * tq;
            if (ia < Q) {
              store_pair(y_h + (bc * Q + ia) * row_y, p, P, acc[t][0],
                         acc[t][1]);
            }
            if (ib < Q) {
              store_pair(y_h + (bc * Q + ib) * row_y, p, P, acc[t][2],
                         acc[t][3]);
            }
          }
        }
      }

      // state = B^T (x w): warp w takes 16-row blocks w, w + 8, ... of N
      for (int nb = warp; nb < d.Np / 16; nb += kWarps) {
        const int n0 = 16 * nb;
        float acc[kChunkTiles][4];
#pragma unroll
        for (int t = 0; t < kChunkTiles; ++t) {
          acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
        }
        for (int j0 = 0; j0 < d.Qp; j0 += 8) {
          const float* ba = b_s + (j0 + tq) * d.ldb + n0 + gq;
          const float bta[4] = {ba[0], ba[8], ba[4 * d.ldb],
                                ba[4 * d.ldb + 8]};
          const SplitA bt(bta);
          const float w0 = w_s[j0 + tq], w1 = w_s[j0 + tq + 4];
          const float* xb = x_s + (j0 + tq) * d.ldx + p0 + gq;
#pragma unroll
          for (int t = 0; t < kChunkTiles; ++t) {
            mma_3xtf32(acc[t], bt, xb[8 * t] * w0, xb[4 * d.ldx + 8 * t] * w1);
          }
        }
        float* st = state + ((bc * H + h) * N) * P;
        const int na = n0 + gq, nb8 = na + 8;
#pragma unroll
        for (int t = 0; t < kChunkTiles; ++t) {
          const int p = p0 + 8 * t + 2 * tq;
          if (na < N) store_pair(st + na * P, p, P, acc[t][0], acc[t][1]);
          if (nb8 < N) store_pair(st + nb8 * P, p, P, acc[t][2], acc[t][3]);
        }
      }
    }
    if (d.xbufs == 1 && h + 1 < H) {
      __syncthreads();           // head h is done with the one x buffer
      prefetch_head(d, bc, h + 1, la, dt, x, x_s, la_buf + (cur ^ 1) * d.Qp,
                    dt_buf + (cur ^ 1) * d.Qp);
    }
  }
}

}  // namespace

// la, dt: (B, nc, Q, H); x: (B, nc, Q, H, P); bm, cm: (B, nc, Q, N); f32,
// contiguous, Q <= 128, P <= 128 at Q = N = 128 (the shared memory must
// fit in kSmemLimit). y: (B, nc, Q, H, P); state:
// (B, nc, H, N, P). Returns the CUDA error code of the launch (0 on
// success).
extern "C" int ssd_intra(const float* la, const float* dt, const float* x,
                         const float* bm, const float* cm, float* y,
                         float* state, int64_t B, int64_t nc, int64_t Q,
                         int64_t H, int64_t P, int64_t N, cudaStream_t stream) {
  if (Q < 1 || Q > kMaxQ || N < 1 || P < 1 || H < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float) * smem_floats(make_dims(
      static_cast<int>(Q), static_cast<int>(H), static_cast<int>(P),
      static_cast<int>(N)));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_intra_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t cells = B * nc;
  if (cells == 0) return 0;
  ssd_intra_kernel<<<static_cast<unsigned>(cells), kThreads, smem, stream>>>(
      la, dt, x, bm, cm, y, state, static_cast<int>(Q), static_cast<int>(H),
      static_cast<int>(P), static_cast<int>(N));
  return static_cast<int>(cudaGetLastError());
}
