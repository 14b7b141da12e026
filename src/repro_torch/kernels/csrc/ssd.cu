// Mamba2 SSD within-chunk term for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd.py::_ssd_chunk_kernel
// (reached through ssd_chunk_pallas).  For one (batch, chunk) and one
// block of heads, over the chunk's q positions:
//
//   Y_diag[i,h,p] = sum_{j<=i} S[i,j] * exp(cum[i,h] - cum[j,h]) * dt[j,h] * x[j,h,p]
//   state[h,p,n]  = sum_j exp(cum[q-1,h] - cum[j,h]) * dt[j,h] * x[j,h,p] * B[j,n]
//
// with S = C.B^T and cum the running sum of dA.  Inputs x, B, C in f32 or
// bf16 (upcast at load), dA and dt in f32; all math and both outputs f32.
//
// Design.  One block of 256 threads per (batch*chunk, head block), so S is
// computed once and shared by the block's heads, as on the TPU.  Shared
// memory holds B and C (f32, pitch n + 4: four-float rows that stay
// conflict-free for float4 loads of consecutive rows), S (pitch q + 1), and
// the heads' running sums, dt and state weights.  After S is formed, C's
// space takes one head's x at a time.
//   1. cum: one thread per head sums dA in the reference's rounding: in
//      order within blocks of 16 positions, each block offset by the
//      in-order total of the blocks before (what the reference's
//      jnp.cumsum computes on its CPU backend; exp(cum_i - cum_j) carries
//      any rounding difference straight into the result).
//   2. S: each thread forms 4 x 4 entries, rows and columns strided by
//      q/4 so consecutive threads read consecutive rows of B.
//   3. per head, Y_diag: a thread owns one row i and 16-32 columns p, and
//      walks j = 0..i (the causal mask as a loop bound), weighting S[i,j]
//      by exp(cum_i - cum_j) * dt_j; states: a thread owns 8 p by n/32
//      columns n and walks all j with the weight exp(cum_end - cum_j) * dt_j.
//   Every output element is written by one thread once: no atomics, the
//   same result from run to run.
//
// Bound on this card: operations at the eval shapes (q 128: q^2 n for S,
// q^2/2 p and q p n per head, ~6.5 GFLOP at 8 x 512 tokens of mamba2-1.3b
// on the 67 TFLOP/s fp32 CUDA cores; f32 must hold the reference's 2e-5,
// so no TF32), bytes at serving prefill (q 16), where the f32 states
// (h p n per row) dominate.  This first version stays on the CUDA cores
// with plain shared-memory tiles and one block per SM at q 128 (~205 KB of
// shared memory); bf16 tensor cores and a split of the heads over more
// blocks are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxQ = 128;
constexpr int kCumBlock = 16;
constexpr int kSmemLimit = 232448;  // bytes a block may take on an H100

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__host__ __device__ constexpr int max_i(int a, int b) { return a > b ? a : b; }

// floats of dynamic shared memory (kernels/ssd.py::smem_bytes mirrors it)
__host__ __device__ inline int smem_floats(int q, int p, int n, int hb) {
  const int qp = (q + 3) & ~3;
  return qp * (n + 4) + qp * max_i(n + 4, p) + qp * (qp + 1) + 2 * hb * qp + qp;
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dA,
                     const float* __restrict__ dt, const T* __restrict__ B,
                     const T* __restrict__ C, float* __restrict__ y, float* __restrict__ st,
                     int q, int H, int hb) {
  extern __shared__ __align__(16) float smem[];
  constexpr int NP = N + 4;
  const int bc = blockIdx.x;
  const int h0 = blockIdx.y * hb;
  const int tid = threadIdx.x;
  const int qp = (q + 3) & ~3;
  const int sp = qp + 1;
  float* Bs = smem;                        // [qp][NP]
  float* CX = Bs + qp * NP;                // [qp][NP] C, then [q][P] x of one head
  float* Ss = CX + qp * max_i(NP, P);      // [qp][sp]
  float* cum = Ss + qp * sp;               // [hb][qp]
  float* dts = cum + hb * qp;              // [hb][qp]
  float* wv = dts + hb * qp;               // [qp]

  // ---- load B, C (rows q..qp-1 zero), dA and dt of the block's heads
  const T* Bg = B + (size_t)bc * q * N;
  const T* Cg = C + (size_t)bc * q * N;
  for (int e = tid; e < qp * N; e += kThreads) {
    const int j = e / N, n = e % N;
    const bool in = j < q;
    Bs[j * NP + n] = in ? to_f32(Bg[e]) : 0.f;
    CX[j * NP + n] = in ? to_f32(Cg[e]) : 0.f;
  }
  for (int e = tid; e < q * hb; e += kThreads) {
    const int j = e / hb, hh = e % hb;
    const size_t g = ((size_t)bc * q + j) * H + h0 + hh;
    cum[hh * qp + j] = dA[g];
    dts[hh * qp + j] = dt[g];
  }
  __syncthreads();

  // ---- 1. running sums of dA, one thread per head, in the reference's rounding
  if (tid < hb) {
    float* c = cum + tid * qp;
    float before = 0.f;  // in-order total of the blocks before
    for (int s = 0; s < q; s += kCumBlock) {
      const int e = min(s + kCumBlock, q);
      float run = c[s];
      c[s] = run + before;
      for (int j = s + 1; j < e; ++j) {
        run = run + c[j];
        c[j] = run + before;
      }
      before = before + run;
    }
  }

  // ---- 2. S = C . B^T, 4 x 4 entries per thread, rows/columns strided by qp/4
  {
    const int R = qp / 4;
    for (int t = tid; t < R * R; t += kThreads) {
      const int ti = t / R, tj = t % R;
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
      for (int n = 0; n < N; n += 4) {
        float4 cv[4], bv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
          cv[a] = *reinterpret_cast<const float4*>(CX + (ti + a * R) * NP + n);
#pragma unroll
        for (int b = 0; b < 4; ++b)
          bv[b] = *reinterpret_cast<const float4*>(Bs + (tj + b * R) * NP + n);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            float s = acc[a][b];
            s = fmaf(cv[a].x, bv[b].x, s);
            s = fmaf(cv[a].y, bv[b].y, s);
            s = fmaf(cv[a].z, bv[b].z, s);
            s = fmaf(cv[a].w, bv[b].w, s);
            acc[a][b] = s;
          }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) Ss[(ti + a * R) * sp + tj + b * R] = acc[a][b];
    }
  }
  __syncthreads();

  // ---- 3. per head: Y_diag and the chunk's state
  constexpr int PG = P < 32 ? P : 32;  // Y columns per thread
  constexpr int PP = 8;                 // state rows p per thread
  constexpr int NL = N < 32 ? N : 32;   // threads across n
  constexpr int K = N / NL;             // state columns n per thread
  for (int hh = 0; hh < hb; ++hh) {
    const int h = h0 + hh;
    const float* ch = cum + hh * qp;
    const float* dh = dts + hh * qp;
    const T* xg = x + ((size_t)bc * q * H + h) * P;
    for (int e = tid; e < q * P; e += kThreads) {
      const int j = e / P, p = e % P;
      CX[j * P + p] = to_f32(xg[(size_t)j * H * P + p]);
    }
    if (tid < q) wv[tid] = expf(ch[q - 1] - ch[tid]) * dh[tid];
    __syncthreads();

    for (int item = tid; item < q * (P / PG); item += kThreads) {
      const int i = item % q, pg = item / q;
      float acc[PG];
#pragma unroll
      for (int k = 0; k < PG; ++k) acc[k] = 0.f;
      const float ci = ch[i];
      const float* srow = Ss + i * sp;
      for (int j = 0; j <= i; ++j) {
        const float m = srow[j] * expf(ci - ch[j]) * dh[j];
        const float4* xr = reinterpret_cast<const float4*>(CX + j * P + pg * PG);
#pragma unroll
        for (int k = 0; k < PG / 4; ++k) {
          const float4 v = xr[k];
          acc[4 * k] = fmaf(m, v.x, acc[4 * k]);
          acc[4 * k + 1] = fmaf(m, v.y, acc[4 * k + 1]);
          acc[4 * k + 2] = fmaf(m, v.z, acc[4 * k + 2]);
          acc[4 * k + 3] = fmaf(m, v.w, acc[4 * k + 3]);
        }
      }
      float4* yo = reinterpret_cast<float4*>(y + (((size_t)bc * q + i) * H + h) * P + pg * PG);
#pragma unroll
      for (int k = 0; k < PG / 4; ++k)
        yo[k] = make_float4(acc[4 * k], acc[4 * k + 1], acc[4 * k + 2], acc[4 * k + 3]);
    }

    for (int item = tid; item < (P / PP) * NL; item += kThreads) {
      const int pgrp = item / NL, nl = item % NL;
      float acc[PP][K];
#pragma unroll
      for (int k = 0; k < PP; ++k)
#pragma unroll
        for (int kk = 0; kk < K; ++kk) acc[k][kk] = 0.f;
      for (int j = 0; j < q; ++j) {
        const float w = wv[j];
        const float4 x0 = *reinterpret_cast<const float4*>(CX + j * P + pgrp * PP);
        const float4 x1 = *reinterpret_cast<const float4*>(CX + j * P + pgrp * PP + 4);
        const float xs[PP] = {w * x0.x, w * x0.y, w * x0.z, w * x0.w,
                              w * x1.x, w * x1.y, w * x1.z, w * x1.w};
#pragma unroll
        for (int kk = 0; kk < K; ++kk) {
          const float bv = Bs[j * NP + nl + kk * NL];
#pragma unroll
          for (int k = 0; k < PP; ++k) acc[k][kk] = fmaf(xs[k], bv, acc[k][kk]);
        }
      }
      float* so = st + (((size_t)bc * H + h) * P + pgrp * PP) * N + nl;
#pragma unroll
      for (int k = 0; k < PP; ++k)
#pragma unroll
        for (int kk = 0; kk < K; ++kk) so[(size_t)k * N + kk * NL] = acc[k][kk];
    }
    __syncthreads();  // the next head overwrites x and the state weights
  }
}

template <typename T, int P, int N>
cudaError_t launch(const void* x, const void* dA, const void* dt, const void* B, const void* C,
                   void* y, void* st, int bnc, int q, int H, int hb, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * (size_t)smem_floats(q, P, N, hb);
  auto kern = ssd_chunk_kernel<T, P, N>;
  static bool opted_in = false;  // shared memory above 48 KB, once per instantiation
  if (bytes > 48 * 1024 && !opted_in) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  if (bytes > (size_t)kSmemLimit) return cudaErrorInvalidValue;
  const dim3 grid(bnc, H / hb);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dA), static_cast<const float*>(dt),
      static_cast<const T*>(B), static_cast<const T*>(C), static_cast<float*>(y),
      static_cast<float*>(st), q, H, hb);
  return cudaGetLastError();
}

template <typename T, int P>
cudaError_t launch_n(int N, const void* x, const void* dA, const void* dt, const void* B,
                     const void* C, void* y, void* st, int bnc, int q, int H, int hb,
                     cudaStream_t s) {
  switch (N) {
    case 16: return launch<T, P, 16>(x, dA, dt, B, C, y, st, bnc, q, H, hb, s);
    case 32: return launch<T, P, 32>(x, dA, dt, B, C, y, st, bnc, q, H, hb, s);
    case 64: return launch<T, P, 64>(x, dA, dt, B, C, y, st, bnc, q, H, hb, s);
    case 128: return launch<T, P, 128>(x, dA, dt, B, C, y, st, bnc, q, H, hb, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_pn(int P, int N, const void* x, const void* dA, const void* dt, const void* B,
                      const void* C, void* y, void* st, int bnc, int q, int H, int hb,
                      cudaStream_t s) {
  switch (P) {
    case 16: return launch_n<T, 16>(N, x, dA, dt, B, C, y, st, bnc, q, H, hb, s);
    case 32: return launch_n<T, 32>(N, x, dA, dt, B, C, y, st, bnc, q, H, hb, s);
    case 64: return launch_n<T, 64>(N, x, dA, dt, B, C, y, st, bnc, q, H, hb, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B and C); dA, dt, y and states are
// float32.  x (bnc, q, H, P), dA/dt (bnc, q, H), B/C (bnc, q, N) ->
// y (bnc, q, H, P), states (bnc, H, P, N), all contiguous.  hb heads per
// block must divide H.  Returns cudaGetLastError() after the launch.
extern "C" int ssd_chunk_fwd(int dtype, const void* x, const void* dA, const void* dt,
                             const void* B, const void* C, void* y, void* states, int bnc, int q,
                             int H, int P, int N, int hb, void* stream) {
  if (bnc <= 0 || q <= 0 || q > kMaxQ || H <= 0 || hb <= 0 || H % hb) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_pn<float>(P, N, x, dA, dt, B, C, y, states, bnc, q, H, hb, s);
  if (dtype == 1)
    return launch_pn<__nv_bfloat16>(P, N, x, dA, dt, B, C, y, states, bnc, q, H, hb, s);
  return cudaErrorInvalidValue;
}
