// Fused dense layer for Hopper (sm_90a): out = act(x @ w + b).
//
// K4  av1_fused_dense replaces the forward of av1tpu/kernels/fused_dense.py
//     fused_dense (_dense_kernel through _matmul_tiled): x (M, K) and w (K, N)
//     in fp32 or bf16, b (N,) in fp32; products summed in fp32, the bias and
//     the activation (linear, relu, silu, sigmoid) applied in fp32 in the
//     epilogue, the output in x's dtype. The backward stays in PyTorch, as the
//     JAX package computes it outside Pallas.
//
// What bounds it: at a v6 head's first layer (M = 4096, K = 512, N = 256) a
// call is 1.07 GFLOP over 6.3 MB in bf16, ~170 FLOP per byte: compute-bound
// on the fp32 CUDA cores this simple kernel uses (67 TFLOP/s), below the
// ridge of the bf16 tensor cores (~295 FLOP/B) that a later version should
// use.
//
// The simple design: a shared-memory tiled GEMM. A block of 256 threads owns
// a 64 x 64 output tile and walks K in steps of 16; each step stages a
// 64 x 16 slice of x (transposed) and a 16 x 64 slice of w in shared memory
// as fp32, zero-filled past the edges, so any M, K and N work. Each thread
// keeps a 4 x 4 tile of fp32 sums in registers, fed by float4 reads of both
// slices, and applies bias and activation there before the store.

#include "common.cuh"

namespace {

using av1::from_f;
using av1::to_f;

constexpr int THREADS = 256;
constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int XS_PITCH = BM + 4;  // pads the transposed x slice off one bank
enum { LINEAR = 0, RELU = 1, SILU = 2, SIGMOID = 3 };

template <int ACT>
__device__ __forceinline__ float activate(float z) {
  if (ACT == RELU) return fmaxf(z, 0.f);
  if (ACT == SILU) return z / (1.f + expf(-z));
  if (ACT == SIGMOID) return 1.f / (1.f + expf(-z));
  return z;
}

template <typename T, int ACT>
__global__ void __launch_bounds__(THREADS)
fused_dense_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const float* __restrict__ b, T* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(16) float xs[BK][XS_PITCH];  // xs[k][m]
  __shared__ __align__(16) float ws[BK][BN];        // ws[k][n]
  const int tn = threadIdx.x % (BN / TN), tm = threadIdx.x / (BN / TN);
  const int64_t m0 = int64_t(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  float acc[TM][TN] = {};
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = threadIdx.x; i < BM * BK; i += THREADS) {
      const int m = i / BK, k = i % BK, gk = k0 + k;
      const int64_t gm = m0 + m;
      xs[k][m] = (gm < M && gk < K) ? to_f<T>(x[gm * K + gk]) : 0.f;
    }
    for (int i = threadIdx.x; i < BK * BN; i += THREADS) {
      const int k = i / BN, n = i % BN, gk = k0 + k, gn = n0 + n;
      ws[k][n] = (gk < K && gn < N) ? to_f<T>(w[int64_t(gk) * N + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[k][tm * TM]);
      const float4 c = *reinterpret_cast<const float4*>(&ws[k][tn * TN]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float cv[TN] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], cv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t gm = m0 + tm * TM + i;
    if (gm >= M) break;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tn * TN + j;
      if (gn < N) out[gm * N + gn] = from_f<T>(activate<ACT>(acc[i][j] + b[gn]));
    }
  }
}

template <typename T>
int launch_dense(const void* x, const void* w, const void* b, void* out, int m, int k,
                 int n, int act, cudaStream_t st) {
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const float* bp = static_cast<const float*>(b);
  T* op = static_cast<T*>(out);
  switch (act) {
    case LINEAR:
      fused_dense_kernel<T, LINEAR><<<grid, THREADS, 0, st>>>(xp, wp, bp, op, m, k, n);
      break;
    case RELU:
      fused_dense_kernel<T, RELU><<<grid, THREADS, 0, st>>>(xp, wp, bp, op, m, k, n);
      break;
    case SILU:
      fused_dense_kernel<T, SILU><<<grid, THREADS, 0, st>>>(xp, wp, bp, op, m, k, n);
      break;
    case SIGMOID:
      fused_dense_kernel<T, SIGMOID><<<grid, THREADS, 0, st>>>(xp, wp, bp, op, m, k, n);
      break;
    default:
      return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches K4 on `stream` and returns cudaGetLastError() (0 on success); it
// neither allocates nor synchronises. `act`: 0 linear, 1 relu, 2 silu,
// 3 sigmoid. `bf16` selects the dtype of x, w and out (0: fp32); b is fp32.
int av1_fused_dense(const void* x, const void* w, const void* b, void* out, int m, int k,
                    int n, int act, int bf16, void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || (n + BN - 1) / BN > 65535)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_dense<__nv_bfloat16>(x, w, b, out, m, k, n, act, st)
              : launch_dense<float>(x, w, b, out, m, k, n, act, st);
}

}  // extern "C"
