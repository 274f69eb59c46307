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
// call is 1.07 GFLOP over 6.8 MB in bf16 (13.1 MB in fp32). In bf16 the
// tensor cores (989 TFLOP/s) would need 0.001 ms and the bytes 0.002 ms, so
// it is bound by bytes; in fp32, held to fp32 accuracy, the yardstick is
// the CUDA cores' 67 TFLOP/s (0.016 ms), so it is bound by operations.
//
// Two kernels:
//   * fused_dense_mma_kernel, the fast path, for rows that are 16-byte
//     aligned (K and N multiples of 8 in bf16, of 4 in fp32). A block of 256
//     threads owns a 128 x 64 output tile (4096 x 256 gives 128 blocks for
//     132 SMs); x and w panels of 64 k (bf16) or 32 k (fp32) go to padded
//     shared memory through a cp.async ring of 4 (bf16) or 5 (fp32) slots,
//     zero-filled past M, K and N; each warp owns 32 x 32 outputs as 2 x 4 mma.sync.m16n8k16 tiles.
//       bf16: ldmatrix (x) and ldmatrix.trans (w, stored k x n) feed one bf16
//         MMA per tile; x and w are exact bf16, so only the order of the
//         fp32 sum differs from the plain version.
//       fp32: a split-precision product on the same bf16 MMA (bf16 triples;
//         picked over 3xTF32, whose two 11-bit pieces leave 2^-22 per
//         product, and over a larger CUDA-core tile, which can at best match
//         the library). Each fp32 value is cut in registers into three bf16
//         pieces h + m + l that hold its 24 bits exactly; the six products
//         down to 2^-14 (hh, hm, mh, mm, hl, lh) each become an MMA. The tensor
//         core truncates when it adds to its accumulator, so the large term
//         hh is multiplied with a zero accumulator and added outside with
//         rounded fp32 adds, in windows of 8 ring steps so that no chain of
//         adds grows with K, and only the five small terms (2^-7 of the
//         result and below) chain inside the tensor core. The error against
//         a float64 product is printed beside the library's by chip_smoke.py.
//     Bias and activation run on the fp32 accumulators; the tile goes through
//     shared memory so that every store is 16 bytes.
//   * fused_dense_simt_kernel, the general path, for every other shape: a
//     shared-memory tiled SIMT GEMM. A block of 256 threads owns a 64 x 64
//     tile and walks K in steps of 16, zero-filled past the edges; each
//     thread keeps a 4 x 4 tile of fp32 sums.

#include "common.cuh"
#include "mma.cuh"

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
fused_dense_simt_kernel(const T* __restrict__ x, const T* __restrict__ w,
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

// ---------------------------------------------------------------------------
// The fast path: tensor cores
// ---------------------------------------------------------------------------

constexpr int MBM = 128, MBN = 64;  // block tile
constexpr int WARPS_M = 4;          // 4 x 2 warps of 32 x 32 outputs
constexpr int FOLD = 8;             // fp32: ring steps between folds of the large term

template <typename T>
struct Fast {
  static constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
  // k per ring step and ring depth: at K = 512 three quarters (bf16) or half
  // (fp32) of a block's operands are in flight before the first MMA, which
  // is what hides the latency of device memory with one block on an SM.
  static constexpr int BK = sizeof(T) == 2 ? 64 : 32;
  static constexpr int STAGES = sizeof(T) == 2 ? 4 : 5;
  // Row pitches in elements. bf16: 144 bytes, an odd multiple of 16, so the
  // eight rows of an ldmatrix tile fall in eight different bank groups.
  // fp32: 40 words (= 8 mod 32) makes the 8-byte reads of x conflict-free,
  // 68 words (2 * 68 = 8 mod 32) the 4-byte reads of w.
  static constexpr int XP = BK + 8;
  static constexpr int WP = sizeof(T) == 2 ? MBN + 8 : MBN + 4;
  static constexpr int OP = WP;  // output tile staged for 16-byte stores
  static constexpr int X_ELEMS = MBM * XP, W_ELEMS = BK * WP;
  static constexpr int STAGE_ELEMS = X_ELEMS + W_ELEMS;
  static constexpr size_t SMEM = sizeof(T) * size_t(STAGES) * STAGE_ELEMS;
  static_assert(sizeof(T) * MBM * OP <= SMEM, "the output tile reuses the ring");
};

// One BK-wide panel of x (128 rows) and w (64 columns) into a ring slot.
template <typename T>
__device__ __forceinline__ void load_stage(T* slot, const T* __restrict__ x,
                                           const T* __restrict__ w, int64_t m0, int n0, int k0,
                                           int M, int K, int N) {
  using F = Fast<T>;
  constexpr int XC = F::BK / F::EPC, WC = MBN / F::EPC;  // chunks per row
  for (int c = threadIdx.x; c < MBM * XC; c += THREADS) {
    const int row = c / XC, kc = (c % XC) * F::EPC;
    const bool ok = m0 + row < M && k0 + kc < K;
    av1::cp_async16(av1::smem_addr(slot + row * F::XP + kc),
                    ok ? x + (m0 + row) * K + k0 + kc : x, ok ? 16 : 0);
  }
  T* ws = slot + F::X_ELEMS;
  for (int c = threadIdx.x; c < F::BK * WC; c += THREADS) {
    const int row = c / WC, nc = (c % WC) * F::EPC;
    const bool ok = k0 + row < K && n0 + nc < N;
    av1::cp_async16(av1::smem_addr(ws + row * F::WP + nc),
                    ok ? w + int64_t(k0 + row) * N + n0 + nc : w, ok ? 16 : 0);
  }
}

// The accumulators of a warp's 32 x 32 outputs. bf16 needs `sum` alone. fp32
// keeps the large term hh in `window` (rounded fp32 adds), folded into `sum`
// every FOLD ring steps so that no chain of adds grows long, and the five
// small terms in `small` (chained inside the tensor core).
struct Acc {
  float sum[2][4][4], window[2][4][4], small[2][4][4];
};

// acc += the slot's 128 x BK by BK x 64 product, this warp's 32 x 32 part.
__device__ __forceinline__ void mma_stage(const __nv_bfloat16* slot, int wm, int wn, int lane,
                                          Acc& acc) {
  using F = Fast<__nv_bfloat16>;
  const __nv_bfloat16* ws = slot + F::X_ELEMS;
  const int r16 = lane % 16, c8 = 8 * (lane / 16);
#pragma unroll
  for (int kk = 0; kk < F::BK; kk += 16) {
    uint32_t a[2][4], b[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      av1::ldmatrix_x4(a[mi], av1::smem_addr(slot + (wm * 32 + mi * 16 + r16) * F::XP + kk + c8));
#pragma unroll
    for (int nj = 0; nj < 2; ++nj)
      av1::ldmatrix_x4_trans(
          b[nj], av1::smem_addr(ws + (kk + r16) * F::WP + wn * 32 + nj * 16 + c8));
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        av1::mma_bf16(acc.sum[mi][ni], a[mi], b[ni / 2][2 * (ni % 2)],
                      b[ni / 2][2 * (ni % 2) + 1]);
  }
}

// The fp32 flavour: bf16 triples, split in registers.
__device__ __forceinline__ void mma_stage(const float* slot, int wm, int wn, int lane,
                                          Acc& acc) {
  using F = Fast<float>;
  const float* ws = slot + F::X_ELEMS;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int kk = 0; kk < F::BK; kk += 16) {
    uint32_t ah[2][4], am[2][4], al[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // a0..a3: rows g, g+8; columns 2t, 2t+8
        const float2 v = *reinterpret_cast<const float2*>(
            slot + (wm * 32 + mi * 16 + g + 8 * (q % 2)) * F::XP + kk + 2 * t + 8 * (q / 2));
        av1::split3_pack(v.x, v.y, ah[mi][q], am[mi][q], al[mi][q]);
      }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      uint32_t bh[2], bm[2], bl[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {  // b0, b1: k 2t, 2t+8; column g
        const float* p = ws + (kk + 2 * t + 8 * q) * F::WP + wn * 32 + ni * 8 + g;
        av1::split3_pack(p[0], p[F::WP], bh[q], bm[q], bl[q]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        float (&s)[4] = acc.small[mi][ni];
        av1::mma_bf16(s, al[mi], bh[0], bh[1]);
        av1::mma_bf16(s, ah[mi], bl[0], bl[1]);
        av1::mma_bf16(s, am[mi], bm[0], bm[1]);
        av1::mma_bf16(s, am[mi], bh[0], bh[1]);
        av1::mma_bf16(s, ah[mi], bm[0], bm[1]);
        float big[4] = {0.f, 0.f, 0.f, 0.f};
        av1::mma_bf16(big, ah[mi], bh[0], bh[1]);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc.window[mi][ni][q] += big[q];
      }
    }
  }
}

template <typename T, int ACT>
__global__ void __launch_bounds__(THREADS)
fused_dense_mma_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const float* __restrict__ b, T* __restrict__ out, int M, int K, int N) {
  using F = Fast<T>;
  extern __shared__ uint4 dense_smem[];
  T* ring = reinterpret_cast<T*>(dense_smem);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int64_t m0 = int64_t(blockIdx.x) * MBM;
  const int n0 = blockIdx.y * MBN;
  const int steps = (K + F::BK - 1) / F::BK;
  Acc acc = {};

  for (int s = 0; s < F::STAGES - 1; ++s) {
    if (s < steps) load_stage(ring + s * F::STAGE_ELEMS, x, w, m0, n0, s * F::BK, M, K, N);
    av1::cp_async_commit();
  }
#pragma unroll 1
  for (int kt = 0; kt < steps; ++kt) {
    av1::cp_async_wait<F::STAGES - 2>();  // panel kt has landed
    __syncthreads();                      // ... for every thread; panel kt-1 is consumed
    const int next = kt + F::STAGES - 1;
    if (next < steps)
      load_stage(ring + (next % F::STAGES) * F::STAGE_ELEMS, x, w, m0, n0, next * F::BK, M, K,
                 N);
    av1::cp_async_commit();
    mma_stage(ring + (kt % F::STAGES) * F::STAGE_ELEMS, wm, wn, lane, acc);
    if (sizeof(T) == 4 && kt % FOLD == FOLD - 1) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        (&acc.sum[0][0][0])[i] += (&acc.window[0][0][0])[i];
        (&acc.window[0][0][0])[i] = 0.f;
      }
    }
  }
  av1::cp_async_wait<0>();
  __syncthreads();  // the ring is free: it becomes the output tile

  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = wn * 32 + ni * 8 + 2 * t;
    const float b0 = n0 + col < N ? b[n0 + col] : 0.f;
    const float b1 = n0 + col + 1 < N ? b[n0 + col + 1] : 0.f;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm * 32 + mi * 16 + g + 8 * h, q = 2 * h;
        const float z0 = acc.sum[mi][ni][q] + acc.window[mi][ni][q] + acc.small[mi][ni][q];
        const float z1 =
            acc.sum[mi][ni][q + 1] + acc.window[mi][ni][q + 1] + acc.small[mi][ni][q + 1];
        T* o = ring + row * F::OP + col;
        o[0] = from_f<T>(activate<ACT>(z0 + b0));
        o[1] = from_f<T>(activate<ACT>(z1 + b1));
      }
  }
  __syncthreads();
  constexpr int OC = MBN / F::EPC;
  for (int c = threadIdx.x; c < MBM * OC; c += THREADS) {
    const int row = c / OC, nc = (c % OC) * F::EPC;
    if (m0 + row < M && n0 + nc < N)
      *reinterpret_cast<uint4*>(out + (m0 + row) * N + n0 + nc) =
          *reinterpret_cast<const uint4*>(ring + row * F::OP + nc);
  }
}

template <typename T, int ACT>
int launch_mma(const T* x, const T* w, const float* b, T* out, int m, int k, int n,
               cudaStream_t st) {
  static const cudaError_t attr =  // once per kernel, not per launch
      cudaFuncSetAttribute(fused_dense_mma_kernel<T, ACT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, int(Fast<T>::SMEM));
  if (attr != cudaSuccess) return int(attr);
  const dim3 grid((m + MBM - 1) / MBM, (n + MBN - 1) / MBN);
  fused_dense_mma_kernel<T, ACT><<<grid, THREADS, Fast<T>::SMEM, st>>>(x, w, b, out, m, k, n);
  return int(cudaGetLastError());
}

template <typename T, int ACT>
int launch_act(bool fast, const T* x, const T* w, const float* b, T* out, int m, int k, int n,
               cudaStream_t st) {
  if (fast) return launch_mma<T, ACT>(x, w, b, out, m, k, n, st);
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  fused_dense_simt_kernel<T, ACT><<<grid, THREADS, 0, st>>>(x, w, b, out, m, k, n);
  return int(cudaGetLastError());
}

template <typename T>
int launch_dense(bool fast, const void* x, const void* w, const void* b, void* out, int m,
                 int k, int n, int act, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const float* bp = static_cast<const float*>(b);
  T* op = static_cast<T*>(out);
  switch (act) {
    case LINEAR: return launch_act<T, LINEAR>(fast, xp, wp, bp, op, m, k, n, st);
    case RELU: return launch_act<T, RELU>(fast, xp, wp, bp, op, m, k, n, st);
    case SILU: return launch_act<T, SILU>(fast, xp, wp, bp, op, m, k, n, st);
    case SIGMOID: return launch_act<T, SIGMOID>(fast, xp, wp, bp, op, m, k, n, st);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launches K4 on `stream` and returns cudaGetLastError() (0 on success); it
// neither allocates nor synchronises. `act`: 0 linear, 1 relu, 2 silu,
// 3 sigmoid. `bf16` selects the dtype of x, w and out (0: fp32); b is fp32.
// `fast` (0 or 1) asks for the tensor-core kernel, which needs x, w and out
// 16-byte aligned and K and N multiples of 16 / sizeof(dtype); anything else
// takes the general kernel.
int av1_fused_dense(const void* x, const void* w, const void* b, void* out, int m, int k,
                    int n, int act, int bf16, int fast, void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || (n + BN - 1) / BN > 65535)
    return int(cudaErrorInvalidValue);
  if (fast) {
    const int epc = bf16 ? 8 : 4;
    const uintptr_t bits = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                           reinterpret_cast<uintptr_t>(out);
    if (k % epc || n % epc || bits % 16) return int(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_dense<__nv_bfloat16>(fast, x, w, b, out, m, k, n, act, st)
              : launch_dense<float>(fast, x, w, b, out, m, k, n, act, st);
}

}  // extern "C"
