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
// call is 1.07 GFLOP over 6.6 MB in bf16 (13.1 MB in fp32). The tensor cores
// (989 TFLOP/s) would need 0.0011 ms and the bytes 0.0020 ms (fp32: 0.0039
// ms) at 3.35 TB/s, so it is bound by bytes in both dtypes. (fp32 held to
// fp32 accuracy runs six bf16 products, which caps it at 0.0065 ms of tensor
// time, 60% of the bytes bound; the CUDA cores' 67 TFLOP/s would need 0.016.)

// Two kernels:
//   * fused_dense_wgmma_kernel, the fast path, for rows that are 16-byte
//     aligned (K and N multiples of 8 in bf16, of 4 in fp32). A block owns a
//     128 x 64 output tile (4096 x 256 gives 128 blocks for 132 SMs): one
//     producer warp keeps a ring of 4 stages full by TMA (x as 128 rows of
//     128 bytes of k in the 128-byte swizzle, w as 128-byte rows of n; each
//     stage with a full and an empty mbarrier), and two consumer warpgroups
//     each multiply 64 rows by the 64 columns with wgmma.m64n64k16
//     (hopper.cuh). Out-of-range rows, k and columns arrive as zeros.
//       bf16: both operands from shared memory, one product per k16 step;
//         x and w are exact bf16, so only the order of the fp32 sum differs
//         from the plain version.
//       fp32: a split-precision product on the bf16 tensor cores (bf16
//         triples; picked over 3xTF32, whose two 11-bit pieces leave 2^-22
//         per product, and over a CUDA-core tile, which can at best match the
//         library). Each fp32 value is cut into three bf16 pieces h + m + l
//         that hold its 24 bits exactly; the six products down to 2^-14
//         (hh, hm, mh, mm, hl, lh) are each a wgmma. x's pieces are cut in
//         registers and fed as A (register operand); the consumers write w's
//         three pieces from the fp32 stage into shared memory in the wgmma
//         layout (double-buffered), and the fp32 stage goes back to the
//         producer at once. The tensor core truncates when it adds to its
//         accumulator, so the large term hh is multiplied with a zeroed
//         accumulator (scale-d = 0) and added outside with rounded fp32 adds,
//         in windows of 8 ring steps so that no chain of adds grows with K;
//         only the five small terms (2^-7 of the result and below) chain
//         inside the tensor core. The error against a float64 product is
//         printed beside the library's by chip_smoke.py.
//     Bias and activation run on the fp32 accumulators; the tile goes through
//     shared memory so that every store is 16 bytes. The tensor maps of x
//     and w are encoded on the host at each call (x and w move between
//     calls; the encoding is a few hundred nanoseconds of host time).
//   * fused_dense_simt_kernel, the general path, for every other shape: a
//     shared-memory tiled SIMT GEMM. A block of 256 threads owns a 64 x 64
//     tile and walks K in steps of 16, zero-filled past the edges; each
//     thread keeps a 4 x 4 tile of fp32 sums.

#include "common.cuh"
#include "hopper.cuh"
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
// The fast path: wgmma on a TMA-fed ring
// ---------------------------------------------------------------------------

namespace sm90 = av1::sm90;

constexpr int MBM = 128, MBN = 64;          // block tile: two warpgroups of 64 x 64
constexpr int CONSUMERS = 256;              // the two warpgroups
constexpr int WG_THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int STAGES = 4;                   // ring depth
constexpr int FOLD = 8;                     // fp32: ring steps between folds of the large term
constexpr int CONSUMER_BARRIER = 1;         // named barrier of the two warpgroups

template <typename T>
struct Ring {
  static constexpr int EPC = 16 / sizeof(T);             // elements per 16-byte chunk
  static constexpr int BK = 128 / sizeof(T);             // k per step: one 128-byte row
  static constexpr int X_BYTES = MBM * BK * sizeof(T);   // 16 KB
  static constexpr int W_BYTES = BK * MBN * sizeof(T);   // 8 KB
  static constexpr int STAGE_BYTES = X_BYTES + W_BYTES;
  // fp32: one bf16 piece of a w step (BK x 64, 128-byte rows), three pieces a
  // step, two steps' worth
  static constexpr int PIECE_BYTES = sizeof(T) == 4 ? BK * MBN * 2 : 0;
  static constexpr int PIECES_BYTES = 2 * 3 * PIECE_BYTES;
  // the output tile staged for 16-byte stores, its rows padded off one bank
  static constexpr int OP = MBN + (sizeof(T) == 2 ? 8 : 4);
  static constexpr size_t SMEM = 1024 + STAGES * STAGE_BYTES + PIECES_BYTES + 2 * STAGES * 8;
  static_assert(MBM * OP * sizeof(T) <= STAGES * STAGE_BYTES, "the output tile reuses the ring");
};

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024 - (sm90::smem_u32(p) & 1023)) & 1023);
}

// bf16: acc += the stage's 64 rows of this warpgroup x the stage's w, both
// from shared memory, four k16 steps.
__device__ __forceinline__ void consume_stage(const uint8_t* stage, int wg, float (&acc)[32]) {
  using R = Ring<__nv_bfloat16>;
  const uint32_t xs = sm90::smem_u32(stage) + wg * 64 * 128;
  const uint32_t ws = sm90::smem_u32(stage + R::X_BYTES);
#pragma unroll
  for (int kk = 0; kk < R::BK / 16; ++kk)
    sm90::wgmma_m64n64k16_ss(acc, sm90::desc_sw128(xs + kk * 32, 16, 1024),
                             sm90::desc_sw128(ws + kk * 2048, 8192, 1024), 1);
}

// fp32: this warp's A fragments of a step (rows `row`, row + 8; two k16
// steps), cut into three bf16 pieces. The x stage is 128 rows of 32 fp32
// in the 128-byte swizzle.
__device__ __forceinline__ void load_x_pieces(const uint8_t* xs, int row, int t,
                                              uint32_t (&ah)[2][4], uint32_t (&am)[2][4],
                                              uint32_t (&al)[2][4]) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // a0..a3: rows g, g+8; columns 2t, 2t+8
      const int r = row + 8 * (q % 2), k = 16 * kk + 2 * t + 8 * (q / 2);
      const float2 v = *reinterpret_cast<const float2*>(
          xs + r * 128 + (((k / 4) ^ (r % 8)) * 16) + (k % 4) * 4);
      av1::split3_pack(v.x, v.y, ah[kk][q], am[kk][q], al[kk][q]);
    }
}

// fp32: the w stage (32 k-rows of 64 fp32) as three bf16 pieces in the
// MN-major 128-byte swizzle, 8 values a consumer thread.
__device__ __forceinline__ void write_w_pieces(const uint8_t* ws, uint8_t* pieces) {
  using R = Ring<float>;
  const int k = threadIdx.x / 8, c = threadIdx.x % 8;
  const float4 v0 = *reinterpret_cast<const float4*>(ws + k * 256 + c * 32);
  const float4 v1 = *reinterpret_cast<const float4*>(ws + k * 256 + c * 32 + 16);
  uint32_t h[4], m[4], l[4];
  av1::split3_pack(v0.x, v0.y, h[0], m[0], l[0]);
  av1::split3_pack(v0.z, v0.w, h[1], m[1], l[1]);
  av1::split3_pack(v1.x, v1.y, h[2], m[2], l[2]);
  av1::split3_pack(v1.z, v1.w, h[3], m[3], l[3]);
  const int dst = k * 128 + ((c ^ (k % 8)) * 16);
  *reinterpret_cast<uint4*>(pieces + dst) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(pieces + R::PIECE_BYTES + dst) = make_uint4(m[0], m[1], m[2], m[3]);
  *reinterpret_cast<uint4*>(pieces + 2 * R::PIECE_BYTES + dst) =
      make_uint4(l[0], l[1], l[2], l[3]);
}

template <typename T, int ACT>
__global__ void __launch_bounds__(WG_THREADS, 1)
fused_dense_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                         const __grid_constant__ CUtensorMap w_map,
                         const float* __restrict__ b, T* __restrict__ out, int M, int K, int N) {
  using R = Ring<T>;
  extern __shared__ uint8_t dense_smem_raw[];
  uint8_t* ring = align_1024(dense_smem_raw);
  uint8_t* pieces = ring + STAGES * R::STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(pieces + R::PIECES_BYTES);
  uint64_t* empty = full + STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * MBM, n0 = blockIdx.y * MBN;
  const int steps = (K + R::BK - 1) / R::BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], CONSUMERS / 32);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {  // the producer: one lane keeps the ring full
    if (lane == 0) {
      sm90::tma_prefetch_map(&x_map);
      sm90::tma_prefetch_map(&w_map);
      for (int kt = 0; kt < steps; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) sm90::mbar_wait(&empty[s], (kt / STAGES - 1) & 1);
        uint8_t* stage = ring + s * R::STAGE_BYTES;
        sm90::mbar_expect_tx(&full[s], R::STAGE_BYTES);
        sm90::tma_load_2d(stage, &x_map, &full[s], kt * R::BK, m0);
        sm90::tma_load_2d(stage + R::X_BYTES, &w_map, &full[s], n0, kt * R::BK);
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the tile
  const int wg = warp / 4, g = lane / 4, t = lane % 4;
  const int row = wg * 64 + (warp % 4) * 16 + g;  // this thread's rows: row, row + 8
  float acc[32], window[32], small[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = window[i] = small[i] = 0.f;
  if constexpr (sizeof(T) == 2) {
#pragma unroll 1
    for (int kt = 0; kt < steps; ++kt) {
      const int s = kt % STAGES;
      sm90::mbar_wait(&full[s], (kt / STAGES) & 1);
      sm90::wgmma_fence();
      consume_stage(ring + s * R::STAGE_BYTES, wg, acc);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // step kt - 1 is done with its stage
      if (kt > 0 && lane == 0) sm90::mbar_arrive(&empty[(kt - 1) % STAGES]);
    }
    sm90::wgmma_wait<0>();
    sm90::reg_fence(acc);
  } else {
    // fp32: `acc` sums the large term hh, `window` takes it step by step
    // with rounded fp32 adds and is folded into `acc` every FOLD steps;
    // the five small terms chain inside the tensor core in `small`.
    float big[2][32];
#pragma unroll
    for (int i = 0; i < 32; ++i) big[0][i] = big[1][i] = 0.f;
#pragma unroll 1
    for (int kt = 0; kt < steps; ++kt) {
      const int s = kt % STAGES;
      const uint8_t* stage = ring + s * R::STAGE_BYTES;
      uint8_t* piece = pieces + (kt % 2) * 3 * R::PIECE_BYTES;
      sm90::mbar_wait(&full[s], (kt / STAGES) & 1);
      uint32_t ah[2][4], am[2][4], al[2][4];
      load_x_pieces(stage, row, t, ah, am, al);
      write_w_pieces(stage + R::X_BYTES, piece);
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&empty[s]);  // the fp32 stage is read
      sm90::fence_proxy_async();
      sm90::named_barrier(CONSUMER_BARRIER, CONSUMERS);  // every piece is written
      const uint32_t pb = sm90::smem_u32(piece);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint64_t bh = sm90::desc_sw128(pb + kk * 2048, 8192, 1024);
        const uint64_t bm = sm90::desc_sw128(pb + R::PIECE_BYTES + kk * 2048, 8192, 1024);
        const uint64_t bl = sm90::desc_sw128(pb + 2 * R::PIECE_BYTES + kk * 2048, 8192, 1024);
        sm90::wgmma_m64n64k16_rs(small, al[kk], bh, 1);
        sm90::wgmma_m64n64k16_rs(small, ah[kk], bl, 1);
        sm90::wgmma_m64n64k16_rs(small, am[kk], bm, 1);
        sm90::wgmma_m64n64k16_rs(small, am[kk], bh, 1);
        sm90::wgmma_m64n64k16_rs(small, ah[kk], bm, 1);
        sm90::wgmma_m64n64k16_rs(big[kk], ah[kk], bh, 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::reg_fence(big[0]);
      sm90::reg_fence(big[1]);
#pragma unroll
      for (int i = 0; i < 32; ++i) window[i] = (window[i] + big[0][i]) + big[1][i];
      if (kt % FOLD == FOLD - 1) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          acc[i] += window[i];
          window[i] = 0.f;
        }
      }
    }
    sm90::reg_fence(small);
  }

  // epilogue: bias and activation in fp32, the tile through shared memory
  sm90::named_barrier(CONSUMER_BARRIER, CONSUMERS);  // no warpgroup reads the ring now
  T* tile = reinterpret_cast<T*>(ring);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * t;
    const float b0 = n0 + col < N ? b[n0 + col] : 0.f;
    const float b1 = n0 + col + 1 < N ? b[n0 + col + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = 4 * j + 2 * h;
      T* o = tile + (row + 8 * h) * R::OP + col;
      o[0] = from_f<T>(activate<ACT>(acc[q] + window[q] + small[q] + b0));
      o[1] = from_f<T>(activate<ACT>(acc[q + 1] + window[q + 1] + small[q + 1] + b1));
    }
  }
  sm90::named_barrier(CONSUMER_BARRIER, CONSUMERS);
  constexpr int OC = MBN / R::EPC;
  for (int c = threadIdx.x; c < MBM * OC; c += CONSUMERS) {
    const int r = c / OC, nc = (c % OC) * R::EPC;
    if (m0 + r < M && n0 + nc < N)
      *reinterpret_cast<uint4*>(out + int64_t(m0 + r) * N + n0 + nc) =
          *reinterpret_cast<const uint4*>(tile + r * R::OP + nc);
  }
}

template <typename T, int ACT>
int launch_wgmma(const T* x, const T* w, const float* b, T* out, int m, int k, int n,
                 cudaStream_t st) {
  using R = Ring<T>;
  static const cudaError_t attr =  // once per kernel, not per launch
      cudaFuncSetAttribute(fused_dense_wgmma_kernel<T, ACT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, int(R::SMEM));
  if (attr != cudaSuccess) return int(attr);
  constexpr CUtensorMapDataType dtype =
      sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap x_map, w_map;  // encoded on the host per call: x and w move between calls
  int err = sm90::encode_map_2d(&x_map, dtype, x, m, k, uint64_t(k) * sizeof(T), MBM, R::BK,
                                CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0)
    err = sm90::encode_map_2d(
        &w_map, dtype, w, k, n, uint64_t(n) * sizeof(T), R::BK, MBN,
        sizeof(T) == 2 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != 0) return err;
  const dim3 grid((m + MBM - 1) / MBM, (n + MBN - 1) / MBN);
  fused_dense_wgmma_kernel<T, ACT><<<grid, WG_THREADS, R::SMEM, st>>>(x_map, w_map, b, out, m,
                                                                      k, n);
  return int(cudaGetLastError());
}

template <typename T, int ACT>
int launch_act(bool fast, const T* x, const T* w, const float* b, T* out, int m, int k, int n,
               cudaStream_t st) {
  if (fast) return launch_wgmma<T, ACT>(x, w, b, out, m, k, n, st);
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
