// Fused backbone front of the v6 stage models, for Hopper (sm_90a).
//
// K1  av1_fused_front    replaces av1tpu/kernels/fused_front.py make_fused_front:
//     7x7/2 stem conv (pad 3) on the BN-folded stem kernel + fp32 bias + relu,
//     then 3x3/2 max-pool (pad 1).  (B, hw, hw, 1) -> (B, hw/4, hw/4, 64), NHWC.
// K2  av1_fused_front_g1 replaces av1tpu/kernels/fused_front.py make_fused_front_g1:
//     K1, then layer1_0 and layer1_1 (3x3/1 SAME convs on folded weights,
//     relu, identity residual), then SE1 (spatial mean -> d0 -> relu -> d1 ->
//     sigmoid -> channel scale).  Same output shape.
//
// Both take fp32 or bf16 activations and weights (the serving dtype) and give
// the same dtype out; every sum is accumulated in fp32 and every bias added in
// fp32. K2 keeps fp32 between its stages and rounds each conv input to the
// weight dtype, as the TPU kernel does.
//
// What bounds them on an H100. At 16 px in bf16, K1 reads 512 B of input per
// sample, does 8x8 conv outputs x 64 channels x 49 taps = 200 k MACs and writes
// 2 KB: about 160 FLOP per byte. That is below the bf16 tensor cores' ridge
// (~295 FLOP/B), but this kernel runs on the fp32 CUDA cores (67 TFLOP/s
// against 3.35 TB/s, a ridge near 20 FLOP/B), so it is compute-bound. K2 adds
// four 64x64x3x3 convs at 4x4: 2.56 M MACs per sample for the same 2.5 KB of
// traffic, ~2000 FLOP/B, compute-bound by far.
//
// The simple design does only one thing about that: it keeps every
// intermediate on chip, so device memory sees the input and the output and
// nothing else. The TPU kernel's dense candidate matrix (3 MB at 16 px) and
// its n1 x n1 spatial-matmul convs (16/9 of the FLOPs) were shapes for the
// MXU and VMEM; here both become direct convolutions on the CUDA cores:
//   * 256 threads per block = 64 channels x 4 groups; a block serves 4 samples.
//   * Stem: each thread keeps its channel's 49 weights in registers; the input
//     tile (zero border of 3) sits in shared memory and every warp reads one
//     broadcast address per tap; conv outputs go to shared memory and the
//     max-pool reads them back in the epilogue (0 is a safe pool identity
//     after relu, and padding never wins).
//   * K2 layer 1: group g owns sample g; thread (co, g) accumulates all 16
//     (or 4) positions of its output channel in registers. Activations live
//     in shared memory with a zero border of 1 (channel-fastest, read as
//     float4 broadcasts); the 4 x 72 KB of bf16 conv weights do not fit in
//     shared memory and are read through L1/L2 (__ldg), each load feeding one
//     FMA per position.
// Tensor cores, cp.async/TMA staging and register tiling across samples are
// left for later work.

#include "common.cuh"

namespace {

using av1::from_f;
using av1::ldg_f;
using av1::round_to;
using av1::to_f;

constexpr int C = 64;                  // stem and layer-1 channels
constexpr int THREADS = 256;           // C channels x GROUPS
constexpr int GROUPS = THREADS / C;    // 4
constexpr int SPB = GROUPS;            // samples per block
constexpr int TAPS = 49;               // 7x7 stem taps
constexpr int SE_HIDDEN = C / 16;      // SE1 reduction 16

template <int HW>
struct Geom {
  static constexpr int PADW = HW + 6;  // stem input tile, border 3
  static constexpr int CO = HW / 2;    // stem conv extent
  static constexpr int SO = HW / 4;    // pooled extent
  static constexpr int P = SO * SO;    // pooled positions
  static constexpr int Q = SO + 2;     // layer-1 activation extent, border 1
};

// One sample's pixels into the interior of the zero-bordered tile.
template <int HW, typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ x, int64_t b,
                                          float* tile) {
  using G = Geom<HW>;
  const T* xb = x + b * HW * HW;
  for (int i = threadIdx.x; i < HW * HW; i += THREADS)
    tile[(i / HW + 3) * G::PADW + i % HW + 3] = to_f<T>(xb[i]);
}

// Stem conv + bias + relu of channel c at conv positions g, g+GROUPS, ...
template <int HW>
__device__ __forceinline__ void stem_conv(const float* tile, const float (&w)[TAPS],
                                          float bias, int c, int g, float* conv) {
  using G = Geom<HW>;
  for (int pos = g; pos < G::CO * G::CO; pos += GROUPS) {
    const float* t = tile + 2 * (pos / G::CO) * G::PADW + 2 * (pos % G::CO);
    float acc = 0.f;
#pragma unroll
    for (int dy = 0; dy < 7; ++dy)
#pragma unroll
      for (int dx = 0; dx < 7; ++dx)
        acc = fmaf(t[dy * G::PADW + dx], w[dy * 7 + dx], acc);
    conv[pos * C + c] = fmaxf(acc + bias, 0.f);
  }
}

// 3x3/2 max-pool (pad 1) at pooled position p, channel c.
template <int HW>
__device__ __forceinline__ float pool_at(const float* conv, int p, int c) {
  using G = Geom<HW>;
  const int py = p / G::SO, px = p % G::SO;
  float m = 0.f;  // every candidate is >= 0 after relu
  for (int y = max(2 * py - 1, 0); y <= min(2 * py + 1, G::CO - 1); ++y)
    for (int x = max(2 * px - 1, 0); x <= min(2 * px + 1, G::CO - 1); ++x)
      m = fmaxf(m, conv[(y * G::CO + x) * C + c]);
  return m;
}

template <typename T>
__device__ __forceinline__ void load_stem_weights(const T* __restrict__ w, int c,
                                                  float (&wr)[TAPS]) {
#pragma unroll
  for (int t = 0; t < TAPS; ++t) wr[t] = ldg_f(w + t * C + c);
}

template <int HW, typename T>
__global__ void __launch_bounds__(THREADS)
fused_front_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const float* __restrict__ bias, T* __restrict__ out, int batch) {
  using G = Geom<HW>;
  __shared__ float tile[G::PADW * G::PADW];
  __shared__ float conv[G::CO * G::CO * C];
  const int c = threadIdx.x % C, g = threadIdx.x / C;
  float wr[TAPS];
  load_stem_weights(w, c, wr);
  const float bc = bias[c];
  for (int i = threadIdx.x; i < G::PADW * G::PADW; i += THREADS) tile[i] = 0.f;
  __syncthreads();
  const int64_t b0 = int64_t(blockIdx.x) * SPB;
  for (int s = 0; s < SPB; ++s) {
    const int64_t b = b0 + s;
    if (b >= batch) break;  // uniform across the block
    load_tile<HW>(x, b, tile);
    __syncthreads();
    stem_conv<HW>(tile, wr, bc, c, g, conv);
    __syncthreads();
    for (int p = g; p < G::P; p += GROUPS)
      out[(b * G::P + p) * C + c] = from_f<T>(pool_at<HW>(conv, p, c));
  }
}

template <int HW>
struct G1Smem {
  using G = Geom<HW>;
  float zin[SPB][G::Q * G::Q][C];  // conv input (rounded), zero border
  union {
    float h[SPB][G::Q * G::Q][C];  // mid-block activation (rounded), zero border
    struct {
      float tile[G::PADW * G::PADW];
      float conv[G::CO * G::CO * C];
    } stem;
  } u;
  float z[SPB][G::P][C];           // block output / residual, fp32
  float gate[SPB][C];
  float hid[SPB][SE_HIDDEN];
};

// 3x3/1 conv of one sample's zero-bordered activation for output channel co,
// at all P positions; w is [tap][ci][co].
template <int HW, typename T>
__device__ __forceinline__ void conv3x3(const float* __restrict__ in,
                                        const T* __restrict__ w, int co,
                                        float (&acc)[Geom<HW>::P]) {
  using G = Geom<HW>;
#pragma unroll
  for (int p = 0; p < G::P; ++p) acc[p] = 0.f;
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int off = (tap / 3) * G::Q + tap % 3;
    const T* wt = w + tap * C * C + co;
#pragma unroll 2
    for (int ci = 0; ci < C; ci += 4) {
      const float w0 = ldg_f(wt + (ci + 0) * C), w1 = ldg_f(wt + (ci + 1) * C);
      const float w2 = ldg_f(wt + (ci + 2) * C), w3 = ldg_f(wt + (ci + 3) * C);
#pragma unroll
      for (int p = 0; p < G::P; ++p) {
        const int q = (p / G::SO) * G::Q + p % G::SO + off;
        const float4 a = *reinterpret_cast<const float4*>(in + q * C + ci);
        acc[p] = fmaf(a.x, w0, acc[p]);
        acc[p] = fmaf(a.y, w1, acc[p]);
        acc[p] = fmaf(a.z, w2, acc[p]);
        acc[p] = fmaf(a.w, w3, acc[p]);
      }
    }
  }
}

template <int HW>
__device__ __forceinline__ int interior(int p) {
  using G = Geom<HW>;
  return (p / G::SO + 1) * G::Q + p % G::SO + 1;
}

template <int HW, typename T>
__global__ void __launch_bounds__(THREADS)
fused_front_g1_kernel(const T* __restrict__ x, const T* __restrict__ stem_w,
                      const float* __restrict__ stem_b, const T* __restrict__ conv_w,
                      const float* __restrict__ conv_b, const float* __restrict__ d0,
                      const float* __restrict__ d1, T* __restrict__ out, int batch) {
  using G = Geom<HW>;
  extern __shared__ float4 smem_raw[];
  G1Smem<HW>& sm = *reinterpret_cast<G1Smem<HW>*>(smem_raw);
  const int c = threadIdx.x % C, g = threadIdx.x / C;
  const int64_t b0 = int64_t(blockIdx.x) * SPB;

  // ---- stem + pool, one sample at a time, into z (fp32) and zin (rounded)
  {
    float wr[TAPS];
    load_stem_weights(stem_w, c, wr);
    const float bc = stem_b[c];
    float* zin = &sm.zin[0][0][0];
    for (int i = threadIdx.x; i < SPB * G::Q * G::Q * C; i += THREADS) zin[i] = 0.f;
    for (int i = threadIdx.x; i < G::PADW * G::PADW; i += THREADS) sm.u.stem.tile[i] = 0.f;
    __syncthreads();
    for (int s = 0; s < SPB; ++s) {
      if (b0 + s >= batch) break;  // uniform across the block
      load_tile<HW>(x, b0 + s, sm.u.stem.tile);
      __syncthreads();
      stem_conv<HW>(sm.u.stem.tile, wr, bc, c, g, sm.u.stem.conv);
      __syncthreads();
      for (int p = g; p < G::P; p += GROUPS) {
        const float v = pool_at<HW>(sm.u.stem.conv, p, c);
        sm.z[s][p][c] = v;
        sm.zin[s][interior<HW>(p)][c] = round_to<T>(v);
      }
    }
    __syncthreads();
    float* h = &sm.u.h[0][0][0];  // the stem scratch it aliases is done
    for (int i = threadIdx.x; i < SPB * G::Q * G::Q * C; i += THREADS) h[i] = 0.f;
    __syncthreads();
  }

  // ---- layer1_0, layer1_1: group g owns sample g, thread owns channel c
  float acc[G::P];
  const int kw = 9 * C * C;
  for (int blk = 0; blk < 2; ++blk) {
    const T* w1 = conv_w + (2 * blk) * kw;
    const T* w2 = conv_w + (2 * blk + 1) * kw;
    const float bias1 = conv_b[(2 * blk) * C + c];
    const float bias2 = conv_b[(2 * blk + 1) * C + c];
    conv3x3<HW, T>(&sm.zin[g][0][0], w1, c, acc);
#pragma unroll
    for (int p = 0; p < G::P; ++p)
      sm.u.h[g][interior<HW>(p)][c] = round_to<T>(fmaxf(acc[p] + bias1, 0.f));
    __syncthreads();
    conv3x3<HW, T>(&sm.u.h[g][0][0], w2, c, acc);
#pragma unroll
    for (int p = 0; p < G::P; ++p) {
      acc[p] = fmaxf(acc[p] + bias2 + sm.z[g][p][c], 0.f);
      sm.z[g][p][c] = acc[p];
      sm.zin[g][interior<HW>(p)][c] = round_to<T>(acc[p]);
    }
    __syncthreads();
  }

  // ---- SE1 on the block output, which acc still holds
  float mean = 0.f;
#pragma unroll
  for (int p = 0; p < G::P; ++p) mean += acc[p];
  sm.gate[g][c] = mean / G::P;
  __syncthreads();
  if (threadIdx.x < SPB * SE_HIDDEN) {
    const int s = threadIdx.x / SE_HIDDEN, r = threadIdx.x % SE_HIDDEN;
    float v = 0.f;
    for (int k = 0; k < C; ++k) v = fmaf(d0[r * C + k], sm.gate[s][k], v);
    sm.hid[s][r] = fmaxf(v, 0.f);
  }
  __syncthreads();
  float e = 0.f;
#pragma unroll
  for (int r = 0; r < SE_HIDDEN; ++r) e = fmaf(d1[c * SE_HIDDEN + r], sm.hid[g][r], e);
  e = 1.f / (1.f + expf(-e));
  const int64_t b = b0 + g;
  if (b < batch) {
#pragma unroll
    for (int p = 0; p < G::P; ++p) out[(b * G::P + p) * C + c] = from_f<T>(acc[p] * e);
  }
}

int grid_for(int batch) { return (batch + SPB - 1) / SPB; }

template <int HW, typename T>
int launch_front(const void* x, const void* w, const void* b, void* out, int batch,
                 cudaStream_t st) {
  fused_front_kernel<HW, T><<<grid_for(batch), THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(b),
      static_cast<T*>(out), batch);
  return int(cudaGetLastError());
}

template <int HW, typename T>
int launch_front_g1(const void* x, const void* sw, const void* sb, const void* cw,
                    const void* cb, const void* d0, const void* d1, void* out,
                    int batch, cudaStream_t st) {
  const size_t smem = sizeof(G1Smem<HW>);
  cudaError_t err = cudaFuncSetAttribute(
      fused_front_g1_kernel<HW, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  fused_front_g1_kernel<HW, T><<<grid_for(batch), THREADS, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(sw), static_cast<const float*>(sb),
      static_cast<const T*>(cw), static_cast<const float*>(cb),
      static_cast<const float*>(d0), static_cast<const float*>(d1), static_cast<T*>(out),
      batch);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError() (0 on
// success); it neither allocates nor synchronises. `bf16` selects the dtype
// of activations and conv weights (0: fp32); biases and SE weights are fp32.

int av1_fused_front(const void* x, const void* stem_w, const void* stem_b, void* out,
                    int batch, int hw, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch <= 0) return int(cudaErrorInvalidValue);
  if (hw == 16)
    return bf16 ? launch_front<16, __nv_bfloat16>(x, stem_w, stem_b, out, batch, st)
                : launch_front<16, float>(x, stem_w, stem_b, out, batch, st);
  if (hw == 8)
    return bf16 ? launch_front<8, __nv_bfloat16>(x, stem_w, stem_b, out, batch, st)
                : launch_front<8, float>(x, stem_w, stem_b, out, batch, st);
  return int(cudaErrorInvalidValue);
}

int av1_fused_front_g1(const void* x, const void* stem_w, const void* stem_b,
                       const void* conv_w, const void* conv_b, const void* se_d0,
                       const void* se_d1, void* out, int batch, int hw, int bf16,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch <= 0) return int(cudaErrorInvalidValue);
  if (hw == 16)
    return bf16 ? launch_front_g1<16, __nv_bfloat16>(x, stem_w, stem_b, conv_w, conv_b,
                                                      se_d0, se_d1, out, batch, st)
                : launch_front_g1<16, float>(x, stem_w, stem_b, conv_w, conv_b, se_d0,
                                             se_d1, out, batch, st);
  if (hw == 8)
    return bf16 ? launch_front_g1<8, __nv_bfloat16>(x, stem_w, stem_b, conv_w, conv_b,
                                                     se_d0, se_d1, out, batch, st)
                : launch_front_g1<8, float>(x, stem_w, stem_b, conv_w, conv_b, se_d0,
                                            se_d1, out, batch, st);
  return int(cudaErrorInvalidValue);
}

const char* av1_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
