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
// fp32. K2 keeps fp32 between its stages and rounds to the weight dtype where
// the TPU kernel casts a matmul operand: each conv input, and in SE1 the block
// output before the spatial mean, the mean, the hidden vector, the gate, and
// d0 and d1. In fp32 every one of those casts is the identity.
//
// What bounds them on an H100. At 16 px in bf16, K1 reads 512 B of input per
// sample, does 8x8 conv outputs x 64 channels x 49 taps = 200 k MACs and writes
// 2 KB: about 160 FLOP per byte, below the bf16 tensor cores' ridge
// (~295 FLOP/B), so it is bound by bytes, and by far by its output. K2 adds
// four 64x64x3x3 convs at 4x4: 2.56 M MACs per sample for the same 2.5 KB of
// traffic, ~2000 FLOP/B, bound by operations. Every intermediate stays on
// chip: device memory sees the input, the weights and the output. The TPU
// kernel's dense candidate matrix (3 MB at 16 px) and its n1 x n1 spatial-matmul
// convs (16/9 of the FLOPs) were shapes for the MXU and VMEM and are not
// carried over.
//
// bf16 (the serving dtype): fused_front_mma_kernel and fused_front_g1_mma_kernel,
// on the tensor cores (mma.sync.m16n8k16, mma.cuh).
//   * The stem is an implicit GEMM. Rows are (sample, conv position), 256 to a
//     pass, each warp 2 m-tiles x 64 channels; N is the 64 channels. K is the
//     7x7 window laid out as 8 rows of 8 taps, k = 8 dy + dx + 1, so K = 64
//     with no padding loop. The samples' pixels sit in shared memory as bf16
//     tiles with a zero border (3 rows above, 4 columns left, so that every
//     k-pair is one aligned 32-bit word), and each thread builds its A
//     fragments in registers straight from the tile: 8 word loads per m-tile
//     and 16-k step, no im2col buffer, no ldmatrix for A. The 15 slots with
//     dx + 1 = 0 or dy = 7 read a finite value of the tile and meet a zero row
//     of the weight tile, which the block builds once in shared memory from
//     the (49, 64) stem kernel (kernels/fused_front.py stem_gemm_weight and
//     stem_gemm_index state the two layouts, and the CPU tests hold them
//     against a convolution). Products of two bf16 values are exact in fp32;
//     only the order of the sums differs from the TPU kernel's.
//   * Bias and relu on the accumulators; the conv outputs of a pass go to
//     shared memory in fp32 and the max-pool reads them back, 4 channels a
//     thread: 16 lanes read one row's 256 bytes, so no two lanes of a
//     quarter-warp share a bank (0 is a safe identity after relu, and padding
//     never wins).
//   * K1: a block serves 16 samples, two blocks to an SM; the pooled values
//     leave as bf16, 8 bytes a thread, a warp's store 256 contiguous bytes.
//   * K2: a block holds 256 pooled rows (16 samples at 16 px, 64 at 8 px),
//     the rows of K5's layer 1. The pooled fp32 value is the first residual,
//     in a 256 x 64 fp32 plane; its bf16 rounding is the first conv input, in a
//     bf16 plane at a pitch of 72 beside a second plane for the mid activation.
//     The four convs run through conv_mma.cuh's routine with one plane: K2's
//     conv inputs are bf16 values, so one MMA pass is exact where K5 (hi/lo
//     planes) needs two. conv_w (4, 9, 64, 64) is k-major as it stands, 36 chunks of
//     64 k-rows through a four-slot cp.async ring; a block reads the 288 KB
//     once for its 256 rows. The stem's conv scratch aliases the mid plane and
//     the ring, which are free until the first conv. SE1 runs from shared
//     memory with the roundings above, and the output leaves scaled, 8 bytes a
//     thread. A short last block computes on zero samples and stores only those
//     inside the batch.
//   * x may start at any element: a base address off the 16-byte grid takes
//     2-byte loads. conv_w and out must be 16-byte aligned (tensors of their
//     own always are); the entry point refuses others.
//
// fp32 (the parity mode): fused_front_kernel and fused_front_g1_kernel, direct
// convolutions on the CUDA cores, the first version:
//   * 256 threads per block = 64 channels x 4 groups; a block serves 4 samples.
//   * Stem: each thread keeps its channel's 49 weights in registers; the input
//     tile (zero border of 3) sits in shared memory and every warp reads one
//     broadcast address per tap; conv outputs go to shared memory and the
//     max-pool reads them back in the epilogue.
//   * K2 layer 1: group g owns sample g; thread (co, g) accumulates all 16
//     (or 4) positions of its output channel in registers. Activations live
//     in shared memory with a zero border of 1 (channel-fastest, read as
//     float4 broadcasts); the conv weights are read through L1/L2 (__ldg),
//     each load feeding one FMA per position.

#include "common.cuh"
#include "conv_mma.cuh"

namespace {

using av1::from_f;
using av1::ldg_f;
using av1::round_to;
using av1::to_f;
using av1::conv::THREADS;              // 256: C channels x GROUPS

constexpr int C = 64;                  // stem and layer-1 channels
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

  // ---- SE1 on the block output, which acc still holds; each matmul operand
  // rounded to T as the TPU kernel casts it
  float mean = 0.f;
#pragma unroll
  for (int p = 0; p < G::P; ++p) mean += round_to<T>(acc[p]);
  sm.gate[g][c] = round_to<T>(mean / G::P);
  __syncthreads();
  if (threadIdx.x < SPB * SE_HIDDEN) {
    const int s = threadIdx.x / SE_HIDDEN, r = threadIdx.x % SE_HIDDEN;
    float v = 0.f;
    for (int k = 0; k < C; ++k) v = fmaf(round_to<T>(d0[r * C + k]), sm.gate[s][k], v);
    sm.hid[s][r] = round_to<T>(fmaxf(v, 0.f));
  }
  __syncthreads();
  float e = 0.f;
#pragma unroll
  for (int r = 0; r < SE_HIDDEN; ++r)
    e = fmaf(round_to<T>(d1[c * SE_HIDDEN + r]), sm.hid[g][r], e);
  e = round_to<T>(1.f / (1.f + expf(-e)));
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

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernels
// ---------------------------------------------------------------------------

using av1::conv::bf16;
using av1::conv::conv_mma;
using av1::conv::fetch_chunk;
using av1::conv::for_each_pair;
using av1::conv::KC;
using av1::conv::zero_acc;

constexpr int ROWS = 256;         // GEMM rows of a stem pass, and of a K2 block in layer 1
constexpr int PITCH = C + 8;      // row pitch of a bf16 plane and of the stem weight tile:
                                  // 144 bytes, an odd multiple of 16, as ldmatrix likes
constexpr int FPITCH = C + 8;     // row pitch of an fp32 plane: rows 8 banks apart
constexpr int PLANE = ROWS * PITCH;
constexpr int POOLED = ROWS / 4;  // pooled rows a pass yields: a conv position is 1/4 of one
constexpr int K1_SPB = 16;        // samples of a K1 block

// A sample's pixels as a bf16 tile with a zero border: 3 rows above and 4
// columns left of the pixels, so that tap (dy, dx) of conv position (cy, cx)
// is element (2 cy + dy, 2 cx + dx + 1) and every k-pair an aligned word.
template <int HW>
struct Tile {
  static constexpr int W = HW + 8;
  static constexpr int H = HW + 6;
  static constexpr int SIZE = W * H;              // elements of a sample
  static constexpr int CP = (HW / 2) * (HW / 2);  // conv positions of a sample
  static_assert(SIZE % 8 == 0 && W % 4 == 0, "tiles are zeroed 16 bytes and filled 8 at a time");
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Samples b0 .. b0 + n - 1 into the `spb` tiles (the rest stay zero), and the
// (49, 64) stem kernel into the GEMM's 64 x 64 weight tile: row
// k = 8 dy + dx + 1 holds tap (dy, dx), the other 15 rows zeros. Ends with a
// barrier.
template <int HW>
__device__ __forceinline__ void stem_setup(const bf16* __restrict__ x,
                                           const bf16* __restrict__ stem_w, int64_t b0, int n,
                                           int spb, bf16* tile, bf16* wsm) {
  using T = Tile<HW>;
  for (int i = threadIdx.x; i < spb * T::SIZE / 8; i += THREADS)
    reinterpret_cast<uint4*>(tile)[i] = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < KC * C; i += THREADS) {
    const int k = i / C, c = i % C, dy = k / 8, dx = k % 8 - 1;
    wsm[k * PITCH + c] =
        dy < 7 && dx >= 0 ? __ldg(stem_w + (dy * 7 + dx) * C + c) : __float2bfloat16_rn(0.f);
  }
  __syncthreads();
  const bf16* xb = x + b0 * HW * HW;
  if (reinterpret_cast<uintptr_t>(x) % 16 == 0) {  // 16 bytes a load
    constexpr int PER_ROW = HW / 8;
    for (int i = threadIdx.x; i < n * HW * PER_ROW; i += THREADS) {
      const int s = i / (HW * PER_ROW), y = i / PER_ROW % HW, x0 = i % PER_ROW * 8;
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(xb) + i);
      uint2* d = reinterpret_cast<uint2*>(tile + s * T::SIZE + (y + 3) * T::W + 4 + x0);
      d[0] = make_uint2(v.x, v.y);
      d[1] = make_uint2(v.z, v.w);
    }
  } else {  // a view that starts off the 16-byte grid
    for (int i = threadIdx.x; i < n * HW * HW; i += THREADS)
      tile[i / (HW * HW) * T::SIZE + (i / HW % HW + 3) * T::W + 4 + i % HW] = xb[i];
  }
  __syncthreads();
}

// One pass of the stem GEMM: conv rows pass * 256 .. + 255 of the block
// (sample-major, then conv position), 64 channels, bias and relu, into
// `scratch` (256 x FPITCH fp32). Each warp 32 rows x 64 channels.
template <int HW>
__device__ __forceinline__ void stem_pass(const bf16* tile, const bf16* wsm,
                                          const float* __restrict__ stem_b, int pass,
                                          float* scratch, int warp, int lane) {
  using T = Tile<HW>;
  constexpr int CO = HW / 2;
  const int g = lane / 4, t = lane % 4, row0 = warp * 32;
  // where the windows of this thread's four rows start, plus its k-pair's dx
  const bf16* win[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = pass * ROWS + row0 + mi * 16 + g + 8 * hf;
      const int pos = r % T::CP;
      win[mi][hf] = tile + r / T::CP * T::SIZE + 2 * (pos / CO) * T::W + 2 * (pos % CO) + 2 * t;
    }
  const uint32_t w =
      av1::smem_addr(wsm) + uint32_t(lane % 16 * PITCH) * sizeof(bf16) + 16 * (lane / 16);
  float acc[2][8][4];
  zero_acc(acc);
#pragma unroll
  for (int kk = 0; kk < KC / 16; ++kk) {  // k = 16 kk + ..: window rows 2 kk and 2 kk + 1
    uint32_t a[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const bf16* p0 = win[mi][0] + 2 * kk * T::W;
      const bf16* p1 = win[mi][1] + 2 * kk * T::W;
      a[mi][0] = ld32(p0);
      a[mi][1] = ld32(p1);
      a[mi][2] = ld32(p0 + T::W);
      a[mi][3] = ld32(p1 + T::W);
    }
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      uint32_t b[4];
      av1::ldmatrix_x4_trans(b, w + uint32_t(kk * 16 * PITCH + nj * 16) * sizeof(bf16));
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        av1::mma_bf16(acc[mi][2 * nj], a[mi], b[0], b[1]);
        av1::mma_bf16(acc[mi][2 * nj + 1], a[mi], b[2], b[3]);
      }
    }
  }
  for_each_pair(acc, row0, 0, lane, [&](int row, int col, float v0, float v1) {
    *reinterpret_cast<float2*>(scratch + row * FPITCH + col) = make_float2(
        fmaxf(v0 + __ldg(stem_b + col), 0.f), fmaxf(v1 + __ldg(stem_b + col + 1), 0.f));
  });
}

// 3x3/2 max-pool (pad 1) of a pass's conv outputs in `scratch`: pooled row
// `prow` of the pass (sample-major, then pooled position), channels c4 .. c4 + 3.
// A thread takes 4 channels, so that 16 lanes read one row's 256 bytes and no
// two lanes of a quarter-warp share a bank.
template <int HW>
__device__ __forceinline__ float4 pool4(const float* scratch, int prow, int c4) {
  using G = Geom<HW>;
  const int s = prow / G::P, p = prow % G::P, py = p / G::SO, px = p % G::SO;
  float4 m = make_float4(0.f, 0.f, 0.f, 0.f);  // every candidate is >= 0 after relu
  for (int y = max(2 * py - 1, 0); y <= min(2 * py + 1, G::CO - 1); ++y)
    for (int xx = max(2 * px - 1, 0); xx <= min(2 * px + 1, G::CO - 1); ++xx) {
      const float4 v = *reinterpret_cast<const float4*>(
          scratch + (s * Tile<HW>::CP + y * G::CO + xx) * FPITCH + c4);
      m = make_float4(fmaxf(m.x, v.x), fmaxf(m.y, v.y), fmaxf(m.z, v.z), fmaxf(m.w, v.w));
    }
  return m;
}

__device__ __forceinline__ uint2 pack4_bf16(float4 v) {
  return make_uint2(av1::pack_bf16(v.x, v.y), av1::pack_bf16(v.z, v.w));
}

template <int HW>
constexpr size_t K1_SMEM =
    sizeof(float) * ROWS * FPITCH + sizeof(bf16) * (K1_SPB * Tile<HW>::SIZE + KC * PITCH);

template <int HW>
__global__ void __launch_bounds__(THREADS, 2)  // two blocks an SM: 128 registers a thread
fused_front_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ stem_w,
                       const float* __restrict__ stem_b, bf16* __restrict__ out, int batch) {
  constexpr int P = Geom<HW>::P, PASSES = K1_SPB * Tile<HW>::CP / ROWS;
  extern __shared__ uint4 front_smem[];
  float* scratch = reinterpret_cast<float*>(front_smem);  // a pass's conv outputs
  bf16* tile = reinterpret_cast<bf16*>(scratch + ROWS * FPITCH);
  bf16* wsm = tile + K1_SPB * Tile<HW>::SIZE;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int64_t b0 = int64_t(blockIdx.x) * K1_SPB;
  const int n = batch - b0 < K1_SPB ? int(batch - b0) : K1_SPB;  // samples to store

  stem_setup<HW>(x, stem_w, b0, n, K1_SPB, tile, wsm);
  bf16* ob = out + b0 * P * C;
  for (int pass = 0; pass < PASSES; ++pass) {
    stem_pass<HW>(tile, wsm, stem_b, pass, scratch, warp, lane);
    __syncthreads();
    for (int i = threadIdx.x; i < POOLED * (C / 4); i += THREADS) {
      const int prow = i / (C / 4), c4 = i % (C / 4) * 4, row = pass * POOLED + prow;
      if (row / P >= n) continue;
      *reinterpret_cast<uint2*>(ob + row * C + c4) = pack4_bf16(pool4<HW>(scratch, prow, c4));
    }
    if (pass + 1 < PASSES) __syncthreads();  // the next pass overwrites scratch
  }
}

// conv_w (4, 9, 64, 64) as the conv routine's schedule: [conv][tap][ci][co] is
// 36 chunks of 64 k-rows x 64 columns, the head of K5's stream.
struct G1Stream {
  static constexpr int STAGES = 4;
  static constexpr int CHUNKS = 4 * 9;
  static constexpr int WPITCH = PITCH;
  static constexpr int SLOT = KC * WPITCH;
  __device__ static constexpr int cols(int) { return C; }
  __device__ static constexpr int offset(int c) { return c * KC * C; }
};
constexpr int RING = G1Stream::STAGES * G1Stream::SLOT;
static_assert(sizeof(float) * ROWS * FPITCH <= sizeof(bf16) * (PLANE + RING),
              "the stem's conv scratch aliases the mid plane and the ring");

template <int HW>
struct G1Mma {
  static constexpr int SPB = ROWS / Geom<HW>::P;  // samples of a block: 256 pooled rows
  static constexpr size_t SMEM =
      sizeof(float) * ROWS * FPITCH +
      sizeof(bf16) * (2 * PLANE + RING + PITCH + SPB * Tile<HW>::SIZE + KC * PITCH);
};

template <int HW>
__global__ void __launch_bounds__(THREADS)
fused_front_g1_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ stem_w,
                          const float* __restrict__ stem_b, const bf16* __restrict__ conv_w,
                          const float* __restrict__ conv_b, const float* __restrict__ d0,
                          const float* __restrict__ d1, bf16* __restrict__ out, int batch) {
  using G = Geom<HW>;
  constexpr int E = G::SO, P = G::P, SPB = G1Mma<HW>::SPB;
  constexpr int PASSES = SPB * Tile<HW>::CP / ROWS;
  extern __shared__ uint4 g1_smem[];
  bf16* zin = reinterpret_cast<bf16*>(g1_smem);          // conv input: the residual, rounded
  float* res = reinterpret_cast<float*>(zin + PLANE);    // block input / residual / output
  bf16* h = reinterpret_cast<bf16*>(res + ROWS * FPITCH);  // mid activation; SE scratch
  bf16* ring = h + PLANE;
  bf16* zero_row = ring + RING;
  bf16* tile = zero_row + PITCH;
  bf16* wsm = tile + SPB * Tile<HW>::SIZE;
  float* scratch = reinterpret_cast<float*>(h);          // over h and the ring
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int64_t b0 = int64_t(blockIdx.x) * SPB;
  const int n = batch - b0 < SPB ? int(batch - b0) : SPB;  // samples to store

  // ---- stem + pool: the fp32 value into res, its rounding into zin
  for (int i = threadIdx.x; i < PITCH / 2; i += THREADS)
    reinterpret_cast<uint32_t*>(zero_row)[i] = 0;
  stem_setup<HW>(x, stem_w, b0, n, SPB, tile, wsm);
  for (int pass = 0; pass < PASSES; ++pass) {
    stem_pass<HW>(tile, wsm, stem_b, pass, scratch, warp, lane);
    __syncthreads();
    for (int i = threadIdx.x; i < POOLED * (C / 4); i += THREADS) {
      const int prow = i / (C / 4), c4 = i % (C / 4) * 4, row = pass * POOLED + prow;
      const float4 m = pool4<HW>(scratch, prow, c4);
      *reinterpret_cast<float4*>(res + row * FPITCH + c4) = m;
      *reinterpret_cast<uint2*>(zin + row * PITCH + c4) = pack4_bf16(m);
    }
    __syncthreads();  // scratch is read; the next pass, or the ring, overwrites it
  }

  // ---- layer1_0, layer1_1: each warp 32 rows x 64 columns, weights through
  // the ring. No cp.async group is pending here, in any thread.
  for (int c = 0; c < G1Stream::STAGES - 1; ++c) fetch_chunk<G1Stream>(conv_w, ring, c);
  const uint32_t zero = av1::smem_addr(zero_row);
  const uint32_t in_z = av1::smem_addr(zin), in_h = av1::smem_addr(h);
  const int row0 = warp * 32;
  float acc[2][8][4];
#pragma unroll 1
  for (int blk = 0; blk < 2; ++blk) {
    const float* b1 = conv_b + 2 * blk * C;
    const float* b2 = b1 + C;
    zero_acc(acc);
    conv_mma<G1Stream, E, E, 1, C, PITCH, 9, 2>(acc, in_z, zero, row0, 0, conv_w, ring,
                                                18 * blk, lane);
    for_each_pair(acc, row0, 0, lane, [&](int row, int col, float v0, float v1) {
      *reinterpret_cast<uint32_t*>(h + row * PITCH + col) = av1::pack_bf16(
          fmaxf(v0 + __ldg(b1 + col), 0.f), fmaxf(v1 + __ldg(b1 + col + 1), 0.f));
    });
    zero_acc(acc);
    conv_mma<G1Stream, E, E, 1, C, PITCH, 9, 2>(acc, in_h, zero, row0, 0, conv_w, ring,
                                                18 * blk + 9, lane);
    for_each_pair(acc, row0, 0, lane, [&](int row, int col, float v0, float v1) {
      float2* r = reinterpret_cast<float2*>(res + row * FPITCH + col);
      const float2 z = *r;
      const float o0 = fmaxf(v0 + __ldg(b2 + col) + z.x, 0.f);
      const float o1 = fmaxf(v1 + __ldg(b2 + col + 1) + z.y, 0.f);
      *r = make_float2(o0, o1);
      *reinterpret_cast<uint32_t*>(zin + row * PITCH + col) = av1::pack_bf16(o0, o1);
    });
    __syncthreads();
  }
  av1::cp_async_wait<0>();

  // ---- SE1, each matmul operand a bf16 value: the mean of the rounded output
  // (zin), rounded; the hidden vector, rounded; the gate, rounded
  float* gate = reinterpret_cast<float*>(h);  // SPB x C: the mean, then the gate
  float* hid = gate + SPB * C;                // SPB x SE_HIDDEN
  for (int i = threadIdx.x; i < SPB * C; i += THREADS) {
    const bf16* zs = zin + i / C * P * PITCH + i % C;
    float sum = 0.f;
    for (int p = 0; p < P; ++p) sum += __bfloat162float(zs[p * PITCH]);
    gate[i] = round_to<bf16>(sum / P);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < SPB * SE_HIDDEN; i += THREADS) {
    const float* gs = gate + i / SE_HIDDEN * C;
    const float* w = d0 + i % SE_HIDDEN * C;
    float v = 0.f;
    for (int k = 0; k < C; ++k) v = fmaf(round_to<bf16>(__ldg(w + k)), gs[k], v);
    hid[i] = round_to<bf16>(fmaxf(v, 0.f));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < SPB * C; i += THREADS) {
    const float* hs = hid + i / C * SE_HIDDEN;
    const float* w = d1 + i % C * SE_HIDDEN;
    float e = 0.f;
    for (int r = 0; r < SE_HIDDEN; ++r) e = fmaf(round_to<bf16>(__ldg(w + r)), hs[r], e);
    gate[i] = round_to<bf16>(1.f / (1.f + expf(-e)));
  }
  __syncthreads();

  // ---- the output, scaled as it is written
  bf16* ob = out + b0 * P * C;
  for (int i = threadIdx.x; i < ROWS * (C / 4); i += THREADS) {
    const int row = i / (C / 4), c4 = i % (C / 4) * 4, s = row / P;
    if (s >= n) continue;
    const float4 z = *reinterpret_cast<const float4*>(res + row * FPITCH + c4);
    const float4 e = *reinterpret_cast<const float4*>(gate + s * C + c4);
    *reinterpret_cast<uint2*>(ob + row * C + c4) =
        pack4_bf16(make_float4(z.x * e.x, z.y * e.y, z.z * e.z, z.w * e.w));
  }
}

template <int HW>
int launch_front_mma(const void* x, const void* w, const void* b, void* out, int batch,
                     cudaStream_t st) {
  constexpr size_t smem = K1_SMEM<HW>;
  static const cudaError_t attr =  // once per kernel, not per launch
      cudaFuncSetAttribute(fused_front_mma_kernel<HW>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (attr != cudaSuccess) return int(attr);
  fused_front_mma_kernel<HW><<<(batch + K1_SPB - 1) / K1_SPB, THREADS, smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const float*>(b),
      static_cast<bf16*>(out), batch);
  return int(cudaGetLastError());
}

template <int HW>
int launch_front_g1_mma(const void* x, const void* sw, const void* sb, const void* cw,
                        const void* cb, const void* d0, const void* d1, void* out, int batch,
                        cudaStream_t st) {
  using L = G1Mma<HW>;
  static const cudaError_t attr =  // once per kernel, not per launch
      cudaFuncSetAttribute(fused_front_g1_mma_kernel<HW>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, int(L::SMEM));
  if (attr != cudaSuccess) return int(attr);
  fused_front_g1_mma_kernel<HW><<<(batch + L::SPB - 1) / L::SPB, THREADS, L::SMEM, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(sw), static_cast<const float*>(sb),
      static_cast<const bf16*>(cw), static_cast<const float*>(cb),
      static_cast<const float*>(d0), static_cast<const float*>(d1), static_cast<bf16*>(out),
      batch);
  return int(cudaGetLastError());
}

bool aligned16(const void* a, const void* b = nullptr) {
  return (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 16 == 0;
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError() (0 on
// success); it neither allocates nor synchronises. `bf16` selects the dtype
// of activations and conv weights (0: fp32, on the CUDA cores; 1: bf16, on the
// tensor cores); biases and SE weights are fp32. With bf16, `out` and `conv_w`
// must be 16-byte aligned; `x` may start at any element.

int av1_fused_front(const void* x, const void* stem_w, const void* stem_b, void* out,
                    int batch, int hw, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || (hw != 8 && hw != 16)) return int(cudaErrorInvalidValue);
  if (!bf16)
    return hw == 16 ? launch_front<16, float>(x, stem_w, stem_b, out, batch, st)
                    : launch_front<8, float>(x, stem_w, stem_b, out, batch, st);
  if (!aligned16(out)) return int(cudaErrorInvalidValue);
  return hw == 16 ? launch_front_mma<16>(x, stem_w, stem_b, out, batch, st)
                  : launch_front_mma<8>(x, stem_w, stem_b, out, batch, st);
}

int av1_fused_front_g1(const void* x, const void* stem_w, const void* stem_b,
                       const void* conv_w, const void* conv_b, const void* se_d0,
                       const void* se_d1, void* out, int batch, int hw, int bf16,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || (hw != 8 && hw != 16)) return int(cudaErrorInvalidValue);
  if (!bf16)
    return hw == 16 ? launch_front_g1<16, float>(x, stem_w, stem_b, conv_w, conv_b, se_d0,
                                                 se_d1, out, batch, st)
                    : launch_front_g1<8, float>(x, stem_w, stem_b, conv_w, conv_b, se_d0,
                                                se_d1, out, batch, st);
  if (!aligned16(out, conv_w)) return int(cudaErrorInvalidValue);
  return hw == 16 ? launch_front_g1_mma<16>(x, stem_w, stem_b, conv_w, conv_b, se_d0, se_d1,
                                            out, batch, st)
                  : launch_front_g1_mma<8>(x, stem_w, stem_b, conv_w, conv_b, se_d0, se_d1,
                                           out, batch, st);
}

const char* av1_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
