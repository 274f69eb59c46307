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
// (~295 FLOP/B), so it is bound by bytes, and by far by its output (4,096
// samples: 10.5 MB, 0.0031 ms at 3.35 TB/s). K2 adds four 64x64x3x3 convs at
// 4x4: 2.56 M MACs per sample (fewer with the taps outside the image left
// out) for the same 2.5 KB of traffic, ~2000 FLOP/B, bound by operations. Every
// intermediate stays on chip: device memory sees the input, the weights and
// the output. The TPU kernel's dense candidate matrix (3 MB at 16 px) and its
// n1 x n1 spatial-matmul convs (16/9 of the FLOPs) were shapes for the MXU and
// VMEM and are not carried over.
//
// bf16 (the serving dtype): fused_front_wgmma_kernel (K1) and
// fused_front_g1_wgmma_kernel (K2), on wgmma (hopper.cuh).
//   * The input: x viewed as (B, hw, hw) by a 3-D TMA map, one box a group of
//     samples, (samples, hw + 6, hw + 8) from (b0, 0, 0): the box's zero fill
//     outside the array puts 6 zero rows below and 8 zero columns right of
//     each sample's pixels, and zero samples past the batch. Read from 3 rows
//     and 4 columns before the box (TMA takes no negative coordinates), that
//     is each sample's tile with the zero border the stem reads, so that tap
//     (dy, dx) of conv position (cy, cx) is element (2 cy + dy, 2 cx + dx + 1)
//     and every k-pair an aligned word (Tile). An x whose base is off the
//     16-byte grid, which a map cannot view, is loaded by elements into the
//     same layout: a second load path in front of the same math.
//   * The stem is an implicit GEMM on 64-row tiles: rows are (sample, conv
//     position), one sample a tile at 16 px, four at 8 px; N the 64 channels;
//     K the 7x7 window as 8 rows of 8 taps, k = 8 dy + dx + 1, K = 64. Each
//     lane builds its register A fragments from the tile by 32-bit word
//     loads (no im2col buffer); B is the (49, 64) stem kernel as a 64 x 64
//     tile, written once a block into shared memory in the 128-byte-swizzled
//     layout wgmma reads (kernels/fused_front.py stem_gemm_weight and
//     stem_gemm_index state the two layouts). Four wgmma.m64n64k16 a tile,
//     one accumulator chain. Products of two bf16 values are exact in fp32;
//     only the order of the sums differs from the TPU kernel's.
//   * Bias, relu and the 3x3/2 max-pool run on the accumulators, in registers:
//     a tile's rows are laid out (stem_tile_rows) so that a lane holds two
//     neighbouring columns of one conv row; the pool's x window takes one
//     shuffle; its y window at 8 px two, at 16 px one trade within a warp's
//     row pair (each lane then finishes half the channel blocks) and the row
//     above from the previous warp through shared memory. Nothing of the conv
//     output is stored. The stem's weights and bias reach shared memory once
//     a block, one load a value (every block reads the same lines).
//   * K1: a persistent grid, two blocks an SM, each warpgroup a worker that
//     walks over groups of 2 (16 px) or 4 (8 px) samples: the next group's box
//     lands in a second buffer while this one computes; the pooled bf16
//     values go into a staging buffer in the store map's 128-byte swizzle and
//     leave by one TMA store a group, which overlaps the next group's math
//     (two staging buffers; rows past the batch are clipped by the map).
//   * K2: K5's layer-1 block at extent hw / 4 (csrc/conv_wgmma.cuh): 256
//     rows a block (16 samples at 16 px), 128 at 8 px (32 samples: 4,096
//     samples fill 128 blocks), rows position-major (p * SPB + s), one
//     consumer warpgroup a 64-row tile (four at 16 px, two at 8 px) and a
//     producer warp, clusters of two. The stem's pool writes the fp32 value,
//     the first residual, into an fp32 plane and its bf16 rounding, the first
//     conv input, into a bf16 plane, at the position-major row (each lane's
//     channel blocks rotated by its position, so that a store's lanes meet
//     distinct banks); the warpgroups share the stem's tiles. The four convs run on
//     register-A wgmma with one plane (K2's conv inputs are bf16 values, so
//     one pass is exact where K5 needs two): conv_w (4, 9, 64, 64) is the head
//     of K5's conv stream, 36 chunks of 64 k-rows, fetched by the producer
//     warp by TMA multicast into a four-slot mbarrier ring from the moment
//     the block starts, so the ring fills while the stem runs; a 64-row tile
//     skips the taps none of its rows reads inside the image (the layer-1 rows
//     of resnet_group.group12_tile_taps). SE1 runs a warp a sample in
//     registers, on its weights staged in shared memory, with the roundings
//     above and fixed summation orders (the hidden sums by a butterfly; no
//     atomics), and the output leaves scaled, 16 bytes a store, back in
//     sample order. A short last block, and a block that only pads the grid
//     to whole clusters, computes on zero samples and stores only those
//     inside the batch.
//   * What bounds them now (clock64 stamps of each phase, on an H100): K1
//     the latency of a worker's chain (its first box lands ~3 k cycles after
//     the start; a group's four wgmmas and pool) more than its bytes; K2 at
//     16 px layer 1 (~32 k of ~50 k cycles a block: ~890 cycles a chunk, the
//     shared-memory reads of A by ldmatrix and of B by wgmma, ~64 KB a chunk,
//     against ~430 cycles of tensor work), then the stem (~8 k), with its
//     205 KiB of shared memory one block an SM.
//   * conv_w and out must be 16-byte aligned (tensors of their own always
//     are); the entry points refuse others.
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

#include <string.h>

#include "common.cuh"
#include "conv_wgmma.cuh"
#include "hopper.cuh"

namespace {

using av1::from_f;
using av1::ldg_f;
using av1::round_to;
using av1::to_f;

constexpr int THREADS = 256;           // the fp32 kernels' block: C channels x GROUPS
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
// bf16: the wgmma kernels
// ---------------------------------------------------------------------------

namespace sm90 = av1::sm90;
using av1::convwg::align_1024;
using av1::convwg::CLUSTER;
using av1::convwg::CONSUMER_BARRIER;
using av1::convwg::conv_wg;
using av1::convwg::for_each_pair;
using av1::convwg::KC;
using av1::convwg::L10_C1;
using av1::convwg::L11_C1;
using av1::convwg::produce;
using av1::convwg::Ring;
using av1::convwg::STAGES;
using av1::convwg::TileTaps;
using av1::convwg::WARPGROUP_BARRIER;
using av1::convwg::zero_acc;
using bf16 = __nv_bfloat16;

constexpr int PITCH = C + 8;       // row pitch of a bf16 plane (elements): 144 bytes, an odd
                                   // multiple of 16, as ldmatrix likes
constexpr int FPITCH = C + 8;      // row pitch of the fp32 plane: rows 8 banks apart
constexpr int B_BYTES = 64 * 128;  // the stem's B tile: 64 k-rows of 64 channels

// A sample's pixels as a bf16 tile with a zero border: 3 rows above and 4
// columns left of the pixels, so that tap (dy, dx) of conv position (cy, cx)
// is element (2 cy + dy, 2 cx + dx + 1) and every k-pair an aligned word.
// TMA takes no negative coordinates, so the box (samples, H, W) comes from
// (b0, 0, 0): each sample's pixels at the top left of its H x W block, zeros
// right of and below them (outside the array). Read from LEAD elements before
// the box, that block is the tile: the 4 columns left of a row are the
// previous row's last 4 zeros, the 3 rows above the first the previous
// sample's last zero rows or, for the first sample, LEAD zeros in front of
// the buffer (LEAD_BYTES, zeroed once).
template <int HW>
struct Tile {
  static constexpr int W = HW + 8;
  static constexpr int H = HW + 6;
  static constexpr int SIZE = W * H;  // elements of a sample
  static constexpr int LEAD = 3 * W + 4;
  static constexpr int LEAD_BYTES = (2 * LEAD + 127) / 128 * 128;
  static_assert(SIZE % 8 == 0 && W % 8 == 0, "tiles are zeroed 16 bytes at a time; rows 16 bytes");
};

// The stem's implicit GEMM on 64-row tiles. Row 16 w + 8 h + g of a tile
// (warp w, lane group g = lane / 4, h the fragment's upper half) is conv row
// Y = RW w + g / XP of the tile's samples (sample Y / CO, row y = Y % CO) at
// column x = 2 (g % XP) + h. A lane thus holds two neighbouring columns of one
// conv row, and its four lanes t the 64 channels in pairs: the pool's x window
// is the lane's own pair and the right value of lane g - 1, its y window the
// lanes 4 XP away (at 16 px the partner row, with which a lane trades half its
// channel blocks) and, at 16 px, the row above in the previous warp.
template <int HW>
struct Stem {
  static constexpr int CO = HW / 2;           // conv extent
  static constexpr int SO = HW / 4;           // pooled extent
  static constexpr int P = SO * SO;           // pooled positions of a sample
  static constexpr int SPT = 64 / (CO * CO);  // samples of a tile: 1 (16 px) or 4 (8 px)
  static constexpr int XP = CO / 2;           // lane groups of a conv row
  static constexpr int RW = 8 / XP;           // conv rows of a warp: 2 (16 px) or 4 (8 px)
  static constexpr int EDGE = RW == 2 ? 3 * 8 * XP * 4 : 0;  // pairs a warpgroup passes down
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// stem_gemm_weight's 64 x 64 tile (kernels/fused_front.py) into `b` (1,024-byte
// aligned) in wgmma's MN-major layout with the 128-byte swizzle: k-row k at
// byte 128 k, its 16-byte chunk c (channels 8c ..) at chunk c ^ (k % 8). Row
// k = 8 dy + dx + 1 holds tap (dy, dx), the 15 others zeros. NT threads, a
// 16-byte load each chunk, all in flight together (a stem_w off the 16-byte
// grid takes 2-byte loads).
template <int NT>
__device__ __forceinline__ void stem_b_tile(const bf16* __restrict__ stem_w, uint8_t* b,
                                            int tid) {
  const bool vec = reinterpret_cast<uintptr_t>(stem_w) % 16 == 0;
#pragma unroll
  for (int i = tid; i < 64 * 8; i += NT) {
    const int k = i / 8, c = i % 8, dy = k / 8, dx = k % 8 - 1;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (dy < 7 && dx >= 0) {
      const bf16* src = stem_w + (dy * 7 + dx) * C + 8 * c;
      if (vec) {
        v = __ldg(reinterpret_cast<const uint4*>(src));
      } else {
        bf16* e = reinterpret_cast<bf16*>(&v);
        for (int q = 0; q < 8; ++q) e[q] = src[q];
      }
    }
    *reinterpret_cast<uint4*>(b + k * 128 + ((c ^ (k % 8)) << 4)) = v;
  }
  sm90::fence_proxy_async();  // wgmma reads it through the async proxy
}

// This thread's bias pairs (channels 8j + 2t, + 1) from `b` in shared memory.
// Every block needs the same 64 values: one thread loads each into shared
// memory, not every thread all 16 of its own from the same L2 lines.
__device__ __forceinline__ void stage_bias(float (&bias)[8][2], const float* b, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q) bias[j][q] = b[8 * j + 2 * (lane % 4) + q];
}

// Samples b0 .. b0 + n - 1 of x by element loads into `spb` samples' blocks
// of `box`, as the TMA box lays them down (the rest stay zero): the load path
// of an x whose base is off the 16-byte grid, which a TMA map cannot view.
// `nthreads` threads from `tid`; ends with their barrier `bar`.
template <int HW>
__device__ void load_box(const bf16* __restrict__ x, int64_t b0, int n, int spb, bf16* box,
                         int tid, int nthreads, int bar) {
  using T = Tile<HW>;
  for (int i = tid; i < spb * T::SIZE / 8; i += nthreads)
    reinterpret_cast<uint4*>(box)[i] = make_uint4(0, 0, 0, 0);
  sm90::named_barrier(bar, nthreads);
  const bf16* xb = x + b0 * HW * HW;
  for (int i = tid; i < n * HW * HW; i += nthreads)
    box[i / (HW * HW) * T::SIZE + i / HW % HW * T::W + i % HW] = xb[i];
  sm90::named_barrier(bar, nthreads);
}

// The LEAD_BYTES of zeros in front of a box buffer.
template <int HW>
__device__ __forceinline__ void zero_lead(uint8_t* box, int tid, int nthreads) {
  for (int i = tid; i < Tile<HW>::LEAD_BYTES / 16; i += nthreads)
    reinterpret_cast<uint4*>(box - Tile<HW>::LEAD_BYTES)[i] = make_uint4(0, 0, 0, 0);
}

// acc = the stem conv (no bias) of the 64-row tile whose samples' tiles start
// at `tile`: four wgmma.m64n64k16, one accumulator chain, A built in
// registers by 32-bit word loads from the tile (k = 8 dy + dx + 1, so a
// k-pair is one word), B the stem tile at shared address b.
template <int HW>
__device__ __forceinline__ void stem_mma(const bf16* tile, uint32_t b, float (&acc)[32], int lane,
                                         int w) {
  using S = Stem<HW>;
  using T = Tile<HW>;
  const int g = lane / 4, t = lane % 4, y_all = w * S::RW + g / S::XP;
  const bf16* p0 = tile + y_all / S::CO * T::SIZE + 2 * (y_all % S::CO) * T::W +
                   4 * (g % S::XP) + 2 * t;  // row g: column x = 2 (g % XP), window at 2 x
  const bf16* p1 = p0 + 2;                   // row g + 8: column x + 1
  uint32_t a[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {  // k = 16 kk + ..: window rows 2 kk and 2 kk + 1
    a[kk][0] = ld32(p0 + 2 * kk * T::W);
    a[kk][1] = ld32(p1 + 2 * kk * T::W);
    a[kk][2] = ld32(p0 + (2 * kk + 1) * T::W);
    a[kk][3] = ld32(p1 + (2 * kk + 1) * T::W);
  }
  sm90::reg_fence(acc);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) sm90::reg_fence(a[kk][e]);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)  // the first step overwrites acc (scale-d 0)
    sm90::wgmma_m64n64k16_rs(acc, a[kk], sm90::desc_sw128(b + kk * 2048, 8192, 1024), kk > 0);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::reg_fence(acc);
}

// The pool's value pairs (channels 8j + 2t, + 1). K2 pools the raw fp32 sums
// and adds the bias and the relu to the pooled value, its first residual: the
// bias is the same across a window, rounding is monotone and relu commutes
// with max, so max fl(a_i + b) = fl(max a_i + b). K1 adds them first and pools
// packed bf16 (the max of the rounded values is the rounded max), so that a
// shuffle moves two channels.
template <class V> struct PoolPair;
template <> struct PoolPair<float2> {
  __device__ static float2 in(float a, float b, const float (&)[2]) { return make_float2(a, b); }
  __device__ static float2 out(float2 m, const float (&bias)[2]) {
    return make_float2(fmaxf(m.x + bias[0], 0.f), fmaxf(m.y + bias[1], 0.f));
  }
};
template <> struct PoolPair<uint32_t> {
  __device__ static uint32_t in(float a, float b, const float (&bias)[2]) {
    return av1::pack_bf16(fmaxf(a + bias[0], 0.f), fmaxf(b + bias[1], 0.f));
  }
  __device__ static uint32_t out(uint32_t m, const float (&)[2]) { return m; }
};
__device__ __forceinline__ float2 vmax(float2 a, float2 b) {
  return make_float2(fmaxf(a.x, b.x), fmaxf(a.y, b.y));
}
__device__ __forceinline__ uint32_t vmax(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r = __hmax2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}
__device__ __forceinline__ float2 shfl_up(float2 v, int d) {
  return make_float2(__shfl_up_sync(~0u, v.x, d), __shfl_up_sync(~0u, v.y, d));
}
__device__ __forceinline__ uint32_t shfl_up(uint32_t v, int d) { return __shfl_up_sync(~0u, v, d); }
__device__ __forceinline__ float2 shfl_idx(float2 v, int src) {
  return make_float2(__shfl_sync(~0u, v.x, src), __shfl_sync(~0u, v.y, src));
}
__device__ __forceinline__ uint32_t shfl_idx(uint32_t v, int src) {
  return __shfl_sync(~0u, v, src);
}
__device__ __forceinline__ float2 shfl_xor(float2 v, int d) {
  return make_float2(__shfl_xor_sync(~0u, v.x, d), __shfl_xor_sync(~0u, v.y, d));
}
__device__ __forceinline__ uint32_t shfl_xor(uint32_t v, int d) {
  return __shfl_xor_sync(~0u, v, d);
}

// Bias, relu and the 3x3/2 max-pool (pad 1) of a stem tile's accumulators, in
// registers. Returns the first of the 4 channel blocks this lane finishes of
// the pooled value at position p of the tile's sample s (m[q] holds block
// first + q, channels 8 (first + q) + 2t, + 1). A window's positions outside
// the conv are left out. Conv rows pair up, (2i, 2i + 1) in lanes l and
// l ^ 4 XP: the two trade halves, the even row's lane finishing blocks 0-3,
// the odd row's 4-7. The row above a pair (2i - 1) is, at 16 px, the previous
// warp's odd row, passed down through `edge` (Stem::EDGE pairs of the
// warpgroup) and the warpgroup's barrier `bar`; at 8 px, where a warp holds a
// whole sample, row 1, read by two shuffles. Every thread of the warpgroup
// calls this.
template <int HW, class V>
__device__ __forceinline__ int stem_pool(const float (&acc)[32], const float (&bias)[8][2],
                                         V* edge, int bar, int lane, int w, V (&m)[8], int& s,
                                         int& p) {
  using S = Stem<HW>;
  const int g = lane / 4, t = lane % 4, k = g % S::XP, y_all = w * S::RW + g / S::XP;
  const int y = y_all % S::CO, odd = y % 2;
  s = y_all / S::CO;
  p = y / 2 * S::SO + k;
#pragma unroll
  for (int j = 0; j < 8; ++j) {  // columns: 2k, 2k + 1 and lane g - 1's 2k - 1
    const V v0 = PoolPair<V>::in(acc[4 * j], acc[4 * j + 1], bias[j]);
    const V v1 = PoolPair<V>::in(acc[4 * j + 2], acc[4 * j + 3], bias[j]);
    const V left = shfl_up(v1, 4);
    m[j] = vmax(v0, v1);
    if (k > 0) m[j] = vmax(m[j], left);
  }
  V above[4];  // the row above the pair, this lane's half, where there is one
  if constexpr (S::RW == 2) {  // 16 px: the previous warp's odd row, after the barrier
    if (odd == 1 && w < 3) {
#pragma unroll
      for (int j = 0; j < 8; ++j) edge[((w * 8 + j) * S::XP + k) * 4 + t] = m[j];
    }
  } else {  // 8 px: row 1 (lanes 8 .. 15) for the pair (2, 3)
    const int src = 8 + lane % 8;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const V lo = shfl_idx(m[q], src), hi = shfl_idx(m[4 + q], src);
      above[q] = odd ? hi : lo;
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {  // the pair's own rows, by one trade
    const V mine = odd ? m[4 + q] : m[q];
    const V theirs = shfl_xor(odd ? m[q] : m[4 + q], 4 * S::XP);
    m[q] = vmax(mine, theirs);
  }
  if constexpr (S::RW == 2) {
    sm90::named_barrier(bar, 128);
    if (w > 0) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        m[q] = vmax(m[q], edge[(((w - 1) * 8 + 4 * odd + q) * S::XP + k) * 4 + t]);
    }
  } else if (y >= 2) {
#pragma unroll
    for (int q = 0; q < 4; ++q) m[q] = vmax(m[q], above[q]);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float b[2] = {odd ? bias[4 + q][0] : bias[q][0], odd ? bias[4 + q][1] : bias[q][1]};
    m[q] = PoolPair<V>::out(m[q], b);
  }
  return 4 * odd;
}

// m[q] = the old m[(q + k) % 4] for q < 4, k in 0 .. 3, without indexing
// registers by a runtime value: a rotation by 1 where k & 1, then by 2 where k & 2.
__device__ __forceinline__ void rotate_blocks(float2 (&m)[8], int k) {
#pragma unroll
  for (int step = 1; step <= 2; step *= 2) {
    float2 r[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) r[q] = (k & step) ? m[(q + step) % 4] : m[q];
#pragma unroll
    for (int q = 0; q < 4; ++q) m[q] = r[q];
  }
}

// x as a (batch, hw, hw) bf16 array read in boxes of (spb, hw + 6, hw + 8)
// from (b0, 0, 0): zeros outside the array, right of and below the pixels.
int encode_x_map(CUtensorMap* map, const void* x, int batch, int hw, int spb) {
  const uint64_t dims[3] = {uint64_t(hw), uint64_t(hw), uint64_t(batch)};
  const uint64_t strides[2] = {uint64_t(hw) * 2, uint64_t(hw) * hw * 2};
  const uint32_t box[3] = {uint32_t(hw + 8), uint32_t(hw + 6), uint32_t(spb)};
  return sm90::encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, x, dims, strides, box,
                          CU_TENSOR_MAP_SWIZZLE_NONE);
}

bool aligned16(const void* a, const void* b = nullptr) {
  return (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 16 == 0;
}

// ---- K1 --------------------------------------------------------------------

// K1's persistent blocks of two warpgroups, each a worker that walks over
// groups of G samples (TILES stem tiles): its input tiles double-buffered,
// its output staged in two buffers for the TMA store.
template <int HW>
struct K1Plan {
  using S = Stem<HW>;
  static constexpr int THREADS = 256;                      // two warpgroups, two workers
  static constexpr int TILES = HW == 16 ? 2 : 1;
  static constexpr int G = TILES * S::SPT;                 // samples of a group: 2 or 4
  static constexpr int OUT_ROWS = G * S::P;                // output rows a group: 32 or 16
  static constexpr int OUT_BYTES = OUT_ROWS * 128;         // whole 1,024-byte swizzle atoms
  static constexpr int IN_BYTES = G * Tile<HW>::SIZE * 2;  // the input box
  static constexpr int IN_STRIDE = Tile<HW>::LEAD_BYTES + (IN_BYTES + 127) / 128 * 128;
  static constexpr int WORKER =  // out[2], (lead, in)[2], edge[2], from a 1,024-byte boundary
      (2 * OUT_BYTES + 2 * IN_STRIDE + 2 * S::EDGE * 4 + 1023) / 1024 * 1024;
  static constexpr int O_BIAS = B_BYTES + 2 * WORKER + 4 * sizeof(uint64_t);
  static constexpr size_t SMEM = 1024 + O_BIAS + C * sizeof(float);
  static_assert(OUT_BYTES % 1024 == 0, "the staging buffers are whole swizzle atoms");
};

template <int HW>
__global__ void __launch_bounds__(K1Plan<HW>::THREADS, 2)  // two blocks an SM: 128 registers
fused_front_wgmma_kernel(const bf16* __restrict__ x, const __grid_constant__ CUtensorMap x_map,
                         const __grid_constant__ CUtensorMap out_map, int x_by_tma,
                         const bf16* __restrict__ stem_w, const float* __restrict__ stem_b,
                         int batch) {
  using K = K1Plan<HW>;
  using S = Stem<HW>;
  extern __shared__ uint8_t k1_smem_raw[];
  uint8_t* base = align_1024(k1_smem_raw);  // the stem's B tile
  const int wg = threadIdx.x / 128, wt = threadIdx.x % 128, w = wt / 32, lane = threadIdx.x % 32;
  uint8_t* stage0 = base + B_BYTES + wg * K::WORKER;  // two output buffers, then two inputs
  uint8_t* in0 = stage0 + 2 * K::OUT_BYTES + Tile<HW>::LEAD_BYTES;  // each after its lead
  uint32_t* edge = reinterpret_cast<uint32_t*>(in0 - Tile<HW>::LEAD_BYTES + 2 * K::IN_STRIDE);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + B_BYTES + 2 * K::WORKER);
  uint64_t* full = bars + 2 * wg;  // the worker's two input buffers
  float* bias_s = reinterpret_cast<float*>(base + K::O_BIAS);
  const int groups = (batch + K::G - 1) / K::G, workers = 2 * gridDim.x;
  auto fetch = [&](int worker, int group, int buf) {  // a group's samples, one box
    uint8_t* dst = base + B_BYTES + worker * K::WORKER + 2 * K::OUT_BYTES +
                   Tile<HW>::LEAD_BYTES + buf * K::IN_STRIDE;
    sm90::mbar_expect_tx(&bars[2 * worker + buf], K::IN_BYTES);
    sm90::tma_load_3d(dst, &x_map, &bars[2 * worker + buf], 0, 0, group * K::G);
  };
  if (threadIdx.x == 0) {  // both workers' first boxes, before anything else
    for (int i = 0; i < 4; ++i) sm90::mbar_init(&bars[i], 1);
    sm90::fence_barrier_init();
    if (x_by_tma) sm90::tma_prefetch_map(&x_map);
    sm90::tma_prefetch_map(&out_map);
    for (int i = 0; i < 2; ++i)
      if (x_by_tma && 2 * int(blockIdx.x) + i < groups) fetch(i, 2 * blockIdx.x + i, 0);
  }
  stem_b_tile<K::THREADS>(stem_w, base, threadIdx.x);
  if (threadIdx.x < C) bias_s[threadIdx.x] = __ldg(stem_b + threadIdx.x);  // one load a value
  zero_lead<HW>(in0, wt, 128);
  zero_lead<HW>(in0 + K::IN_STRIDE, wt, 128);
  __syncthreads();
  float bias[8][2];
  stage_bias(bias, bias_s, lane);
  __syncthreads();  // the last block-wide barrier: the workers run apart from here

  const int bar = 1 + wg;  // the worker's named barrier
  const bool leader = wt == 0;
  const uint32_t b = sm90::smem_u32(base);
  int group = 2 * blockIdx.x + wg;
#pragma unroll 1
  for (int i = 0; group < groups; group += workers, ++i) {
    const int buf = i & 1;
    bf16* box = reinterpret_cast<bf16*>(in0 + buf * K::IN_STRIDE);
    const bf16* tile = box - Tile<HW>::LEAD;
    uint8_t* stage = stage0 + buf * K::OUT_BYTES;
    if (x_by_tma) {  // the next group's box lands while this one computes
      if (leader && group + workers < groups) fetch(wg, group + workers, buf ^ 1);
      sm90::mbar_wait(&full[buf], (i >> 1) & 1);
    } else {
      load_box<HW>(x, int64_t(group) * K::G, min(K::G, batch - group * K::G), K::G, box, wt, 128,
                   bar);
    }
#pragma unroll
    for (int t = 0; t < K::TILES; ++t) {
      float acc[32];
      stem_mma<HW>(tile + t * S::SPT * Tile<HW>::SIZE, b, acc, lane, w);
      uint32_t m[8];
      int s, p;
      const int first = stem_pool<HW>(acc, bias, edge + (t & 1) * S::EDGE, bar, lane, w, m, s, p);
      const int row = (t * S::SPT + s) * S::P + p;  // sample-major, as the output
      uint8_t* r = stage + row * 128 + 4 * (lane % 4);
#pragma unroll
      for (int q = 0; q < 4; ++q)  // the 128-byte swizzle of the store's map
        *reinterpret_cast<uint32_t*>(r + (((first + q) ^ (row % 8)) << 4)) = m[q];
    }
    sm90::fence_proxy_async();  // the staging writes, before the store reads them
    sm90::named_barrier(bar, 128);
    if (leader) {
      sm90::tma_store_2d(&out_map, stage, 0, group * K::OUT_ROWS);
      sm90::tma_store_commit();
      sm90::tma_store_wait_read<1>();  // the previous group's store is done with its buffer
    }
    sm90::named_barrier(bar, 128);
  }
  if (leader) sm90::tma_store_wait_read<0>();  // the staging outlives no store that reads it
}

template <int HW>
int launch_front_wgmma(const void* x, const void* w, const void* b, void* out, int batch,
                       cudaStream_t st) {
  using K = K1Plan<HW>;
  static const cudaError_t attr =  // once per kernel, not per launch
      cudaFuncSetAttribute(fused_front_wgmma_kernel<HW>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, int(K::SMEM));
  if (attr != cudaSuccess) return int(attr);
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 1;
  }();
  // the maps hold x's and out's addresses: encoded at each call, a few hundred
  // nanoseconds of host time
  CUtensorMap x_map, out_map;
  memset(&x_map, 0, sizeof(x_map));
  const int x_by_tma = aligned16(x);
  if (x_by_tma) {
    const int err = encode_x_map(&x_map, x, batch, HW, K::G);
    if (err != 0) return err;
  }
  const int err = sm90::encode_map_2d(&out_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, out,
                                      uint64_t(batch) * Stem<HW>::P, C, C * sizeof(bf16),
                                      K::OUT_ROWS, C, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  const int groups = (batch + K::G - 1) / K::G;
  const int grid = (groups + 1) / 2 < 2 * sms ? (groups + 1) / 2 : 2 * sms;
  fused_front_wgmma_kernel<HW><<<grid, K::THREADS, K::SMEM, st>>>(
      static_cast<const bf16*>(x), x_map, out_map, x_by_tma, static_cast<const bf16*>(w),
      static_cast<const float*>(b), batch);
  return int(cudaGetLastError());
}

// ---- K2 --------------------------------------------------------------------

// K2's block: K5's layer-1 geometry at extent E = hw / 4 (ROWS rows, SPB
// samples, position-major), one consumer warpgroup a 64-row layer-1 tile
// (four at 16 px, two at 8 px), plus the producer warp; its shared memory.
template <int HW>
struct G1Plan {
  static constexpr int E = HW / 4, P = E * E;
  static constexpr int ROWS = E == 2 ? 128 : 256;           // 4,096 samples: 128 or 256 blocks
  static constexpr int SPB = ROWS / P;                      // samples: 16 (16 px) or 32 (8 px)
  static constexpr int NWG = ROWS / 64;                     // consumer warpgroups
  static constexpr int CONSUMERS = NWG * 128, THREADS = CONSUMERS + 32;
  static constexpr int STEM_TILES = SPB / Stem<HW>::SPT;    // the stem's 64-row tiles: 16 or 8
  static constexpr int SLOT = KC * C * 2;                   // a chunk: 64 k-rows x 64 columns
  static constexpr int TILE_BYTES = SPB * Tile<HW>::SIZE * 2;  // the input box
  static constexpr int PLANE = ROWS * PITCH;                // elements of a bf16 plane
  static constexpr int SE_W = 2 * SE_HIDDEN * C;            // d0 and d1, staged
  static constexpr int BIASES = 5 * C;                      // the stem's and the 4 convs', staged
  // byte offsets from a 1,024-byte boundary: ring, stem B, lead and box, planes, SE1's
  // weights, zero row, barriers
  static constexpr int O_B = STAGES * SLOT, O_TILE = O_B + B_BYTES + Tile<HW>::LEAD_BYTES;
  static constexpr int O_ZIN = O_TILE + (TILE_BYTES + 127) / 128 * 128;
  static constexpr int O_H = O_ZIN + 2 * PLANE, O_RES = O_H + 2 * PLANE;
  static constexpr int O_SE = O_RES + 4 * ROWS * FPITCH, O_BIAS = O_SE + 4 * SE_W;
  static constexpr int O_ZERO = O_BIAS + 4 * BIASES;
  static constexpr int O_BARS = O_ZERO + 2 * PITCH;
  static constexpr size_t SMEM = 1024 + O_BARS + (2 * STAGES + 1) * sizeof(uint64_t);
  static_assert(STEM_TILES % NWG == 0, "the stem's tiles split evenly");
  static_assert(SE_W % CONSUMERS == 0, "SE1's weights split evenly");
  static_assert(NWG * 2 * Stem<HW>::EDGE * sizeof(float2) <= 2 * PLANE, "the edges fit in h");
  static_assert(SPB * C * sizeof(float) <= 2 * PLANE, "SE1's gates fit in h");
  static_assert(SE_HIDDEN == 4 && C == 64 && SPB % (CONSUMERS / 32) == 0,
                "SE1 runs a warp a sample, two channels a lane");
};

template <class G>
__device__ __forceinline__ void g1_sync() {
  sm90::named_barrier(CONSUMER_BARRIER, G::CONSUMERS);
}

// A layer-1 basic block on one bf16 plane: zin (the rounded residual) is
// conv J's input, h the mid activation, res the fp32 residual and output:
// res = relu(conv2(relu(conv1(zin) + b1)) + b2 + res), zin = bf16(res); the
// biases b1, b2 in shared memory. This warpgroup's tile: rows row0 .. row0 + 63.
template <int J, class G, class R>
__device__ __forceinline__ void g1_block(bf16* zin, float* res, bf16* h, uint32_t zero,
                                         const float* b1, const float* b2, int row0,
                                         const TileTaps& tt, int tile, R& ring, int lane) {
  float acc[1][1][32], bias[8][2];
  zero_acc(acc);
  conv_wg<J, G::E, G::E, 1, C, PITCH, G::SPB, G::ROWS, 1, 1>(acc, zin, nullptr, zero, row0, 0,
                                                             tt, tile, ring, lane);
  stage_bias(bias, b1, lane);
  for_each_pair(acc, bias, row0, 0, lane, [&](int row, int col, float v0, float v1) {
    *reinterpret_cast<uint32_t*>(h + row * PITCH + col) =
        av1::pack_bf16(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
  });
  g1_sync<G>();
  zero_acc(acc);
  conv_wg<J + 1, G::E, G::E, 1, C, PITCH, G::SPB, G::ROWS, 1, 1>(acc, h, nullptr, zero, row0, 0,
                                                                 tt, tile, ring, lane);
  stage_bias(bias, b2, lane);
  for_each_pair(acc, bias, row0, 0, lane, [&](int row, int col, float v0, float v1) {
    float2* r = reinterpret_cast<float2*>(res + row * FPITCH + col);
    const float2 z = *r;
    const float o0 = fmaxf(v0 + z.x, 0.f), o1 = fmaxf(v1 + z.y, 0.f);
    *r = make_float2(o0, o1);
    *reinterpret_cast<uint32_t*>(zin + row * PITCH + col) = av1::pack_bf16(o0, o1);
  });
  g1_sync<G>();
}

template <int HW>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(G1Plan<HW>::THREADS, 1)
fused_front_g1_wgmma_kernel(const bf16* __restrict__ x, const __grid_constant__ CUtensorMap x_map,
                            const __grid_constant__ CUtensorMap w_map, const TileTaps tt,
                            int x_by_tma, const bf16* __restrict__ stem_w,
                            const float* __restrict__ stem_b, const float* __restrict__ conv_b,
                            const float* __restrict__ d0, const float* __restrict__ d1,
                            bf16* __restrict__ out, int batch) {
  using G = G1Plan<HW>;
  using S = Stem<HW>;
  constexpr int P = G::P, SPB = G::SPB, NT = G::CONSUMERS;
  extern __shared__ uint8_t g1_smem_raw[];
  uint8_t* base = align_1024(g1_smem_raw);  // the ring's slots
  bf16* box = reinterpret_cast<bf16*>(base + G::O_TILE);
  bf16* zin = reinterpret_cast<bf16*>(base + G::O_ZIN);    // conv input: the residual, rounded
  bf16* h = reinterpret_cast<bf16*>(base + G::O_H);        // mid activation; edges; SE scratch
  float* res = reinterpret_cast<float*>(base + G::O_RES);  // block input / residual / output
  float* se_w = reinterpret_cast<float*>(base + G::O_SE);  // d0 (4 x 64), then d1 (64 x 4)
  float* bias_s = reinterpret_cast<float*>(base + G::O_BIAS);  // stem_b, then conv_b (4 x 64)
  bf16* zero_row = reinterpret_cast<bf16*>(base + G::O_ZERO);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + G::O_BARS);
  uint64_t* x_full = bars + 2 * STAGES;
  Ring<G::SLOT> ring{base, bars, bars + STAGES, 0};
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int64_t b0 = int64_t(blockIdx.x) * SPB;
  const int n = int(batch - b0 < SPB ? batch - b0 : SPB);  // samples to store (<= 0: none)

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&ring.full[s], 1);
      sm90::mbar_init(&ring.empty[s], CLUSTER * G::NWG);
    }
    sm90::mbar_init(x_full, 1);
    sm90::fence_barrier_init();
  }
  // the consumers' loads of the weights they stage go out before the cluster's
  // barrier, whose wait covers their latency
  constexpr int NBIAS = (G::BIASES + NT - 1) / NT;
  float se_v[G::SE_W / NT], bias_v[NBIAS];
  if (threadIdx.x < NT) {
#pragma unroll
    for (int q = 0; q < NBIAS; ++q) {
      const int i = threadIdx.x + q * NT;
      bias_v[q] = i < C ? __ldg(stem_b + i) : i < G::BIASES ? __ldg(conv_b + i - C) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < G::SE_W / NT; ++q) {
      const int i = threadIdx.x + q * NT;
      se_v[q] = __ldg(i < SE_HIDDEN * C ? d0 + i : d1 + i - SE_HIDDEN * C);
    }
  }
  sm90::cluster_sync();  // every block's barriers exist before any TMA or remote arrive

  if (warp == NT / 32) {  // the producer warp: its first lane fetches
    if (lane == 0) {
      if (x_by_tma) {  // the block's samples, one box
        sm90::tma_prefetch_map(&x_map);
        sm90::mbar_expect_tx(x_full, G::TILE_BYTES);
        sm90::tma_load_3d(box, &x_map, x_full, 0, 0, int(b0));
      }
      sm90::tma_prefetch_map(&w_map);
      produce<4>(&w_map, &w_map, tt, ring);  // layer 1's chunks, from the stem on
    }
    __syncwarp();
    sm90::cluster_sync();  // no block leaves while its peer may still write to it
    return;
  }

  const int wg = warp / 4, w = warp % 4;
  stem_b_tile<NT>(stem_w, base + G::O_B, threadIdx.x);
#pragma unroll
  for (int q = 0; q < G::SE_W / NT; ++q)  // values of bf16
    se_w[threadIdx.x + q * NT] = round_to<bf16>(se_v[q]);
#pragma unroll
  for (int q = 0; q < NBIAS; ++q)
    if (threadIdx.x + q * NT < G::BIASES) bias_s[threadIdx.x + q * NT] = bias_v[q];
  for (int i = threadIdx.x; i < PITCH / 2; i += NT) reinterpret_cast<uint32_t*>(zero_row)[i] = 0;
  zero_lead<HW>(base + G::O_TILE, threadIdx.x, NT);
  if (!x_by_tma) load_box<HW>(x, b0, n, SPB, box, threadIdx.x, NT, CONSUMER_BARRIER);
  g1_sync<G>();
  float bias[8][2];
  stage_bias(bias, bias_s, lane);
  if (x_by_tma) sm90::mbar_wait(x_full, 0);

  // ---- stem + pool: the fp32 value into res, its rounding into zin; row
  // p * SPB + s. Warpgroup wg takes STEM_TILES / NWG of the stem's tiles.
  {
    constexpr int PER_WG = G::STEM_TILES / G::NWG;
    const uint32_t b = sm90::smem_u32(base + G::O_B);
    const bf16* tile = box - Tile<HW>::LEAD;
    float2* edge = reinterpret_cast<float2*>(h) + wg * 2 * S::EDGE;
#pragma unroll 1
    for (int i = 0; i < PER_WG; ++i) {
      const int st = wg * PER_WG + i;  // samples st * SPT ..
      float acc[32];
      stem_mma<HW>(tile + st * S::SPT * Tile<HW>::SIZE, b, acc, lane, w);
      float2 m[8];
      int s, p;
      const int first = stem_pool<HW>(acc, bias, edge + (i & 1) * S::EDGE,
                                      WARPGROUP_BARRIER + wg, lane, w, m, s, p);
      // The rows a warp writes (four positions of a sample) lie SPB rows apart,
      // on the same banks: each lane writes its channel blocks rotated by its
      // position, so that one store's lanes meet distinct banks.
      const int rot = p % 4;
      rotate_blocks(m, rot);
      const int row = p * SPB + st * S::SPT + s;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = 8 * (first + (q + rot) % 4) + 2 * (lane % 4);
        *reinterpret_cast<float2*>(res + row * FPITCH + col) = m[q];
        *reinterpret_cast<uint32_t*>(zin + row * PITCH + col) = av1::pack_bf16(m[q].x, m[q].y);
      }
    }
  }
  g1_sync<G>();  // zin is whole; h is free

  // ---- layer1_0, layer1_1: warpgroup wg owns 64-row tile wg
  {
    const uint32_t zero = sm90::smem_u32(zero_row);
    const float* cb = bias_s + C;  // conv_b, staged
    g1_block<L10_C1, G>(zin, res, h, zero, cb, cb + C, wg * 64, tt, wg, ring, lane);
    g1_block<L11_C1, G>(zin, res, h, zero, cb + 2 * C, cb + 3 * C, wg * 64, tt, wg, ring, lane);
  }

  // ---- SE1, each matmul operand a bf16 value: the mean of the rounded output
  // (zin), rounded; the hidden vector, rounded; the gate, rounded. One warp a
  // sample, lane l its channels 2l and 2l + 1, in registers; fixed summation
  // orders (positions in turn, the hidden sums by a butterfly), so the output
  // is the same on every run and batch split.
  float* gate = reinterpret_cast<float*>(h);  // SPB x C
#pragma unroll
  for (int i = 0; i < SPB / (NT / 32); ++i) {  // the warp's samples, their chains interleaved
    const int s = warp + i * (NT / 32);
    float2 sum = make_float2(0.f, 0.f);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float2 v = av1::unpack_bf16(
          *reinterpret_cast<const uint32_t*>(zin + (p * SPB + s) * PITCH + 2 * lane));
      sum = make_float2(sum.x + v.x, sum.y + v.y);
    }
    const float g0 = round_to<bf16>(sum.x / P), g1 = round_to<bf16>(sum.y / P);
    float hid[SE_HIDDEN];
#pragma unroll
    for (int r = 0; r < SE_HIDDEN; ++r) {
      const float2 w = *reinterpret_cast<const float2*>(se_w + r * C + 2 * lane);
      float v = fmaf(w.y, g1, w.x * g0);
#pragma unroll
      for (int d = 16; d > 0; d /= 2) v += __shfl_xor_sync(~0u, v, d);
      hid[r] = round_to<bf16>(fmaxf(v, 0.f));
    }
    float e[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float4 w = *reinterpret_cast<const float4*>(se_w + SE_HIDDEN * C +
                                                        (2 * lane + c) * SE_HIDDEN);
      const float z = fmaf(w.w, hid[3], fmaf(w.z, hid[2], fmaf(w.y, hid[1], w.x * hid[0])));
      e[c] = round_to<bf16>(1.f / (1.f + expf(-z)));
    }
    *reinterpret_cast<float2*>(gate + s * C + 2 * lane) = make_float2(e[0], e[1]);
  }
  g1_sync<G>();

  // ---- the output, scaled as it is written, back in sample order, 16 bytes a store
  bf16* ob = out + b0 * P * C;
#pragma unroll
  for (int it = 0; it < G::ROWS * (C / 8) / NT; ++it) {
    const int i = threadIdx.x + it * NT;
    const int dst = i / (C / 8), col = i % (C / 8) * 8;  // dst = s * P + p
    const int s = dst / P, p = dst % P;
    if (s >= n) continue;
    const float* r = res + (p * SPB + s) * FPITCH + col;
    const float4 z0 = *reinterpret_cast<const float4*>(r);
    const float4 z1 = *reinterpret_cast<const float4*>(r + 4);
    const float4 e0 = *reinterpret_cast<const float4*>(gate + s * C + col);
    const float4 e1 = *reinterpret_cast<const float4*>(gate + s * C + col + 4);
    *reinterpret_cast<uint4*>(ob + dst * C + col) = make_uint4(
        av1::pack_bf16(z0.x * e0.x, z0.y * e0.y), av1::pack_bf16(z0.z * e0.z, z0.w * e0.w),
        av1::pack_bf16(z1.x * e1.x, z1.y * e1.y), av1::pack_bf16(z1.z * e1.z, z1.w * e1.w));
  }
  sm90::cluster_sync();
}

template <int HW>
int launch_front_g1_wgmma(const void* x, const CUtensorMap& w_map, const TileTaps& tt,
                          const void* sw, const void* sb, const void* cb, const void* d0,
                          const void* d1, void* out, int batch, cudaStream_t st) {
  using G = G1Plan<HW>;
  static const cudaError_t attr =  // once per kernel, not per launch
      cudaFuncSetAttribute(fused_front_g1_wgmma_kernel<HW>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, int(G::SMEM));
  if (attr != cudaSuccess) return int(attr);
  CUtensorMap x_map;  // x's address: encoded at each call
  memset(&x_map, 0, sizeof(x_map));
  const int x_by_tma = aligned16(x);
  if (x_by_tma) {
    const int err = encode_x_map(&x_map, x, batch, HW, G::SPB);
    if (err != 0) return err;
  }
  const int blocks = (batch + G::SPB - 1) / G::SPB;
  const int grid = (blocks + CLUSTER - 1) / CLUSTER * CLUSTER;  // whole clusters
  fused_front_g1_wgmma_kernel<HW><<<grid, G::THREADS, G::SMEM, st>>>(
      static_cast<const bf16*>(x), x_map, w_map, tt, x_by_tma, static_cast<const bf16*>(sw),
      static_cast<const float*>(sb), static_cast<const float*>(cb),
      static_cast<const float*>(d0), static_cast<const float*>(d1), static_cast<bf16*>(out),
      batch);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError() (0 on
// success); it neither allocates nor synchronises. `bf16` selects the dtype
// of activations and conv weights (0: fp32, on the CUDA cores; 1: bf16, on the
// tensor cores); biases and SE weights are fp32. With bf16, `out` and `conv_w`
// must be 16-byte aligned; `x` may start at any element (off the 16-byte grid
// it is loaded by elements instead of by TMA).

int av1_fused_front(const void* x, const void* stem_w, const void* stem_b, void* out,
                    int batch, int hw, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || (hw != 8 && hw != 16)) return int(cudaErrorInvalidValue);
  if (!bf16)
    return hw == 16 ? launch_front<16, float>(x, stem_w, stem_b, out, batch, st)
                    : launch_front<8, float>(x, stem_w, stem_b, out, batch, st);
  if (!aligned16(out)) return int(cudaErrorInvalidValue);
  return hw == 16 ? launch_front_wgmma<16>(x, stem_w, stem_b, out, batch, st)
                  : launch_front_wgmma<8>(x, stem_w, stem_b, out, batch, st);
}

// Encodes the TMA map of K2's conv_w (4, 9, 64, 64) bf16 into `map_out` (host
// memory, 128 bytes): a 2,304 x 64 array in boxes of 32 rows x 64 columns
// with the 128-byte swizzle, as K5's map of the head of its conv stream. It
// holds the address and the geometry, never the values. Returns 0 or a
// cudaError_t.
int av1_fused_front_g1_encode_map(const void* conv_w, void* map_out) {
  if (conv_w == nullptr || map_out == nullptr || !aligned16(conv_w))
    return int(cudaErrorInvalidValue);
  CUtensorMap map;
  const int err = sm90::encode_map_2d(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, conv_w,
                                      uint64_t(av1::convwg::CHUNKS1) * KC, C, C * sizeof(bf16),
                                      av1::convwg::BOX_ROWS, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  memcpy(map_out, &map, sizeof(map));
  return 0;
}

// With bf16, `conv_map` is conv_w's map from av1_fused_front_g1_encode_map
// and `tile_taps` the 9 x 4 tap masks of kernels/resnet_group.py
// group12_tile_taps at extent hw / 4 (layer 1 reads rows 0-3), both host
// memory; fp32 reads neither.
int av1_fused_front_g1(const void* x, const void* stem_w, const void* stem_b,
                       const void* conv_w, const void* conv_b, const void* se_d0,
                       const void* se_d1, const void* conv_map, const uint16_t* tile_taps,
                       void* out, int batch, int hw, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || (hw != 8 && hw != 16)) return int(cudaErrorInvalidValue);
  if (!bf16)
    return hw == 16 ? launch_front_g1<16, float>(x, stem_w, stem_b, conv_w, conv_b, se_d0,
                                                 se_d1, out, batch, st)
                    : launch_front_g1<8, float>(x, stem_w, stem_b, conv_w, conv_b, se_d0,
                                                se_d1, out, batch, st);
  if (conv_map == nullptr || tile_taps == nullptr || !aligned16(out, conv_w))
    return int(cudaErrorInvalidValue);
  CUtensorMap w_map;
  memcpy(&w_map, conv_map, sizeof(w_map));
  TileTaps tt;
  memcpy(tt.taps, tile_taps, sizeof(tt.taps));
  return hw == 16 ? launch_front_g1_wgmma<16>(x, w_map, tt, stem_w, stem_b, conv_b, se_d0, se_d1,
                                              out, batch, st)
                  : launch_front_g1_wgmma<8>(x, w_map, tt, stem_w, stem_b, conv_b, se_d0, se_d1,
                                             out, batch, st);
}

const char* av1_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
