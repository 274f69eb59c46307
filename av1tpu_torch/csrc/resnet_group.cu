// Layer groups 1 and 2 of the v6 backbone with both SE gates, for Hopper (sm_90a).
//
// K5  av1_fused_group12 replaces av1tpu/kernels/resnet_group.py fused_group12:
//     layer1_0 and layer1_1 (3x3/1 SAME convs, identity residual), SE1, then
//     layer2_0 (3x3/2 conv with XLA-SAME padding (0, 1), and a 1x1/2
//     downsample on the even positions), layer2_1 and SE2, all on BN-folded
//     weights. NHWC (B, E, E, 64) -> (B, E/2, E/2, 128) for E in
//     {2, 4, 8, 16}: the post-maxpool extents of 8, 16, 32 and 64 px blocks.
//
// Numerics follow the TPU kernel: the input and all 22 weight arrays come in
// the serving dtype (fp32 or bf16), every intermediate is kept beyond that
// dtype, and only the output is rounded. (K2 rounds each conv input to the
// weight dtype; K5 does not.)
//
// What bounds it on an H100. The eight 3x3 convs and the downsample are
// ~278 k x E^2 MACs per sample with every tap counted, fewer with the taps
// that fall outside the image left out (the bound counts valid taps only,
// examples/_bench.py backbone_flops: 21.8 GFLOP at 4096 x extent 4, 0.022 ms
// of bf16 tensor-core time). For 2 KB of input and 1 KB of output a sample it
// is bound by operations. The two passes below (hi and lo) cap the kernel at
// half that bound. The traffic that matters is the weights: 0.675 M values
// (1.35 MB in bf16) do not fit in shared memory and every block streams them
// from L2.
//
// bf16 (the serving dtype): fused_group12_wgmma_kernel, tensor cores. Its
// conv routine, weight ring, producer and tap table are csrc/conv_wgmma.cuh,
// shared with K2 (fused_front.cu), which runs layer 1 on one plane.
//   * Every conv is an implicit GEMM on wgmma.m64n64k16 (hopper.cuh). Rows
//     are (sample, output position), K is tap x ci, N is 64 or 128. A block
//     holds SPB = ROWS1 / E^2 samples: ROWS1 = 256 rows in layer 1 (128 at
//     E = 2, so that 4,096 samples make 128 blocks), a quarter of that in
//     layer 2 (one 64-row tile, half of it padding at E = 2). Two consumer
//     warpgroups: in layer 1 each owns ROWS1 / 2 rows (tiles of 64) x 64
//     columns, in layer 2 the one tile x 64 of the 128 columns.
//   * A from registers, B from shared memory. Each lane computes the address
//     of its row's input row for each tap (the window shift, the stride-2
//     start 2*o, the sample), ldmatrix builds the A fragments (the register
//     layout of wgmma's A is mma.sync's, a warp 16 rows), and a tap outside
//     the image (SAME's border, XLA's pad (0, 1)) points at one shared row of
//     zeros. No border is stored; a row is 64 (128) channels at a pitch of
//     144 (272) bytes, odd multiples of 16, so ldmatrix is conflict-free.
//   * Rows are position-major inside the block (row p * SPB + s), so a tile
//     holds whole positions and the taps outside the image are the same for
//     all its rows: the host's table (kernels/resnet_group.py
//     group12_tile_taps) gives each tile the taps it computes, and a tap no
//     tile of the block computes is not fetched. At E = 2 that skips 5 of
//     layer2_0.conv1's 9 chunks and 16 of 18 of each 128-wide stride-1 conv;
//     in layer 1 a tile of the image's top or bottom row skips 3 of 9 taps.
//     The output is written back in sample order.
//   * fp32 inside, to 16 bits. An activation v lives in shared memory as two
//     bf16 planes, hi = bf16(v) and lo = bf16(v - hi); each B chunk feeds two
//     wgmmas (lo, then hi) into fp32 accumulators. Products carry 16 bits of
//     the activation (2^-17 relative); the residual and the SE mean read hi +
//     lo.
//   * A chunk's wgmmas alternate between two accumulators (a warpgroup's two
//     tiles, or a lone tile's two planes), so that none waits on the sum of
//     the one before. Which of its tiles compute a chunk is one of three
//     patterns, each compiled on its own: ptxas serialises wgmmas that sit
//     behind a condition it cannot see through. One producer warp runs the
//     ring; 288 threads leave ptxas 168 registers a thread (three warps share
//     a sub-partition), enough for two tiles' accumulators and A fragments.
//   * Weights: the nine conv kernels are concatenated once, when the pipeline
//     is built, into one stream in the order of use ([tap][ci][co] is
//     k-major, so the stream is 36 chunks of 64 k-rows x 64 columns, then 64
//     of 64 x 128). Two TMA maps, encoded once per stream by the host, view
//     it as a 2,304 x 64 and a 4,096 x 128 array in 64-column boxes (the
//     128-byte swizzle, which wgmma reads as an MN-major B). Blocks run in
//     clusters of two: each block's producer warp fetches half of every
//     chunk's rows and multicasts it to both, so one L2 read serves two
//     blocks. A ring of 4 slots with full and empty mbarriers (the empty one
//     counts both blocks' consumer warpgroups, one arrival each once its
//     wgmmas are done) runs ahead of the math straight through the
//     boundaries between convs; block-wide barriers (of the consumers) remain
//     only where a conv's output must be complete before the next conv reads
//     shifted rows.
//   * layer2_0: the 1x1/2 downsample is one more chunk summed into the second
//     conv's accumulators; the sum replaces group 1's output only after a
//     barrier, when no warp reads that output any more.
//   * SE1 and SE2 run from shared memory; their scratch lies in the mid
//     planes, which are free then; the mean sums positions in a fixed order
//     (no atomics). SE2's scale is applied as the output is written, 16
//     bytes a store. A short last block, and a block that only pads the grid
//     to whole clusters, computes on zero samples and stores only those
//     inside the batch.
//
// fp32 (the parity mode): fused_group12_kernel, the first version, on CUDA
// cores, unchanged:
//   * 256 threads; a block serves SPB samples (8/4/2/1 at E = 2/4/8/16). Each
//     sample has two regions of fp32 activations in dynamic shared memory,
//     with a zero border of 1 so the conv loops need no bounds checks.
//     Region 0 holds a group's input, residual and output (updated in
//     place), region 1 the mid-block activation.
//   * A conv's output rows (sample, position) are cut into tiles of up to 16
//     rows; thread (co, group) accumulates output channel co of one tile in
//     registers. Each weight load (coalesced over co, through L1/L2) feeds
//     one FMA per row of the tile; activations are float4 broadcasts from
//     shared memory (all lanes of a warp read the same row).
//   * Stride 2: the window of output o starts at input 2*o, and the missing
//     high-side row and column read the zero border: XLA's pad (0, 1). The
//     downsample is the 1x1 tap at the window's start, summed into the same
//     registers as layer2_0's second conv.

#include <string.h>

#include "common.cuh"
#include "conv_wgmma.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace {

using av1::from_f;
using av1::ldg_f;
using av1::to_f;
using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;  // the fp32 kernel's block

constexpr int C1 = 64, C2 = 128;  // layer-1 and layer-2 widths
constexpr int SE1_H = C1 / 16, SE2_H = C2 / 16;
constexpr int MAX_RT = 16;        // rows per tile
constexpr int N_WEIGHTS = 22;

// The 22 weight arrays, in the order of kernels/resnet_group.py PACK_ORDER.
enum {
  L10_K1, L10_B1, L10_K2, L10_B2, L11_K1, L11_B1, L11_K2, L11_B2, SE1_D0, SE1_D1,
  L20_K1, L20_B1, L20_K2, L20_B2, L20_DSK, L20_DSB,
  L21_K1, L21_B1, L21_K2, L21_B2, SE2_D0, SE2_D1,
};

struct Weights {
  const void* p[N_WEIGHTS];
};

template <typename T>
__device__ __forceinline__ const T* wp(const Weights& w, int i) {
  return static_cast<const T*>(w.p[i]);
}

constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int cmin(int a, int b) { return a < b ? a : b; }

// An activation buffer: E x E positions of CH channels (channel fastest)
// inside a zero border of 1.
template <int E, int CH>
struct Act {
  static constexpr int W = E + 2;
  static constexpr int FLOATS = W * W * CH;
  __host__ __device__ static constexpr int interior(int p) {
    return ((p / E + 1) * W + p % E + 1) * CH;
  }
};

template <int E>
struct Plan {
  static constexpr int E2 = E / 2;
  using A1 = Act<E, C1>;
  using A2 = Act<E2, C2>;
  static constexpr int REGION = cmax(A1::FLOATS, A2::FLOATS);  // floats per sample
  static constexpr int SPB = E >= 16 ? 1 : E == 8 ? 2 : E == 4 ? 4 : 8;
  static constexpr size_t SMEM =
      sizeof(float) * (2 * SPB * REGION + SPB * (C2 + SE2_H));
};

// The output rows (sample, position) of a conv with output extent OE,
// stride S and CI input channels, reading buffers of input extent IE whose
// samples lie REGION floats apart. Rows run sample-major. Tile sizes, OE and
// the sample count are powers of two, so row j of any tile lies off(j) floats
// after the tile's first row.
template <int OE, int S, int CI, int IE, int REGION>
struct Rows {
  static constexpr int P = OE * OE;
  static constexpr int IW = IE + 2;
  __host__ __device__ static constexpr int off(int r) {
    return (r / P) * REGION + (((r % P) / OE) * S * IW + (r % P) % OE * S) * CI;
  }
  // offset of the first tap of row r's window in the input buffer
  __host__ __device__ static constexpr int window(int r) {
    return off(r) + (S == 2 ? (IW + 1) * CI : 0);
  }
};

// offset of output row r in an Act<OE, CO> buffer
template <int OE, int CO, int REGION>
__device__ __forceinline__ int dest(int r) {
  return (r / (OE * OE)) * REGION + Act<OE, CO>::interior(r % (OE * OE));
}

// How ROWS output rows of a conv with CO channels split over the threads.
template <int ROWS, int CO>
struct Tiling {
  static constexpr int G = THREADS / CO;             // thread groups
  static constexpr int RT = cmin(MAX_RT, ROWS / G);  // rows per tile
  static constexpr int TILES = ROWS / RT;
  static_assert(RT >= 1 && TILES % G == 0, "rows must split evenly");
};

// acc[j] += the conv of output channel co at the RT rows of a tile whose
// first window starts at `in`; w is [tap][ci][co].
template <int CI, int CO, int TAPS, int RT, class R, typename T>
__device__ __forceinline__ void conv_acc(const float* __restrict__ in,
                                         const T* __restrict__ w, int co,
                                         float (&acc)[RT]) {
#pragma unroll 1
  for (int tap = 0; tap < TAPS; ++tap) {
    const float* it = in + ((tap / 3) * R::IW + tap % 3) * CI;
    const T* wt = w + tap * CI * CO + co;
#pragma unroll 2
    for (int ci = 0; ci < CI; ci += 4) {
      const float w0 = ldg_f(wt + (ci + 0) * CO), w1 = ldg_f(wt + (ci + 1) * CO);
      const float w2 = ldg_f(wt + (ci + 2) * CO), w3 = ldg_f(wt + (ci + 3) * CO);
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        const float4 a = *reinterpret_cast<const float4*>(it + R::off(j) + ci);
        acc[j] = fmaf(a.x, w0, acc[j]);
        acc[j] = fmaf(a.y, w1, acc[j]);
        acc[j] = fmaf(a.z, w2, acc[j]);
        acc[j] = fmaf(a.w, w3, acc[j]);
      }
    }
  }
}

template <int RT>
__device__ __forceinline__ void zero(float (&acc)[RT]) {
#pragma unroll
  for (int j = 0; j < RT; ++j) acc[j] = 0.f;
}

// A stride-1 basic block at extent E with CH channels, in place on `a`
// (input, residual and output), with `h` for the mid activation:
// a = relu(conv2(relu(conv1(a) + b1)) + b2 + a).
template <int E, int CH, int SPB, int REGION, typename T>
__device__ void block_s1(float* a, float* h, const T* k1, const T* b1, const T* k2,
                         const T* b2) {
  using R = Rows<E, 1, CH, E, REGION>;
  using TL = Tiling<SPB * E * E, CH>;
  constexpr int RT = TL::RT;
  const int co = threadIdx.x % CH, g = threadIdx.x / CH;
  const float bias1 = ldg_f(b1 + co), bias2 = ldg_f(b2 + co);
  float acc[RT];
#pragma unroll 1
  for (int t = g; t < TL::TILES; t += TL::G) {
    zero(acc);
    conv_acc<CH, CH, 9, RT, R>(a + R::window(t * RT), k1, co, acc);
#pragma unroll
    for (int j = 0; j < RT; ++j)
      h[dest<E, CH, REGION>(t * RT + j) + co] = fmaxf(acc[j] + bias1, 0.f);
  }
  __syncthreads();
#pragma unroll 1
  for (int t = g; t < TL::TILES; t += TL::G) {
    zero(acc);
    conv_acc<CH, CH, 9, RT, R>(h + R::window(t * RT), k2, co, acc);
#pragma unroll
    for (int j = 0; j < RT; ++j) {
      float* d = a + dest<E, CH, REGION>(t * RT + j) + co;
      *d = fmaxf(acc[j] + bias2 + *d, 0.f);
    }
  }
  __syncthreads();
}

// The SE gates of SPB samples of an Act<E, CH> buffer `a`:
// gate[s][c] = sigmoid(d1 . relu(d0 . mean_p a[s][p])), d0 (HID, CH) and
// d1 (CH, HID) in Linear layout. `hid` is SPB x HID scratch.
template <int E, int CH, int HID, int SPB, int REGION, typename T>
__device__ void se_gate(const float* a, const T* d0, const T* d1, float* gate,
                        float* hid) {
  using A = Act<E, CH>;
  for (int i = threadIdx.x; i < SPB * CH; i += THREADS) {
    const float* as = a + (i / CH) * REGION + i % CH;
    float sum = 0.f;
    for (int p = 0; p < E * E; ++p) sum += as[A::interior(p)];
    gate[i] = sum / (E * E);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < SPB * HID; i += THREADS) {
    const float* gs = gate + (i / HID) * CH;
    const T* w = d0 + (i % HID) * CH;
    float v = 0.f;
    for (int k = 0; k < CH; ++k) v = fmaf(ldg_f(w + k), gs[k], v);
    hid[i] = fmaxf(v, 0.f);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < SPB * CH; i += THREADS) {
    const float* hs = hid + (i / CH) * HID;
    const T* w = d1 + (i % CH) * HID;
    float e = 0.f;
    for (int r = 0; r < HID; ++r) e = fmaf(ldg_f(w + r), hs[r], e);
    gate[i] = 1.f / (1.f + expf(-e));
  }
  __syncthreads();
}

template <int E, typename T>
__global__ void __launch_bounds__(THREADS)
fused_group12_kernel(const T* __restrict__ x, Weights wt, T* __restrict__ out,
                     int batch) {
  using PL = Plan<E>;
  constexpr int E2 = PL::E2, SPB = PL::SPB, REGION = PL::REGION;
  constexpr int P1 = E * E, P2 = E2 * E2;
  extern __shared__ float4 smem_raw[];
  float* r0 = reinterpret_cast<float*>(smem_raw);  // group input/residual/output
  float* r1 = r0 + SPB * REGION;                   // mid-block activation
  float* gate = r1 + SPB * REGION;                 // SPB x C2
  float* hid = gate + SPB * C2;                    // SPB x SE2_H
  const int64_t b0 = int64_t(blockIdx.x) * SPB;
  const int n = batch - b0 < SPB ? int(batch - b0) : SPB;  // samples to store

  // ---- zero both regions (borders, and the samples past the batch), load x
  for (int i = threadIdx.x; i < 2 * SPB * REGION; i += THREADS) r0[i] = 0.f;
  __syncthreads();
  const T* xb = x + b0 * P1 * C1;
  for (int i = threadIdx.x; i < n * P1 * C1; i += THREADS)
    r0[(i / (P1 * C1)) * REGION + PL::A1::interior((i / C1) % P1) + i % C1] =
        to_f<T>(xb[i]);
  __syncthreads();

  // ---- layer group 1 and SE1, in place on region 0
  block_s1<E, C1, SPB, REGION>(r0, r1, wp<T>(wt, L10_K1), wp<T>(wt, L10_B1),
                               wp<T>(wt, L10_K2), wp<T>(wt, L10_B2));
  block_s1<E, C1, SPB, REGION>(r0, r1, wp<T>(wt, L11_K1), wp<T>(wt, L11_B1),
                               wp<T>(wt, L11_K2), wp<T>(wt, L11_B2));
  se_gate<E, C1, SE1_H, SPB, REGION>(r0, wp<T>(wt, SE1_D0), wp<T>(wt, SE1_D1), gate,
                                     hid);
  for (int i = threadIdx.x; i < SPB * P1 * C1; i += THREADS) {
    const int s = i / (P1 * C1), c = i % C1;
    r0[s * REGION + PL::A1::interior((i / C1) % P1) + c] *= gate[s * C1 + c];
  }
  // region 1 becomes layer 2's mid buffer, whose border must read zero
  for (int i = threadIdx.x; i < SPB * REGION; i += THREADS) r1[i] = 0.f;
  __syncthreads();

  // ---- layer2_0: conv1 3x3/2 (region 0 -> region 1), then conv2 + the
  // downsample in registers; their sum replaces region 0 once all is read
  {
    using RS2 = Rows<E2, 2, C1, E, REGION>;   // stride-2 windows on group 1's output
    using RS1 = Rows<E2, 1, C2, E2, REGION>;  // stride-1 windows at E2
    using TL = Tiling<SPB * P2, C2>;
    constexpr int RT = TL::RT;
    const int co = threadIdx.x % C2, g = threadIdx.x / C2;
    const float bias1 = ldg_f(wp<T>(wt, L20_B1) + co);
    const float bias2 = ldg_f(wp<T>(wt, L20_B2) + co) + ldg_f(wp<T>(wt, L20_DSB) + co);
    constexpr int PER_GROUP = TL::TILES / TL::G;
    float acc[PER_GROUP][RT];
#pragma unroll
    for (int k = 0; k < PER_GROUP; ++k) {
      const int t = g + k * TL::G;
      zero(acc[k]);
      conv_acc<C1, C2, 9, RT, RS2>(r0 + RS2::window(t * RT), wp<T>(wt, L20_K1), co,
                                   acc[k]);
#pragma unroll
      for (int j = 0; j < RT; ++j)
        r1[dest<E2, C2, REGION>(t * RT + j) + co] = fmaxf(acc[k][j] + bias1, 0.f);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < PER_GROUP; ++k) {
      const int t = g + k * TL::G;
      zero(acc[k]);
      conv_acc<C2, C2, 9, RT, RS1>(r1 + RS1::window(t * RT), wp<T>(wt, L20_K2), co,
                                   acc[k]);
      conv_acc<C1, C2, 1, RT, RS2>(r0 + RS2::window(t * RT), wp<T>(wt, L20_DSK), co,
                                   acc[k]);
    }
    __syncthreads();  // the last read of group 1's output
    for (int i = threadIdx.x; i < SPB * REGION; i += THREADS) r0[i] = 0.f;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < PER_GROUP; ++k) {
      const int t = g + k * TL::G;
#pragma unroll
      for (int j = 0; j < RT; ++j)
        r0[dest<E2, C2, REGION>(t * RT + j) + co] = fmaxf(acc[k][j] + bias2, 0.f);
    }
    __syncthreads();
  }

  // ---- layer2_1 in place on region 0, SE2, and the output
  block_s1<E2, C2, SPB, REGION>(r0, r1, wp<T>(wt, L21_K1), wp<T>(wt, L21_B1),
                                wp<T>(wt, L21_K2), wp<T>(wt, L21_B2));
  se_gate<E2, C2, SE2_H, SPB, REGION>(r0, wp<T>(wt, SE2_D0), wp<T>(wt, SE2_D1), gate,
                                      hid);
  T* ob = out + b0 * P2 * C2;
  for (int i = threadIdx.x; i < n * P2 * C2; i += THREADS) {
    const int s = i / (P2 * C2), c = i % C2;
    ob[i] = from_f<T>(r0[s * REGION + PL::A2::interior((i / C2) % P2) + c] *
                      gate[s * C2 + c]);
  }
}

template <int E, typename T>
int launch_group12(const void* x, const Weights& w, void* out, int batch,
                   cudaStream_t st) {
  using PL = Plan<E>;
  cudaError_t err = cudaFuncSetAttribute(
      fused_group12_kernel<E, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(PL::SMEM));
  if (err != cudaSuccess) return int(err);
  const int grid = (batch + PL::SPB - 1) / PL::SPB;
  fused_group12_kernel<E, T><<<grid, THREADS, PL::SMEM, st>>>(
      static_cast<const T*>(x), w, static_cast<T*>(out), batch);
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------

namespace sm90 = av1::sm90;
using namespace av1::convwg;  // the wgmma conv, its ring and its tap table (conv_wgmma.cuh)

constexpr int SLOT_BYTES = KC * C2 * 2;     // a chunk of 64 k-rows x 128 columns
constexpr int PITCH1 = C1 + 8;              // plane row pitch in layer 1 (elements)
constexpr int PITCH2 = C2 + 8;              // ... in layer 2
constexpr int ZERO_ROW = PITCH2;            // elements of the shared zero row
using Ring = av1::convwg::Ring<SLOT_BYTES>;

// Rows of a block: ROWS1 in layer 1 (256, or 128 at extent 2 so that 4,096
// samples fill 128 blocks), ROWS1 / 4 in layer 2, position-major: row
// p * SPB + s is sample s at position p, so a 64-row tile holds whole
// positions and the taps outside the image are the same for all its rows.
template <int E>
struct Geo {
  static constexpr int E2 = E / 2, PS1 = E * E, PS2 = E2 * E2;
  static constexpr int ROWS1 = E == 2 ? 128 : 256;
  static constexpr int SPB = ROWS1 / PS1;
  static constexpr int ROWS2 = SPB * PS2;    // 64, or 32 at extent 2 (a half tile)
  static constexpr int MT1 = ROWS1 / 128;    // layer-1 tiles of a warpgroup
  static constexpr int PLANE = ROWS1 * PITCH1;
  static constexpr size_t SMEM = 1024 + STAGES * SLOT_BYTES + sizeof(bf16) * (4 * PLANE + ZERO_ROW)
                                 + 2 * STAGES * sizeof(uint64_t);
  static_assert(64 * PITCH2 <= PLANE, "layer 2 reuses layer 1's planes");
};

// the pair at element `idx` of an activation: hi + lo
__device__ __forceinline__ float2 load_pair(const bf16* hi, const bf16* lo, int idx) {
  const float2 h = av1::unpack_bf16(*reinterpret_cast<const uint32_t*>(hi + idx));
  const float2 l = av1::unpack_bf16(*reinterpret_cast<const uint32_t*>(lo + idx));
  return make_float2(h.x + l.x, h.y + l.y);
}
__device__ __forceinline__ void store_pair(bf16* hi, bf16* lo, int idx, float v0, float v1) {
  uint32_t h, l;
  av1::split2_pack(v0, v1, h, l);
  *reinterpret_cast<uint32_t*>(hi + idx) = h;
  *reinterpret_cast<uint32_t*>(lo + idx) = l;
}

// A stride-1 basic block on `a` (input, residual, output) with `h` for the mid
// activation: a = relu(conv2(relu(conv1(a) + b1)) + b2 + a); convs J, J + 1.
template <int J, int EXT, int CH, int IP, int SPB, int NROWS, int MT>
__device__ __forceinline__ void block_s1(bf16* a_hi, bf16* a_lo, bf16* h_hi, bf16* h_lo,
                                         uint32_t zero, const bf16* b1, const bf16* b2,
                                         int row0, int n0, const TileTaps& tt, int tile0,
                                         Ring& ring, int lane) {
  float acc[MT][3 - MT][32], bias[8][2];
  zero_acc(acc);
  conv_wg<J, EXT, EXT, 1, CH, IP, SPB, NROWS, MT, 2>(acc, a_hi, a_lo, zero, row0, n0, tt, tile0,
                                                  ring, lane);
  load_bias(bias, b1, n0, lane);
  for_each_pair(acc, bias, row0, n0, lane, [&](int row, int col, float v0, float v1) {
    store_pair(h_hi, h_lo, row * IP + col, fmaxf(v0, 0.f), fmaxf(v1, 0.f));
  });
  consumer_sync();
  zero_acc(acc);
  conv_wg<J + 1, EXT, EXT, 1, CH, IP, SPB, NROWS, MT, 2>(acc, h_hi, h_lo, zero, row0, n0, tt,
                                                      tile0, ring, lane);
  load_bias(bias, b2, n0, lane);
  for_each_pair(acc, bias, row0, n0, lane, [&](int row, int col, float v0, float v1) {
    const float2 res = load_pair(a_hi, a_lo, row * IP + col);
    store_pair(a_hi, a_lo, row * IP + col, fmaxf(v0 + res.x, 0.f), fmaxf(v1 + res.y, 0.f));
  });
  consumer_sync();
}

// The SE gates of SPB samples of PS positions x CH channels at pitch IP, rows
// position-major: gate[s][c] = sigmoid(d1 . relu(d0 . mean_p a[s][p])). `hid`
// is SPB x HID; with fewer items than threads (E = 16) the positions are
// split in PARTS, whose sums lie after `hid` and are added in part order: the
// mean, and so the kernel's output, is the same on every run and at every
// batch size.
template <int PS, int CH, int HID, int SPB, int IP, int PLANE>
__device__ void se_gate(const bf16* a_hi, const bf16* a_lo, const bf16* d0, const bf16* d1,
                        float* gate, float* hid) {
  constexpr int ITEMS = SPB * CH;
  constexpr int PARTS = ITEMS >= CONSUMERS ? 1 : CONSUMERS / ITEMS;  // splits of the positions
  static_assert(PS % PARTS == 0, "positions must split evenly");
  static_assert(SPB * (CH + HID) + (PARTS > 1 ? PARTS * ITEMS : 0) <= PLANE,
                "the SE scratch fits in the mid-block planes");
  float* part_sums = hid + SPB * HID;  // PARTS x ITEMS, when PARTS > 1
  for (int i = threadIdx.x; i < ITEMS * PARTS; i += CONSUMERS) {
    const int item = i % ITEMS, part = i / ITEMS;
    const int s = item / CH, c = item % CH, p0 = part * (PS / PARTS);
    float sum = 0.f;
    for (int p = p0; p < p0 + PS / PARTS; ++p) {
      const int idx = (p * SPB + s) * IP + c;
      sum += __bfloat162float(a_hi[idx]) + __bfloat162float(a_lo[idx]);
    }
    if (PARTS == 1) gate[item] = sum; else part_sums[part * ITEMS + item] = sum;
  }
  consumer_sync();
  if (PARTS > 1) {
    for (int i = threadIdx.x; i < ITEMS; i += CONSUMERS) {
      float sum = 0.f;
      for (int part = 0; part < PARTS; ++part) sum += part_sums[part * ITEMS + i];
      gate[i] = sum;
    }
    consumer_sync();
  }
  // 8 lanes an output, each every 8th channel, summed by shuffles in a fixed
  // order: the weights' loads are in flight together
  static_assert(SPB * HID * 8 % 32 == 0, "whole warps take part in the shuffles");
  for (int i = threadIdx.x; i < SPB * HID * 8; i += CONSUMERS) {
    const int o = i / 8, l = i % 8;
    const float* gs = gate + (o / HID) * CH;
    const bf16* w = d0 + (o % HID) * CH;
    float v = 0.f;
#pragma unroll
    for (int k = l; k < CH; k += 8) v = fmaf(ldg_f(w + k), gs[k] * (1.f / PS), v);
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    if (l == 0) hid[o] = fmaxf(v, 0.f);
  }
  consumer_sync();
  for (int i = threadIdx.x; i < ITEMS; i += CONSUMERS) {
    const float* hs = hid + (i / CH) * HID;
    const bf16* w = d1 + (i % CH) * HID;
    float e = 0.f;
#pragma unroll
    for (int r = 0; r < HID; ++r) e = fmaf(ldg_f(w + r), hs[r], e);
    gate[i] = 1.f / (1.f + expf(-e));
  }
  consumer_sync();
}

template <int E>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(G_THREADS, 1)
fused_group12_wgmma_kernel(const bf16* __restrict__ x, const __grid_constant__ CUtensorMap map1,
                           const __grid_constant__ CUtensorMap map2, const TileTaps tt,
                           Weights wt, bf16* __restrict__ out, int batch) {
  using G = Geo<E>;
  constexpr int E2 = G::E2, PS1 = G::PS1, PS2 = G::PS2, SPB = G::SPB, MT = G::MT1;
  extern __shared__ uint8_t group_smem_raw[];
  uint8_t* slots = align_1024(group_smem_raw);
  bf16* a_hi = reinterpret_cast<bf16*>(slots + STAGES * SLOT_BYTES);  // group input / residual / output
  bf16* a_lo = a_hi + G::PLANE;
  bf16* h_hi = a_lo + G::PLANE;  // mid-block activation; SE scratch
  bf16* h_lo = h_hi + G::PLANE;
  bf16* zero_row = h_lo + G::PLANE;
  uint64_t* bars = reinterpret_cast<uint64_t*>(zero_row + ZERO_ROW);
  Ring ring{slots, bars, bars + STAGES, 0};
  float* gate = reinterpret_cast<float*>(h_hi);  // SPB x C2 at most, then SPB x SE2_H
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int64_t b0 = int64_t(blockIdx.x) * SPB;
  const int n = int(batch - b0 < SPB ? batch - b0 : SPB);  // samples to store (<= 0: none)

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&ring.full[s], 1);
      sm90::mbar_init(&ring.empty[s], CLUSTER * CONSUMERS / 128);
    }
    sm90::fence_barrier_init();
  }
  sm90::cluster_sync();  // every block's barriers exist before any TMA or remote arrive

  if (warp == CONSUMERS / 32) {  // the producer warp: its first lane fetches
    if (lane == 0) {
      sm90::tma_prefetch_map(&map1);
      sm90::tma_prefetch_map(&map2);
      produce<N_CONVS>(&map1, &map2, tt, ring);
    }
    __syncwarp();
    sm90::cluster_sync();  // no block leaves while its peer may still write to it
    return;
  }

  // ---- x into the hi plane, position-major (bf16 is exact: lo = 0); samples
  // past the batch read 0
  const bf16* xb = x + b0 * PS1 * C1;
  for (int i = threadIdx.x; i < G::ROWS1 * (C1 / 8); i += CONSUMERS) {
    const int src = i / (C1 / 8), col = (i % (C1 / 8)) * 8;  // src = s * PS1 + p
    const int s = src / PS1, p = src % PS1;
    const bool ok = s < n;
    av1::cp_async16(av1::smem_addr(a_hi + (p * SPB + s) * PITCH1 + col),
                    ok ? xb + src * C1 + col : x, ok ? 16 : 0);
  }
  av1::cp_async_commit();
  for (int i = threadIdx.x; i < G::PLANE / 8; i += CONSUMERS)
    reinterpret_cast<uint4*>(a_lo)[i] = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < ZERO_ROW / 2; i += CONSUMERS)
    reinterpret_cast<uint32_t*>(zero_row)[i] = 0;
  av1::cp_async_wait<0>();
  consumer_sync();
  const uint32_t zero = av1::smem_addr(zero_row);
  const int wg = warp / 4;

  // ---- layer group 1 and SE1, in place on a: warpgroup wg owns ROWS1 / 2
  // rows (MT tiles of 64) x 64 columns
  {
    const int row0 = wg * (G::ROWS1 / 2);
    block_s1<L10_C1, E, C1, PITCH1, SPB, G::ROWS1, MT>(
        a_hi, a_lo, h_hi, h_lo, zero, wp<bf16>(wt, L10_B1), wp<bf16>(wt, L10_B2), row0, 0, tt,
        wg * MT, ring, lane);
    block_s1<L11_C1, E, C1, PITCH1, SPB, G::ROWS1, MT>(
        a_hi, a_lo, h_hi, h_lo, zero, wp<bf16>(wt, L11_B1), wp<bf16>(wt, L11_B2), row0, 0, tt,
        wg * MT, ring, lane);
  }
  se_gate<PS1, C1, SE1_H, SPB, PITCH1, G::PLANE>(a_hi, a_lo, wp<bf16>(wt, SE1_D0),
                                                 wp<bf16>(wt, SE1_D1), gate, gate + SPB * C1);
  for (int i = threadIdx.x; i < G::ROWS1 * (C1 / 2); i += CONSUMERS) {
    const int row = i / (C1 / 2), col = (i % (C1 / 2)) * 2;
    const float2 v = load_pair(a_hi, a_lo, row * PITCH1 + col);
    const float* gs = gate + (row % SPB) * C1 + col;
    store_pair(a_hi, a_lo, row * PITCH1 + col, v.x * gs[0], v.y * gs[1]);
  }
  consumer_sync();

  // ---- layer group 2: one tile of 64 rows; warpgroup wg owns 64 of the 128
  // columns
  const int n0 = wg * 64;
  {
    // layer2_0: conv1 3x3/2 (a -> h), then conv2 + the downsample in
    // registers; their sum replaces a once nothing reads group 1's output
    float acc[1][2][32], bias[8][2];
    zero_acc(acc);
    conv_wg<L20_C1, E, E2, 2, C1, PITCH1, SPB, G::ROWS2, 1, 2>(acc, a_hi, a_lo, zero, 0, n0, tt,
                                                            0, ring, lane);
    load_bias(bias, wp<bf16>(wt, L20_B1), n0, lane);
    for_each_pair(acc, bias, 0, n0, lane, [&](int row, int col, float v0, float v1) {
      store_pair(h_hi, h_lo, row * PITCH2 + col, fmaxf(v0, 0.f), fmaxf(v1, 0.f));
    });
    consumer_sync();
    zero_acc(acc);
    conv_wg<L20_C2, E2, E2, 1, C2, PITCH2, SPB, G::ROWS2, 1, 2>(acc, h_hi, h_lo, zero, 0, n0, tt,
                                                             0, ring, lane);
    conv_wg<L20_DS, E, E2, 2, C1, PITCH1, SPB, G::ROWS2, 1, 2>(acc, a_hi, a_lo, zero, 0, n0, tt, 0,
                                                            ring, lane);
    load_bias(bias, wp<bf16>(wt, L20_B2), n0, lane, wp<bf16>(wt, L20_DSB));
    consumer_sync();  // the last read of group 1's output
    for_each_pair(acc, bias, 0, n0, lane, [&](int row, int col, float v0, float v1) {
      store_pair(a_hi, a_lo, row * PITCH2 + col, fmaxf(v0, 0.f), fmaxf(v1, 0.f));
    });
    consumer_sync();
  }
  block_s1<L21_C1, E2, C2, PITCH2, SPB, G::ROWS2, 1>(a_hi, a_lo, h_hi, h_lo, zero,
                                                      wp<bf16>(wt, L21_B1), wp<bf16>(wt, L21_B2),
                                                      0, n0, tt, 0, ring, lane);

  // ---- SE2 and the output, scaled as it is written, back in sample order
  se_gate<PS2, C2, SE2_H, SPB, PITCH2, G::PLANE>(a_hi, a_lo, wp<bf16>(wt, SE2_D0),
                                                 wp<bf16>(wt, SE2_D1), gate, gate + SPB * C2);
  bf16* ob = out + b0 * PS2 * C2;
  for (int i = threadIdx.x; i < G::ROWS2 * (C2 / 8); i += CONSUMERS) {
    const int dst = i / (C2 / 8), col = (i % (C2 / 8)) * 8;  // dst = s * PS2 + p
    const int s = dst / PS2, p = dst % PS2;
    if (s >= n) continue;
    const int row = p * SPB + s;
    const uint4 h = *reinterpret_cast<const uint4*>(a_hi + row * PITCH2 + col);
    const uint4 l = *reinterpret_cast<const uint4*>(a_lo + row * PITCH2 + col);
    const uint32_t hw[4] = {h.x, h.y, h.z, h.w}, lw[4] = {l.x, l.y, l.z, l.w};
    const float* gs = gate + s * C2 + col;
    uint32_t o[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 hv = av1::unpack_bf16(hw[q]), lv = av1::unpack_bf16(lw[q]);
      o[q] = av1::pack_bf16((hv.x + lv.x) * gs[2 * q], (hv.y + lv.y) * gs[2 * q + 1]);
    }
    *reinterpret_cast<uint4*>(ob + dst * C2 + col) = make_uint4(o[0], o[1], o[2], o[3]);
  }
  sm90::cluster_sync();
}

template <int E>
int launch_group12_wgmma(const void* x, const CUtensorMap (&maps)[2], const TileTaps& tt,
                         const Weights& w, void* out, int batch, cudaStream_t st) {
  using G = Geo<E>;
  static const cudaError_t attr =  // once per kernel, not per launch
      cudaFuncSetAttribute(fused_group12_wgmma_kernel<E>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, int(G::SMEM));
  if (attr != cudaSuccess) return int(attr);
  const int blocks = (batch + G::SPB - 1) / G::SPB;
  const int grid = (blocks + CLUSTER - 1) / CLUSTER * CLUSTER;  // whole clusters
  fused_group12_wgmma_kernel<E><<<grid, G_THREADS, G::SMEM, st>>>(
      static_cast<const bf16*>(x), maps[0], maps[1], tt, w, static_cast<bf16*>(out), batch);
  return int(cudaGetLastError());
}

int dispatch_extent_wgmma(int hw, const void* x, const CUtensorMap (&maps)[2],
                          const TileTaps& tt, const Weights& w, void* out, int batch,
                          cudaStream_t st) {
  switch (hw) {
    case 2: return launch_group12_wgmma<2>(x, maps, tt, w, out, batch, st);
    case 4: return launch_group12_wgmma<4>(x, maps, tt, w, out, batch, st);
    case 8: return launch_group12_wgmma<8>(x, maps, tt, w, out, batch, st);
    case 16: return launch_group12_wgmma<16>(x, maps, tt, w, out, batch, st);
    default: return int(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_extent(int hw, const void* x, const Weights& w, void* out, int batch,
                    cudaStream_t st) {
  switch (hw) {
    case 2: return launch_group12<2, T>(x, w, out, batch, st);
    case 4: return launch_group12<4, T>(x, w, out, batch, st);
    case 8: return launch_group12<8, T>(x, w, out, batch, st);
    case 16: return launch_group12<16, T>(x, w, out, batch, st);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Encodes the two TMA maps of a conv stream (kernels/resnet_group.py
// group12_conv_stream) into `maps_out` (host memory, 2 x 128 bytes): part i
// starts `parts[3i]` elements into the stream and is a row-major array of
// `parts[3i + 1]` rows of `parts[3i + 2]` bf16, read in boxes of
// box_rows x box_cols. The kernel takes only the geometry it was built for.
// Returns 0 or a cudaError_t.
int av1_group12_encode_maps(const void* conv_stream, const long long* parts, int box_rows,
                            int box_cols, void* maps_out) {
  if (conv_stream == nullptr || reinterpret_cast<uintptr_t>(conv_stream) % 16 ||
      box_rows != BOX_ROWS || box_cols != 64)
    return int(cudaErrorInvalidValue);
  CUtensorMap maps[2];
  for (int i = 0; i < 2; ++i) {
    const long long first = parts[3 * i], rows = parts[3 * i + 1], cols = parts[3 * i + 2];
    if (rows % KC || cols != (i == 0 ? C1 : C2)) return int(cudaErrorInvalidValue);
    const int err = sm90::encode_map_2d(
        &maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, static_cast<const bf16*>(conv_stream) + first,
        uint64_t(rows), uint64_t(cols), uint64_t(cols) * sizeof(bf16), uint32_t(box_rows),
        uint32_t(box_cols), CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != 0) return err;
  }
  memcpy(maps_out, maps, sizeof(maps));
  return 0;
}

// Launches K5 on `stream` and returns cudaGetLastError() (0 on success); it
// neither allocates nor synchronises. `weights` is a host array of the 22
// device pointers in PACK_ORDER, all in the dtype of x (`bf16`: 1, else fp32).
// With bf16, `conv_maps` are the stream's two maps from
// av1_group12_encode_maps and `tile_taps` the 9 x 4 tap masks of
// group12_tile_taps at this extent (both host memory); x and out 16-byte
// aligned.
int av1_fused_group12(const void* x, const void* const* weights, const void* conv_maps,
                      const uint16_t* tile_taps, void* out, int batch, int hw, int bf16,
                      void* stream) {
  if (batch <= 0 || weights == nullptr) return int(cudaErrorInvalidValue);
  Weights w;
  for (int i = 0; i < N_WEIGHTS; ++i) w.p[i] = weights[i];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!bf16) return dispatch_extent<float>(hw, x, w, out, batch, st);
  const uintptr_t bits = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out);
  if (conv_maps == nullptr || tile_taps == nullptr || bits % 16) return int(cudaErrorInvalidValue);
  CUtensorMap maps[2];
  memcpy(maps, conv_maps, sizeof(maps));
  TileTaps tt;
  memcpy(tt.taps, tile_taps, sizeof(tt.taps));
  return dispatch_extent_wgmma(hw, x, maps, tt, w, out, batch, st);
}

}  // extern "C"
