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
// ~278 k x E^2 MACs per sample: 4.45 M at E = 4 (16 px blocks) for 2 KB of
// input and 1 KB of output in bf16, ~3000 FLOP per byte of device memory. So
// it is bound by operations: 36.5 GFLOP at batch 4096, 0.037 ms of bf16
// tensor-core time, 0.074 ms with the two passes described below. The
// traffic that matters is the weights: 0.675 M values (1.35 MB in bf16) do
// not fit in shared memory and every block streams them from L2.
//
// bf16 (the serving dtype): fused_group12_mma_kernel, tensor cores.
//   * Every conv is an implicit GEMM on mma.sync.m16n8k16 (conv_mma.cuh, the
//     routine K2 shares, over mma.cuh; picked
//     over wgmma because its A operand comes from ldmatrix with one address
//     per row, which is what the shifted windows need, and because layer 2
//     has only 64 rows a block, one wgmma tile). Rows are (sample, output
//     position), K is tap x ci, N is 64 or 128. A block of 256 threads holds
//     256 / E^2 samples (64, 16, 4, 1), so layer 1 is always 256 rows (each
//     warp 2 m-tiles x 64 columns) and layer 2 always 64 rows (each warp one
//     m-tile x 64 of the 128 columns), whatever the extent.
//   * fp32 inside, to 16 bits. An activation v lives in shared memory as two
//     bf16 planes, hi = bf16(v) and lo = bf16(v - hi), so ldmatrix reads the
//     MMA's A fragments directly and each weight fragment feeds two MMAs
//     (hi and lo). Products carry 16 bits of the activation (2^-17 relative),
//     sums are fp32, and the residual and the SE mean read hi + lo.
//   * No border is stored. A row is 64 (128) channels at a pitch of 144 (272)
//     bytes, odd multiples of 16, so the eight rows of an ldmatrix tile hit
//     eight bank groups. The lane that owns tile row r computes the address
//     of its input row for each tap: the window shift, the row wrap, the
//     stride-2 start 2*o and the sample boundary are address arithmetic, and
//     a tap outside the image (SAME's border, XLA's pad (0, 1)) points at one
//     shared row of zeros.
//   * Weights: the nine conv kernels are concatenated once, when the pipeline
//     is built, into one stream in the order of use ([tap][ci][co] is already
//     k-major, so the stream is 100 chunks of 64 k-rows x 64 or 128 columns).
//     A three-slot cp.async ring runs two chunks ahead of the math, straight
//     through the boundaries between convs, with one __syncthreads per chunk.
//     A block reads the 1.35 MB once for its 256 rows (16 samples at E = 4,
//     where the first version read them once for 4).
//   * layer2_0: the 1x1/2 downsample is one more chunk summed into the second
//     conv's accumulators; the sum replaces group 1's output only after a
//     barrier, when no warp reads that output any more.
//   * SE1 and SE2 run from shared memory; their scratch lies in the mid
//     buffer, which is free then. SE2's scale is applied as the output is
//     written, 16 bytes a store. A short last block computes on zero samples
//     and stores only those inside the batch.
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

#include "common.cuh"
#include "conv_mma.cuh"

namespace {

using av1::from_f;
using av1::ldg_f;
using av1::to_f;
using av1::conv::bf16;
using av1::conv::conv_mma;
using av1::conv::fetch_chunk;
using av1::conv::for_each_pair;
using av1::conv::KC;
using av1::conv::THREADS;
using av1::conv::zero_acc;

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

constexpr int ROWS1 = 256, ROWS2 = 64;  // output rows of a block in layers 1 and 2
constexpr int PITCH1 = C1 + 8;          // plane row pitch in layer 1 (elements)
constexpr int PITCH2 = C2 + 8;          // ... in layer 2
constexpr int PLANE = ROWS1 * PITCH1;   // elements of one plane
constexpr int CHUNKS1 = 4 * 9;          // layer 1: four 576 x 64 convs

// The conv stream (kernels/resnet_group.py group12_conv_stream) as the conv
// routine's schedule: 36 chunks of 64 columns, then layer 2's 64 of 128.
struct Stream12 {
  static constexpr int STAGES = 3;
  static constexpr int CHUNKS = CHUNKS1 + 9 + 19 + 36;  // 100 in all
  static constexpr int WPITCH = C2 + 8;                 // ring row pitch
  static constexpr int SLOT = KC * WPITCH;              // elements of a ring slot
  __device__ static constexpr int cols(int c) { return c < CHUNKS1 ? C1 : C2; }
  __device__ static constexpr int offset(int c) {
    return c < CHUNKS1 ? c * KC * C1 : CHUNKS1 * KC * C1 + (c - CHUNKS1) * KC * C2;
  }
};
constexpr int ZERO_ROW = PITCH2;  // elements of the shared zero row
constexpr size_t MMA_SMEM =
    sizeof(bf16) * (4 * PLANE + Stream12::STAGES * Stream12::SLOT + ZERO_ROW);
static_assert(ROWS2 * PITCH2 <= PLANE, "layer 2 reuses layer 1's planes");

// A conv on the two planes (hi, lo) of an activation, weights from Stream12.
template <int IE, int OE, int S, int CI, int IP, int TAPS, int MT>
__device__ __forceinline__ void conv12(float (&acc)[MT][8][4], const bf16* in_hi,
                                       const bf16* in_lo, uint32_t zero, int row0, int n0,
                                       const bf16* __restrict__ stream, bf16* ring, int c0,
                                       int lane) {
  const uint32_t in[2] = {av1::smem_addr(in_hi), av1::smem_addr(in_lo)};
  conv_mma<Stream12, IE, OE, S, CI, IP, TAPS, MT, 2>(acc, in, zero, row0, n0, stream, ring, c0,
                                                     lane);
}

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
// activation: a = relu(conv2(relu(conv1(a) + b1)) + b2 + a). EXT is the
// extent, CH the width, IP the pitch; weights from chunk c0.
template <int EXT, int CH, int IP, int MT>
__device__ __forceinline__ void block_s1_mma(bf16* a_hi, bf16* a_lo, bf16* h_hi, bf16* h_lo,
                                             uint32_t zero, const bf16* b1, const bf16* b2,
                                             int row0, int n0, const bf16* stream, bf16* ring,
                                             int c0, int lane) {
  constexpr int PER_CONV = 9 * CH / KC;
  float acc[MT][8][4];
  zero_acc(acc);
  conv12<EXT, EXT, 1, CH, IP, 9, MT>(acc, a_hi, a_lo, zero, row0, n0, stream, ring, c0, lane);
  for_each_pair(acc, row0, n0, lane, [&](int row, int col, float v0, float v1) {
    store_pair(h_hi, h_lo, row * IP + col, fmaxf(v0 + ldg_f(b1 + col), 0.f),
               fmaxf(v1 + ldg_f(b1 + col + 1), 0.f));
  });
  zero_acc(acc);
  conv12<EXT, EXT, 1, CH, IP, 9, MT>(acc, h_hi, h_lo, zero, row0, n0, stream, ring,
                                     c0 + PER_CONV, lane);
  for_each_pair(acc, row0, n0, lane, [&](int row, int col, float v0, float v1) {
    const float2 res = load_pair(a_hi, a_lo, row * IP + col);
    store_pair(a_hi, a_lo, row * IP + col, fmaxf(v0 + ldg_f(b2 + col) + res.x, 0.f),
               fmaxf(v1 + ldg_f(b2 + col + 1) + res.y, 0.f));
  });
  __syncthreads();
}

// The SE gates of SPB samples of PS positions x CH channels at pitch IP:
// gate[s][c] = sigmoid(d1 . relu(d0 . mean_p a[s][p])). `hid` is SPB x HID;
// with fewer items than threads (E = 16) the positions are split in PARTS,
// whose sums lie after `hid` and are added in part order: the mean, and so
// the kernel's output, is the same on every run and at every batch size.
template <int PS, int CH, int HID, int SPB, int IP>
__device__ void se_gate_mma(const bf16* a_hi, const bf16* a_lo, const bf16* d0, const bf16* d1,
                            float* gate, float* hid) {
  constexpr int ITEMS = SPB * CH;
  constexpr int PARTS = ITEMS >= THREADS ? 1 : THREADS / ITEMS;  // splits of the positions
  static_assert(PS % PARTS == 0, "positions must split evenly");
  static_assert(SPB * (CH + HID) + (PARTS > 1 ? PARTS * ITEMS : 0) <= PLANE / 2,
                "the SE scratch fits in the mid-block plane");
  float* part_sums = hid + SPB * HID;  // PARTS x ITEMS, when PARTS > 1
  for (int i = threadIdx.x; i < ITEMS * PARTS; i += THREADS) {
    const int item = i % ITEMS, part = i / ITEMS;
    const int base = ((item / CH) * PS + part * (PS / PARTS)) * IP + item % CH;
    float sum = 0.f;
    for (int p = 0; p < PS / PARTS; ++p)
      sum += __bfloat162float(a_hi[base + p * IP]) + __bfloat162float(a_lo[base + p * IP]);
    if (PARTS == 1) gate[item] = sum; else part_sums[part * ITEMS + item] = sum;
  }
  __syncthreads();
  if (PARTS > 1) {
    for (int i = threadIdx.x; i < ITEMS; i += THREADS) {
      float sum = 0.f;
      for (int part = 0; part < PARTS; ++part) sum += part_sums[part * ITEMS + i];
      gate[i] = sum;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < SPB * HID; i += THREADS) {
    const float* gs = gate + (i / HID) * CH;
    const bf16* w = d0 + (i % HID) * CH;
    float v = 0.f;
    for (int k = 0; k < CH; ++k) v = fmaf(ldg_f(w + k), gs[k] * (1.f / PS), v);
    hid[i] = fmaxf(v, 0.f);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ITEMS; i += THREADS) {
    const float* hs = hid + (i / CH) * HID;
    const bf16* w = d1 + (i % CH) * HID;
    float e = 0.f;
    for (int r = 0; r < HID; ++r) e = fmaf(ldg_f(w + r), hs[r], e);
    gate[i] = 1.f / (1.f + expf(-e));
  }
  __syncthreads();
}

template <int E>
__global__ void __launch_bounds__(THREADS)
fused_group12_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ stream,
                         Weights wt, bf16* __restrict__ out, int batch) {
  constexpr int E2 = E / 2, PS1 = E * E, PS2 = E2 * E2, SPB = ROWS1 / PS1;
  extern __shared__ uint4 mma_smem[];
  bf16* a_hi = reinterpret_cast<bf16*>(mma_smem);  // group input / residual / output
  bf16* a_lo = a_hi + PLANE;
  bf16* h_hi = a_lo + PLANE;                       // mid-block activation; SE scratch
  bf16* h_lo = h_hi + PLANE;
  bf16* ring = h_lo + PLANE;
  bf16* zero_row = ring + Stream12::STAGES * Stream12::SLOT;
  float* gate = reinterpret_cast<float*>(h_hi);    // SPB x C2 at most, then SPB x SE2_H
  const uint32_t zero = av1::smem_addr(zero_row);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int64_t b0 = int64_t(blockIdx.x) * SPB;
  const int n = batch - b0 < SPB ? int(batch - b0) : SPB;  // samples to store

  // ---- x into the hi plane (bf16 is exact: lo = 0), samples past the batch 0
  const bf16* xb = x + b0 * PS1 * C1;
  for (int i = threadIdx.x; i < ROWS1 * (C1 / 8); i += THREADS) {
    const int row = i / (C1 / 8), col = (i % (C1 / 8)) * 8;
    const bool ok = row < n * PS1;
    av1::cp_async16(av1::smem_addr(a_hi + row * PITCH1 + col), ok ? xb + row * C1 + col : xb,
                    ok ? 16 : 0);
  }
  av1::cp_async_commit();
  fetch_chunk<Stream12>(stream, ring, 0);
  fetch_chunk<Stream12>(stream, ring, 1);
  for (int i = threadIdx.x; i < PLANE / 8; i += THREADS)
    reinterpret_cast<uint4*>(a_lo)[i] = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < ZERO_ROW / 2; i += THREADS)
    reinterpret_cast<uint32_t*>(zero_row)[i] = 0;

  // ---- layer group 1 and SE1, in place on a: each warp 32 rows x 64 columns
  {
    const int row0 = warp * 32;
    block_s1_mma<E, C1, PITCH1, 2>(a_hi, a_lo, h_hi, h_lo, zero, wp<bf16>(wt, L10_B1),
                                   wp<bf16>(wt, L10_B2), row0, 0, stream, ring, 0, lane);
    block_s1_mma<E, C1, PITCH1, 2>(a_hi, a_lo, h_hi, h_lo, zero, wp<bf16>(wt, L11_B1),
                                   wp<bf16>(wt, L11_B2), row0, 0, stream, ring, 18, lane);
  }
  se_gate_mma<PS1, C1, SE1_H, SPB, PITCH1>(a_hi, a_lo, wp<bf16>(wt, SE1_D0),
                                           wp<bf16>(wt, SE1_D1), gate, gate + SPB * C1);
  for (int i = threadIdx.x; i < ROWS1 * (C1 / 2); i += THREADS) {
    const int row = i / (C1 / 2), col = (i % (C1 / 2)) * 2;
    const float2 v = load_pair(a_hi, a_lo, row * PITCH1 + col);
    const float* gs = gate + (row / PS1) * C1 + col;
    store_pair(a_hi, a_lo, row * PITCH1 + col, v.x * gs[0], v.y * gs[1]);
  }
  __syncthreads();

  // ---- layer group 2: each warp 16 rows x 64 of the 128 columns
  const int row0 = (warp % 4) * 16, n0 = (warp / 4) * 64;
  {
    // layer2_0: conv1 3x3/2 (a -> h), then conv2 + the downsample in
    // registers; their sum replaces a once nothing reads group 1's output
    float acc[1][8][4];
    zero_acc(acc);
    conv12<E, E2, 2, C1, PITCH1, 9, 1>(acc, a_hi, a_lo, zero, row0, n0, stream, ring, CHUNKS1,
                                       lane);
    const bf16* b1 = wp<bf16>(wt, L20_B1);
    for_each_pair(acc, row0, n0, lane, [&](int row, int col, float v0, float v1) {
      store_pair(h_hi, h_lo, row * PITCH2 + col, fmaxf(v0 + ldg_f(b1 + col), 0.f),
                 fmaxf(v1 + ldg_f(b1 + col + 1), 0.f));
    });
    zero_acc(acc);
    conv12<E2, E2, 1, C2, PITCH2, 9, 1>(acc, h_hi, h_lo, zero, row0, n0, stream, ring,
                                        CHUNKS1 + 9, lane);
    conv12<E, E2, 2, C1, PITCH1, 1, 1>(acc, a_hi, a_lo, zero, row0, n0, stream, ring,
                                       CHUNKS1 + 27, lane);
    __syncthreads();  // the last read of group 1's output
    const bf16* b2 = wp<bf16>(wt, L20_B2);
    const bf16* bd = wp<bf16>(wt, L20_DSB);
    for_each_pair(acc, row0, n0, lane, [&](int row, int col, float v0, float v1) {
      store_pair(a_hi, a_lo, row * PITCH2 + col,
                 fmaxf(v0 + (ldg_f(b2 + col) + ldg_f(bd + col)), 0.f),
                 fmaxf(v1 + (ldg_f(b2 + col + 1) + ldg_f(bd + col + 1)), 0.f));
    });
  }
  block_s1_mma<E2, C2, PITCH2, 1>(a_hi, a_lo, h_hi, h_lo, zero, wp<bf16>(wt, L21_B1),
                                  wp<bf16>(wt, L21_B2), row0, n0, stream, ring, CHUNKS1 + 28,
                                  lane);
  av1::cp_async_wait<0>();

  // ---- SE2 and the output, scaled as it is written
  se_gate_mma<PS2, C2, SE2_H, SPB, PITCH2>(a_hi, a_lo, wp<bf16>(wt, SE2_D0),
                                           wp<bf16>(wt, SE2_D1), gate, gate + SPB * C2);
  bf16* ob = out + b0 * PS2 * C2;
  for (int i = threadIdx.x; i < ROWS2 * (C2 / 8); i += THREADS) {
    const int row = i / (C2 / 8), col = (i % (C2 / 8)) * 8;
    const int s = row / PS2;
    if (s >= n) continue;
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
    *reinterpret_cast<uint4*>(ob + row * C2 + col) = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

template <int E>
int launch_group12_mma(const void* x, const void* stream, const Weights& w, void* out,
                       int batch, cudaStream_t st) {
  static const cudaError_t attr =  // once per kernel, not per launch
      cudaFuncSetAttribute(fused_group12_mma_kernel<E>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, int(MMA_SMEM));
  if (attr != cudaSuccess) return int(attr);
  constexpr int SPB = ROWS1 / (E * E);
  fused_group12_mma_kernel<E><<<(batch + SPB - 1) / SPB, THREADS, MMA_SMEM, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(stream), w,
      static_cast<bf16*>(out), batch);
  return int(cudaGetLastError());
}

int dispatch_extent_mma(int hw, const void* x, const void* stream, const Weights& w, void* out,
                        int batch, cudaStream_t st) {
  switch (hw) {
    case 2: return launch_group12_mma<2>(x, stream, w, out, batch, st);
    case 4: return launch_group12_mma<4>(x, stream, w, out, batch, st);
    case 8: return launch_group12_mma<8>(x, stream, w, out, batch, st);
    case 16: return launch_group12_mma<16>(x, stream, w, out, batch, st);
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

// Launches K5 on `stream` and returns cudaGetLastError() (0 on success); it
// neither allocates nor synchronises. `weights` is a host array of the 22
// device pointers in PACK_ORDER, all in the dtype of x (`bf16`: 1, else fp32).
// With bf16, `conv_stream` is the device pointer of the nine conv kernels
// concatenated in the order of use (kernels/resnet_group.py
// group12_conv_stream), 16-byte aligned like x and out.
int av1_fused_group12(const void* x, const void* const* weights, const void* conv_stream,
                      void* out, int batch, int hw, int bf16, void* stream) {
  if (batch <= 0 || weights == nullptr) return int(cudaErrorInvalidValue);
  Weights w;
  for (int i = 0; i < N_WEIGHTS; ++i) w.p[i] = weights[i];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!bf16) return dispatch_extent<float>(hw, x, w, out, batch, st);
  const uintptr_t bits = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out) |
                         reinterpret_cast<uintptr_t>(conv_stream);
  if (conv_stream == nullptr || bits % 16) return int(cudaErrorInvalidValue);
  return dispatch_extent_mma(hw, x, conv_stream, w, out, batch, st);
}

}  // extern "C"
