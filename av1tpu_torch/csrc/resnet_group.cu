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
// the serving dtype (fp32 or bf16) and are widened to fp32 on load, every
// intermediate stays fp32, and only the output is rounded. (K2 rounds each
// conv input to the weight dtype; K5 does not.)
//
// What bounds it on an H100. The eight 3x3 convs and the downsample are
// ~278 k x E^2 MACs per sample: 4.45 M at E = 4 (16 px blocks) for 2 KB of
// input and 1 KB of output in bf16, ~3000 FLOP per byte of device memory.
// So it is compute-bound on the fp32 CUDA cores. The traffic that matters is
// the weights: 0.675 M values (1.35 MB in bf16) do not fit in shared memory
// (one 128x128x3x3 conv alone is 295 KB in bf16) and stream through L1/L2.
//
// The simple design:
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
//   * SE1 and SE2 run from shared memory at the end of their groups; SE2's
//     channel scale is applied as the output is written.
// Tensor cores, cp.async/TMA weight staging and register tiling across
// channels are left for later work.

#include "common.cuh"

namespace {

using av1::from_f;
using av1::ldg_f;
using av1::to_f;

constexpr int THREADS = 256;
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
int av1_fused_group12(const void* x, const void* const* weights, void* out, int batch,
                      int hw, int bf16, void* stream) {
  if (batch <= 0 || weights == nullptr) return int(cudaErrorInvalidValue);
  Weights w;
  for (int i = 0; i < N_WEIGHTS; ++i) w.p[i] = weights[i];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_extent<__nv_bfloat16>(hw, x, w, out, batch, st)
              : dispatch_extent<float>(hw, x, w, out, batch, st);
}

}  // extern "C"
