// Ingest preprocessing for Hopper (sm_90a): 10-bit luma in uint16 -> float.
//
// K3a av1_tile_normalize_frames replaces av1tpu/kernels/preprocess.py
//     tile_normalize_frames: (F, H, W) frames -> (F*R*C, bs, bs) blocks,
//     frame-major then row-major, each value times 1/1023.
// K3b av1_normalize_blocks replaces preprocess.py normalize_blocks: the same
//     scaling, value by value, for blocks that are already tiled.
//
// Both multiply by float(1/1023) in fp32 and round the product to the output
// dtype (fp32 or bf16), as the TPU kernels do. (The serving pipelines divide
// by 1023 instead; in fp32 the two differ by 1 ulp on 24 of the 1024 codes.)
//
// What bounds them: 2 bytes in, 2 or 4 bytes out and one multiply per value,
// so device-memory bandwidth alone. Each thread moves 8 values: one 16-byte
// load of uint16 and one or two 16-byte stores. For the tiler, 8 neighbouring
// values of a block row are 8 neighbouring pixels of a frame row (bs is a
// multiple of 8), so both sides stay coalesced. Other block sizes and
// unaligned pointers take a one-value-per-thread path. A grid-stride loop
// caps the grid.

#include "common.cuh"

namespace {

using av1::from_f;

constexpr int THREADS = 256;
constexpr int VEC = 8;
constexpr int64_t MAX_BLOCKS = 132 * 32;

__device__ __forceinline__ float scale(uint16_t v) {
  return float(v) * static_cast<float>(1.0 / 1023.0);
}

template <typename T>
__device__ __forceinline__ void store8(T* dst, const float (&v)[VEC]);
template <>
__device__ __forceinline__ void store8<float>(float* dst, const float (&v)[VEC]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
template <>
__device__ __forceinline__ void store8<__nv_bfloat16>(__nv_bfloat16* dst,
                                                      const float (&v)[VEC]) {
  __nv_bfloat162 h[VEC / 2];
#pragma unroll
  for (int k = 0; k < VEC / 2; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(h);
}

// 8 values from 16-byte aligned src to 16-byte aligned dst
template <typename T>
__device__ __forceinline__ void convert8(const uint16_t* __restrict__ src,
                                         T* __restrict__ dst) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
  const uint16_t* u = reinterpret_cast<const uint16_t*>(&raw);
  float v[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) v[k] = scale(u[k]);
  store8<T>(dst, v);
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
normalize_kernel(const uint16_t* __restrict__ in, T* __restrict__ out, int64_t n) {
  const int64_t step = int64_t(gridDim.x) * THREADS * V;
  for (int64_t e = (int64_t(blockIdx.x) * THREADS + threadIdx.x) * V; e < n; e += step) {
    if (V == VEC && e + VEC <= n) {
      convert8<T>(in + e, out + e);
    } else {
      for (int64_t k = e; k < e + V && k < n; ++k) out[k] = from_f<T>(scale(in[k]));
    }
  }
}

// out[((f*R + r)*C + c)*bs*bs + i*bs + j] = frames[f][r*bs + i][c*bs + j] / 1023;
// with V = 8, bs is a multiple of 8 and total a multiple of 64.
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
tile_kernel(const uint16_t* __restrict__ frames, T* __restrict__ out, int64_t total,
            int rows, int cols, int bs) {
  const int64_t step = int64_t(gridDim.x) * THREADS * V;
  const int64_t bsq = int64_t(bs) * bs, per_frame = int64_t(rows) * cols;
  const int64_t width = int64_t(cols) * bs;
  for (int64_t o = (int64_t(blockIdx.x) * THREADS + threadIdx.x) * V; o < total;
       o += step) {
    const int64_t n = o / bsq, f = n / per_frame;
    const int rem = int(o - n * bsq), rc = int(n - f * per_frame);
    const int i = rem / bs, j = rem % bs, r = rc / cols, c = rc % cols;
    const int64_t src = (f * rows * bs + int64_t(r) * bs + i) * width + int64_t(c) * bs + j;
    if (V == VEC) {
      convert8<T>(frames + src, out + o);
    } else {
      out[o] = from_f<T>(scale(frames[src]));
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

int grid_for(int64_t items) {
  const int64_t blocks = (items + THREADS - 1) / THREADS;
  return int(blocks < MAX_BLOCKS ? blocks : MAX_BLOCKS);
}

template <typename T>
int launch_normalize(const void* in, void* out, int64_t n, cudaStream_t st) {
  const uint16_t* src = static_cast<const uint16_t*>(in);
  T* dst = static_cast<T*>(out);
  if (aligned16(in) && aligned16(out))
    normalize_kernel<T, VEC><<<grid_for((n + VEC - 1) / VEC), THREADS, 0, st>>>(src, dst, n);
  else
    normalize_kernel<T, 1><<<grid_for(n), THREADS, 0, st>>>(src, dst, n);
  return int(cudaGetLastError());
}

template <typename T>
int launch_tile(const void* frames, void* out, int f, int rows, int cols, int bs,
                cudaStream_t st) {
  const uint16_t* src = static_cast<const uint16_t*>(frames);
  T* dst = static_cast<T*>(out);
  const int64_t total = int64_t(f) * rows * cols * bs * bs;
  if (bs % VEC == 0 && aligned16(frames) && aligned16(out))
    tile_kernel<T, VEC><<<grid_for(total / VEC), THREADS, 0, st>>>(src, dst, total, rows,
                                                                  cols, bs);
  else
    tile_kernel<T, 1><<<grid_for(total), THREADS, 0, st>>>(src, dst, total, rows, cols, bs);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError() (0 on
// success); it neither allocates nor synchronises. `bf16` selects the output
// dtype (0: fp32); the input is uint16.

int av1_normalize_blocks(const void* in, void* out, int64_t n, int bf16, void* stream) {
  if (n <= 0) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_normalize<__nv_bfloat16>(in, out, n, st)
              : launch_normalize<float>(in, out, n, st);
}

int av1_tile_normalize_frames(const void* frames, void* out, int f, int h, int w, int bs,
                              int bf16, void* stream) {
  if (f <= 0 || bs <= 0 || h <= 0 || w <= 0 || h % bs || w % bs)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_tile<__nv_bfloat16>(frames, out, f, h / bs, w / bs, bs, st)
              : launch_tile<float>(frames, out, f, h / bs, w / bs, bs, st);
}

}  // extern "C"
