// The implicit-GEMM convolution shared by K2 (fused_front.cu) and K5
// (resnet_group.cu), on mma.sync.m16n8k16 (mma.cuh).
//
// A block of 256 threads computes a conv for a set of output rows (sample,
// output position) whose input rows lie in shared memory, channel fastest, as
// NP bf16 planes: one plane where the conv input is a bf16 value (K2), two
// (hi, lo) where it is an fp32 value carried to 16 bits (K5). K is tap x ci and
// N is 64 columns a warp. No border is stored: the lane that owns row r of an
// ldmatrix tile computes the address of its input row for each tap, and a tap
// outside the image points at one shared row of zeros.
//
// The weights come as one stream of chunks of KC = 64 k-rows in the order of
// use ([tap][ci][co] is k-major already). A ring of cp.async slots runs
// STAGES - 1 chunks ahead of the math, straight through the boundaries
// between convs, with one __syncthreads per chunk. A schedule type S says how
// the stream is cut:
//   S::STAGES, S::CHUNKS        ring slots; chunks in the stream
//   S::WPITCH, S::SLOT          ring row pitch and slot size, in elements
//   S::cols(c), S::offset(c)    columns of chunk c; its first element
// Every thread of the block must have committed the same number of cp.async
// groups when it enters conv_mma, the first STAGES - 1 chunks the latest of
// them: the waits count groups.
#pragma once

#include "mma.cuh"

namespace av1 {
namespace conv {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int KC = 64;  // k rows of a weight chunk

// Chunk c of the weight stream into its ring slot, as one cp.async group
// (an empty group past the end, so that the group count stays in step).
template <class S>
__device__ __forceinline__ void fetch_chunk(const bf16* __restrict__ stream, bf16* ring, int c) {
  if (c < S::CHUNKS) {
    const int n = S::cols(c);
    const bf16* src = stream + S::offset(c);
    bf16* dst = ring + (c % S::STAGES) * S::SLOT;
    const int per_row = n / 8;
    for (int i = threadIdx.x; i < KC * per_row; i += THREADS) {
      const int row = i / per_row, col = (i % per_row) * 8;
      cp_async16(smem_addr(dst + row * S::WPITCH + col), src + row * n + col);
    }
  }
  cp_async_commit();
}

// The shared-memory address, in each plane, of the input row that tap
// (dy, dx) of output row r reads: input extent IE at pitch IP, output extent
// OE, stride S. A tap outside the image reads the zero row.
template <int IE, int OE, int S, int IP, int NP>
__device__ __forceinline__ void tap_row(int r, int dy, int dx, const uint32_t (&in)[NP],
                                        uint32_t zero, uint32_t (&a)[NP]) {
  constexpr int OP = OE * OE;
  const int s = r / OP, p = r % OP;
  const int iy = (p / OE) * S + dy, ix = (p % OE) * S + dx;
  const bool inside = unsigned(iy) < unsigned(IE) && unsigned(ix) < unsigned(IE);
  const uint32_t off = uint32_t((s * IE * IE + iy * IE + ix) * IP) * sizeof(bf16);
#pragma unroll
  for (int pl = 0; pl < NP; ++pl) a[pl] = inside ? in[pl] + off : zero;
}

// acc += a conv with TAPS taps of CI input channels, for this warp's MT
// m-tiles from output row `row0` and its 64 columns from `n0`; `in` holds the
// shared-memory addresses of the input planes (the most significant first),
// and the weights are chunks c0 .. c0 + TAPS * CI / 64 - 1 of the stream.
// Every thread of the block calls this with the same c0: the chunk loop holds
// the barriers.
template <class SCH, int IE, int OE, int S, int CI, int IP, int TAPS, int MT, int NP>
__device__ __forceinline__ void conv_mma(float (&acc)[MT][8][4], const uint32_t (&in)[NP],
                                         uint32_t zero, int row0, int n0,
                                         const bf16* __restrict__ stream, bf16* ring, int c0,
                                         int lane) {
  constexpr int PER_TAP = CI / KC;
  const int r16 = lane % 16;
  const uint32_t kb = 16 * (lane / 16);  // bytes: 8 elements along k (A) or n (B)
#pragma unroll 1
  for (int j = 0; j < TAPS * PER_TAP; ++j) {
    const int c = c0 + j;
    cp_async_wait<SCH::STAGES - 2>();  // chunk c has landed
    __syncthreads();                   // ... for every thread; chunk c-1 is consumed
    fetch_chunk<SCH>(stream, ring, c + SCH::STAGES - 1);
    const int tap = j / PER_TAP;
    const int dy = TAPS == 1 ? 0 : tap / 3 - (S == 1 ? 1 : 0);
    const int dx = TAPS == 1 ? 0 : tap % 3 - (S == 1 ? 1 : 0);
    uint32_t a[MT][NP];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      tap_row<IE, OE, S, IP, NP>(row0 + mi * 16 + r16, dy, dx, in, zero, a[mi]);
      const uint32_t k_off = uint32_t((j % PER_TAP) * KC) * sizeof(bf16) + kb;
#pragma unroll
      for (int pl = 0; pl < NP; ++pl) a[mi][pl] += k_off;
    }
    const uint32_t w = smem_addr(ring + (c % SCH::STAGES) * SCH::SLOT) +
                       uint32_t(r16 * SCH::WPITCH + n0) * sizeof(bf16) + kb;
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      uint32_t f[MT][NP][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int pl = 0; pl < NP; ++pl) ldmatrix_x4(f[mi][pl], a[mi][pl] + kk * 32);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, w + uint32_t(kk * 16 * SCH::WPITCH + nj * 16) * sizeof(bf16));
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          // planes from the least significant up
#pragma unroll
          for (int pl = NP - 1; pl >= 0; --pl) mma_bf16(acc[mi][2 * nj], f[mi][pl], b[0], b[1]);
#pragma unroll
          for (int pl = NP - 1; pl >= 0; --pl)
            mma_bf16(acc[mi][2 * nj + 1], f[mi][pl], b[2], b[3]);
        }
      }
    }
  }
}

// f(row, col, v0, v1) for every pair of neighbouring columns this thread
// holds of its warp's accumulators.
template <int MT, class F>
__device__ __forceinline__ void for_each_pair(const float (&acc)[MT][8][4], int row0, int n0,
                                              int lane, F f) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        f(row0 + mi * 16 + g + 8 * h, n0 + ni * 8 + 2 * t, acc[mi][ni][2 * h],
          acc[mi][ni][2 * h + 1]);
}

template <int MT>
__device__ __forceinline__ void zero_acc(float (&acc)[MT][8][4]) {
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;
}

}  // namespace conv
}  // namespace av1
