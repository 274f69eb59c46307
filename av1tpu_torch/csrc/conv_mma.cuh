// The implicit-GEMM convolution of K2 (fused_front.cu), on mma.sync.m16n8k16
// (mma.cuh). (K5's bf16 kernel, resnet_group.cu, reads the same conv stream
// layout through TMA and wgmma instead.)
//
// A block of 256 threads computes a conv for a set of output rows (sample,
// output position) whose input rows lie in shared memory, channel fastest, as
// one bf16 plane (K2's conv inputs are bf16 values). K is tap x ci and
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

// The shared-memory address of the input row that tap (dy, dx) of output row
// r reads from the plane at `in`: input extent IE at pitch IP, output extent
// OE, stride S. A tap outside the image reads the zero row.
template <int IE, int OE, int S, int IP>
__device__ __forceinline__ uint32_t tap_row(int r, int dy, int dx, uint32_t in, uint32_t zero) {
  constexpr int OP = OE * OE;
  const int s = r / OP, p = r % OP;
  const int iy = (p / OE) * S + dy, ix = (p % OE) * S + dx;
  const bool inside = unsigned(iy) < unsigned(IE) && unsigned(ix) < unsigned(IE);
  const uint32_t off = uint32_t((s * IE * IE + iy * IE + ix) * IP) * sizeof(bf16);
  return inside ? in + off : zero;
}

// acc += a conv with TAPS taps of CI input channels, for this warp's MT
// m-tiles from output row `row0` and its 64 columns from `n0`; `in` is the
// shared-memory address of the input plane, and the weights are chunks
// c0 .. c0 + TAPS * CI / 64 - 1 of the stream.
// Every thread of the block calls this with the same c0: the chunk loop holds
// the barriers.
template <class SCH, int IE, int OE, int S, int CI, int IP, int TAPS, int MT>
__device__ __forceinline__ void conv_mma(float (&acc)[MT][8][4], uint32_t in,
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
    const uint32_t k_off = uint32_t((j % PER_TAP) * KC) * sizeof(bf16) + kb;
    uint32_t a[MT];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
      a[mi] = tap_row<IE, OE, S, IP>(row0 + mi * 16 + r16, dy, dx, in, zero) + k_off;
    const uint32_t w = smem_addr(ring + (c % SCH::STAGES) * SCH::SLOT) +
                       uint32_t(r16 * SCH::WPITCH + n0) * sizeof(bf16) + kb;
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      uint32_t f[MT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) ldmatrix_x4(f[mi], a[mi] + kk * 32);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, w + uint32_t(kk * 16 * SCH::WPITCH + nj * 16) * sizeof(bf16));
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          mma_bf16(acc[mi][2 * nj], f[mi], b[0], b[1]);
          mma_bf16(acc[mi][2 * nj + 1], f[mi], b[2], b[3]);
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
