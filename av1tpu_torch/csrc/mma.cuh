// Building blocks the wgmma kernels take beside hopper.cuh: cp.async 16-byte
// copies with commit/wait groups (K5's input), ldmatrix fragment loads (the
// register A of K2's and K5's convs, conv_wgmma.cuh), and the bf16 packing
// and the splits of an fp32 value into bf16 pieces (K4, K5).
//
// wgmma's register A is, a warp of 16 rows, mma.sync.m16n8k16's A fragment
// (g = lane / 4, t = lane % 4; the element with the lower index in the low
// half of a 32-bit register):
//   a0: (g, 2t..2t+1)   a1: (g+8, 2t..2t+1)   a2: (g, 2t+8..2t+9)   a3: (g+8, 2t+8..2t+9)
// ldmatrix.x4 reads four 8 x 8 tiles of 16-bit values; lanes 8i..8i+7 give the
// addresses of the eight 16-byte rows of tile i. With a tile stored [m][k]
// (k fastest), lane l pointing at row l % 16 and column 8 * (l / 16) yields
// a0..a3.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace av1 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; `bytes` (0 or 16) of the source
// are read and the rest of the destination is zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// blocks until at most PENDING of this thread's committed groups are in flight
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// two floats as a bf16 pair, `lo_elem` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo_elem, float hi_elem) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo_elem, hi_elem);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// v = hi + lo + (an error below 2^-17 |v|): hi = bf16(v), lo = bf16(v - hi)
__device__ __forceinline__ void split2(float v, float& hi, float& lo) {
  hi = __bfloat162float(__float2bfloat16_rn(v));
  lo = __bfloat162float(__float2bfloat16_rn(v - hi));
}
// the pair (x, y) as packed hi and lo bf16 pairs
__device__ __forceinline__ void split2_pack(float x, float y, uint32_t& hi, uint32_t& lo) {
  float xh, xl, yh, yl;
  split2(x, xh, xl);
  split2(y, yh, yl);
  hi = pack_bf16(xh, yh);
  lo = pack_bf16(xl, yl);
}
// Three bf16 pieces of the pair (x, y), packed: v = hi + mid + lo exactly.
// The pieces are cut by truncation (masks and exact subtractions, no
// conversion instruction): hi is the top 8 bits of the 24-bit significand,
// mid the next 8 significant bits, lo the rest, which fits 8 bits.
__device__ __forceinline__ void split3_pack(float x, float y, uint32_t& hi, uint32_t& mid,
                                            uint32_t& lo) {
  constexpr uint32_t TOP = 0xffff0000u;
  const uint32_t xh = __float_as_uint(x) & TOP, yh = __float_as_uint(y) & TOP;
  const float xr = x - __uint_as_float(xh), yr = y - __uint_as_float(yh);
  const uint32_t xm = __float_as_uint(xr) & TOP, ym = __float_as_uint(yr) & TOP;
  const float xl = xr - __uint_as_float(xm), yl = yr - __uint_as_float(ym);
  hi = __byte_perm(xh, yh, 0x7632);  // the upper halves: x low, y high
  mid = __byte_perm(xm, ym, 0x7632);
  lo = __byte_perm(__float_as_uint(xl), __float_as_uint(yl), 0x7632);
}

}  // namespace av1
