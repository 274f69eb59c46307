// Hopper (sm_90a) building blocks shared by K1, K2 (fused_front.cu), K4
// (fused_dense.cu) and K5 (resnet_group.cu): mbarrier rings, TMA tile loads
// (2-D and 3-D, plain and multicast to a thread-block cluster) and 2-D tile
// stores with their bulk groups, wgmma on shared-memory matrix descriptors
// with fp32 accumulators, cluster and named barriers, and, on the host, the
// encoding of a TMA tensor map.
//
// wgmma.m64n64k16 (one warpgroup of four warps, w = warp % 4, g = lane / 4,
// t = lane % 4):
//   A from registers: warp w holds rows 16w..16w+15 in mma.sync.m16n8k16's A
//     layout (mma.cuh): a0 (g, 2t..2t+1), a1 (g+8, ..), a2 (g, 2t+8..), a3
//     (g+8, 2t+8..), so ldmatrix.x4 builds it as it builds an m16n8k16 A.
//   D: d[4j + q] is row 16w + g + 8 (q / 2), column 8j + 2t + q % 2.
// The shared-memory operands here use the 128-byte swizzle (TMA's
// CU_TENSOR_MAP_SWIZZLE_128B): rows of 128 bytes, the 16-byte chunk c of
// row r stored at chunk c ^ (r % 8), atoms of 8 rows (1,024 bytes) that
// start on 1,024-byte boundaries.
//   K-major (A, or x in K4): rows are m, 64 bf16 of k a row; SBO = 1,024
//     (the next 8 rows); a step of 16 k adds 32 bytes to the start address.
//   MN-major (B = w as [k][n]): rows are k, 64 bf16 of n a row; SBO = 1,024
//     (the next 8 k), LBO the stride between 64-wide column blocks; a step
//     of 16 k adds 2,048 bytes. The instruction reads it transposed (tnsp-b).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace av1 {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// makes the initialised barriers visible to the cluster and to the TMA unit
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one arrival that also announces `bytes` of TMA data for this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// One arrival on the barrier at the same offset in block `rank` of the
// cluster, with the default (CTA-scope release) semantics: it only tells the
// peer's producer that a slot's reads are done, and a cluster-scope release
// cost about a microsecond an arrival on an H100.
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t rank) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(rank)
      : "memory");
}
// Waits until the barrier's phase with parity `parity` has completed. A wait
// that never ends (a broken schedule) traps after ~2^24 polls, so that the
// launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 24)) __trap();
  }
}

// ---- TMA --------------------------------------------------------------------

// The box of `map` at coordinates (c0 innermost, c1) into `dst`, completing
// its bytes on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
// The same box into `dst` of every block of the cluster in `blocks` (a bit a
// block rank), each completing on its own barrier at `bar`'s offset.
__device__ __forceinline__ void tma_load_2d_multicast(void* dst, const CUtensorMap* map,
                                                      uint64_t* bar, int c0, int c1,
                                                      uint16_t blocks) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "h"(blocks)
      : "memory");
}
// The box of a 3-D map at (c0 innermost, c1, c2) into `dst`, completing its
// bytes on `bar`. Elements outside the array (negative coordinates too) arrive
// as zeros and count as bytes of the box.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// The box at `src` (this block's shared memory) to the 2-D map at (c0, c1);
// elements outside the array are not written. Joins the thread's open bulk
// group: tma_store_commit closes it. The writes of `src` must precede it in
// the async proxy (fence_proxy_async, then a barrier, where other threads
// wrote them).
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// blocks until at most PENDING of this thread's store groups may still read
// their shared memory
template <int PENDING>
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(PENDING) : "memory");
}
__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// ---- barriers and fences ----------------------------------------------------

// bar.sync on hardware barrier `id` (1..15; __syncthreads owns 0) by `count`
// threads, whole warps
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
// makes this thread's shared-memory stores visible to wgmma and TMA reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// every thread of every block of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// ---- wgmma ------------------------------------------------------------------

// Descriptor of a 128-byte-swizzled operand that starts at `addr`.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t((lbo_bytes >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo_bytes >> 4) & 0x3FFF) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// blocks until at most PENDING committed groups of this warpgroup are in flight
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}
// Keeps the compiler from moving reads or writes of `r` across this point:
// wgmma reads and writes its registers asynchronously, out of its sight.
__device__ __forceinline__ void reg_fence(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void reg_fence(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) reg_fence(r[i]);
}

#define AV1_WGMMA_D32                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define AV1_WGMMA_D32_OPERANDS(d)                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),     \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),          \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),       \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])

// d (+)= A (64 x 16, K-major, from shared memory) * B (16 x 64, MN-major, from
// shared memory); with scale_d = 0 d is overwritten.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t a_desc,
                                                   uint64_t b_desc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " AV1_WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : AV1_WGMMA_D32_OPERANDS(d)
      : "l"(a_desc), "l"(b_desc), "r"(scale_d));
}
// d (+)= A (64 x 16, this warp's 16 rows in registers) * B (16 x 64, MN-major,
// from shared memory)
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t b_desc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " AV1_WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : AV1_WGMMA_D32_OPERANDS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(scale_d));
}

#undef AV1_WGMMA_D32
#undef AV1_WGMMA_D32_OPERANDS

// ---- host: tensor maps ------------------------------------------------------

// An array of `rank` dimensions at `base`: dims[i] elements along dimension i
// (0 innermost), dimension i + 1 `strides[i]` bytes apart, read or written in
// boxes of box[i] elements. Out-of-bounds elements read as zeros and are not
// written. Returns 0 or a cudaError_t.
inline int encode_map(CUtensorMap* map, CUtensorMapDataType dtype, int rank, const void* base,
                      const uint64_t* dims, const uint64_t* strides, const uint32_t* box,
                      CUtensorMapSwizzle swizzle) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static const Encode encode = [] {  // cuTensorMapEncodeTiled, looked up once
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      fn = nullptr;
    return reinterpret_cast<Encode>(fn);
  }();
  if (encode == nullptr) return int(cudaErrorNotSupported);
  if (rank < 1 || rank > 3) return int(cudaErrorInvalidValue);
  cuuint64_t d[3], st[2];
  cuuint32_t b[3], unit[3];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    unit[i] = 1;
    if (i + 1 < rank) st[i] = strides[i];
  }
  const CUresult r = encode(map, dtype, cuuint32_t(rank), const_cast<void*>(base), d, st, b, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);  // out of bounds reads zero
  return r == CUDA_SUCCESS ? 0 : int(cudaErrorInvalidValue);
}

// A row-major (rows, cols) array at `base` with rows `row_bytes` apart, read
// in boxes of (box_rows, box_cols) elements.
inline int encode_map_2d(CUtensorMap* map, CUtensorMapDataType dtype, const void* base,
                         uint64_t rows, uint64_t cols, uint64_t row_bytes, uint32_t box_rows,
                         uint32_t box_cols, CUtensorMapSwizzle swizzle) {
  const uint64_t dims[2] = {cols, rows};
  const uint64_t strides[1] = {row_bytes};
  const uint32_t box[2] = {box_cols, box_rows};
  return encode_map(map, dtype, 2, base, dims, strides, box, swizzle);
}

}  // namespace sm90
}  // namespace av1
