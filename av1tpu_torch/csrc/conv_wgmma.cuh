// The implicit-GEMM 3x3 convolution on wgmma shared by K2 (fused_front.cu,
// layer 1 on one bf16 plane) and K5 (resnet_group.cu, every conv on the hi/lo
// planes of an fp32 activation).
//
// A block has two consumer warpgroups and one producer warp (G_THREADS).
// Rows are (sample, output position), position-major inside the block (row
// p * SPB + s), so a 64-row tile holds whole positions and the taps that fall
// outside the image are the same for all its rows. K is tap x ci, N is 64
// columns a warpgroup.
//   * A from registers: each lane computes the shared-memory address of its
//     row's input row for each tap (pm_tap_row), ldmatrix builds the
//     fragments (wgmma's register A is mma.sync's m16n8k16 A, a warp 16
//     rows), and a tap outside the image reads one shared row of zeros. An
//     activation is NP bf16 planes (1: bf16 values; 2: hi and lo of fp32
//     values), each B chunk feeding NP wgmmas a tile.
//   * B from shared memory: the weights are one stream of chunks of KC k-rows
//     in the order of use (kernels/resnet_group.py group12_conv_stream; K2's
//     conv_w is its head, the 36 chunks of layer 1). One producer lane
//     fetches by TMA, from maps in 64-column boxes with the 128-byte swizzle,
//     into a ring of STAGES slots with full and empty mbarriers. Blocks run in
//     clusters of two: each block fetches half of every chunk's rows and
//     multicasts it to both; the empty barrier counts both blocks' consumer
//     warpgroups, one CTA-scope arrival each once its wgmmas are done.
//   * The host's table of the taps each 64-row tile computes (TileTaps,
//     kernels/resnet_group.py group12_tile_taps) skips a tap none of a tile's
//     rows reads inside the image, and the fetch of a tap no tile reads.
//   * One accumulator chain a tile: two tiles of a warpgroup alternate, a lone
//     tile on two planes alternates between the planes, a lone tile on one
//     plane chains its wgmmas. Which tiles compute a chunk is one of three
//     patterns, each compiled on its own: ptxas serialises (C75xx) wgmmas
//     behind a condition it cannot see through, and wherever A registers may
//     be rewritten while a wgmma group may read them.
#pragma once

#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace av1 {
namespace convwg {

using bf16 = __nv_bfloat16;

constexpr int CONSUMERS = 256;              // two warpgroups
constexpr int G_THREADS = CONSUMERS + 32;   // and one producer warp
constexpr int CONSUMER_BARRIER = 1;         // named barrier of the two warpgroups
constexpr int WARPGROUP_BARRIER = 2;        // ... and 3: each warpgroup's own
constexpr int CLUSTER = 2;                  // blocks that share each weight chunk
constexpr int STAGES = 4;                   // weight ring depth
constexpr int KC = 64;                      // k-rows of a weight chunk
constexpr int BOX_ROWS = KC / CLUSTER;      // k-rows of a chunk that each block fetches
constexpr int BOX_BYTES = BOX_ROWS * 128;   // ... of one 64-column box
constexpr int N_CONVS = 9, MAX_TILES = 4;
constexpr int CHUNKS1 = 36;                 // layer 1's chunks: 64 columns; the rest 128

// The convs in the order of the stream: which taps each 64-row tile computes
// (bit tap; built by the host, kernels/resnet_group.py group12_tile_taps).
// Layer 1 has 256 / 64 tiles (128 / 64 at extent 2), layer 2 one; a tap no
// tile of the block computes is not fetched either.
struct TileTaps {
  uint16_t taps[N_CONVS][MAX_TILES];
};
enum { L10_C1, L10_C2, L11_C1, L11_C2, L20_C1, L20_C2, L20_DS, L21_C1, L21_C2 };
// the first chunk of conv j in the stream; its taps and chunks a tap
__device__ __forceinline__ int first_chunk(int j) {
  return j < L20_C1 ? 9 * j : j == L20_C1 ? 36 : j == L20_C2 ? 45 : j == L20_DS ? 63
         : j == L21_C1 ? 64 : 82;
}
__device__ __forceinline__ int conv_taps(int j) { return j == L20_DS ? 1 : 9; }
__device__ __forceinline__ int chunks_a_tap(int j) {
  return j == L20_C2 || j == L21_C1 || j == L21_C2 ? 2 : 1;
}
__device__ __forceinline__ int chunk_cols(int c) { return c < CHUNKS1 ? 64 : 128; }

// Accumulators of a tile: two for a lone tile on two planes, else one.
template <int MT, int NP>
struct Accs {
  static constexpr int N = NP == 2 && MT == 1 ? 2 : 1;
};

// The weight ring: STAGES slots of SLOT bytes (one chunk), a full and an
// empty barrier each. Every thread of a role counts the chunks it has passed
// in `q`.
template <int SLOT>
struct Ring {
  uint8_t* slots;
  uint64_t* full;
  uint64_t* empty;
  int q;
  __device__ uint8_t* slot() const { return slots + (q % STAGES) * SLOT; }
  __device__ uint32_t parity() const { return (q / STAGES) & 1; }
};

// The producer (one lane): every chunk of the block's first NC convs that it
// fetches, in order; this block's BOX_ROWS-row half of each 64-column box,
// multicast to the cluster. map1 views the 64-column chunks, map2 the rest.
template <int NC, class R>
__device__ void produce(const CUtensorMap* map1, const CUtensorMap* map2, const TileTaps& tt,
                        R ring) {
  const uint32_t rank = sm90::cluster_rank();
#pragma unroll 1
  for (int j = 0; j < NC; ++j) {
    const uint32_t fetch = tt.taps[j][0] | tt.taps[j][1] | tt.taps[j][2] | tt.taps[j][3];
    const int first = first_chunk(j), per_tap = chunks_a_tap(j);
#pragma unroll 1
    for (int tap = 0; tap < conv_taps(j); ++tap) {
      if (!(fetch >> tap & 1)) continue;
#pragma unroll 1
      for (int u = 0; u < per_tap; ++u, ++ring.q) {
        const int c = first + tap * per_tap + u;
        const int boxes = chunk_cols(c) / 64;
        const int s = ring.q % STAGES;
        if (ring.q >= STAGES) sm90::mbar_wait(&ring.empty[s], (ring.q / STAGES - 1) & 1);
        sm90::mbar_expect_tx(&ring.full[s], boxes * KC * 128);
        const CUtensorMap* map = c < CHUNKS1 ? map1 : map2;
        const int row = (c < CHUNKS1 ? c : c - CHUNKS1) * KC + int(rank) * BOX_ROWS;
        for (int bx = 0; bx < boxes; ++bx)
          sm90::tma_load_2d_multicast(ring.slot() + bx * KC * 128 + rank * BOX_BYTES, map,
                                      &ring.full[s], bx * 64, row, (1 << CLUSTER) - 1);
      }
    }
  }
}

// The shared-memory address, in each of the NP planes, of the input row that
// tap (dy, dx) of output row r reads: input extent IE at pitch IP, output
// extent OE, stride S, SPB samples, rows position-major. A tap outside the
// image, and a row past the block's NROWS, reads the zero row.
template <int IE, int OE, int S, int IP, int SPB, int NROWS, int NP>
__device__ __forceinline__ void pm_tap_row(int r, int dy, int dx, const uint32_t (&in)[NP],
                                           uint32_t zero, uint32_t (&a)[NP]) {
  const int s = r % SPB, p = r / SPB;
  const int iy = (p / OE) * S + dy, ix = (p % OE) * S + dx;
  const bool inside =
      r < NROWS && unsigned(iy) < unsigned(IE) && unsigned(ix) < unsigned(IE);
  const uint32_t off = uint32_t(((iy * IE + ix) * SPB + s) * IP) * sizeof(bf16);
#pragma unroll
  for (int pl = 0; pl < NP; ++pl) a[pl] = inside ? in[pl] + off : zero;
}

// The wgmmas of one chunk for the tiles in ACTIVE (bit i: tile i), their
// A fragments f[tile][plane][k16 step] in registers, B at shared address b.
// Two tiles keep one accumulator each and the instructions alternate between
// the tiles; a tile alone on two planes keeps one a plane and they alternate
// between the planes: consecutive wgmmas never wait on each other's sums.
template <int MT, int NP, int ACTIVE>
__device__ __forceinline__ void chunk_mma(float (&acc)[MT][Accs<MT, NP>::N][32],
                                          uint32_t (&f)[MT][NP][4][4], uint32_t b) {
  constexpr int NA = Accs<MT, NP>::N;
#pragma unroll
  for (int i = 0; i < MT; ++i)  // no register of the wgmmas moves past the fence
#pragma unroll
    for (int pl = 0; pl < NP; ++pl) {
      if (pl < NA) sm90::reg_fence(acc[i][pl]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) sm90::reg_fence(f[i][pl][kk][e]);
    }
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t desc = sm90::desc_sw128(b + kk * 2048, 8192, 1024);
#pragma unroll
    for (int pl = NP - 1; pl >= 0; --pl)  // lo, then hi
#pragma unroll
      for (int i = 0; i < MT; ++i)
        if ((ACTIVE >> i & 1) != 0)  // constant once unrolled
          sm90::wgmma_m64n64k16_rs(acc[i][NA == 2 ? pl : 0], f[i][pl][kk], desc, 1);
  }
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int c = 0; c < NA; ++c) sm90::reg_fence(acc[i][c]);
}

// acc[i] += conv J on the NP planes `in_hi` (and `in_lo`) for tile i of this
// warpgroup (rows row0 + 64 i ..), output columns n0 .. n0 + 63, MT tiles:
// each chunk's A fragments by ldmatrix (a lane its row's address), then the
// chunk's wgmmas (register A, B from the ring) for the tiles that compute
// its tap: a tile none of whose rows reads inside the image at a tap skips
// it. Every consumer thread walks every chunk the block fetches.
template <int J, int IE, int OE, int S, int CI, int IP, int SPB, int NROWS, int MT, int NP,
          class R>
__device__ __forceinline__ void conv_wg(float (&acc)[MT][Accs<MT, NP>::N][32],
                                        const bf16* in_hi, const bf16* in_lo, uint32_t zero,
                                        int row0, int n0, const TileTaps& tt, int tile0, R& ring,
                                        int lane) {
  constexpr int TAPS = (J == L20_DS) ? 1 : 9, PER_TAP = CI / KC;
  uint32_t in[NP];
  in[0] = sm90::smem_u32(in_hi);
  if constexpr (NP == 2) in[1] = sm90::smem_u32(in_lo);
  const int warp_row = (threadIdx.x / 32 % 4) * 16 + lane % 16;
  const uint32_t kb = 16 * (lane / 16);  // bytes: 8 elements along k
  const uint32_t fetch = tt.taps[J][0] | tt.taps[J][1] | tt.taps[J][2] | tt.taps[J][3];
  uint32_t mine[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) mine[i] = tt.taps[J][tile0 + i];
#pragma unroll 1
  for (int tap = 0; tap < TAPS; ++tap) {
    if (!(fetch >> tap & 1)) continue;
    const int dy = TAPS == 1 ? 0 : tap / 3 - (S == 1 ? 1 : 0);
    const int dx = TAPS == 1 ? 0 : tap % 3 - (S == 1 ? 1 : 0);
    uint32_t rows[MT][NP];
    int active = 0;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      pm_tap_row<IE, OE, S, IP, SPB, NROWS, NP>(row0 + i * 64 + warp_row, dy, dx, in, zero,
                                                rows[i]);
      active |= int(mine[i] >> tap & 1) << i;
    }
#pragma unroll 1
    for (int u = 0; u < PER_TAP; ++u, ++ring.q) {
      uint32_t f[MT][NP][4][4];  // tile, plane, k16 step
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int pl = 0; pl < NP; ++pl)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            av1::ldmatrix_x4(f[i][pl][kk], rows[i][pl] + u * KC * 2 + kb + kk * 32);
      sm90::mbar_wait(&ring.full[ring.q % STAGES], ring.parity());
      const uint32_t b = sm90::smem_u32(ring.slot()) + (n0 / 64) * KC * 128;
      if (active == (1 << MT) - 1) {
        chunk_mma<MT, NP, (1 << MT) - 1>(acc, f, b);
      } else if (MT == 2 && active == 1) {
        chunk_mma<MT, NP, 1>(acc, f, b);
      } else if (MT == 2 && active == 2) {
        chunk_mma<MT, NP, 2>(acc, f, b);
      }
      // the warpgroup is done with the slot
      sm90::named_barrier(WARPGROUP_BARRIER + threadIdx.x / 128, 128);
      if (threadIdx.x % 128 == 0)
        for (int r = 0; r < CLUSTER; ++r)
          sm90::mbar_arrive_cluster(&ring.empty[ring.q % STAGES], r);
    }
  }
}

// This thread's bias pairs (columns n0 + 8j + 2t, + 1) of `b`, plus those of
// `more` where given, loaded together before an epilogue.
template <typename T>
__device__ __forceinline__ void load_bias(float (&bias)[8][2], const T* b, int n0, int lane,
                                          const T* more = nullptr) {
  const int t = lane % 4;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int col = n0 + 8 * j + 2 * t + q;
      bias[j][q] = more == nullptr ? ldg_f(b + col) : ldg_f(b + col) + ldg_f(more + col);
    }
}

// f(row, col, v0, v1) for every pair of neighbouring columns this thread
// holds of its warpgroup's MT tiles (rows row0 + 64 i ..., columns n0 ..),
// each value the sum of its accumulators plus its bias.
template <int MT, int NA, class F>
__device__ __forceinline__ void for_each_pair(const float (&acc)[MT][NA][32],
                                              const float (&bias)[8][2], int row0, int n0,
                                              int lane, F f) {
  const int g = lane / 4, t = lane % 4, w = threadIdx.x / 32 % 4;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = 4 * j + 2 * h;
        float v0 = acc[i][0][q], v1 = acc[i][0][q + 1];
        if (NA == 2) {  // a tile alone on two planes sums its two accumulators
          v0 += acc[i][NA - 1][q];
          v1 += acc[i][NA - 1][q + 1];
        }
        f(row0 + i * 64 + w * 16 + g + 8 * h, n0 + 8 * j + 2 * t, v0 + bias[j][0],
          v1 + bias[j][1]);
      }
}

template <int MT, int NA>
__device__ __forceinline__ void zero_acc(float (&acc)[MT][NA][32]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int c = 0; c < NA; ++c)
#pragma unroll
      for (int q = 0; q < 32; ++q) acc[i][c][q] = 0.f;
}

__device__ __forceinline__ void consumer_sync() {
  sm90::named_barrier(CONSUMER_BARRIER, CONSUMERS);
}

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024 - (sm90::smem_u32(p) & 1023)) & 1023);
}

}  // namespace convwg
}  // namespace av1
