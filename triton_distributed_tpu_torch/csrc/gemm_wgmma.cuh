// The wgmma + TMA mainloop of the fused GEMM kernels B9 (ag_gemm) and B10
// (gemm_rs) in gemm_comm.cu, bf16 at the tall tile, and of B3's tall route
// in gemm.cu (bf16, and e4m3 through the K-major forms at the end of this
// file): C = A @ B with A (M, K) row-major and B (K, N) row-major as
// stored, fp32 accumulation, one cast.
//
// A block of THREADS threads is three warpgroups:
//  - warpgroup 2, the producer (setmaxnreg down to kProducerRegs): its
//    warp 0 keeps TMA loads in flight into a ring of STAGES stages, each
//    stage A's 128 x 64 tile (K-major) and B's 64 x BN tile (MN-major, BN /
//    64 boxes of 64 columns), 128-byte swizzled, completed through the
//    stage's full mbarrier; its warps 1-3 are free for the kernel's own
//    work (B9 pushes A's sub-blocks to the peers with them);
//  - warpgroups 0 and 1, the consumers (setmaxnreg up to kConsumerRegs):
//    rows 64 wg .. 64 wg + 63 of each output tile, SS-wgmma m64nBNk16
//    with B read through the transpose bit (nothing is transposed in
//    registers); one k-step's wgmmas stay in flight while the next is
//    issued (wait_group 1), and each stage goes back through its empty
//    mbarrier once its wgmmas have retired.
// Blocks run in clusters of two that take row tiles 2 p and 2 p + 1 of the
// same columns: launched together, the pair reads each B tile from L2 at
// about the same time. The ring runs on across a block's output tiles: the
// producer loads the next tile's k-steps while the consumers finish this
// one and store it.
//
// What bounds it (variants of this design timed on an H100 at the main
// path's shapes, 4 ranks on one card): the bytes the ring pulls from L2 —
// 32 KiB a k-step for 2.1 MFLOP at 128 x 128, 48 KiB for twice the work
// at 128 x 256 — not the ring's depth (handing each stage back a k-step
// earlier gained nothing). Hence BN 256 where the output has 512 columns
// or more, and the cluster pairs (w_gate / w_up ran slower without them;
// sharing the B tile across the pair by TMA multicast was no faster, so
// it is not done). The narrow outputs (B9's wk / wv, 256
// columns) keep BN 128, so their tiles still cover a rank's blocks. 64 or
// 128 accumulators a consumer thread fit the register cap; the ring is
// 192 KiB either way (6 stages of 32 KiB, 4 of 48 KiB), more than half an
// SM's shared memory (one block an SM, as gemm_comm.cu requires). What is
// left at the short shapes lies outside the mainloop: B9's peer tiles
// wait for their pushes, B10's reduce follows the last tile (PERF.md).
//
// Epilogue: each consumer thread casts its fp32 fragment once to bf16, and
// the 4 lanes of a quad trade words (two xor shuffles, twice) so that each
// holds 8 consecutive columns of one row: 16-byte stores straight from
// registers, a warp's store 16 rows x 32 bytes, rows and columns past the
// valid edge left out. Tails of M, N and K are zero-filled by the tensor
// maps' extents and never read past. Pair tiles are walked column-major
// inside a group of rows (a B9 (source, sub-block), a B10 chunk), so the
// clusters working at once share their B columns in L2.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace tdt {
namespace wg {

using namespace tdt::hopper;

constexpr int BM = 128, BK = 64;
constexpr int THREADS = 384;               // consumers 0, 1; producer 2
constexpr int CONSUMER_WARPS = 8;
constexpr int CLUSTER = 2;                 // CTAs on a pair of row tiles
constexpr int kProducerRegs = 56, kConsumerRegs = 224;
constexpr int A_BYTES = BM * BK * 2;       // one 128-row box, 128 B a row
constexpr int B_BOX = BK * 64 * 2;         // 64 K rows x 64 columns
constexpr int RING_BYTES = 192 << 10;
constexpr int BARS = 128;
// Dynamic shared memory: 1024 to align the ring to the swizzle's period,
// the ring, the mbarriers.
constexpr int SMEM_BYTES = 1024 + RING_BYTES + BARS;

template <int BN>
struct Cfg {
  static_assert(BN == 128 || BN == 256, "wgmma tile width");
  static constexpr int B_BYTES = (BN / 64) * B_BOX;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int STAGES = RING_BYTES / STAGE;
  static_assert(STAGES >= 3 && 2 * STAGES * 8 <= BARS, "ring and barriers");
};

// Named barriers (0 is __syncthreads): the producer's free warps (B9's
// pushers), the two consumer warpgroups together.
constexpr int kBarPushers = 1, kBarConsumers = 2;

struct Ring {
  uint32_t a0, b0, full0, empty0;
};

template <int BN>
__device__ __forceinline__ Ring ring_of(uint8_t* smem_raw) {
  const uint32_t s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  Ring r;
  r.a0 = s;
  r.b0 = s + Cfg<BN>::STAGES * A_BYTES;
  r.full0 = s + RING_BYTES;
  r.empty0 = r.full0 + 8 * Cfg<BN>::STAGES;
  return r;
}

// Thread 0 only; the block meets after.
template <int BN>
__device__ __forceinline__ void ring_init(const Ring& r) {
  for (int s = 0; s < Cfg<BN>::STAGES; ++s) {
    mbar_init(r.full0 + 8 * s, 1);
    mbar_init(r.empty0 + 8 * s, CONSUMER_WARPS);
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Row-tile pairs of a group of `rt` row tiles: a cluster's two CTAs take
// row tiles 2 p and 2 p + 1 (the second may lie past the group: its rows
// are computed and never stored) of the same columns, so the two read one
// B tile from L2 at about the same time.
__host__ __device__ __forceinline__ int pairs_of(int rt) {
  return (rt + 1) / 2;
}

// The cluster's pair tile w of a group of `rtp` row-tile pairs, for CTA
// `crank`: column-major, so the clusters working at once share B's
// columns. Returns (row offset, column offset).
__device__ __forceinline__ int2 tile_at(int w, int rtp, int bn, int crank) {
  return make_int2((2 * (w % rtp) + crank) * BM, (w / rtp) * bn);
}

// Producer, one lane: the `ktiles` k-steps of one output tile — A's rows
// [arow, arow + 128) of map `ta`, B's columns [col0, col0 + BN) of `tb` —
// into the ring; `it` counts the block's k-steps across tiles.
template <int BN>
__device__ __forceinline__ void load_tile(const Ring& r, int& it,
                                          const CUtensorMap* ta, int arow,
                                          const CUtensorMap* tb, int col0,
                                          int ktiles) {
  using C = Cfg<BN>;
  for (int kt = 0; kt < ktiles; ++kt, ++it) {
    const int s = it % C::STAGES;
    if (it >= C::STAGES)
      mbar_wait(r.empty0 + 8 * s, ((it / C::STAGES) - 1) & 1);
    const uint32_t full = r.full0 + 8 * s;
    const uint32_t sb = r.b0 + s * C::B_BYTES;
    mbar_expect_tx(full, C::STAGE);
    tma_load(r.a0 + s * A_BYTES, ta, full, kt * BK, arow);
#pragma unroll
    for (int c = 0; c < BN / 64; ++c)
      tma_load(sb + c * B_BOX, tb, full, col0 + 64 * c, kt * BK);
  }
}

template <int BN>
__device__ __forceinline__ void wgmma_bn(float (&acc)[BN / 2], uint64_t a,
                                         uint64_t b, int scale_d) {
  if constexpr (BN == 256)
    wgmma_ss_m64n256<1>(acc, a, b, scale_d);
  else
    wgmma_ss_m64n128<1>(acc, a, b, scale_d);
}

// Consumer warpgroup `wgi`: its 64 x BN share of one output tile into
// `acc` (overwritten), over the tile's `ktiles` k-steps from the ring.
template <int BN>
__device__ __forceinline__ void mma_tile(const Ring& r, int& it, int ktiles,
                                         int wgi, float (&acc)[BN / 2]) {
  using C = Cfg<BN>;
  const int lane = threadIdx.x & 31;
  // Hand stage `st` back to the producer.
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(r.empty0 + 8 * st);
  };
  int prev = -1;
  fence_regs(acc);
  for (int kt = 0; kt < ktiles; ++kt, ++it) {
    const int s = it % C::STAGES;
    mbar_wait(r.full0 + 8 * s, (it / C::STAGES) & 1);
    const uint32_t a = r.a0 + s * A_BYTES + wgi * 64 * 128;
    const uint32_t b = r.b0 + s * C::B_BYTES;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_bn<BN>(acc, sw128_desc(a + kk * 32, 16),
                   sw128_desc(b + kk * 16 * 128, B_BOX), kt > 0 || kk > 0);
    wg_commit();
    wg_wait1();
    fence_regs(acc);
    // The previous k-step's wgmmas have retired: its stage goes back.
    if (prev >= 0) release(prev);
    prev = s;
  }
  wg_wait0();
  fence_regs(acc);
  release(prev);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Consumer warpgroup `wgi`: store its rows of the tile whose corner is
// `dst` (row stride `ld` elements), cast once to bf16; rows >= `rows` and
// columns >= `cols` of the tile are left out (`cols` a multiple of 8).
// Fragment: a thread holds rows r0 and r0 + 8 (r0 = 16 warp + lane / 4),
// columns 8 j + 2 q, + 1 (q = lane % 4) in acc[4 j + 2 half], + 1. For
// each pair (j, j + 1) the quad's 4 x 4 words are transposed, so lane q
// holds the 8 columns of chunk q: row r0 + 8 (q / 2), columns 8 (j + q % 2).
template <int BN>
__device__ __forceinline__ void store_tile(int wgi, const float (&acc)[BN / 2],
                                           __nv_bfloat16* dst, long long ld,
                                           int rows, int cols) {
  const int t = threadIdx.x & 127;
  const int lane = t & 31, q = lane & 3;
  const bool odd = q & 1, hi = q & 2;
  const int row = 64 * wgi + 16 * (t >> 5) + (lane >> 2) + (hi ? 8 : 0);
  const bool row_ok = row < rows;
  dst += (long long)row * ld;
#pragma unroll
  for (int j = 0; j < BN / 8; j += 2) {
    uint32_t w0 = pack2(acc[4 * j], acc[4 * j + 1]);
    uint32_t w1 = pack2(acc[4 * j + 4], acc[4 * j + 5]);
    uint32_t w2 = pack2(acc[4 * j + 2], acc[4 * j + 3]);
    uint32_t w3 = pack2(acc[4 * j + 6], acc[4 * j + 7]);
    uint32_t s0 = odd ? w0 : w1, s1 = odd ? w2 : w3;
    s0 = __shfl_xor_sync(0xffffffffu, s0, 1);
    s1 = __shfl_xor_sync(0xffffffffu, s1, 1);
    if (odd) {
      w0 = s0;
      w2 = s1;
    } else {
      w1 = s0;
      w3 = s1;
    }
    s0 = hi ? w0 : w2;
    s1 = hi ? w1 : w3;
    s0 = __shfl_xor_sync(0xffffffffu, s0, 2);
    s1 = __shfl_xor_sync(0xffffffffu, s1, 2);
    if (hi) {
      w0 = s0;
      w1 = s1;
    } else {
      w2 = s0;
      w3 = s1;
    }
    const int col = 8 * (j + (odd ? 1 : 0));
    if (row_ok && col < cols)
      *reinterpret_cast<uint4*>(dst + col) = make_uint4(w0, w1, w2, w3);
  }
}

// ---------------------------------------------------------------------------
// B3's other epilogues and its e4m3 operands (gemm.cu). The bf16 forms
// above stay as B9 / B10 compile them.
// ---------------------------------------------------------------------------

// The 4 x 4 word transpose of a quad (the exchange store_tile does inline):
// x[t] is this lane's word for quad lane t; on return x[s] is quad lane
// s's word for this lane. Two rounds of two xor shuffles; the words a lane
// keeps stay in place, so no register is indexed by the lane.
__device__ __forceinline__ void quad_transpose(uint32_t (&x)[4]) {
  const int q = threadIdx.x & 3;
  const bool b0 = q & 1, b1 = q & 2;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    uint32_t s = b0 ? x[2 * u] : x[2 * u + 1];
    s = __shfl_xor_sync(0xffffffffu, s, 1);
    if (b0)
      x[2 * u] = s;
    else
      x[2 * u + 1] = s;
  }
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    uint32_t s = b1 ? x[v] : x[2 + v];
    s = __shfl_xor_sync(0xffffffffu, s, 2);
    if (b1)
      x[v] = s;
    else
      x[2 + v] = s;
  }
}

// Consumer warpgroup `wgi`: store its rows of the tile at `dst` (row
// stride `ld` floats) in fp32; rows >= `rows` and columns >= `cols` left
// out (`cols` a multiple of 4). For each 8-column group j the even lane of
// a quad pair takes row r0, the odd one row r0 + 8, each 4 consecutive
// columns (one xor shuffle of two words): 16-byte stores.
template <int BN>
__device__ __forceinline__ void store_tile_f32(int wgi,
                                               const float (&acc)[BN / 2],
                                               float* dst, long long ld,
                                               int rows, int cols) {
  const int t = threadIdx.x & 127;
  const int lane = t & 31, q = lane & 3;
  const bool odd = q & 1;
  const int row = 64 * wgi + 16 * (t >> 5) + (lane >> 2) + (odd ? 8 : 0);
  const bool row_ok = row < rows;
  dst += (long long)row * ld;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    // Even: send row r0 + 8's pair, keep r0's; odd: the other way round.
    const float s0 = odd ? acc[4 * j] : acc[4 * j + 2];
    const float s1 = odd ? acc[4 * j + 1] : acc[4 * j + 3];
    const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
    const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
    const float4 v = odd ? make_float4(r0, r1, acc[4 * j + 2], acc[4 * j + 3])
                         : make_float4(acc[4 * j], acc[4 * j + 1], r0, r1);
    const int col = 8 * j + 4 * (q >> 1);
    if (row_ok && col < cols) *reinterpret_cast<float4*>(dst + col) = v;
  }
}

// Two saturating e4m3 bytes (tdt::to_e4m3), `lo` in the low byte.
__device__ __forceinline__ uint32_t pack_e4m3x2(float lo, float hi) {
  return (uint32_t)tdt::to_e4m3(lo).__x |
         ((uint32_t)tdt::to_e4m3(hi).__x << 8);
}

// Consumer warpgroup `wgi`: store its rows of the tile at `dst` (row
// stride `ld` bytes) in e4m3, saturating to +-448; rows >= `rows` and
// columns >= `cols` left out (`cols` a multiple of 16). For each 32-column
// group (j = 4 J .. 4 J + 3) a lane's word for quad lane t holds its two
// columns of j = 4 J + 2 (t & 1) and of the next j, on row r0 + 8 (t >> 1);
// after the quad transpose lane q holds 16 consecutive columns of one row.
template <int BN>
__device__ __forceinline__ void store_tile_e4m3(int wgi,
                                                const float (&acc)[BN / 2],
                                                uint8_t* dst, long long ld,
                                                int rows, int cols) {
  static_assert(BN % 32 == 0, "32-column groups");
  const int t = threadIdx.x & 127;
  const int lane = t & 31, q = lane & 3;
  const int row = 64 * wgi + 16 * (t >> 5) + (lane >> 2) + ((q & 2) ? 8 : 0);
  const bool row_ok = row < rows;
  dst += (long long)row * ld;
#pragma unroll
  for (int jj = 0; jj < BN / 8; jj += 4) {
    uint32_t x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int ja = jj + 2 * (u & 1), h = 2 * (u >> 1);
      x[u] = pack_e4m3x2(acc[4 * ja + h], acc[4 * ja + h + 1]) |
             (pack_e4m3x2(acc[4 * ja + 4 + h], acc[4 * ja + 5 + h]) << 16);
    }
    quad_transpose(x);
    // x[s]: lane s's columns 2 s, 2 s + 1 of j = ja (low half) and of ja + 1.
    const uint4 v = make_uint4(__byte_perm(x[0], x[1], 0x5410),
                               __byte_perm(x[2], x[3], 0x5410),
                               __byte_perm(x[0], x[1], 0x7632),
                               __byte_perm(x[2], x[3], 0x7632));
    const int col = 8 * jj + 16 * (q & 1);
    if (row_ok && col < cols) *reinterpret_cast<uint4*>(dst + col) = v;
  }
}

// e4m3 operands. fp8 wgmma reads both operands K-major, and TMA does not
// transpose: B3 hands the mainloop B^T (N, K), written by its transposing
// pre-pass. (The producer warpgroup's three free warps transposing each
// k-step's B box in shared memory — byte permutes, conflict-free loads and
// stores, a 4-deep ring of raw boxes — set the pace instead: slower than
// pre-pass plus mainloop at the headline on an H100, PERF.md.) A k-step
// is then 128 K values (the 128-byte swizzle row), one box of A (128 rows)
// and one of B^T (BN rows): the bf16 ring's stages, in bytes.
constexpr int BK8 = 128;

template <int BN>
__device__ __forceinline__ void load_tile_k8(const Ring& r, int& it,
                                             const CUtensorMap* ta, int arow,
                                             const CUtensorMap* tbt, int col0,
                                             int ktiles) {
  using C = Cfg<BN>;
  static_assert(C::B_BYTES == BN * BK8, "B^T box fills the B slot");
  for (int kt = 0; kt < ktiles; ++kt, ++it) {
    const int s = it % C::STAGES;
    if (it >= C::STAGES)
      mbar_wait(r.empty0 + 8 * s, ((it / C::STAGES) - 1) & 1);
    const uint32_t full = r.full0 + 8 * s;
    mbar_expect_tx(full, C::STAGE);
    tma_load(r.a0 + s * A_BYTES, ta, full, kt * BK8, arow);
    tma_load(r.b0 + s * C::B_BYTES, tbt, full, kt * BK8, col0);
  }
}

// Consumer warpgroup `wgi`, e4m3: its 64 x 128 share of one output tile
// into `acc`. The fp8 tensor cores keep about 14 bits of a running sum
// (the mma.sync lane's finding, gemm_tile.cuh), so every PROMOTE8 wgmmas
// (64 K values, that lane's cadence) sum into `part` from zero, and
// `part` is added to the fp32 `acc` once they retire. Promoting once a
// k-step (128 K values) was faster but broke chip_smoke's e4m3 tolerance
// (2^-10 of the output's spread) at K = 1008 for some seeds on an H100.
// Holding both pins this route to BN 128 (128 accumulator registers a
// thread); while a warpgroup waits for its wgmmas the other one's keep the
// tensor cores busy. The partial cannot be added while the next group
// runs: ptxas serializes every wgmma when other instructions read an
// accumulator with a wgmma in flight (C7514).
constexpr int PROMOTE8 = 2;

__device__ __forceinline__ void mma_tile_e4m3(const Ring& r, int& it,
                                              int ktiles, int wgi,
                                              float (&acc)[64],
                                              float (&part)[64]) {
  using C = Cfg<128>;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < ktiles; ++kt, ++it) {
    const int s = it % C::STAGES;
    mbar_wait(r.full0 + 8 * s, (it / C::STAGES) & 1);
    const uint32_t a = r.a0 + s * A_BYTES + wgi * 64 * 128;
    const uint32_t b = r.b0 + s * C::B_BYTES;
#pragma unroll
    for (int g = 0; g < BK8 / 32; g += PROMOTE8) {
      fence_regs(part);
      wg_fence();
#pragma unroll
      for (int kk = g; kk < g + PROMOTE8; ++kk)
        wgmma_ss_m64n128_e4m3(part, sw128_desc(a + kk * 32, 16),
                              sw128_desc(b + kk * 32, 16), kk > g);
      wg_commit();
      wg_wait0();
      fence_regs(part);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(r.empty0 + 8 * s);
  }
}

}  // namespace wg
}  // namespace tdt
