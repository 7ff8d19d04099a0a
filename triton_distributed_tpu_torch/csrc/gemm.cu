// Kernel B3: tiled GEMM, out = A @ B with fp32 accumulation.
//
// Replaces the TPU kernel triton_distributed_tpu/ops/gemm.py:32
// (_grid_matmul_kernel, reached through pallas_matmul). On the TPU the k
// grid axis runs in order and carries the fp32 sum in VMEM scratch; here a
// loop inside the block walks K, and where K is split over blocks (the
// decode route) their partials meet in one fixed order.
//
// Lanes (A x B -> out), chosen by the wrapper (ops/gemm.py):
//   fp32 x {fp32, bf16, e4m3} -> fp32        scalar FMA, never TF32
//   bf16 x {bf16, e4m3}       -> bf16, fp32  tensor cores in bf16; an e4m3 B
//                                            is upcast to bf16 as it is
//                                            staged (the mixed lane)
//   e4m3 x e4m3               -> e4m3, bf16, fp32  tensor cores in e4m3
// An e4m3 store saturates to +-448 (tdt::to_e4m3), as models/fp8.to_e4m3.
//
// What bounds it on an H100 (989 TFLOP/s bf16, 1979 fp8, 67 fp32 without
// tensor cores, 3.35 TB/s): at M=2048, K=N=5120 the operations (107.4
// GFLOP: 0.109 ms bf16, 0.054 ms e4m3, 1.60 ms fp32); at decode (M <= 16)
// the bytes of B (e.g. 52.4 MB bf16 at K=N=5120: 0.0157 ms). Four routes,
// picked by the wrapper from the lane, M and alignment before the launch
// (cfg, below):
//
//  - wgmma (bf16 and e4m3, M >= 64, A's and B's base and rows whole
//    16-byte units): gemm_wgmma.cuh's mainloop — a producer warp issuing
//    TMA into a 192 KiB ring of 128-byte-swizzled stages, two consumer
//    warpgroups on SS-wgmma, setmaxnreg, clusters of two CTAs on a pair of
//    row tiles of the same columns — on a persistent grid over every SM
//    (as many clusters as fit at once), its pair tiles walked column-major
//    so the clusters working together share B's columns in L2. bf16 at
//    BN 256 or 128 (the wrapper weighs the last wave's fill); e4m3 at BN
//    128 only: fp8 wgmma reads B K-major and TMA does not transpose, so a
//    pre-pass (transpose_b8, inside the same call and count) writes B^T
//    into the wrapper's workspace, and the consumers promote the tensor
//    cores' sums to fp32 every 64 K values (gemm_wgmma.cuh mma_tile_e4m3),
//    which holds 128 accumulators a thread. Epilogues in bf16, fp32 and saturating e4m3,
//    16-byte stores, rows and columns past the edge left out.
//  - splitk (bf16 and e4m3, M <= 16, aligned): the bytes of B are the
//    bound, so B streams over every SM: a block owns a column strip (a
//    warp's 8 lanes x 16 bytes: 128 e4m3 or 64 bf16 columns) and a slice of
//    K; the slices of one strip are one cluster (at most 8 CTAs). Each
//    warp takes 32-row K steps of its block's slice, eight 16-byte loads a
//    lane, the next step's in flight while it multiplies this one; A's <= 16
//    rows of the slice wait in shared memory. The product runs on mma.sync
//    with the weight as the 16-row operand (W^T x A^T: its 16 "rows" are
//    columns of the output, the activation rows the 8-wide side), the
//    weight bytes transposed in registers by byte permutes. The partials of
//    the 8 warps and the cluster's CTAs are summed in one fixed order
//    through distributed shared memory: each output written once, no
//    atomics, two calls give the same bits.
//  - mma (everything else on tensor cores: 16 < M < 64, an unaligned
//    operand, the mixed lane): gemm_tile.cuh's tiles staged global ->
//    registers -> shared memory, mma.sync on fp32 accumulators (the e4m3
//    tile promotes once per staged chunk), one block per output tile; the
//    16-row tiles split K over the block's warps.
//  - fma (fp32 A): gemm_tile.cuh's scalar tile.
//
// The tile code of the mma and fma routes is shared with gemm_comm.cu's
// fused kernels, the wgmma mainloop with its B9 / B10.

#include <cooperative_groups.h>

#include <atomic>
#include <type_traits>

#include "gemm_tile.cuh"
#include "gemm_wgmma.cuh"

namespace {

namespace cg = cooperative_groups;
namespace wg = tdt::wg;
using tdt::tile::bf16;
using tdt::tile::e4m3;
using tdt::tile::FmaCfg;
using tdt::tile::NT;
using tdt::tile::store_cvt;
using tdt::tile::TcCfg;

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------------
// The mma and fma routes: one block per output tile (blockIdx: column tile,
// row tile); the tile code is gemm_tile.cuh's.
// ---------------------------------------------------------------------------

template <typename TA, typename TB, typename TO, typename TC, int BM, int BN,
          int BK, int WM, int WN, int WK>
__global__ void __launch_bounds__(NT)
    gemm_tc_kernel(const TA* __restrict__ A, const TB* __restrict__ B,
                   TO* __restrict__ out, int M, int N, int K, int vec_a,
                   int vec_b) {
  extern __shared__ __align__(16) unsigned char smem[];
  tdt::tile::tc_tile<TA, TB, TC, BM, BN, BK, WM, WN, WK, false>(
      smem, A, K, B, N, M, N, K, blockIdx.y * BM, blockIdx.x * BN, vec_a,
      vec_b, [&](int r, int c, float v) {
        out[(long)r * N + c] = store_cvt<TO>(v);
      });
}

template <typename TB, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__(NT)
    gemm_fma_kernel(const float* __restrict__ A, const TB* __restrict__ B,
                    float* __restrict__ out, int M, int N, int K, int vec_a,
                    int vec_b) {
  extern __shared__ __align__(16) unsigned char smem[];
  tdt::tile::fma_tile<TB, BM, BN, BK, TM, TN, false>(
      smem, A, K, B, N, M, N, K, blockIdx.y * BM, blockIdx.x * BN, vec_a,
      vec_b, [&](int r, int c, float v) { out[(long)r * N + c] = v; });
}

// ---------------------------------------------------------------------------
// The wgmma route.
// ---------------------------------------------------------------------------

// The e4m3 pre-pass: B (K, N) bytes -> B^T (N, K), a 64 x 64 tile a block
// through shared memory, 16-byte loads and stores (K and N are whole
// 16-byte units: the route's alignment). Each output word gathers byte n of
// four K rows with byte permutes.
__global__ void __launch_bounds__(256)
    transpose_b8(const uint8_t* __restrict__ B, uint8_t* __restrict__ BT,
                 int K, int N) {
  __shared__ uint32_t tile[64][17];
  const int n0 = blockIdx.x * 64, k0 = blockIdx.y * 64;
  const int tid = threadIdx.x;
  {
    const int r = tid >> 2, cq = tid & 3;
    const int k = k0 + r, n = n0 + 16 * cq;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (k < K && n < N)
      v = __ldcs(reinterpret_cast<const uint4*>(B + (long long)k * N + n));
    tile[r][4 * cq] = v.x;
    tile[r][4 * cq + 1] = v.y;
    tile[r][4 * cq + 2] = v.z;
    tile[r][4 * cq + 3] = v.w;
  }
  __syncthreads();
  const int n = tid >> 2, kq = tid & 3;
  const int gn = n0 + n, gk = k0 + 16 * kq;
  if (gn >= N || gk >= K) return;
  const int w = n >> 2, b = n & 3;
  const uint32_t sel = (uint32_t)(b | ((b + 4) << 4));
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 16 * kq + 4 * i;
    const uint32_t x = __byte_perm(tile[r][w], tile[r + 1][w], sel);
    const uint32_t y = __byte_perm(tile[r + 2][w], tile[r + 3][w], sel);
    o[i] = __byte_perm(x, y, 0x5410);
  }
  *reinterpret_cast<uint4*>(BT + (long long)gn * K + gk) =
      make_uint4(o[0], o[1], o[2], o[3]);
}

// One cluster of two CTAs walks pair tiles t = cluster, cluster + clusters,
// ... of the whole output (wg::tile_at: column-major, so the clusters
// working at once share B's columns). TI bf16: ta over A (M, K), tb over B
// (K, N); TI e4m3: tb over B^T (N, K).
template <typename TI, typename TO, int BN>
__global__ void __cluster_dims__(wg::CLUSTER, 1, 1)
    __launch_bounds__(wg::THREADS, 1)
    gemm_wgmma(TO* __restrict__ out, int M, int N, int K,
               const __grid_constant__ CUtensorMap ta,
               const __grid_constant__ CUtensorMap tb) {
  constexpr bool F8 = sizeof(TI) == 1;
  static_assert(!F8 || BN == 128, "the e4m3 route holds two accumulators");
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const wg::Ring ring = wg::ring_of<BN>(smem_raw);
  if (threadIdx.x == 0) wg::ring_init<BN>(ring);
  __syncthreads();
  const int crank = blockIdx.x % wg::CLUSTER;
  const int cl = blockIdx.x / wg::CLUSTER, ncl = gridDim.x / wg::CLUSTER;
  const int rtp = wg::pairs_of(ceil_div(M, wg::BM));
  const int total = rtp * ceil_div(N, BN);
  const int ktiles = ceil_div(K, F8 ? wg::BK8 : wg::BK);
  // Warp-uniform, so the wgmma descriptors live in uniform registers.
  const int wgi = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wgi == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(
        wg::kProducerRegs));
    if (threadIdx.x == 256) {
      int it = 0;
      for (int t = cl; t < total; t += ncl) {
        const int2 at = wg::tile_at(t, rtp, BN, crank);
        if constexpr (F8)
          wg::load_tile_k8<BN>(ring, it, &ta, at.x, &tb, at.y, ktiles);
        else
          wg::load_tile<BN>(ring, it, &ta, at.x, &tb, at.y, ktiles);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(
      wg::kConsumerRegs));
  int it = 0;
  float acc[BN / 2];
  for (int t = cl; t < total; t += ncl) {
    const int2 at = wg::tile_at(t, rtp, BN, crank);
    if constexpr (F8) {
      float part[64];
      wg::mma_tile_e4m3(ring, it, ktiles, wgi, acc, part);
    } else {
      wg::mma_tile<BN>(ring, it, ktiles, wgi, acc);
    }
    TO* dst = out + (long long)at.x * N + at.y;
    const int rows = M - at.x, cols = N - at.y;
    if constexpr (std::is_same<TO, bf16>::value)
      wg::store_tile<BN>(wgi, acc, dst, N, rows, cols);
    else if constexpr (std::is_same<TO, float>::value)
      wg::store_tile_f32<BN>(wgi, acc, dst, N, rows, cols);
    else
      wg::store_tile_e4m3<BN>(wgi, acc, reinterpret_cast<uint8_t*>(dst), N,
                              rows, cols);
  }
}

// ---------------------------------------------------------------------------
// The split-K route (M <= 16).
// ---------------------------------------------------------------------------

constexpr int SK_THREADS = 256, SK_WARPS = 8;
constexpr int SPLITK_CLUSTER = 8;     // CTAs a cluster at most (portable)
constexpr int SK_STEP = 32;           // K rows a warp takes a step
constexpr int SK_SMEM = 64 << 10;     // A's staged rows; then the partials

// A lane loads 16 bytes of a row: VEC columns; a warp's 8 lane groups COLS
// columns; J mma tiles of 16 weight columns (x 8 activation rows) a
// k-step's K (32 e4m3; 16 bf16, twice a step).
template <typename TI>
struct SplitK;
template <>
struct SplitK<e4m3> {
  static constexpr int VEC = 16, COLS = 128, J = 8;
};
template <>
struct SplitK<bf16> {
  static constexpr int VEC = 8, COLS = 64, J = 4;
};

// The 4 x 4 byte transpose: w[c] = byte c of r0, r1, r2, r3 (low first).
__device__ __forceinline__ void transpose4x4(uint32_t r0, uint32_t r1,
                                             uint32_t r2, uint32_t r3,
                                             uint32_t (&w)[4]) {
  const uint32_t x0 = __byte_perm(r0, r1, 0x5140);
  const uint32_t x1 = __byte_perm(r0, r1, 0x7362);
  const uint32_t y0 = __byte_perm(r2, r3, 0x5140);
  const uint32_t y1 = __byte_perm(r2, r3, 0x7362);
  w[0] = __byte_perm(x0, y0, 0x5410);
  w[1] = __byte_perm(x0, y0, 0x7632);
  w[2] = __byte_perm(x1, y1, 0x5410);
  w[3] = __byte_perm(x1, y1, 0x7632);
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Grid (splits, strips), clusters of `splits` CTAs along x: CTA x of strip
// y takes k-steps [x * per, (x + 1) * per) of B's columns
// [y * COLS, (y + 1) * COLS); A's rows of `chunk` k-steps are staged at a
// time. MT: 8-row blocks of the activation (1 for M <= 8, else 2; two
// blocks an SM at MT 1).
template <typename TI, typename TO, int MT>
__global__ void __launch_bounds__(SK_THREADS, 3 - MT)
    gemm_splitk(const TI* __restrict__ A, const TI* __restrict__ B,
                TO* __restrict__ out, int M, int N, int K, int per,
                int chunk) {
  using S = SplitK<TI>;
  constexpr bool F8 = sizeof(TI) == 1;
  constexpr int J = S::J;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int crank = (int)cluster.block_rank();
  const int nsplit = (int)cluster.num_blocks();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int col = blockIdx.y * S::COLS + g * S::VEC;   // this lane's columns
  const bool col_ok = col < N;
  const int total = ceil_div(K, SK_STEP);
  const int s0 = crank * per, s1 = min(total, s0 + per);
  const int pitch = chunk * SK_STEP * (int)sizeof(TI) + 16;   // A row, bytes

  float acc[MT][J][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;

  // Rows of B a lane loads at k-step k0: e4m3 4t..4t+3 and 16 + the same
  // (the weight operand's a0-a1 / a2-a3 K groups); bf16 2t, 2t+1, 2t+8,
  // 2t+9 of each 16-row half.
  auto brow = [&](int i) {
    return F8 ? (i >> 2) * 16 + 4 * t + (i & 3)
              : (i >> 2) * 16 + ((i & 2) ? 8 : 0) + 2 * t + (i & 1);
  };
  auto load = [&](uint4 (&v)[8], int step, bool ok) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = step * SK_STEP + brow(i);
      v[i] = make_uint4(0, 0, 0, 0);
      if (ok && col_ok && row < K)
        v[i] = __ldcs(reinterpret_cast<const uint4*>(
            B + (long long)row * N + col));
    }
  };

  // Each chunk's first k-step of B is in flight while A's rows are staged.
  int s = s0 + warp;
  uint4 cur[8];
  load(cur, s, s < min(s1, s0 + chunk));
  for (int c0 = s0; c0 < s1; c0 += chunk) {
    const int c1 = min(s1, c0 + chunk);
    {
      // A's rows [0, M) of K [c0 * 32, c1 * 32), zeros past K.
      const int kb = c0 * SK_STEP;
      const int vrow = (c1 - c0) * SK_STEP * (int)sizeof(TI) / 16;
      constexpr int VE = 16 / (int)sizeof(TI);
      for (int v = threadIdx.x; v < M * vrow; v += SK_THREADS) {
        const int r = v / vrow, cv = v % vrow;
        const int k = kb + cv * VE;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (k < K)
          val = *reinterpret_cast<const uint4*>(A + (long long)r * K + k);
        *reinterpret_cast<uint4*>(smem + r * pitch + cv * 16) = val;
      }
    }
    __syncthreads();
    for (; s < c1; s += SK_WARPS) {
      uint4 nxt[8];
      load(nxt, s + SK_WARPS, s + SK_WARPS < c1);
      const int kl = (s - c0) * SK_STEP;       // within the staged rows
      if constexpr (F8) {
        uint32_t b[MT][2];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int r = m * 8 + g;
          const unsigned char* ar = smem + r * pitch + kl + 4 * t;
          b[m][0] = r < M ? *reinterpret_cast<const uint32_t*>(ar) : 0u;
          b[m][1] = r < M ? *reinterpret_cast<const uint32_t*>(ar + 16) : 0u;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint32_t lo[4], hi[4];
          transpose4x4(word_of(cur[0], q), word_of(cur[1], q),
                       word_of(cur[2], q), word_of(cur[3], q), lo);
          transpose4x4(word_of(cur[4], q), word_of(cur[5], q),
                       word_of(cur[6], q), word_of(cur[7], q), hi);
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const uint32_t a[4] = {lo[2 * jj], lo[2 * jj + 1], hi[2 * jj],
                                   hi[2 * jj + 1]};
#pragma unroll
            for (int m = 0; m < MT; ++m)
              tdt::tile::Mma<e4m3>::run(acc[m][2 * q + jj], a, b[m]);
          }
        }
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t b[MT][2];
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const int r = m * 8 + g;
            const unsigned char* ar =
                smem + r * pitch + (kl + 16 * h + 2 * t) * 2;
            b[m][0] = r < M ? *reinterpret_cast<const uint32_t*>(ar) : 0u;
            b[m][1] = r < M ? *reinterpret_cast<const uint32_t*>(ar + 16)
                            : 0u;
          }
          const uint4& r0 = cur[4 * h];
          const uint4& r1 = cur[4 * h + 1];
          const uint4& r8 = cur[4 * h + 2];
          const uint4& r9 = cur[4 * h + 3];
#pragma unroll
          for (int j = 0; j < J; ++j) {
            const uint32_t w0 = word_of(r0, j), w1 = word_of(r1, j);
            const uint32_t w8 = word_of(r8, j), w9 = word_of(r9, j);
            const uint32_t a[4] = {__byte_perm(w0, w1, 0x5410),
                                   __byte_perm(w0, w1, 0x7632),
                                   __byte_perm(w8, w9, 0x5410),
                                   __byte_perm(w8, w9, 0x7632)};
#pragma unroll
            for (int m = 0; m < MT; ++m)
              tdt::tile::Mma<bf16>::run(acc[m][j], a, b[m]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) cur[i] = nxt[i];
    }
    __syncthreads();
    s = c1 + warp;
    load(cur, s, s < min(s1, c1 + chunk));
  }

  // Partials: float4 red[warp][MT * J][lane] in this CTA's shared memory
  // (A's rows are done with). Each thread sums one output unit (a lane's
  // tile) over the 8 warps in warp order, into warp 0's slot; then CTA
  // `crank` sums its share of the strip's units over the cluster's CTAs in
  // rank order (their loads all in flight at once) and stores each output
  // once.
  constexpr int F = MT * J, U = F * 32;
  float4* red = reinterpret_cast<float4*>(smem);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < J; ++j)
      red[(warp * F + m * J + j) * 32 + lane] =
          make_float4(acc[m][j][0], acc[m][j][1], acc[m][j][2],
                      acc[m][j][3]);
  __syncthreads();
  for (int u = threadIdx.x; u < U; u += SK_THREADS) {
    float4 sum = red[u];
#pragma unroll
    for (int w = 1; w < SK_WARPS; ++w) {
      const float4 v = red[w * U + u];
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    red[u] = sum;
  }
  cluster.sync();
  const int share = ceil_div(U, nsplit);
  const int u1 = min(U, (crank + 1) * share);
  for (int u = crank * share + (int)threadIdx.x; u < u1; u += SK_THREADS) {
    float4 v[SPLITK_CLUSTER];
#pragma unroll
    for (int r = 0; r < SPLITK_CLUSTER; ++r)
      if (r < nsplit) v[r] = cluster.map_shared_rank(red, r)[u];
    float4 sum = v[0];
#pragma unroll
    for (int r = 1; r < SPLITK_CLUSTER; ++r)
      if (r < nsplit) {
        sum.x += v[r].x;
        sum.y += v[r].y;
        sum.z += v[r].z;
        sum.w += v[r].w;
      }
    // Tile (m, j) of lane ln: weight columns c, c + 1 (its a0 / a1 rows),
    // activation rows 2 t', 2 t' + 1 of block m.
    const int f = u >> 5, ln = u & 31;
    const int m = f / J, j = f % J;
    const int c = blockIdx.y * S::COLS + (ln >> 2) * S::VEC + 2 * j;
    const int r = m * 8 + 2 * (ln & 3);
    if (c < N) {
      if (r < M) out[(long long)r * N + c] = store_cvt<TO>(sum.x);
      if (r + 1 < M) out[(long long)(r + 1) * N + c] = store_cvt<TO>(sum.y);
      if (r < M) out[(long long)r * N + c + 1] = store_cvt<TO>(sum.z);
      if (r + 1 < M)
        out[(long long)(r + 1) * N + c + 1] = store_cvt<TO>(sum.w);
    }
  }
  // No CTA leaves while a peer may still read its partials.
  cluster.sync();
}

// ---------------------------------------------------------------------------
// Launch.
// ---------------------------------------------------------------------------

struct Args {
  const void* a;
  const void* b;
  void* out;
  void* ws;                 // e4m3 wgmma: B^T (N, K)
  int M, N, K, vec_a, vec_b;
  int splits, per, chunk;   // split-K plan
  cudaStream_t stream;
};

template <typename TA, typename TB, typename TO, typename TC, int BM, int BN,
          int BK, int WM, int WN, int WK>
cudaError_t launch_tc(const Args& x) {
  using Cfg = TcCfg<TC, BM, BN, BK, WM, WN, WK>;
  auto kern = gemm_tc_kernel<TA, TB, TO, TC, BM, BN, BK, WM, WN, WK>;
  static tdt::SmemCap cap;
  cudaError_t err = tdt::ensure_smem(kern, Cfg::SMEM, cap);
  if (err != cudaSuccess) return err;
  dim3 grid((x.N + BN - 1) / BN, (x.M + BM - 1) / BM);
  kern<<<grid, NT, Cfg::SMEM, x.stream>>>(
      static_cast<const TA*>(x.a), static_cast<const TB*>(x.b),
      static_cast<TO*>(x.out), x.M, x.N, x.K, x.vec_a, x.vec_b);
  return cudaGetLastError();
}

template <typename TB, int BM, int BN, int BK, int TM, int TN>
cudaError_t launch_fma(const Args& x) {
  using Cfg = FmaCfg<BM, BN, BK, TM, TN>;
  auto kern = gemm_fma_kernel<TB, BM, BN, BK, TM, TN>;
  static tdt::SmemCap cap;
  cudaError_t err = tdt::ensure_smem(kern, Cfg::SMEM, cap);
  if (err != cudaSuccess) return err;
  dim3 grid((x.N + BN - 1) / BN, (x.M + BM - 1) / BM);
  kern<<<grid, NT, Cfg::SMEM, x.stream>>>(
      static_cast<const float*>(x.a), static_cast<const TB*>(x.b),
      static_cast<float*>(x.out), x.M, x.N, x.K, x.vec_a, x.vec_b);
  return cudaGetLastError();
}

static_assert(wg::SMEM_BYTES <= 232448, "the ring fits a block");

// The wgmma route at tile width BN: the pre-pass for e4m3, the tensor maps
// (encoded on the host every call), then as many clusters as the card
// holds at once (cudaOccupancyMaxActiveClusters, asked once), at most one
// a pair tile.
template <typename TI, typename TO, int BN>
cudaError_t launch_wgmma(const Args& x) {
  constexpr bool F8 = sizeof(TI) == 1;
  if (!x.vec_a || !x.vec_b || (F8 && x.ws == nullptr))
    return cudaErrorInvalidValue;
  auto kern = gemm_wgmma<TI, TO, BN>;
  static tdt::SmemCap cap;
  cudaError_t err = tdt::ensure_smem(kern, wg::SMEM_BYTES, cap);
  if (err != cudaSuccess) return err;
  static std::atomic<int> max_clusters{0};
  int mc = max_clusters.load(std::memory_order_relaxed);
  if (mc == 0) {
    cudaLaunchConfig_t c = {};
    c.gridDim = dim3(wg::CLUSTER * 64);
    c.blockDim = dim3(wg::THREADS);
    c.dynamicSmemBytes = wg::SMEM_BYTES;
    err = cudaOccupancyMaxActiveClusters(&mc, kern, &c);
    if (err != cudaSuccess) return err;
    if (mc < 1) return cudaErrorInvalidConfiguration;
    max_clusters.store(mc, std::memory_order_relaxed);
  }
  const int pairs = wg::pairs_of(ceil_div(x.M, wg::BM)) * ceil_div(x.N, BN);
  const int grid = wg::CLUSTER * (pairs < mc ? pairs : mc);
  CUtensorMap ta, tb;
  const int elem = (int)sizeof(TI);
  err = tdt::hopper::make_map_2d(&ta, x.a, x.M, x.K, x.K, wg::BM, elem);
  if (err != cudaSuccess) return err;
  if constexpr (F8) {
    dim3 tg(ceil_div(x.N, 64), ceil_div(x.K, 64));
    transpose_b8<<<tg, 256, 0, x.stream>>>(
        static_cast<const uint8_t*>(x.b), static_cast<uint8_t*>(x.ws), x.K,
        x.N);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = tdt::hopper::make_map_2d(&tb, x.ws, x.N, x.K, x.K, BN, 1);
  } else {
    err = tdt::hopper::make_map_2d(&tb, x.b, x.K, x.N, x.N, wg::BK, 2);
  }
  if (err != cudaSuccess) return err;
  kern<<<grid, wg::THREADS, wg::SMEM_BYTES, x.stream>>>(
      static_cast<TO*>(x.out), x.M, x.N, x.K, ta, tb);
  return cudaGetLastError();
}

template <typename TI, typename TO, int MT>
cudaError_t launch_splitk_mt(const Args& x) {
  using S = SplitK<TI>;
  constexpr int F = MT * S::J;
  const int red = SK_WARPS * F * 32 * 16;
  const int a_bytes = x.M * (x.chunk * SK_STEP * (int)sizeof(TI) + 16);
  const int smem = red > a_bytes ? red : a_bytes;
  if (smem > SK_SMEM) return cudaErrorInvalidValue;
  auto kern = gemm_splitk<TI, TO, MT>;
  static tdt::SmemCap cap;
  cudaError_t err = tdt::ensure_smem(kern, SK_SMEM, cap);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t c = {};
  c.gridDim = dim3(x.splits, ceil_div(x.N, S::COLS));
  c.blockDim = dim3(SK_THREADS);
  c.dynamicSmemBytes = smem;
  c.stream = x.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = x.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  c.attrs = attr;
  c.numAttrs = 1;
  err = cudaLaunchKernelEx(&c, kern, static_cast<const TI*>(x.a),
                           static_cast<const TI*>(x.b),
                           static_cast<TO*>(x.out), x.M, x.N, x.K, x.per,
                           x.chunk);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename TI, typename TO>
cudaError_t launch_splitk(const Args& x) {
  const int total = ceil_div(x.K, SK_STEP);
  if (!x.vec_a || !x.vec_b || x.M > 16 || x.splits < 1 ||
      x.splits > SPLITK_CLUSTER ||
      x.per < 1 || x.chunk < 1 || (long long)x.splits * x.per < total ||
      (x.splits - 1) * x.per >= total)
    return cudaErrorInvalidValue;
  return x.M <= 8 ? launch_splitk_mt<TI, TO, 1>(x)
                  : launch_splitk_mt<TI, TO, 2>(x);
}

// The compiled tiles, by index (ops/gemm.py _TC, _WGMMA and _SPLITK, and
// _FMA, list the same tiles in the same order). BK is in elements: the
// e4m3 lane stages twice the bf16 lane's K per chunk.
//   mma route
//   0: 128 x 128, warps 2x4      (large M)
//   1:  64 x 128, warps 2x4
//   2:  16 x  64, warps 1x2, K split over 4 warps   (decode, M <= 16)
//   3:  16 x  32, warps 1x1, K split over 8 warps
//   wgmma route (bf16, e4m3; aligned operands)
//   4: 128 x 256 x 64 (bf16 only)
//   5: 128 x 128 x 64 bf16, x 128 e4m3
//   split-K route (bf16, e4m3; aligned; M <= 16)
//   6: 16 x COLS (64 bf16, 128 e4m3), 32-row k-steps
template <typename TA, typename TB, typename TO, typename TC>
cudaError_t run_tc(int cfg, const Args& x) {
  constexpr int S = sizeof(TC) == 1 ? 2 : 1;  // K scale of the e4m3 lane
  constexpr bool SAME = std::is_same<TA, TB>::value;
  switch (cfg) {
    case 0: return launch_tc<TA, TB, TO, TC, 128, 128, 32 * S, 2, 4, 1>(x);
    case 1: return launch_tc<TA, TB, TO, TC, 64, 128, 32 * S, 2, 4, 1>(x);
    case 2: return launch_tc<TA, TB, TO, TC, 16, 64, 256 * S, 1, 2, 4>(x);
    case 3: return launch_tc<TA, TB, TO, TC, 16, 32, 256 * S, 1, 1, 8>(x);
  }
  if constexpr (SAME) {
    switch (cfg) {
      case 4:
        if constexpr (sizeof(TA) == 2) return launch_wgmma<TA, TO, 256>(x);
        break;
      case 5: return launch_wgmma<TA, TO, 128>(x);
      case 6: return launch_splitk<TA, TO>(x);
    }
  }
  return cudaErrorInvalidValue;
}

//   0: 128 x 128 x 8, 8 x 8 per thread   (large M)
//   1:  16 x  64 x 32, 1 x 4 per thread  (small M)
template <typename TB>
cudaError_t run_fma(int cfg, const Args& x) {
  switch (cfg) {
    case 0: return launch_fma<TB, 128, 128, 8, 8, 8>(x);
    case 1: return launch_fma<TB, 16, 64, 32, 1, 4>(x);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Type codes: 0 float32, 1 bfloat16, 2 float8_e4m3fn. A, B and out are
// contiguous row-major (M x K), (K x N), (M x N). ws: the e4m3 wgmma
// route's B^T workspace (N x K bytes; null elsewhere). vec_a / vec_b: the
// operand's base address and row stride are multiples of 16 bytes. cfg:
// the tile (run_tc above). splits, per, chunk: the split-K route's plan —
// CTAs a column strip (1-8, one cluster), 32-row k-steps a CTA, k-steps of
// A staged at once (ops/gemm.splitk_plan). Returns the launch's
// cudaError_t; an uncompiled lane or tile, or a route its operands do not
// meet, is cudaErrorInvalidValue (the wrapper refuses those by name first).
extern "C" int gemm_run(const void* a, const void* b, void* out, void* ws,
                        int M, int N, int K, int a_type, int b_type,
                        int out_type, int cfg, int vec_a, int vec_b,
                        int splits, int per, int chunk, void* stream) {
  const Args x{a,     b,      out,    ws,    M,     N,
               K,     vec_a,  vec_b,  splits, per,  chunk,
               static_cast<cudaStream_t>(stream)};
  if (M == 0 || N == 0) return cudaSuccess;
  const int lane = a_type * 9 + b_type * 3 + out_type;
  switch (lane) {
    // fp32 A: FMA, fp32 out.
    case 0 * 9 + 0 * 3 + 0: return run_fma<float>(cfg, x);
    case 0 * 9 + 1 * 3 + 0: return run_fma<bf16>(cfg, x);
    case 0 * 9 + 2 * 3 + 0: return run_fma<e4m3>(cfg, x);
    // bf16 A (B bf16, or e4m3 upcast at staging): bf16 or fp32 out.
    case 1 * 9 + 1 * 3 + 0: return run_tc<bf16, bf16, float, bf16>(cfg, x);
    case 1 * 9 + 1 * 3 + 1: return run_tc<bf16, bf16, bf16, bf16>(cfg, x);
    case 1 * 9 + 2 * 3 + 0: return run_tc<bf16, e4m3, float, bf16>(cfg, x);
    case 1 * 9 + 2 * 3 + 1: return run_tc<bf16, e4m3, bf16, bf16>(cfg, x);
    // e4m3 x e4m3: fp32, bf16 or e4m3 out.
    case 2 * 9 + 2 * 3 + 0: return run_tc<e4m3, e4m3, float, e4m3>(cfg, x);
    case 2 * 9 + 2 * 3 + 1: return run_tc<e4m3, e4m3, bf16, e4m3>(cfg, x);
    case 2 * 9 + 2 * 3 + 2: return run_tc<e4m3, e4m3, e4m3, e4m3>(cfg, x);
  }
  return cudaErrorInvalidValue;
}
