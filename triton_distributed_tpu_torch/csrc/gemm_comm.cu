// The fused GEMM + communication kernels of the tensor-parallel path, on
// dist.cuh (flags, waits with a deadline), gemm_tile.cuh (B3's tile code)
// and gemm_wgmma.cuh (the wgmma + TMA mainloop). Each replaces one TPU
// kernel of the JAX package:
//
//  ag_gemm   B9, ops/allgather_gemm.py:88 _ag_gemm_kernel — entry
//            barrier; every block pushes its share of each of this
//            rank's `sub` A sub-blocks into slot `rank` of every rank's
//            landing workspace (n*m, k) and raises that (source,
//            sub-block) flag of its own on each; the blocks walk the
//            output tiles of all_gather(A) @ B_local in rank-swizzled
//            order (own rows first, then rank+1, ...), each tile waiting
//            only for the flags of its (source, sub-block). fp32
//            accumulation, one cast; out (n*m, ncols).
//  gemm_rs   B10, ops/gemm_reduce_scatter.py:57 _gemm_rs_kernel — entry
//            barrier; the blocks compute the partial row chunks in the
//            order rank+1, ..., rank (own chunk last), each tile cast to
//            the payload type and stored straight into slot `rank` of the
//            chunk owner's workspace (n, m/n, ncols); a block raises the
//            owner's flag once it finished its tiles of that chunk; then
//            every block waits for all n ranks' blocks and sums its share
//            of the n slots in slot order, from 0 in fp32, one cast.
//  gemm_ar   B11, ops/gemm_allreduce.py:47 _gemm_ar_stream_kernel — no
//            barrier: the parity protocol of ar_parity over a persistent
//            workspace (2, n_chunks, n, mp, nc); each output-column
//            chunk's partial tiles are cast and stored into slot `rank`
//            of that parity on every rank; then wait for the blocks that
//            wrote what this block reduces (on the split-K route the n
//            blocks of its strips; on the mma.sync tiles every rank's
//            blocks) and sum the n slots in rank order, from 0 in fp32,
//            one cast; out (m, n_chunks * nc).
//
// What bounds them on an H100: B9 and B10 at the prefill's shapes are
// GEMMs (2 * 2048 * 4096 * 1024 operations for B9 at wq: 17.2 GFLOP a
// rank, 0.017 ms at 989 TFLOP/s bf16), their communication a copy of A
// (B9) or of the partial output (B10) to every peer; B11 at decode
// (M = 2) is bound by the bytes of its weight shard and by the flag
// round trip. Three routes, picked by the wrapper from dtype, rows and
// alignment before the launch (ops/allgather_gemm.py gemm_tile_for,
// ops/gemm_allreduce.py gemm_ar_route):
//
//  - bf16 at the tall tile, A's and B's rows whole 16-byte units (B9 and
//    B10 only): the wgmma + TMA mainloop of gemm_wgmma.cuh, a producer
//    warpgroup and two consumer warpgroups a block, clusters of two
//    blocks on a pair of row tiles of the same columns. B9 reads its own
//    rank's rows
//    straight from its input through their own tensor map, so the
//    own-rank tiles need no flag, and the producer's three free warps push
//    A's sub-blocks to the peers while the consumers compute them; a
//    peer's sub-block is read only after its flags landed and a
//    fence.proxy.async (the pushes are generic-proxy stores, TMA reads
//    through the async proxy). B10 stores its tiles with 16-byte vectors
//    into the owner's slot; its reduce is unchanged.
//  - B11 in bf16 at m <= 16 with aligned operands: the split-K weight
//    stream (gemm_ar_splitk, below), one flag a block and n waits.
//  - everything else (fp32, the short tile, an unaligned B, B11 past 16
//    rows): B3's mma.sync tiles, staged through registers, no TMA or
//    wgmma.
//
// All run a persistent grid of one block an SM (each reserves more than
// half an SM's shared memory) on at most 1/r of the SMs (r = ranks on the
// card), so every rank's whole grid is resident at once and a laggard
// rank's other kernels keep SMs to run on; every block issues its pushes
// before it waits on anything, and every wait has the group's deadline (a
// lost peer writes the error word and the kernel returns; the wgmma
// route's producer runs its ring on over whatever landed, so the
// consumers finish; the host raises). Flags are 64-bit epochs never
// reset, one per (source, sub-block, block) or (source, block): a waiter
// knows which rows landed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dist.cuh"
#include "gemm_tile.cuh"
#include "gemm_wgmma.cuh"
#include "push.cuh"

using namespace tdt::dist;
using namespace tdt::hopper;
namespace wg = tdt::wg;
using tdt::tile::bf16;
using tdt::tile::NT;

namespace {

static_assert(NT == kThreads, "one block size for tiles and collectives");

// The two compiled tiles of each payload type: 0 for tall operands
// (prefill), 1 for short ones (decode, M <= 16).
template <typename T, int CFG>
struct Tile;

template <>
struct Tile<bf16, 0> {
  static constexpr int BM = 128, BN = 128;
  static constexpr int SMEM =
      tdt::tile::TcCfg<bf16, 128, 128, 32, 2, 4, 1>::SMEM;
  template <bool CG, typename S>
  __device__ static void run(unsigned char* sm, const bf16* A, long lda,
                             const bf16* B, long ldb, int M, int N, int K,
                             int m0, int n0, bool va, bool vb, S s) {
    tdt::tile::tc_tile<bf16, bf16, bf16, 128, 128, 32, 2, 4, 1, CG>(
        sm, A, lda, B, ldb, M, N, K, m0, n0, va, vb, s);
  }
};

template <>
struct Tile<bf16, 1> {
  static constexpr int BM = 16, BN = 64;
  static constexpr int SMEM =
      tdt::tile::TcCfg<bf16, 16, 64, 256, 1, 2, 4>::SMEM;
  template <bool CG, typename S>
  __device__ static void run(unsigned char* sm, const bf16* A, long lda,
                             const bf16* B, long ldb, int M, int N, int K,
                             int m0, int n0, bool va, bool vb, S s) {
    tdt::tile::tc_tile<bf16, bf16, bf16, 16, 64, 256, 1, 2, 4, CG>(
        sm, A, lda, B, ldb, M, N, K, m0, n0, va, vb, s);
  }
};

template <>
struct Tile<float, 0> {
  static constexpr int BM = 128, BN = 128;
  static constexpr int SMEM = tdt::tile::FmaCfg<128, 128, 8, 8, 8>::SMEM;
  template <bool CG, typename S>
  __device__ static void run(unsigned char* sm, const float* A, long lda,
                             const float* B, long ldb, int M, int N, int K,
                             int m0, int n0, bool va, bool vb, S s) {
    tdt::tile::fma_tile<float, 128, 128, 8, 8, 8, CG>(
        sm, A, lda, B, ldb, M, N, K, m0, n0, va, vb, s);
  }
};

template <>
struct Tile<float, 1> {
  static constexpr int BM = 16, BN = 64;
  static constexpr int SMEM = tdt::tile::FmaCfg<16, 64, 32, 1, 4>::SMEM;
  template <bool CG, typename S>
  __device__ static void run(unsigned char* sm, const float* A, long lda,
                             const float* B, long ldb, int M, int N, int K,
                             int m0, int n0, bool va, bool vb, S s) {
    tdt::tile::fma_tile<float, 16, 64, 32, 1, 4, CG>(
        sm, A, lda, B, ldb, M, N, K, m0, n0, va, vb, s);
  }
};

struct Shape {
  const void* x;    // this rank's A
  const void* b;    // this rank's B (k rows)
  void* out;
  int m;            // B9: A rows a rank; B10: all rows; B11: rows
  int mp;           // B11: a slot's rows (m padded; rows >= m unused)
  int k, ncols;     // B columns: all of them (B9, B10) or a chunk's (B11)
  int parts;        // B9: sub-blocks; B11: column chunks
  int vec_b;        // B rows 16-byte aligned
};

// Block barrier over the persistent grid: block b of every rank meets
// block b of every other (flags [b * kMaxRanks + j]). A block of a peer
// that arrived proves that peer's earlier kernels on its stream finished
// — its reads of the workspace this call overwrites.
__device__ __forceinline__ bool grid_barrier(const Group& g) {
  const int base = blockIdx.x * kMaxRanks;
  signal_peers(g, base, g.epoch);
  return wait_peers(g, base, g.epoch);
}

__host__ __device__ inline int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

// B9: flags kGemmFlagBase + (source * sub + s) * kMaxGemmBlocks + block.
template <typename T, int CFG>
__global__ void __launch_bounds__(NT) ag_gemm_kernel(Group g, Shape a) {
  using Tl = Tile<T, CFG>;
  extern __shared__ __align__(16) unsigned char smem[];
  if (!grid_barrier(g)) return;
  const int n = g.n, me = g.rank, G = gridDim.x, sub = a.parts;
  const int m_sub = a.m / sub;
  const long long row_bytes = (long long)a.k * sizeof(T);
  const long long sub_vec = m_sub * row_bytes / 16;
  const uint4* x = static_cast<const uint4*>(a.x);
  for (int s = 0; s < sub; ++s) {
    long long v0, v1;
    block_range(sub_vec, &v0, &v1);
    const long long dst_off = ((long long)me * a.m + s * m_sub) * row_bytes;
    for (int i = 0; i < n; ++i) {
      uint4* dst = reinterpret_cast<uint4*>(peer_base(g, (me + i) % n) +
                                            dst_off);
      put(dst, x + s * sub_vec, v0, v1);
    }
    signal_all(g, kGemmFlagBase + (me * sub + s) * kMaxGemmBlocks +
                      blockIdx.x, g.epoch);
  }
  const T* ws = reinterpret_cast<const T*>(peer_base(g, me));
  const T* B = static_cast<const T*>(a.b);
  T* out = static_cast<T*>(a.out);
  const bool va = row_bytes % 16 == 0;
  const int tn = ceil_div(a.ncols, Tl::BN);
  const int per = ceil_div(m_sub, Tl::BM) * tn;
  const int total = n * sub * per;
  int waited = -1;
  for (int t = blockIdx.x; t < total; t += G) {
    const int q = t / per, w = t % per;          // q = i * sub + s
    const int r = (me + q / sub) % n, s = q % sub;
    if (q != waited) {
      if (!wait_flags(g, kGemmFlagBase + (r * sub + s) * kMaxGemmBlocks, 1,
                      0, G, g.epoch))
        return;
      waited = q;
    }
    const long long row0 = (long long)r * a.m + (long long)s * m_sub;
    T* o = out + row0 * a.ncols;
    const int ldo = a.ncols;
    Tl::template run<true>(smem, ws + row0 * a.k, a.k, B, a.ncols, m_sub,
                           a.ncols, a.k, (w / tn) * Tl::BM,
                           (w % tn) * Tl::BN, va, a.vec_b,
                           [&](int rr, int cc, float v) {
                             o[(long long)rr * ldo + cc] =
                                 tdt::from_f<T>(v);
                           });
  }
}

// B10: flags kGemmFlagBase + source * kMaxGemmBlocks + block.
template <typename T, int CFG>
__global__ void __launch_bounds__(NT) gemm_rs_kernel(Group g, Shape a) {
  using Tl = Tile<T, CFG>;
  extern __shared__ __align__(16) unsigned char smem[];
  if (!grid_barrier(g)) return;
  const int n = g.n, me = g.rank, G = gridDim.x;
  const int mc = a.m / n;
  const T* x = static_cast<const T*>(a.x);
  const T* B = static_cast<const T*>(a.b);
  const bool va = ((long long)a.k * sizeof(T)) % 16 == 0;
  const int tn = ceil_div(a.ncols, Tl::BN);
  const int per = ceil_div(mc, Tl::BM) * tn;
  const int flag = kGemmFlagBase + me * kMaxGemmBlocks + blockIdx.x;
  int told = 0;     // chunks (in visiting order) whose owner was told
  for (int t = blockIdx.x; t < n * per; t += G) {
    const int i = t / per, w = t % per;
    for (; told < i; ++told) signal(g, (me + 1 + told) % n, flag, g.epoch);
    const int c = (me + 1 + i) % n;
    T* dst = reinterpret_cast<T*>(peer_base(g, c)) + (long long)me * mc *
                                                         a.ncols;
    const int ldo = a.ncols;
    Tl::template run<false>(smem, x + (long long)c * mc * a.k, a.k, B,
                            a.ncols, mc, a.ncols, a.k, (w / tn) * Tl::BM,
                            (w % tn) * Tl::BN, va, a.vec_b,
                            [&](int rr, int cc, float v) {
                              dst[(long long)rr * ldo + cc] =
                                  tdt::from_f<T>(v);
                            });
  }
  for (; told < n; ++told) signal(g, (me + 1 + told) % n, flag, g.epoch);
  if (!wait_flags(g, kGemmFlagBase, n, kMaxGemmBlocks, G, g.epoch)) return;
  const long long slot_vec = (long long)mc * a.ncols * sizeof(T) / 16;
  long long v0, v1;
  block_range(slot_vec, &v0, &v1);
  reduce_slots<T>(reinterpret_cast<const uint4*>(peer_base(g, me)),
                  slot_vec, n, static_cast<uint4*>(a.out), v0, v1);
}

// B11: g.epoch carries call_index + 1, the parity is call_index % 2;
// flags kGemmFlagBase + (parity * kMaxRanks + source) * kMaxGemmBlocks +
// block. B's chunk c is columns [c * nc, (c + 1) * nc) of a row of ldb.
template <typename T, int CFG>
__global__ void __launch_bounds__(NT)
    gemm_ar_kernel(Group g, Shape a, int ldb) {
  using Tl = Tile<T, CFG>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = g.n, me = g.rank, G = gridDim.x, nch = a.parts;
  const int nc = a.ncols;
  const int p = (int)((g.epoch - 1) & 1);
  const long long slot = (long long)a.mp * nc;   // elements of one slot
  const T* x = static_cast<const T*>(a.x);
  const T* B = static_cast<const T*>(a.b);
  const bool va = ((long long)a.k * sizeof(T)) % 16 == 0;
  const int tn = ceil_div(nc, Tl::BN);
  const int per = ceil_div(a.m, Tl::BM) * tn;
  for (int t = blockIdx.x; t < nch * per; t += G) {
    const int c = t / per, w = t % per;
    const long long off = ((long long)(p * nch + c) * n + me) * slot;
    Tl::template run<false>(smem, x, a.k, B + (long long)c * nc, ldb, a.m,
                            nc, a.k, (w / tn) * Tl::BM, (w % tn) * Tl::BN,
                            va, a.vec_b, [&](int rr, int cc, float v) {
                              const T val = tdt::from_f<T>(v);
                              for (int i = 0; i < n; ++i) {
                                T* dst = reinterpret_cast<T*>(
                                    peer_base(g, (me + i) % n));
                                dst[off + (long long)rr * nc + cc] = val;
                              }
                            });
  }
  const int base = kGemmFlagBase + p * kMaxRanks * kMaxGemmBlocks;
  signal_all(g, base + me * kMaxGemmBlocks + blockIdx.x, g.epoch);
  if (!wait_flags(g, base, n, kMaxGemmBlocks, G, g.epoch)) return;
  // out row r, columns of chunk c: the n slots of (p, c) at row r.
  constexpr int E = Vec<T>::N;
  const int cv = nc / E;                       // vectors a chunk row
  const long long nvec = (long long)a.m * nch * cv;
  long long v0, v1;
  block_range(nvec, &v0, &v1);
  const uint4* ws = reinterpret_cast<const uint4*>(peer_base(g, me));
  uint4* out = static_cast<uint4*>(a.out);
  const long long slot_v = slot / E;
  for (long long v = v0 + threadIdx.x; v < v1; v += blockDim.x) {
    const long long r = v / (nch * cv);
    const int c = (int)(v / cv % nch), j = (int)(v % cv);
    const uint4* s0 = ws + (long long)(p * nch + c) * n * slot_v + r * cv + j;
    float acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.0f;
    for (int i = 0; i < n; ++i) {
      const uint4 s = __ldcg(s0 + i * slot_v);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = acc[e] + tdt::to_f(elems<T>(s)[e]);
    }
    uint4 o;
    T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
    for (int e = 0; e < E; ++e) oe[e] = tdt::from_f<T>(acc[e]);
    out[v] = o;
  }
}

// ---------------------------------------------------------------------------
// The split-K route of B11 (bf16, m <= 16, aligned): a weight stream.
// ---------------------------------------------------------------------------

// At decode the bytes of the weight shard are the bound, so it streams
// through every block of the grid. The work unit is a strip: 64 output
// columns of one chunk (a warp's 8 lanes x 16 bytes) over the rank's whole
// K shard; strip s of chunk c is columns [c * nc + 64 s, ...) of B, the
// chunk's last strip cut at nc. The strips (chunk-major) are dealt to the
// persistent grid as strip = b, b + G, ... — the same on every rank, since
// every rank's grid is the same. In a block the 8 warps split K into
// 32-row steps (warp w takes w, w + 8, ...), each lane keeping eight
// 16-byte weight loads in flight with the next step's (the next strip's
// first, at a strip's end) issued before this step's products; the m rows
// of A wait in shared memory, all of K staged once a launch. The products
// run on mma.sync with the weight as the 16-row operand (W^T x A^T: its
// rows are output columns, the activation rows the 8-wide side), the
// weight bytes paired in registers by byte permutes, as B3's split-K. The
// warps' partials are summed in shared memory in warp order in fp32, cast
// once to bf16 (gemm_ar_partials' rounding, within B3's tolerance), and
// the strip's m rows x 128 bytes go as 16-byte vectors into slot `me` of
// (p, c) on every rank, this rank's own first. No clusters: the r ranks'
// grids on one card must all be resident at once, since every block pushes
// before it waits, and clusters of up to 8 CTAs do not promise that.
//
// The exchange: after its last strip, block b raises flag (p, me, b) on
// every rank, then waits only for (p, s, b) from each source s — the n
// blocks that wrote the strips it reduces — and sums those strips' n
// slots in rank order from 0, in fp32, one cast, straight into `out`: n
// flags a block, not n·G. Safe across calls: at call t+2 block b writes
// parity p of peer q only after this rank's call t+1 ended, and that
// kernel's block b waited for q's block b's call-(t+1) flag; q's block b
// raised it in q's call t+1, which began after q's call t — whose block b
// reduced the same strips of parity p — had ended (stream order). The
// flags are per parity, so a fast peer's call t+1 never counts toward t.
// Their memory scope is push.cuh's: the GPU's when the group lives on one
// card (on an H100 80GB HBM3 at 700 W the system scope cost 0.038-0.041
// against 0.033 ms a call at wo: scripts/time_port_gemm_comm.py, PERF.md
// §6), the system's across cards.
constexpr int kSkThreads = 256, kSkWarps = 8;
constexpr int kSkCols = 64;     // a strip's columns
constexpr int kSkStep = 32;     // K rows a warp takes a step

// Shared memory: A's m rows of all of K (a row padded by 16 bytes), the
// warps' partials (float4 per lane and tile), the strip's bf16 sums.
__host__ __device__ inline int sk_pitch(int k) {
  return ceil_div(k, kSkStep) * kSkStep * 2 + 16;
}
__host__ __device__ inline int sk_red_bytes(int mt) {
  return kSkWarps * mt * 4 * 32 * 16;
}
__host__ __device__ inline int sk_smem(int m, int k) {
  return m * sk_pitch(k) + sk_red_bytes(m <= 8 ? 1 : 2) + 16 * kSkCols * 2;
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <int MT, bool SYS>
__global__ void __launch_bounds__(kSkThreads, 1)
    gemm_ar_splitk(Group g, Shape a, int ldb) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int F = MT * 4, U = F * 32;      // a lane's tiles; the units
  const int n = g.n, me = g.rank, G = gridDim.x, b = blockIdx.x;
  const int m = a.m, nc = a.ncols, nch = a.parts;
  const int p = (int)((g.epoch - 1) & 1);
  const int spc = ceil_div(nc, kSkCols);       // strips a chunk
  const int strips = nch * spc;
  const int ns = b < strips ? ceil_div(strips - b, G) : 0;
  const int total = ceil_div(a.k, kSkStep);
  const int pitch = sk_pitch(a.k);
  unsigned char* sa = smem;
  float4* red = reinterpret_cast<float4*>(smem + m * pitch);
  bf16* tile = reinterpret_cast<bf16*>(smem + m * pitch + sk_red_bytes(MT));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  const bf16* B = static_cast<const bf16*>(a.b);
  const long long slot = (long long)a.mp * nc;   // elements of one slot

  {
    // A's rows [0, m) of K [0, total * 32), zeros past K.
    const int kv = a.k / 8, vrow = total * kSkStep / 8;
    const uint4* x = static_cast<const uint4*>(a.x);
    for (int v = threadIdx.x; v < m * vrow; v += kSkThreads) {
      const int r = v / vrow, cv = v % vrow;
      const uint4 val = cv < kv ? __ldg(x + (long long)r * kv + cv)
                                : make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(sa + r * pitch + cv * 16) = val;
    }
  }
  // Rows of B a lane loads at a step: 2t, 2t+1, 2t+8, 2t+9 of each 16-row
  // half (the weight operand's a0-a1 / a2-a3 K pairs).
  auto load = [&](uint4 (&v)[8], int st, int step, bool ok) {
    const int col = (st % spc) * kSkCols + gq * 8;
    const bf16* src = B + (long long)(st / spc) * nc + col;
    ok = ok && col < nc;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = step * kSkStep + (i >> 2) * 16 + ((i & 2) ? 8 : 0) +
                      2 * t + (i & 1);
      v[i] = make_uint4(0, 0, 0, 0);
      if (ok && row < a.k)
        v[i] = __ldcs(reinterpret_cast<const uint4*>(src + (long long)row *
                                                                ldb));
    }
  };
  const bool works = warp < total;
  uint4 cur[8];
  if (works) load(cur, b, warp, ns > 0);
  __syncthreads();
  for (int i = 0; i < ns; ++i) {
    const int st = b + i * G;
    float acc[MT][4][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
    for (int s = warp; works && s < total; s += kSkWarps) {
      uint4 nxt[8];
      const bool more = s + kSkWarps < total;
      load(nxt, more ? st : st + G, more ? s + kSkWarps : warp,
           more || i + 1 < ns);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t bb[MT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int r = mt * 8 + gq;
          const unsigned char* ar =
              sa + r * pitch + (s * kSkStep + 16 * h + 2 * t) * 2;
          bb[mt][0] = r < m ? *reinterpret_cast<const uint32_t*>(ar) : 0u;
          bb[mt][1] =
              r < m ? *reinterpret_cast<const uint32_t*>(ar + 16) : 0u;
        }
        const uint4& r0 = cur[4 * h];
        const uint4& r1 = cur[4 * h + 1];
        const uint4& r8 = cur[4 * h + 2];
        const uint4& r9 = cur[4 * h + 3];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t w0 = word_of(r0, j), w1 = word_of(r1, j);
          const uint32_t w8 = word_of(r8, j), w9 = word_of(r9, j);
          const uint32_t wa[4] = {__byte_perm(w0, w1, 0x5410),
                                  __byte_perm(w0, w1, 0x7632),
                                  __byte_perm(w8, w9, 0x5410),
                                  __byte_perm(w8, w9, 0x7632)};
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            tdt::tile::Mma<bf16>::run(acc[mt][j], wa, bb[mt]);
        }
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) cur[q] = nxt[q];
    }
    // The partials: tile (mt, j) of lane ln holds weight columns c, c + 1
    // (its a0 / a1 rows) of activation rows 2 t', 2 t' + 1 of block mt.
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        red[(warp * F + mt * 4 + j) * 32 + lane] =
            make_float4(acc[mt][j][0], acc[mt][j][1], acc[mt][j][2],
                        acc[mt][j][3]);
    __syncthreads();
    for (int u = threadIdx.x; u < U; u += kSkThreads) {
      float4 sum = red[u];
#pragma unroll
      for (int w = 1; w < kSkWarps; ++w) {
        const float4 v = red[w * U + u];
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
      const int f = u >> 5, ln = u & 31;
      const int c = (ln >> 2) * 8 + 2 * (f % 4), r = (f / 4) * 8 + 2 * (ln & 3);
      if (r < m) {
        tile[r * kSkCols + c] = tdt::from_f<bf16>(sum.x);
        tile[r * kSkCols + c + 1] = tdt::from_f<bf16>(sum.z);
      }
      if (r + 1 < m) {
        tile[(r + 1) * kSkCols + c] = tdt::from_f<bf16>(sum.y);
        tile[(r + 1) * kSkCols + c + 1] = tdt::from_f<bf16>(sum.w);
      }
    }
    __syncthreads();
    // The strip's rows into slot `me` of (p, c) on every rank, own first.
    const int c = st / spc, col0 = (st % spc) * kSkCols;
    const int vecs = min(kSkCols, nc - col0) / 8;
    const long long base = ((long long)(p * nch + c) * n + me) * slot + col0;
    for (int v = threadIdx.x; v < m * 8; v += kSkThreads) {
      const int r = v >> 3, j = v & 7;
      if (j >= vecs) continue;
      const uint4 val =
          *reinterpret_cast<const uint4*>(tile + r * kSkCols + j * 8);
      const long long off = base + (long long)r * nc + j * 8;
      for (int q = 0; q < n; ++q)
        *reinterpret_cast<uint4*>(
            reinterpret_cast<bf16*>(peer_base(g, (me + q) % n)) + off) = val;
    }
  }
  // Every strip's stores issued (the block meets past them): raise (p,
  // me, b) on every rank, then wait for (p, s, b) of every source s.
  const int fb = kGemmFlagBase + p * kMaxRanks * kMaxGemmBlocks;
  __syncthreads();
  int ok = 1;
  if (threadIdx.x < n) {
    tdt::push::signal_word<SYS>(g, threadIdx.x, fb + me * kMaxGemmBlocks + b);
    ok = tdt::push::spin<SYS>(g, fb + threadIdx.x * kMaxGemmBlocks + b,
                              g.epoch);
  }
  if (!__syncthreads_and(ok)) return;
  // This block's strips of the n slots of (p, c), summed in rank order.
  const uint4* ws = reinterpret_cast<const uint4*>(peer_base(g, me));
  uint4* out = static_cast<uint4*>(a.out);
  const long long slot_v = slot / 8;
  for (int v = threadIdx.x; v < ns * m * 8; v += kSkThreads) {
    const int i = v / (m * 8), r = v / 8 % m, j = v & 7;
    const int st = b + i * G, c = st / spc, col0 = (st % spc) * kSkCols;
    if (col0 + j * 8 >= nc) continue;
    const uint4* s0 = ws + (long long)(p * nch + c) * n * slot_v +
                      ((long long)r * nc + col0 + j * 8) / 8;
    uint4 sv[kMaxRanks];
#pragma unroll
    for (int q = 0; q < kMaxRanks; ++q)
      if (q < n) sv[q] = __ldcg(s0 + q * slot_v);
    float acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = 0.0f;
#pragma unroll
    for (int q = 0; q < kMaxRanks; ++q)
      if (q < n) {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc[e] = acc[e] + tdt::to_f(elems<bf16>(sv[q])[e]);
      }
    uint4 o;
    bf16* oe = reinterpret_cast<bf16*>(&o);
#pragma unroll
    for (int e = 0; e < 8; ++e) oe[e] = tdt::from_f<bf16>(acc[e]);
    out[((long long)r * nch * nc + c * nc + col0 + j * 8) / 8] = o;
  }
}

// ---------------------------------------------------------------------------
// The wgmma + TMA route of B9 and B10 (bf16, tall tile): gemm_wgmma.cuh's
// ring; the entry barrier and the flags as above.
// ---------------------------------------------------------------------------

// Producer warp: wait (its 32 lanes sharing the G flags) for the flags
// base + b, b < G; false on timeout. Every lane's acquire is ordered before
// the warp's later work by the __syncwarp.
__device__ __forceinline__ bool warp_wait_flags(const Group& g, int base,
                                                int G) {
  const int lane = threadIdx.x & 31;
  bool ok = true;
  for (int b = lane; b < G && ok; b += 32) ok = spin(g, base + b, g.epoch);
  ok = __all_sync(0xffffffffu, ok);
  __syncwarp();
  return ok;
}

// B9: flags kGemmFlagBase + (source * sub + s) * kMaxGemmBlocks + block.
// tx: this rank's A (m, k); tws: this rank's landing workspace (n*m, k);
// tb: B (k, ncols). Clusters of two CTAs; the cluster's pair tile t: group
// q = t / per (source rank me + q / sub, sub-block q % sub), pair t % per
// of it.
template <int BN>
__global__ void __cluster_dims__(wg::CLUSTER, 1, 1)
    __launch_bounds__(wg::THREADS, 1)
    ag_gemm_wgmma(Group g, Shape a, const __grid_constant__ CUtensorMap tx,
                  const __grid_constant__ CUtensorMap tws,
                  const __grid_constant__ CUtensorMap tb) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  if (!grid_barrier(g)) return;
  const wg::Ring ring = wg::ring_of<BN>(smem_raw);
  if (threadIdx.x == 0) wg::ring_init<BN>(ring);
  __syncthreads();
  const int n = g.n, me = g.rank, sub = a.parts;
  const int crank = blockIdx.x % wg::CLUSTER;   // the cluster's CTA rank
  const int cl = blockIdx.x / wg::CLUSTER, ncl = gridDim.x / wg::CLUSTER;
  const int m_sub = a.m / sub;
  const int rtp = wg::pairs_of(ceil_div(m_sub, wg::BM));
  const int per = rtp * ceil_div(a.ncols, BN);
  const int total = n * sub * per;
  const int ktiles = ceil_div(a.k, wg::BK);
  // Warp-uniform (a shuffle from lane 0), so the wgmma descriptors built
  // from it live in uniform registers.
  const int wgi = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wgi == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(
        wg::kProducerRegs));
    const int warp = (threadIdx.x >> 5) & 3;
    if (warp == 0) {
      // TMA: own rows from x at once; a peer's (source, sub-block) after
      // its flags from every block of that peer, then a proxy fence. A
      // timed-out wait (the error word is written) stops the waiting, and
      // the ring runs on so the consumers finish.
      int it = 0, waited = -1;
      bool failed = false;
      for (int t = cl; t < total; t += ncl) {
        const int q = t / per;
        const int r = (me + q / sub) % n, s = q % sub;
        const int2 at = wg::tile_at(t % per, rtp, BN, crank);
        const int row = s * m_sub + at.x;
        if (r != me && q != waited) {
          if (!failed)
            failed = !warp_wait_flags(
                g, kGemmFlagBase + (r * sub + s) * kMaxGemmBlocks,
                gridDim.x);
          waited = q;
          if ((threadIdx.x & 31) == 0) fence_proxy_async_global();
        }
        if ((threadIdx.x & 31) == 0)
          wg::load_tile<BN>(ring, it, r == me ? &tx : &tws,
                            r == me ? row : r * a.m + row, &tb, at.y,
                            ktiles);
        __syncwarp();
      }
    } else {
      // Warps 1-3: this block's share of each sub-block, read once and
      // stored into slot `me` of every rank (the peers before this one),
      // then that sub-block's flag raised on every rank.
      const int pt = threadIdx.x - 256 - 32, np = 96;
      constexpr int U = 4;
      const long long row_vec = (long long)a.k * 2 / 16;
      const long long sub_vec = m_sub * row_vec;
      const uint4* x = static_cast<const uint4*>(a.x);
      const long long me_off = (long long)me * a.m * row_vec;
      for (int s = 0; s < sub; ++s) {
        long long v0, v1;
        block_range(sub_vec, &v0, &v1);
        const uint4* src = x + s * sub_vec;
        const long long off = me_off + s * sub_vec;
        for (long long v = v0 + pt; v < v1; v += np * U) {
          uint4 val[U];
#pragma unroll
          for (int u = 0; u < U; ++u)
            if (v + u * np < v1) val[u] = __ldcg(src + v + u * np);
          for (int i = 1; i <= n; ++i) {
            uint4* dst = reinterpret_cast<uint4*>(
                             peer_base(g, (me + n - i) % n)) + off;
#pragma unroll
            for (int u = 0; u < U; ++u)
              if (v + u * np < v1) dst[v + u * np] = val[u];
          }
        }
        bar_sync(wg::kBarPushers, np);
        if (pt < n) {
          fence();
          st_release_sys(flags(g, pt) + kGemmFlagBase +
                             (me * sub + s) * kMaxGemmBlocks + blockIdx.x,
                         g.epoch);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(
        wg::kConsumerRegs));
    bf16* out = static_cast<bf16*>(a.out);
    int it = 0;
    float acc[BN / 2];
    for (int t = cl; t < total; t += ncl) {
      const int q = t / per;
      const int r = (me + q / sub) % n, s = q % sub;
      const int2 at = wg::tile_at(t % per, rtp, BN, crank);
      wg::mma_tile<BN>(ring, it, ktiles, wgi, acc);
      wg::store_tile<BN>(
          wgi, acc,
          out + ((long long)r * a.m + s * m_sub + at.x) * a.ncols + at.y,
          a.ncols, m_sub - at.x, a.ncols - at.y);
    }
  }
}

// B10: flags kGemmFlagBase + source * kMaxGemmBlocks + block. tx: this
// rank's A (m, k); tb: B (k, ncols). Clusters of two CTAs; the cluster's
// pair tile t: chunk i = t / per (owner me + 1 + i), pair t % per of it.
template <int BN>
__global__ void __cluster_dims__(wg::CLUSTER, 1, 1)
    __launch_bounds__(wg::THREADS, 1)
    gemm_rs_wgmma(Group g, Shape a, const __grid_constant__ CUtensorMap tx,
                  const __grid_constant__ CUtensorMap tb) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  if (!grid_barrier(g)) return;
  const wg::Ring ring = wg::ring_of<BN>(smem_raw);
  if (threadIdx.x == 0) wg::ring_init<BN>(ring);
  __syncthreads();
  const int n = g.n, me = g.rank;
  const int crank = blockIdx.x % wg::CLUSTER;
  const int cl = blockIdx.x / wg::CLUSTER, ncl = gridDim.x / wg::CLUSTER;
  const int mc = a.m / n;
  const int rtp = wg::pairs_of(ceil_div(mc, wg::BM));
  const int per = rtp * ceil_div(a.ncols, BN);
  const int ktiles = ceil_div(a.k, wg::BK);
  const int wgi = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wgi == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(
        wg::kProducerRegs));
    if (threadIdx.x == 256) {
      int it = 0;
      for (int t = cl; t < n * per; t += ncl) {
        const int c = (me + 1 + t / per) % n;
        const int2 at = wg::tile_at(t % per, rtp, BN, crank);
        wg::load_tile<BN>(ring, it, &tx, c * mc + at.x, &tb, at.y, ktiles);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(
      wg::kConsumerRegs));
  const int ct = threadIdx.x;     // 0 .. 255
  const int flag = kGemmFlagBase + me * kMaxGemmBlocks + blockIdx.x;
  // Tell chunk owner j that this block's stores to it are done: the
  // consumers meet, then one fences and raises the flag.
  auto tell = [&](int j) {
    bar_sync(wg::kBarConsumers, 256);
    if (ct == 0) {
      fence();
      st_release_sys(flags(g, j) + flag, g.epoch);
    }
  };
  int it = 0, told = 0;
  float acc[BN / 2];
  for (int t = cl; t < n * per; t += ncl) {
    const int i = t / per;
    for (; told < i; ++told) tell((me + 1 + told) % n);
    const int c = (me + 1 + i) % n;
    const int2 at = wg::tile_at(t % per, rtp, BN, crank);
    bf16* dst = reinterpret_cast<bf16*>(peer_base(g, c)) +
                (long long)me * mc * a.ncols;
    wg::mma_tile<BN>(ring, it, ktiles, wgi, acc);
    wg::store_tile<BN>(wgi, acc, dst + (long long)at.x * a.ncols + at.y,
                       a.ncols, mc - at.x, a.ncols - at.y);
  }
  for (; told < n; ++told) tell((me + 1 + told) % n);
  // Every rank's blocks of this rank's chunk, the flags shared by the
  // consumers; then the unchanged slot reduction over 256 threads.
  const int G = gridDim.x;
  bool ok = true;
  for (int f = ct; f < n * G && ok; f += 256)
    ok = spin(g, kGemmFlagBase + (f / G) * kMaxGemmBlocks + f % G,
              g.epoch);
  if (!bar_and(wg::kBarConsumers, 256, ok)) return;
  const long long slot_vec = (long long)mc * a.ncols * 2 / 16;
  long long v0, v1;
  block_range(slot_vec, &v0, &v1);
  reduce_slots_part<bf16>(
      reinterpret_cast<const uint4*>(peer_base(g, me)), slot_vec, n,
      static_cast<uint4*>(a.out), v0, v1, ct, 256);
}

// Shared memory each block of a fused kernel reserves: more than half of an
// SM's 228 KiB, so a block holds its SM alone. Every block of these
// kernels may spin on a peer; a spinning block that shared its SM with a
// peer rank's non-waiting kernel (a cuBLAS or K1 launch queued before
// that peer's own fused kernel) could leave no SM with room for that
// kernel's blocks, and the peer would never arrive. One block an SM, and
// at most 1/r of the SMs a rank (r ranks on the card), leaves the
// laggard's kernels SMs of their own. The mma.sync tiles reserve
// kReserveSmem; the wgmma route's ring takes wg::SMEM_BYTES, more again.
constexpr int kReserveSmem = 120 << 10;

// The persistent grid: at most `tiles` blocks and at most 1/r of the SMs.
cudaError_t persistent_grid(int tiles, int ranks_on_card, int* grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  int cap = sms / (ranks_on_card < 1 ? 1 : ranks_on_card);
  cap = cap < kMaxGemmBlocks ? cap : kMaxGemmBlocks;
  if (cap < 1) return cudaErrorInvalidConfiguration;
  *grid = tiles < cap ? (tiles < 1 ? 1 : tiles) : cap;
  return cudaSuccess;
}

enum Op { AG_GEMM = 0, GEMM_RS = 1, GEMM_AR = 2 };

static_assert(wg::SMEM_BYTES > (228 << 10) / 2 &&
                  wg::SMEM_BYTES <= 232448,
              "the ring holds its SM alone and fits a block");

// The wgmma route of B9 (op 0) and B10 (op 1) at tile width BN: bf16; A's
// rows, B's rows and the bases whole 16-byte units (else refused: the
// wrapper routes such shapes to the mma.sync tiles before the launch). ws:
// this rank's landing workspace (B9's A map over it).
template <int BN>
cudaError_t launch_wgmma_bn(int op, const Group& g, const Shape& a,
                            const void* ws, int ranks_on_card,
                            cudaStream_t stream) {
  // Clusters of two CTAs, one a pair of row tiles: the grid is even, at
  // most 1/r of the SMs, at most two blocks a pair tile.
  const int tn = ceil_div(a.ncols, BN);
  const int pairs =
      op == AG_GEMM
          ? g.n * a.parts *
                wg::pairs_of(ceil_div(a.m / a.parts, wg::BM)) * tn
          : g.n * wg::pairs_of(ceil_div(a.m / g.n, wg::BM)) * tn;
  int grid = 1;
  cudaError_t err = persistent_grid(wg::CLUSTER * pairs, ranks_on_card,
                                    &grid);
  if (err != cudaSuccess) return err;
  grid -= grid % wg::CLUSTER;
  if (grid < wg::CLUSTER) return cudaErrorInvalidConfiguration;
  CUtensorMap tx, tb, tws;
  err = make_map_2d(&tx, a.x, a.m, a.k, a.k, wg::BM);
  if (err == cudaSuccess)
    err = make_map_2d(&tb, a.b, a.k, a.ncols, a.ncols, wg::BK);
  if (err == cudaSuccess && op == AG_GEMM)
    err = make_map_2d(&tws, ws, (long long)g.n * a.m, a.k, a.k, wg::BM);
  if (err != cudaSuccess) return err;
  static tdt::SmemCap cap_ag, cap_rs;
  if (op == AG_GEMM) {
    err = tdt::ensure_smem(ag_gemm_wgmma<BN>, wg::SMEM_BYTES, cap_ag);
    if (err == cudaSuccess)
      ag_gemm_wgmma<BN><<<grid, wg::THREADS, wg::SMEM_BYTES, stream>>>(
          g, a, tx, tws, tb);
  } else {
    err = tdt::ensure_smem(gemm_rs_wgmma<BN>, wg::SMEM_BYTES, cap_rs);
    if (err == cudaSuccess)
      gemm_rs_wgmma<BN><<<grid, wg::THREADS, wg::SMEM_BYTES, stream>>>(
          g, a, tx, tb);
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// BN 256 where the output has 512 columns or more (fewer bytes from L2 a
// product), else 128 (gemm_wgmma.cuh).
cudaError_t launch_wgmma(int op, const Group& g, const Shape& a,
                         const void* ws, int ranks_on_card,
                         cudaStream_t stream) {
  if (op == GEMM_AR || (a.k * 2) % 16 || (a.ncols * 2) % 16 || !a.vec_b)
    return cudaErrorInvalidValue;
  return a.ncols >= 512
             ? launch_wgmma_bn<256>(op, g, a, ws, ranks_on_card, stream)
             : launch_wgmma_bn<128>(op, g, a, ws, ranks_on_card, stream);
}

// B11's split-K route: bf16, m <= 16; A's rows, B's base and rows of ldb
// and a chunk's nc columns whole 16-byte units; A's rows of all of K and
// the partials within a block's shared memory (else refused: the wrapper
// keeps such shapes on the mma.sync tiles, ops/gemm_allreduce.py
// gemm_ar_route). One block a strip at most, at most 1/r of the SMs, one
// block an SM (at least kReserveSmem of shared memory).
template <int MT, bool SYS>
cudaError_t launch_splitk_mt(const Group& g, const Shape& a, int ldb,
                             int grid, int smem, cudaStream_t stream) {
  static tdt::SmemCap cap;
  cudaError_t err = tdt::ensure_smem(gemm_ar_splitk<MT, SYS>, smem, cap);
  if (err != cudaSuccess) return err;
  gemm_ar_splitk<MT, SYS><<<grid, kSkThreads, smem, stream>>>(g, a, ldb);
  return cudaGetLastError();
}

cudaError_t launch_splitk(const Group& g, const Shape& a, int ldb,
                          int ranks_on_card, int sys, cudaStream_t stream) {
  if (a.m > 16 || !a.vec_b || a.k % 8 || a.ncols % 8 || ldb % 8 ||
      a.parts * a.ncols > ldb)
    return cudaErrorInvalidValue;
  const int need = sk_smem(a.m, a.k);
  if (need > 232448) return cudaErrorInvalidValue;
  const int smem = need > kReserveSmem ? need : kReserveSmem;
  int grid = 1;
  cudaError_t err = persistent_grid(a.parts * ceil_div(a.ncols, kSkCols),
                                    ranks_on_card, &grid);
  if (err != cudaSuccess) return err;
  if (a.m <= 8)
    return sys ? launch_splitk_mt<1, true>(g, a, ldb, grid, smem, stream)
               : launch_splitk_mt<1, false>(g, a, ldb, grid, smem, stream);
  return sys ? launch_splitk_mt<2, true>(g, a, ldb, grid, smem, stream)
             : launch_splitk_mt<2, false>(g, a, ldb, grid, smem, stream);
}

template <typename T, int CFG>
cudaError_t launch(int op, const Group& g, const Shape& a, int ldb,
                   int ranks_on_card, cudaStream_t stream) {
  using Tl = Tile<T, CFG>;
  int tiles = 0;
  if (op == AG_GEMM)
    tiles = g.n * a.parts * ceil_div(a.m / a.parts, Tl::BM) *
            ceil_div(a.ncols, Tl::BN);
  else if (op == GEMM_RS)
    tiles = g.n * ceil_div(a.m / g.n, Tl::BM) * ceil_div(a.ncols, Tl::BN);
  else
    tiles = a.parts * ceil_div(a.m, Tl::BM) * ceil_div(a.ncols, Tl::BN);
  static_assert(Tl::SMEM <= kReserveSmem, "the tile fits the reservation");
  int grid = 1;
  cudaError_t err = persistent_grid(tiles, ranks_on_card, &grid);
  if (err != cudaSuccess) return err;
  static tdt::SmemCap cap_ag, cap_rs, cap_ar;
  if (op == AG_GEMM) {
    err = tdt::ensure_smem(ag_gemm_kernel<T, CFG>, kReserveSmem, cap_ag);
    if (err == cudaSuccess)
      ag_gemm_kernel<T, CFG><<<grid, NT, kReserveSmem, stream>>>(g, a);
  } else if (op == GEMM_RS) {
    err = tdt::ensure_smem(gemm_rs_kernel<T, CFG>, kReserveSmem, cap_rs);
    if (err == cudaSuccess)
      gemm_rs_kernel<T, CFG><<<grid, NT, kReserveSmem, stream>>>(g, a);
  } else {
    err = tdt::ensure_smem(gemm_ar_kernel<T, CFG>, kReserveSmem, cap_ar);
    if (err == cudaSuccess)
      gemm_ar_kernel<T, CFG><<<grid, NT, kReserveSmem, stream>>>(g, a, ldb);
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// op: 0 AG+GEMM (B9), 1 GEMM+RS (B10), 2 GEMM+AR (B11). dtype: 0 float32,
// 1 bfloat16 (A, B and out alike). cfg: the route (0 the tall mma.sync
// tile, 1 the short one, 2 the wgmma + TMA mainloop: bf16, B9 and B10; 3
// the split-K weight stream: bf16, B11 at m <= 16).
// x, b, out: this rank's A, B and output, contiguous (B11's b: the whole
// (k, ldb) shard, its chunks read in place); ws: this rank's symmetric
// workspace (its base as the host sees it, for B9's tensor map). m, mp,
// k, ncols, parts: see Shape. epoch: the call's epoch (B11: call_index, sent as + 1).
// ranks_on_card: ranks sharing this card (the grid's share of it). sys:
// the split-K route's flags at the system's scope (1: a peer is another
// card) or the GPU's (0). Returns the launch's cudaError_t.
int tdt_gemm_comm(const void* table, const void* sig_table, void* err,
                  int rank, int n, unsigned long long epoch,
                  long long timeout_ns, const void* x, const void* b,
                  void* out, const void* ws, int op, int m, int mp, int k,
                  int ncols, int ldb, int parts, int dtype, int cfg,
                  int vec_b, int ranks_on_card, int sys,
                  cudaStream_t stream) {
  if (n < 1 || n > kMaxRanks || rank < 0 || rank >= n || m < 1 || k < 1 ||
      ncols < 1 || parts < 1 || op < 0 || op > 2 || cfg < 0 || cfg > 3)
    return cudaErrorInvalidValue;
  if (op == AG_GEMM && (m % parts || parts > 4)) return cudaErrorInvalidValue;
  if (op == GEMM_RS && m % n) return cudaErrorInvalidValue;
  if (op == GEMM_AR && (mp < m || parts > 8)) return cudaErrorInvalidValue;
  const Group g = make_group(table, sig_table, err, rank, n,
                             op == GEMM_AR ? epoch + 1 : epoch, timeout_ns);
  const Shape a{x, b, out, m, mp, k, ncols, parts, vec_b};
  if (cfg == 2)
    return dtype == 1 ? launch_wgmma(op, g, a, ws, ranks_on_card, stream)
                      : cudaErrorInvalidValue;
  if (cfg == 3)
    return dtype == 1 && op == GEMM_AR
               ? launch_splitk(g, a, ldb, ranks_on_card, sys, stream)
               : cudaErrorInvalidValue;
  const int code = dtype * 2 + cfg;
  switch (code) {
    case 0: return launch<float, 0>(op, g, a, ldb, ranks_on_card, stream);
    case 1: return launch<float, 1>(op, g, a, ldb, ranks_on_card, stream);
    case 2: return launch<bf16, 0>(op, g, a, ldb, ranks_on_card, stream);
    case 3: return launch<bf16, 1>(op, g, a, ldb, ranks_on_card, stream);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
