// K1 — flash-attention prefill for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel triton_distributed_tpu/ops/flash_attention.py:157
// (_flash_kernel): blockwise online-softmax GQA attention with positional
// causality from (q_offset, k_offset), fully hidden key tiles skipped, and
// either a normalized output or the fp32 (acc, m, l) partials.
//
// What bounds it on this card: at prefill shapes (S ~ 1k, d = 128) the work
// is ~4*S*S/2*d*hq flops against a few MB of q/k/v, far above the H100's
// ~295 bf16 flops per byte, so the bound is the tensor-core rate.
//
// Two lanes, picked by dtype:
//
// bf16 — warp-specialized wgmma + TMA (flash_fwd_wgmma below):
//  - work tiles of (128 queries, query head, batch); a persistent grid of
//    one block per SM walks them, longest causal rows first, the g query
//    heads of one KV head next to each other (their K/V tiles meet in L2);
//  - a block is a producer warpgroup whose one thread issues TMA loads and
//    two consumer warpgroups of 64 query rows each; setmaxnreg moves
//    registers from the producer (24) to the consumers (240);
//  - Q (128 x d) is loaded once a work tile, K and V stream through a ring
//    of two stages of 128 keys, all 128-byte-swizzled tiles completed
//    through mbarriers (full) and handed back by the consumers (empty);
//    the ring runs on across work tiles and Q is handed back after its
//    last S, so the next tile's loads run under this tile's last P.V and
//    its output stores;
//  - S = Q.K^T by SS-wgmma (bf16 in, fp32 out); the online softmax runs on
//    the accumulator fragment (each thread holds two rows, a row's max and
//    sum reduce over the 4 lanes of a quad), scaling after the dot inside
//    the exponent; p is rounded to bf16 in registers and O += P.V runs as
//    RS-wgmma with P as the A fragment and V read in its stored (keys x d)
//    layout: the transposed-B form that 16-bit types allow, no copy of V^T;
//  - the K/V tensor maps end at the call's key frontier
//    (min(Sk, q_offset + Sq - k_offset) when causal): tiles past a work
//    tile's frontier are never loaded, TMA fills zeros past the frontier
//    inside the last tile (no stale or NaN key reaches P.V), and only tiles
//    that cross the diagonal or Sk are masked; causal=False runs unmasked;
//  - not done: overlapping a warpgroup's softmax with its own wgmmas (S of
//    tile j beside P.V of tile j-1). With both groups in flight their 24
//    descriptors outgrew the uniform registers and ptxas serialized every
//    wgmma (C7513), which was slower than this.
//
// fp32 — FMA from shared memory (flash_fwd_kernel, the port's first K1,
// unchanged): the tensor cores take fp32 only as TF32, which would break
// the fp32 contract (and TOL["fp32"]), so this lane stays on fp32 FMA:
//  - one block per (64-query tile, query head, batch) and a loop over
//    32-key tiles staged in shared memory; the block stops at the causal
//    frontier, so tiles above the diagonal (and the unwritten tail of a
//    chunked-prefill buffer) are never loaded;
//  - each thread owns a 4x2 tile of scores and a 4x(D/16) tile of the
//    output, so every shared-memory value it loads feeds several FMAs;
//    K rows are padded by one float so the 16 column-threads of a row hit
//    16 different banks;
//  - the online-softmax row statistics reduce over the 16 threads of a row
//    with warp shuffles (no shared-memory round trip);
//  - q-tiles are scheduled last-first, so the longest causal rows start
//    first and the tail of the grid is short.
//
// Arithmetic of both matches the TPU kernel: fp32 QK scaled after the dot,
// masked logits at -1e30, m/l in fp32 (l summed from the fp32 p), p rounded
// to V's dtype before PV, a dead row ends with m = -1e30, l = 0 and a
// normalized output of 0.

#include <cuda.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using tdt::from_f;
using tdt::NEG;
using tdt::to_f;

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 32;   // keys per shared-memory tile
constexpr int NT = 256;  // threads per block, as 16 (rows) x 16 (columns)

__device__ __forceinline__ float row_max16(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 8));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 8);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x;
}

template <int D>
constexpr int smem_floats() {
  return BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1);
}

// q: (B, Sq, hq, D); k, v: (B, Sk, hkv, D), all contiguous.
// out: (B, Sq, hq, D) in T when normalize, else fp32 acc; m, l: (B, Sq, hq).
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, void* __restrict__ out,
                 float* __restrict__ m_out, float* __restrict__ l_out, int Sq,
                 int Sk, int hq, int hkv, int q_off, int k_off, int causal,
                 int normalize, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                // [BQ][D + 1]
  float* Ks = Qs + BQ * (D + 1);   // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);   // [BK][D]
  float* Ps = Vs + BK * D;         // [BQ][BK + 1]

  constexpr int RI = BQ / 16;  // query rows per thread
  constexpr int CJ = BK / 16;  // score columns per thread
  constexpr int OJ = D / 16;   // output columns per thread

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int q0 = qt * BQ;
  const int rows = min(BQ, Sq - q0);

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D;
    const int c = idx - r * D;
    float x = 0.f;
    if (r < rows) x = to_f(q[(((size_t)b * Sq + q0 + r) * hq + h) * D + c]);
    Qs[r * (D + 1) + c] = x;
  }

  // Key tiles up to the causal frontier of this block's last real row.
  int nk = (Sk + BK - 1) / BK;
  if (causal) {
    const long long last_key = (long long)q_off + q0 + rows - 1 - k_off;
    nk = last_key < 0 ? 0 : (int)min((long long)nk, last_key / BK + 1);
  }

  float m_i[RI], l_i[RI], acc[RI][OJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m_i[i] = NEG;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < OJ; ++j) acc[i][j] = 0.f;
  }

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's Ks/Vs/Ps are consumed
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int r = idx / D;
      const int c = idx - r * D;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < Sk) {
        const size_t off = (((size_t)b * Sk + k0 + r) * hkv + hk) * D + c;
        kx = to_f(k[off]);
        vx = to_f(v[off]);
      }
      Ks[r * (D + 1) + c] = kx;
      Vs[r * D + c] = vx;
    }
    __syncthreads();

    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float qv[RI], kv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = Qs[(ty + 16 * i) * (D + 1) + c];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kv[j] = Ks[(tx + 16 * j) * (D + 1) + c];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const long long qpos = (long long)q_off + q0 + ty + 16 * i;
      bool ok[CJ];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int kc = k0 + tx + 16 * j;
        ok[j] = kc < Sk && (!causal || qpos >= (long long)k_off + kc);
        s[i][j] = ok[j] ? s[i][j] * scale : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max16(mx);
      const float m_new = fmaxf(m_i[i], mx);
      const float corr = expf(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        Ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = to_f(from_f<T>(p));
      }
      rs = row_sum16(rs);
      l_i[i] = l_i[i] * corr + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < OJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = Ps[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < OJ; ++j) {
        const float vv = Vs[kk * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RI; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
    const size_t row = ((size_t)b * Sq + q0 + r) * hq + h;
    if (normalize) {
      const float denom = fmaxf(l_i[i], 1e-30f);
      T* o = static_cast<T*>(out) + row * D;
#pragma unroll
      for (int j = 0; j < OJ; ++j) o[tx + 16 * j] = from_f<T>(acc[i][j] / denom);
    } else {
      float* o = static_cast<float*>(out) + row * D;
#pragma unroll
      for (int j = 0; j < OJ; ++j) o[tx + 16 * j] = acc[i][j];
      if (tx == 0) {
        m_out[row] = m_i[i];
        l_out[row] = l_i[i];
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* m, float* l, int B, int Sq, int Sk, int hq, int hkv,
                   int q_off, int k_off, int causal, int normalize,
                   cudaStream_t stream) {
  static tdt::SmemCap cap;
  const size_t smem = sizeof(float) * smem_floats<D>();
  const cudaError_t err = tdt::ensure_smem(flash_fwd_kernel<T, D>, smem, cap);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, hq, B);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), out, m, l, Sq, Sk, hq, hkv, q_off, k_off,
      causal, normalize, (float)(1.0 / sqrt((double)D)));
  return cudaGetLastError();
}

}  // namespace

namespace {

// ---------------------------------------------------------------------------
// bf16 lane: wgmma + TMA (the mbarrier, TMA, descriptor and wgmma helpers
// are hopper.cuh's).
// ---------------------------------------------------------------------------

using namespace tdt::hopper;

constexpr int TQ = 128;      // query rows per block (two warpgroups of 64)
constexpr int TK = 128;      // keys per K/V tile
constexpr int HSTAGES = 2;    // K/V ring depth
constexpr int HTHREADS = 384; // consumer warpgroups 0, 1; producer 2
constexpr int HCONSUMER_WARPS = 8;
constexpr float LOG2E = 1.4426950408889634f;

// Dynamic shared memory of the bf16 lane: 1024 bytes to align the tiles to
// the 128-byte swizzle's 1024-byte period, Q and 2 x HSTAGES K/V tiles of
// 128 rows x D bf16, and the mbarriers. ops/flash_attention.py
// flash_launch_plan computes the same number and the entry checks it.
template <int D>
struct HopperSmem {
  static constexpr int TILE = TQ * D * 2;
  static constexpr int BARS = 128;
  static constexpr int BYTES = 1024 + (1 + 2 * HSTAGES) * TILE + BARS;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// wgmma m64nNk16, bf16 in, fp32 accumulate. SS (hopper.cuh): A (Q) and B
// (K) both K-major in shared memory, scale-d 0 on the first step. RS: A (P)
// from registers, B (V) MN-major in shared memory (imm-trans-b 1), scale-d 1.
__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64],
                                                  const uint32_t (&a)[4],
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


// q: (B, Sq, hq, D), k, v: (B, Sk, hkv, D) bf16, read through the tensor
// maps tq, tk, tv (4-D: d, head, row, batch; the K/V maps end at the key
// frontier kv_extent). out: (B, Sq, hq, D) bf16 when normalize, else fp32
// acc; m, l: (B, Sq, hq) fp32.
//
// Persistent: one block per SM walks work tiles (query tile, head, batch)
// in the order tile_of gives, so the next tile's Q and K/V loads run
// under this tile's last P.V and its output stores. Work tile w is head
// w % hq (the g heads of one KV head are neighbours, their K/V tiles meet
// in L2) of query tile row y = w / hq: longest causal rows first, every
// batch at each length.
template <int D>
__global__ void __launch_bounds__(HTHREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, void* __restrict__ out,
                float* __restrict__ m_out, float* __restrict__ l_out, int B,
                int Sq, int Sk, int hq, int hkv, int q_off, int k_off,
                int causal, int normalize, float scale, int kv_extent) {
  using Smem = HopperSmem<D>;
  constexpr int TILE = Smem::TILE;
  constexpr int HALF = TQ * 128;  // one 64-column box of a 128-row tile
  constexpr int KSTEPS = D / 16;  // QK^T depth steps
  constexpr int ON = D / 2;       // O accumulator floats per thread

  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK0 = base + TILE;
  const uint32_t sV0 = base + TILE * (1 + HSTAGES);
  // mbarriers: Q full and empty, then per stage K full, V full, K/V empty.
  const uint32_t bars = base + TILE * (1 + 2 * HSTAGES);
  const uint32_t q_full = bars;
  const uint32_t q_empty = bars + 8;
  const uint32_t full_k0 = bars + 16;
  const uint32_t full_v0 = full_k0 + 8 * HSTAGES;
  const uint32_t empty0 = full_v0 + 8 * HSTAGES;

  const int n_qt = (Sq + TQ - 1) / TQ;
  const int total = hq * n_qt * B;
  const int grid = gridDim.x;
  const int cta = blockIdx.x;
  // This block's r-th work tile, or -1: round r takes tiles [r G, r G + G)
  // forwards on even rounds and backwards on odd ones, which evens out the
  // blocks' sums of causal tile lengths.
  auto tile_of = [&](int r) {
    const int w = r * grid + ((r & 1) ? grid - 1 - cta : cta);
    return w < total ? w : -1;
  };
  // Key tiles a query tile needs: up to the frontier of its last real row.
  auto key_tiles = [&](int q0, int rows) {
    int nk = (Sk + TK - 1) / TK;
    if (causal) {
      const long long last = (long long)q_off + q0 + rows - 1 - k_off;
      nk = (last < 0 || kv_extent <= 0)
               ? 0
               : (int)min((long long)(kv_extent + TK - 1) / TK, last / TK + 1);
    }
    return nk;
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, HCONSUMER_WARPS);
    for (int s = 0; s < HSTAGES; ++s) {
      mbar_init(full_k0 + 8 * s, 1);
      mbar_init(full_v0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, HCONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Warp-uniform (a shuffle from lane 0), so the wgmma descriptors built
  // from it live in uniform registers.
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg == 2) {
    // Producer: one thread loads each tile's Q once the consumers are done
    // with the last one, and keeps the K/V ring full across tiles.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 256) {
      int it = 0, nq = 0;  // K/V tiles and Q tiles loaded so far
      for (int r = 0;; ++r) {
        const int w = tile_of(r);
        if (w < 0) break;
        const int h = w % hq, y = w / hq;
        const int q0 = (n_qt - 1 - y / B) * TQ, b = y % B;
        const int hk = h / (hq / hkv);
        const int nk = key_tiles(q0, min(TQ, Sq - q0));
        if (nk == 0) continue;
        if (nq > 0) mbar_wait(q_empty, (nq - 1) & 1);
        mbar_expect_tx(q_full, TILE);
        for (int c = 0; c < D / 64; ++c)
          tma_load(sQ + c * HALF, &tq, q_full, 64 * c, h, q0, b);
        ++nq;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % HSTAGES;
          const int round = it / HSTAGES;
          if (round > 0) mbar_wait(empty0 + 8 * s, (round - 1) & 1);
          const uint32_t sK = sK0 + s * TILE, sV = sV0 + s * TILE;
          mbar_expect_tx(full_k0 + 8 * s, TILE);
          for (int c = 0; c < D / 64; ++c)
            tma_load(sK + c * HALF, &tk, full_k0 + 8 * s, 64 * c, hk,
                     kt * TK, b);
          mbar_expect_tx(full_v0 + 8 * s, TILE);
          for (int c = 0; c < D / 64; ++c)
            tma_load(sV + c * HALF, &tv, full_v0 + 8 * s, 64 * c, hk,
                     kt * TK, b);
        }
      }
    }
  } else {
    // Consumer warpgroup wg: query rows 64 wg .. 64 wg + 63 of each tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int t = threadIdx.x & 127;
    const int warp = t >> 5;
    const int lane = t & 31;
    const int quad = lane & 3;
    // This thread's two rows of a tile (the accumulator fragment's r and
    // r + 8).
    const int r0 = 64 * wg + 16 * warp + (lane >> 2);
    const uint32_t aQ = sQ + wg * 64 * 128;
    auto release = [&](uint32_t empty) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty);
    };

    int it = 0, nq = 0;  // K/V tiles and Q tiles consumed so far
    for (int r = 0;; ++r) {
      const int w = tile_of(r);
      if (w < 0) break;
      const int h = w % hq, y = w / hq;
      const int q0 = (n_qt - 1 - y / B) * TQ, b = y % B;
      const int rows = min(TQ, Sq - q0);
      const int nk = key_tiles(q0, rows);
      const long long qpos0 = (long long)q_off + q0 + r0;
      const long long qpos1 = qpos0 + 8;
      // Tiles holding a key one of this warpgroup's rows sees; it only
      // hands the others back.
      const int wg_rows = min(64, rows - 64 * wg);
      int nk_wg = wg_rows > 0 ? nk : 0;
      if (causal && wg_rows > 0) {
        const long long last =
            (long long)q_off + q0 + 64 * wg + wg_rows - 1 - k_off;
        nk_wg = last < 0 ? 0 : (int)min((long long)nk, last / TK + 1);
      }

      float o[ON];
#pragma unroll
      for (int i = 0; i < ON; ++i) o[i] = 0.f;
      float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;  // l: this thread's share

      if (nk > 0) {
        mbar_wait(q_full, nq & 1);
        ++nq;
        if (nk_wg == 0) release(q_empty);
      }
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % HSTAGES;
        const uint32_t ph = (it / HSTAGES) & 1;
        const uint32_t sK = sK0 + s * TILE, sV = sV0 + s * TILE;
        mbar_wait(full_k0 + 8 * s, ph);
        if (kt < nk_wg) {
          // S = Q K^T, 64 rows x 128 keys, fp32.
          // The first wgmma overwrites sc (scale-d 0): no zeroing.
          float sc[64];
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < KSTEPS; ++kk) {
            const uint32_t off = (kk / 4) * HALF + (kk % 4) * 32;
            wgmma_ss_m64n128<0>(sc, sw128_desc(aQ + off, 16),
                             sw128_desc(sK + off, 16), kk > 0);
          }
          wg_commit();
          wg_wait0();
          fence_regs(sc);
          // Q is read for the last time: the next tile's may load.
          if (kt == nk_wg - 1) release(q_empty);

          // Scale after the dot; mask only a tile that crosses the
          // diagonal (for this warpgroup's first row) or the end of the
          // keys.
          const int k0 = kt * TK;
          const bool need_mask =
              k0 + TK > Sk ||
              (causal && (long long)k_off + k0 + TK - 1 >
                             (long long)q_off + q0 + 64 * wg);
          uint64_t ok = ~0ull;
          if (need_mask) {
            // Row r sees tile columns c <= lim_r: before Sk and, causal,
            // at or before its position.
            auto lim = [&](long long qp) {
              long long v = (long long)Sk - 1 - k0 - 2 * quad;
              if (causal) v = min(v, qp - k_off - k0 - 2 * quad);
              return (int)max(-1ll, min(v, (long long)TK));
            };
            const int lim0 = lim(qpos0), lim1 = lim(qpos1);
#pragma unroll
            for (int i = 0; i < 64; ++i) {
              if (8 * (i >> 2) + (i & 1) > ((i & 2) ? lim1 : lim0)) {
                sc[i] = NEG;
                ok &= ~(1ull << i);
              }
            }
          }
          float mx0 = NEG, mx1 = NEG;
#pragma unroll
          for (int i = 0; i < 64; ++i) {
            if (i & 2)
              mx1 = fmaxf(mx1, sc[i]);
            else
              mx0 = fmaxf(mx0, sc[i]);
          }
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
          // The max of the raw dot products, scaled after: a positive
          // factor keeps the max, and an all-masked row stays at -1e30.
          const float mn0 = fmaxf(m0, mx0 > NEG ? mx0 * scale : NEG);
          const float mn1 = fmaxf(m1, mx1 > NEG ? mx1 * scale : NEG);
          const float corr0 = ex2((m0 - mn0) * LOG2E);
          const float corr1 = ex2((m1 - mn1) * LOG2E);
          const float mb0 = mn0 * LOG2E, mb1 = mn1 * LOG2E;
          m0 = mn0;
          m1 = mn1;

          // p = exp(s scale - m) = 2^(s scale log2(e) - m log2(e)) in fp32
          // (l sums it), rounded to bf16 as the A fragment of P.V:
          // registers 8j .. 8j + 7 of S are keys 16j .. 16j + 15 of this
          // thread's two rows, the m64k16 A layout.
          const float sl = scale * LOG2E;
          uint32_t pa[32];
          float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
          for (int i = 0; i < 64; i += 2) {
            const float mb = (i & 2) ? mb1 : mb0;
            float p0 = ex2(fmaf(sc[i], sl, -mb));
            float p1 = ex2(fmaf(sc[i + 1], sl, -mb));
            p0 = (ok >> i) & 1 ? p0 : 0.f;
            p1 = (ok >> (i + 1)) & 1 ? p1 : 0.f;
            if (i & 2)
              rs1 += p0 + p1;
            else
              rs0 += p0 + p1;
            pa[i >> 1] = pack_bf16(p0, p1);
          }
          l0 = l0 * corr0 + rs0;
          l1 = l1 * corr1 + rs1;
#pragma unroll
          for (int i = 0; i < ON; ++i) o[i] *= (i & 2) ? corr1 : corr0;

          // O += P V: V's tile is (keys x d), read as the MN-major B
          // operand.
          mbar_wait(full_v0 + 8 * s, ph);
          fence_regs(o);
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < TK / 16; ++kk) {
            const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1],
                                   pa[4 * kk + 2], pa[4 * kk + 3]};
            const uint64_t bd = sw128_desc(sV + kk * 16 * 128, HALF);
            if constexpr (D == 128)
              wgmma_rs_m64n128(o, a, bd);
            else
              wgmma_rs_m64n64(o, a, bd);
          }
          wg_commit();
          wg_wait0();
          fence_regs(o);
        } else {
          // Every key of this tile lies after this warpgroup's rows: its
          // V must still land before the stage is handed back.
          mbar_wait(full_v0 + 8 * s, ph);
        }
        release(empty0 + 8 * s);
      }

      // The row sums: each of a quad's 4 lanes holds a quarter of the
      // keys.
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);

#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rr = r0 + 8 * half;
        if (q0 + rr >= Sq) continue;
        const size_t row = ((size_t)b * Sq + q0 + rr) * hq + h;
        const float lr = half ? l1 : l0;
        if (normalize) {
          const float inv = 1.f / fmaxf(lr, 1e-30f);
          __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(out) + row * D;
#pragma unroll
          for (int j = 0; j < D / 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j + 2 * quad) =
                __floats2bfloat162_rn(o[4 * j + 2 * half] * inv,
                                      o[4 * j + 2 * half + 1] * inv);
        } else {
          float* dst = static_cast<float*>(out) + row * D;
#pragma unroll
          for (int j = 0; j < D / 8; ++j)
            *reinterpret_cast<float2*>(dst + 8 * j + 2 * quad) =
                make_float2(o[4 * j + 2 * half], o[4 * j + 2 * half + 1]);
          if (quad == 0) {
            m_out[row] = half ? m1 : m0;
            l_out[row] = lr;
          }
        }
      }
    }
  }
}

// A 4-D map (d, head, row, batch) over a contiguous (batch, rows, heads, d)
// bf16 tensor whose row extent is `extent` of its `rows` rows; boxes of
// 64 d x 1 head x 128 rows x 1 batch, 128-byte swizzled, zeros past the
// extent.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int d, int heads,
                     int extent, int rows, int batch) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t elem = 2;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads,
                              (cuuint64_t)extent, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {d * elem, (cuuint64_t)heads * d * elem,
                                 (cuuint64_t)rows * heads * d * elem};
  const cuuint32_t box[4] = {64, 1, TQ, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* out, float* m, float* l, int B, int Sq, int Sk,
                         int hq, int hkv, int q_off, int k_off, int causal,
                         int normalize, int kv_extent, cudaStream_t stream) {
  static tdt::SmemCap cap;
  constexpr int smem = HopperSmem<D>::BYTES;
  // Work tiles (query tiles x heads x batch); the kernel indexes them in int.
  const long long tiles = (long long)hq * ((Sq + TQ - 1) / TQ) * B;
  if (tiles > 0x7fffffff) return cudaErrorInvalidConfiguration;
  CUtensorMap tq, tk, tv;
  // A tensor map cannot have a zero extent: a call whose frontier is <= 0
  // gets one row, and its blocks load nothing.
  const int ext = kv_extent < 1 ? 1 : kv_extent;
  cudaError_t err = make_map(&tq, q, D, hq, Sq, Sq, B);
  if (err == cudaSuccess) err = make_map(&tk, k, D, hkv, ext, Sk, B);
  if (err == cudaSuccess) err = make_map(&tv, v, D, hkv, ext, Sk, B);
  if (err != cudaSuccess) return err;
  err = tdt::ensure_smem(flash_fwd_wgmma<D>, smem, cap);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // One persistent block an SM, at most one a work tile.
  const dim3 grid((unsigned)(tiles < sms ? tiles : sms));
  flash_fwd_wgmma<D><<<grid, HTHREADS, smem, stream>>>(
      tq, tk, tv, out, m, l, B, Sq, Sk, hq, hkv, q_off, k_off, causal,
      normalize, (float)(1.0 / sqrt((double)D)), kv_extent);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (FMA lane), 1 = bfloat16 (wgmma + TMA lane).
// kv_extent: the key frontier (ops/flash_attention.py flash_launch_plan);
// smem_bytes: the lane's dynamic shared memory as the plan computed it, so
// a plan that disagrees with this build is refused. Returns a cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, float* m,
                                   float* l, int B, int Sq, int Sk, int hq,
                                   int hkv, int d, int q_off, int k_off,
                                   int causal, int normalize, int dtype,
                                   int kv_extent, int smem_bytes,
                                   void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || hkv < 1 || hq % hkv != 0 ||
      (!normalize && (m == nullptr || l == nullptr)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && (d == 64 || d == 128)) {
    const int want = d == 64 ? (int)sizeof(float) * smem_floats<64>()
                             : (int)sizeof(float) * smem_floats<128>();
    if (smem_bytes != want) return cudaErrorInvalidValue;
    return d == 64 ? launch<float, 64>(q, k, v, out, m, l, B, Sq, Sk, hq, hkv,
                                       q_off, k_off, causal, normalize, s)
                   : launch<float, 128>(q, k, v, out, m, l, B, Sq, Sk, hq,
                                        hkv, q_off, k_off, causal, normalize,
                                        s);
  }
  if (dtype == 1 && (d == 64 || d == 128)) {
    const int want = d == 64 ? HopperSmem<64>::BYTES : HopperSmem<128>::BYTES;
    if (smem_bytes != want) return cudaErrorInvalidValue;
    return d == 64
               ? launch_wgmma<64>(q, k, v, out, m, l, B, Sq, Sk, hq, hkv,
                                  q_off, k_off, causal, normalize, kv_extent,
                                  s)
               : launch_wgmma<128>(q, k, v, out, m, l, B, Sq, Sk, hq, hkv,
                                   q_off, k_off, causal, normalize, kv_extent,
                                   s);
  }
  return cudaErrorInvalidValue;
}
