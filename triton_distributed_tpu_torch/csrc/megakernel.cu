// The persistent megakernel for Hopper: ONE cooperative launch interprets a
// whole decode step's task queue.
//
// Replaces the JAX package's Pallas kernel
// triton_distributed_tpu/megakernel/kernel.py:39 (_mega_kernel), for the
// task types the Qwen3 decode programs emit. The paged serving program:
// RMS_NORM (6), ATTN_DECODE_PAGED (9), APPEND_KV (14), GEMM_MAT (19),
// NORM_ROPE_QKV (21), PREFETCH_MAT (23), and over e4m3 KV pools
// ATTN_DECODE_PAGED_F8 (24) and APPEND_KV_F8 (25) — each attention type
// with the speculative causal window fold (word 5) and each append type
// with its windowed form (word 4). The linear (batch-1) programs add
// ATTN_DECODE_GQA (11) and ATTN_DECODE (8) over a linear cache and, in the
// tile weight layout, GEMM_WIDE (12) / GEMM_WIDE_W8 (15: B tiles in the
// e4m3 weight workspace), NORM_ROPE (13), ADD_NORM (20) and the row-wise
// COPY, ADD, SILU_MUL, SCALE (0, 1, 2, 5). The Qwen3-MoE decode programs
// add MOE_TOPK (17) and MOE_FFN (18). A program compiled for a TP group
// adds the in-kernel AllReduce, ALLREDUCE (4) and ALLREDUCE_ROW (22): each
// rank runs its own launch of the same queue on its shard, and the ranks'
// launches run together (the grid's size); a task meets its peers through
// per-block flags over two parity slot sets, with no grid barrier or exit
// barrier of its own (see t_allreduce). PREFETCH
// (10) and PREFETCH_W8 (16) warm one weight tile (main workspace, or e4m3 weight workspace) into L2
// for the next GEMM_WIDE(_W8) with c0 == 1, which reads it as usual: the
// TPU's warm lands in a reserved VMEM slot that the strip fetch re-reads
// anyway (kernel.py:268-280), so here as there the warm changes no value.
// Any other type traps: a row must never silently do nothing
// (megakernel/kernel.py checks the program's types before launch and
// raises, so the trap marks a queue that bypassed that check).
//
// Profile stamp (kernel.py:1356 _stamp_profile): with a non-null `prof`
// (int32, num_exec x 128, filled with -1 by the host), block 0 writes row t
// = [t, queue row t's 10 words] when it begins task t — the dispatch
// record, no durations (the TPU kernel stamps none either). Only the PROF
// instantiations of the full bodies carry it (see mega_kernel).
//
// GEMM_WIDE's item loop is a separate function (__noinline__): it gets its
// own register allocation, so its pressure cannot spill the other handlers'
// loops, which compile inline as one body (see mega_kernel for the three
// instantiations: the linear programs' types live in the full ones, which
// run one block per SM, and the MoE types in the third alone).
//
// Design. A TPU grid step runs one task at a time, so the queue order keeps
// every dependency. Here every block walks the same queue; each task's work
// is cut into items (GEMM output column tiles x contraction chunks,
// attention (row, head) pairs, norm rows) that go round-robin to the blocks.
// A grid-wide barrier (cooperative_groups grid sync) separates a task from
// the tasks it depends on: the host marks those rows (sync_before, from the
// builder's hazard edges — the e4m3 pool tiles have their own hazard ids,
// so an append waits for the attention reads of its tile there too), so
// tasks with no hazard between them share one barrier interval. GEMM_MAT
// holds barriers inside: its contraction chunks write fp32 partial sums to
// a scratch buffer, a barrier, then the epilogue sums them in a fixed order
// (deterministic); epilogue 3's norm needs the whole stored row, so it runs
// after one more barrier.
//
// Rows. Every handler is row-independent. One-token decode carries a token
// in row 0 of each 128-row slot block; speculative decode carries the
// W = spec_k + 1 candidates in rows 0..W-1; a MoE or linear batch its B
// tokens in rows 0..B-1. The kernel computes rows [0, live_rows) of each
// block (1 <= live_rows <= TILE) and leaves the rest untouched. A
// row-blocked program (batch > TILE: one task row per 128-row block) takes
// ONE count for all its blocks, the largest (TILE): a block with fewer
// real rows computes its padding rows too, as run_queue_plain does.
// Registers and shared memory hold sums for ROW_GROUP = 4 rows: each GEMM
// and MOE_FFN item loops over groups of 4 live rows inside the item, so
// the item's weight chunk is fetched from HBM once and re-read by the next
// group from L1 or L2 (the blocks' chunks in flight stay far below L2's
// 50 MB). At live_rows <= 4 there is one group and every sum keeps its
// order. The attention fold scores the fresh window rows in shared memory
// (one thread per row), then takes the max and the sum in row order.
//
// Rounding follows the TPU kernel: fp32 compute from the stored workspace
// values, each task rounds only its stored outputs to the workspace type
// (bf16 or fp32); attention rounds its probabilities to the type V is read
// in before the PV product (the workspace type, or fp32 for widened e4m3
// pages) and sums the unrounded ones; epilogue 3 and the ATTN fold read the
// stored (rounded) values. e4m3 pool stores saturate to +-448; the F8
// attention fold reads the current tokens' k/v through the same saturating
// round trip, so it folds what the append stores.
//
// What bounds it: the step streams every weight (the matrix workspace wsm
// once per slot block; the weight tiles of GEMM_WIDE once) and the KV of
// each live sequence — byte-bound (0.5 to 4 flops per byte; e4m3 pages
// halve the KV bytes, e4m3 weight tiles halve the weight bytes of bf16).
// Weight loads are 16-byte vectors, 256 threads in flight per block; no
// wgmma or TMA yet, and no per-SM queues (both later work).
//
// GEMM_WIDE items. The TPU task stages the A row once and fetches B as
// strips of up to 16 column tiles (4 k-rows at a time with the d0 = 4
// super-strip flag): fetch shapes, not arithmetic. Here a task of `width`
// column tiles is cut into width x 4 items of 32 output columns; one block
// reduces the whole contraction for its 32 columns (threads split the
// rows, warp shuffles and one shared-memory pass sum them in a fixed
// order), so there is no partial-sum scratch and no barrier inside, and the
// strips of one projection group (q, k, v; gate, up) share one barrier
// interval: 128 to 768 items over the full body's one block per SM (132).
//
// MOE_TOPK (kernel.py:964 t_moe_topk) is one item: a warp per live row
// selects the row's top-k logits by iterative argmax (ties to the leftmost
// column) and stores the dense (E, B) weight tile. MOE_FFN (kernel.py:1004
// t_moe_ffn) is one grid step per layer on the TPU: one core streams every
// active expert's weights. Carried over as-is one block would stream them
// while the others wait, so here the task is cut across the grid: every
// block reads the weight tile and lists the active experts (a row that
// sums to zero is skipped before any of its weights is read), then gate/up
// items of (active expert, 32-column ffn strip) write act = silu(g) * u *
// w_tok, rounded to the workspace type, to the fp32 scratch; a grid
// barrier; then down items of 32 hidden columns each sum every active
// expert, in list order, into their columns and store once. Bound: bytes —
// the active experts' 3 x hidden x ffn weights, ~2 flops per weight byte
// in bf16 at batch 1.

#include <cooperative_groups.h>

#include "common.cuh"
#include "dist.cuh"
#include "push.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int TILE = 128;
constexpr int TILE_ELEMS = TILE * TILE;
constexpr int WORDS = 10;
constexpr int MAT_COLS = 1024;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_LIVE = TILE;   // live rows per block the kernel computes
constexpr int ROW_GROUP = 4;     // rows whose sums a GEMM item holds at once
constexpr int KLANES = 16;       // contraction lanes of a GEMM item

enum TaskType : int {
  COPY = 0,
  ADD = 1,
  SILU_MUL = 2,
  SCALE = 5,
  RMS_NORM = 6,
  ATTN_DECODE = 8,
  ATTN_DECODE_PAGED = 9,
  PREFETCH = 10,
  ATTN_DECODE_GQA = 11,
  GEMM_WIDE = 12,
  NORM_ROPE = 13,
  APPEND_KV = 14,
  GEMM_WIDE_W8 = 15,
  PREFETCH_W8 = 16,
  ALLREDUCE = 4,
  ALLREDUCE_ROW = 22,
  GEMM_MAT = 19,
  ADD_NORM = 20,
  NORM_ROPE_QKV = 21,
  MOE_TOPK = 17,
  MOE_FFN = 18,
  PREFETCH_MAT = 23,
  ATTN_DECODE_PAGED_F8 = 24,
  APPEND_KV_F8 = 25,
};

constexpr int QCHUNK = 64;       // queue rows per shared-memory fetch (full body)
constexpr int GW_COLS = 32;      // output columns of a GEMM_WIDE item
constexpr int GW_A_FLOATS = 8192;  // staged A values (all live rows)

// Shared memory, in floats: the largest handler footprint (GEMM_MAT phase
// A: KLANES x ROW_GROUP x TILE reduction slab + ROW_GROUP x 256 A chunk;
// GEMM_WIDE: the staged A chunk + WARPS x ROW_GROUP x GW_COLS sums).
constexpr int GEMM_MAT_FLOATS = KLANES * ROW_GROUP * TILE + ROW_GROUP * 256 + 64;
constexpr int GEMM_WIDE_FLOATS = GW_A_FLOATS + WARPS * ROW_GROUP * GW_COLS;
// MOE_FFN: the staged A chunk (as GEMM_WIDE), the per-warp sums of two
// products, the active-expert list and its ballot words.
constexpr int MOE_COLS = 32;     // output columns of a MOE_FFN item
constexpr int MOE_LIST_OFF = GW_A_FLOATS + WARPS * 2 * ROW_GROUP * MOE_COLS;
constexpr int MOE_FLOATS = MOE_LIST_OFF + TILE + TILE / 32;
constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int SMEM_FLOATS = cmax(GEMM_MAT_FLOATS, GEMM_WIDE_FLOATS);
constexpr int SMEM_MOE_FLOATS = cmax(SMEM_FLOATS, MOE_FLOATS);

struct Args {
  const int* queue;        // (rows, WORDS): tasks, then page-table data
  const int* sync_before;  // (num_exec,): 1 = grid barrier before the row
  const int* specs;        // (n_specs, 4): kt, ns, nt_out, epi per spec
  void* ws;                // (tiles, TILE, TILE) workspace, updated in place
  const void* wsm;         // (rows, MAT_COLS) matrix weight workspace
  const __nv_fp8_e4m3* ws8;  // (tiles, TILE, TILE) e4m3 weight tiles (or null)
  __nv_fp8_e4m3* wkv8;     // (tiles, TILE, TILE) e4m3 KV pools (or null)
  float* partial;          // GEMM_MAT partial sums / MOE_FFN act (fp32)
  int* prof;               // (num_exec, TILE) profile stamps (or null)
  int num_exec;
  int live_rows;
  int head_dim;
  // The AllReduce tasks' rank group (ar_on = 0: they do nothing): table =
  // every rank's AR slot buffer, two sets of (n, max_ar, TILE, TILE) of T
  // each; sig_table = their signal pads; epoch = the launch's first epoch;
  // ar_sys = the flags' scope (1: the system's, a peer on another card);
  // ar_stride = the flag words a (parity, source): the largest grid.
  tdt::dist::Group ar;
  int ar_on;
  int max_ar;
  int ar_sys;
  int ar_stride;
};

// -- loads: the workspace is written during the launch, so it is read
// through L2 (__ldcg); weights and the queue are read-only (__ldg).

__device__ __forceinline__ float ldw(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ldw(const __nv_bfloat16* p) {
  return __bfloat162float(__ldcg(p));
}

__device__ __forceinline__ void ldw4(const float* p, float v[4]) {
  const float4 a = __ldcg(reinterpret_cast<const float4*>(p));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void ldw4(const __nv_bfloat16* p, float v[4]) {
  const uint2 u = __ldcg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void ldw4(const __nv_fp8_e4m3* p, float v[4]) {
  const unsigned u = __ldcg(reinterpret_cast<const unsigned*>(p));
  const __nv_fp8_e4m3* e = reinterpret_cast<const __nv_fp8_e4m3*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = tdt::to_f(e[i]);
}

__device__ __forceinline__ void ldm8(const float* p, float v[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void ldm8(const __nv_bfloat16* p, float v[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

template <typename T>
__device__ __forceinline__ T* tile_at(T* ws, int tile, int row, int col) {
  return ws + (size_t)tile * TILE_ELEMS + row * TILE + col;
}

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return tdt::to_f(tdt::from_f<T>(x));
}

// A store into a KV pool of type P: the workspace type, or saturating e4m3.
template <typename P>
__device__ __forceinline__ P to_pool(float x) {
  return tdt::from_f<P>(x);
}
template <>
__device__ __forceinline__ __nv_fp8_e4m3 to_pool<__nv_fp8_e4m3>(float x) {
  return tdt::to_e4m3(x);
}

template <typename P>
__host__ __device__ constexpr bool is_e4m3() {
  return sizeof(P) == 1;
}

// The current tokens' k/v as the fold reads them: as stored in the
// workspace, or through the saturating e4m3 round trip over e4m3 pools.
template <typename P>
__device__ __forceinline__ float cur_kv(float x) {
  return is_e4m3<P>() ? tdt::to_f(tdt::to_e4m3(x)) : x;
}

__device__ __forceinline__ float inv_sqrt(float x) { return 1.0f / sqrtf(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum over the block, returned to every thread. `red` holds WARPS floats.
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.0f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) t += red[w];
  __syncthreads();
  return t;
}

// Items of one task go round-robin over the blocks, continuing from where
// the barrier interval's earlier tasks left off (`seg` items so far), so
// independent small tasks in one interval land on different blocks.
__device__ __forceinline__ int first_item(int seg) {
  const int g = gridDim.x;
  return ((int)blockIdx.x - seg % g + g) % g;
}

// -- RMS_NORM: out row <- a row * rsqrt(mean(a^2) + eps) * w, over k_tiles
// column tiles; one item per live row.
template <typename T>
__device__ void t_rms_norm(T* ws, const int* w, int& seg, int live,
                           float* smem) {
  const int out = w[1], a0 = w[2], b0 = w[3], cols = w[4] * TILE;
  const float eps = (float)w[7] * 1e-9f;
  for (int r = first_item(seg); r < live; r += gridDim.x) {
    float ss = 0.0f;
    for (int k = threadIdx.x; k < cols; k += THREADS) {
      const float x = ldw(tile_at(ws, a0 + k / TILE, r, k % TILE));
      ss += x * x;
    }
    const float scale = inv_sqrt(block_sum(ss, smem) / (float)cols + eps);
    for (int k = threadIdx.x; k < cols; k += THREADS) {
      const float x = ldw(tile_at(ws, a0 + k / TILE, r, k % TILE));
      const float g = ldw(tile_at(ws, b0 + k / TILE, r, k % TILE));
      *tile_at(ws, out + k / TILE, r, k % TILE) = tdt::from_f<T>(x * scale * g);
    }
  }
  seg += live;
}

// -- One head tile of qk-norm + rotate-half RoPE: row r of tile `in` ->
// row r of tile `out` (they may be the same tile), norm weight row from
// tile `wt`, over the head's hd columns (pad lanes pass through the norm's
// zero weight).
template <typename T>
__device__ void norm_rope_head(T* ws, int in, int out, int wt, int cos_t,
                               int sin_t, int r, int hd, float eps,
                               float* smem) {
  float* xs = smem;            // TILE normalised values
  float* red = smem + TILE;    // WARPS partial sums
  const int c = threadIdx.x;
  const float x = c < TILE ? ldw(tile_at(ws, in, r, c)) : 0.0f;
  const float scale = inv_sqrt(block_sum(x * x, red) / (float)hd + eps);
  float xn = 0.0f;
  if (c < TILE) {
    xn = x * scale * ldw(tile_at(ws, wt, r, c));
    xs[c] = xn;
  }
  __syncthreads();
  if (c < TILE) {
    const int half = hd / 2;
    const float rot = c < half ? -xs[c + half]
                      : c < hd ? xs[c - half] : xs[c];
    const float y = xn * ldw(tile_at(ws, cos_t, r, c))
                    + rot * ldw(tile_at(ws, sin_t, r, c));
    *tile_at(ws, out, r, c) = tdt::from_f<T>(y);
  }
  __syncthreads();
}

// -- NORM_ROPE_QKV: norm_rope_head over the hq q-head tiles and the hkv
// k-head tiles that follow them, in place; one item per (live row, head).
template <typename T>
__device__ void t_norm_rope_qkv(T* ws, const int* w, int& seg, int live,
                                int hd, float* smem) {
  const int a0 = w[2], qn = w[3], hq = w[4], kn = w[5], nh = hq + w[6];
  const float eps = (float)w[7] * 1e-9f;
  const int n = live * nh;
  for (int i = first_item(seg); i < n; i += gridDim.x) {
    const int r = i / nh, h = i % nh;
    norm_rope_head(ws, a0 + h, a0 + h, h < hq ? qn : kn, w[8], w[9], r, hd,
                   eps, smem);
  }
  seg += n;
}

// -- NORM_ROPE: one head tile a0 -> out (norm weight b0, cos c0, sin d0);
// one item per live row.
template <typename T>
__device__ void t_norm_rope(T* ws, const int* w, int& seg, int live, int hd,
                            float* smem) {
  const float eps = (float)w[7] * 1e-9f;
  for (int r = first_item(seg); r < live; r += gridDim.x)
    norm_rope_head(ws, w[2], w[1], w[3], w[8], w[9], r, hd, eps, smem);
  seg += live;
}

// -- COPY / ADD / SILU_MUL / SCALE over a row of k_tiles tiles: fp32
// inside, stored in the workspace type; one item per (live row, tile).
// SCALE's factor is word 7 in fixed point 1e-6.
template <typename T>
__device__ void t_ew(T* ws, const int* w, int& seg, int live) {
  const int type = w[0], out = w[1], a0 = w[2], b0 = w[3], kt = w[4];
  const float factor = (float)w[7] * 1e-6f;
  const int n = live * kt, c = threadIdx.x;
  for (int i = first_item(seg); i < n; i += gridDim.x) {
    const int r = i / kt, t = i % kt;
    if (c < TILE) {
      const float a = ldw(tile_at(ws, a0 + t, r, c));
      float y = a;
      if (type == ADD) {
        y = a + ldw(tile_at(ws, b0 + t, r, c));
      } else if (type == SILU_MUL) {
        y = a / (1.0f + expf(-a)) * ldw(tile_at(ws, b0 + t, r, c));
      } else if (type == SCALE) {
        y = a * factor;
      }
      *tile_at(ws, out + t, r, c) = tdt::from_f<T>(y);
    }
  }
  seg += n;
}

// -- ADD_NORM: x2 = a + b stored (tiles from `out`), then the RMSNorm of
// the STORED, rounded x2 times the weight row (tiles from word 6) into the
// tiles from d0 — bit-equal to the ADD + RMS_NORM pair. One item per live
// row; each thread re-reads only the x2 elements it stored itself.
template <typename T>
__device__ void t_add_norm(T* ws, const int* w, int& seg, int live,
                           float* smem) {
  const int out = w[1], a0 = w[2], b0 = w[3], cols = w[4] * TILE;
  const int nw = w[6], xn_out = w[9];
  const float eps = (float)w[7] * 1e-9f;
  for (int r = first_item(seg); r < live; r += gridDim.x) {
    float ss = 0.0f;
    for (int k = threadIdx.x; k < cols; k += THREADS) {
      const float v = round_to<T>(ldw(tile_at(ws, a0 + k / TILE, r, k % TILE))
                                  + ldw(tile_at(ws, b0 + k / TILE, r, k % TILE)));
      *tile_at(ws, out + k / TILE, r, k % TILE) = tdt::from_f<T>(v);
      ss += v * v;
    }
    const float scale = inv_sqrt(block_sum(ss, smem) / (float)cols + eps);
    for (int k = threadIdx.x; k < cols; k += THREADS) {
      const float v = ldw(tile_at(ws, out + k / TILE, r, k % TILE));
      const float g = ldw(tile_at(ws, nw + k / TILE, r, k % TILE));
      *tile_at(ws, xn_out + k / TILE, r, k % TILE) = tdt::from_f<T>(v * scale * g);
    }
  }
  seg += live;
}

// -- APPEND_KV / APPEND_KV_F8 into pool tiles of type P (the workspace, or
// the e4m3 kv8 workspace): k_new rows src..src+n-1 (a0) -> columns
// c0..c0+n-1 of the kT tile `out`, v_new rows (d0) -> rows c0.. of the V
// tile b0. Word 4 = n (0: the single-row form, row 0), word 7 = src, word
// 8 = c0 (< 0 skips the row: a parked spill). One item.
template <typename T, typename P>
__device__ void t_append_kv(const T* ws, P* pool, const int* w, int& seg) {
  const int out = w[1], a0 = w[2], b0 = w[3], col = w[8], d0 = w[9];
  const int src = w[4] == 0 ? 0 : w[7];
  const int n = min(w[4] == 0 ? 1 : w[4], TILE - col);
  if (col < 0) return;
  if (first_item(seg) == 0) {
    for (int i = threadIdx.x; i < n * TILE; i += THREADS) {
      const int j = i / TILE, d = i % TILE;
      *tile_at(pool, out, d, col + j) = to_pool<P>(ldw(tile_at(ws, a0, src + j, d)));
      *tile_at(pool, b0, col + j, d) = to_pool<P>(ldw(tile_at(ws, d0, src + j, d)));
    }
  }
  seg += 1;
}

// Where the j-th (kT, V) cache tile pair of an attention task lives: in a
// page table (queue data rows: entry pair j at flat offsets 2j, 2j+1), or
// at consecutive tiles of a linear cache (kT from kt0, V from vt0).
struct PagedTiles {
  const int* table;
  __device__ __forceinline__ int k(int j) const { return __ldg(table + 2 * j); }
  __device__ __forceinline__ int v(int j) const {
    return __ldg(table + 2 * j + 1);
  }
};
struct LinearTiles {
  int kt0, vt0;
  __device__ __forceinline__ int k(int j) const { return kt0 + j; }
  __device__ __forceinline__ int v(int j) const { return vt0 + j; }
};

// -- One attention row: online softmax of row r of q tile `qt` over the
// k_tiles cache tile pairs `kv` names (in pool type P: the workspace, or
// the e4m3 kv8 workspace), masked to `valid`, then the current tokens
// folded in, then / l, into row r of tile `out`. win = 0: the row's own
// k/v (c0/d0 row r); win > 0: the causal window — row r folds the block's
// fresh rows j <= r, j < win. The block's 8 warps split the tiles and
// merge at the end.
template <typename T, typename P, typename KV>
__device__ __forceinline__ void attn_row(T* ws, const P* pool, const KV kv, int qt,
                         int out, int k_tiles, int win, int valid, int c0,
                         int d0, float scale, int r, float* smem) {
  float* qs = smem;                           // TILE
  float* pw = qs + TILE;                      // WARPS x TILE probabilities
  float* accs = pw + WARPS * TILE;            // WARPS x TILE partial PV
  float* ms = accs + WARPS * TILE;            // WARPS running maxima
  float* ls = ms + WARPS;                     // WARPS running sums
  float* sws = ls + WARPS;                    // TILE fresh-row scores
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x < TILE) qs[threadIdx.x] = ldw(tile_at(ws, qt, r, threadIdx.x));
  __syncthreads();
  float m = tdt::NEG, l = 0.0f, acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float* pwarp = pw + warp * TILE;
  for (int j = warp; j < k_tiles; j += WARPS) {
    const P* kt = pool + (size_t)kv.k(j) * TILE_ELEMS;
    const P* vt = pool + (size_t)kv.v(j) * TILE_ELEMS;
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 8
    for (int d = 0; d < TILE; ++d) {   // kT tile: row d, columns = keys
      float kvv[4];
      ldw4(kt + d * TILE + lane * 4, kvv);
      const float qd = qs[d];
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i] += qd * kvv[i];
    }
    float mt = tdt::NEG;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[i] *= scale;
      if (j * TILE + lane * 4 + i >= valid) s[i] = tdt::NEG;
      mt = fmaxf(mt, s[i]);
    }
    const float m_new = fmaxf(m, warp_max(mt));
    float psum = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = expf(s[i] - m_new);
      psum += p;
      pwarp[lane * 4 + i] = is_e4m3<P>() ? p : round_to<T>(p);
    }
    const float corr = expf(m - m_new);
    l = l * corr + warp_sum(psum);
    m = m_new;
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] *= corr;
#pragma unroll 8
    for (int k = 0; k < TILE; ++k) {   // V tile: row = key, columns = d
      float vv[4];
      ldw4(vt + k * TILE + lane * 4, vv);
      const float p = pwarp[k];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] += p * vv[i];
    }
    __syncwarp();
  }
  if (lane == 0) {
    ms[warp] = m;
    ls[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) accs[warp * TILE + lane * 4 + i] = acc[i];
  // Fresh rows: row r itself (win == 0), or rows 0..min(r, win-1); thread
  // j scores fresh row j0 + j.
  const int j0 = win == 0 ? r : 0;
  const int j1 = win == 0 ? r : min(r, win - 1);
  if (c0 >= 0) {
    for (int j = threadIdx.x; j <= j1 - j0; j += THREADS) {
      float sj = 0.0f;
      for (int e = 0; e < TILE; ++e)
        sj += qs[e] * cur_kv<P>(ldw(tile_at(ws, c0, j0 + j, e)));
      sws[j] = sj * scale;
    }
  }
  __syncthreads();
  if (threadIdx.x < TILE) {
    const int d = threadIdx.x;
    float mx = tdt::NEG;
    for (int q = 0; q < WARPS; ++q) mx = fmaxf(mx, ms[q]);
    float lsum = 0.0f, a = 0.0f;
    for (int q = 0; q < WARPS; ++q) {
      const float f = expf(ms[q] - mx);
      lsum += ls[q] * f;
      a += accs[q * TILE + d] * f;
    }
    if (c0 >= 0) {
      float m_new = mx;
      for (int j = j0; j <= j1; ++j) m_new = fmaxf(m_new, sws[j - j0]);
      const float corr = expf(mx - m_new);
      float pv = 0.0f, psum = 0.0f;
      for (int j = j0; j <= j1; ++j) {
        const float pj = expf(sws[j - j0] - m_new);
        pv += pj * cur_kv<P>(ldw(tile_at(ws, d0, j, d)));
        psum += pj;
      }
      a = a * corr + pv;
      lsum = lsum * corr + psum;
    }
    *tile_at(ws, out, r, d) = tdt::from_f<T>(a / fmaxf(lsum, 1e-30f));
  }
  __syncthreads();
}

// -- ATTN_DECODE_PAGED / _F8: one q head over the page tiles named in the
// queue's data rows (from row b0); word 5 = the speculative window, word
// 6 = valid. One item per live row.
template <typename T, typename P>
__device__ void t_attn_paged(T* ws, const P* pool, const int* queue,
                             const int* w, int& seg, int live, float* smem) {
  const PagedTiles kv{queue + (size_t)w[3] * WORDS};
  const float scale = (float)w[7] * 1e-6f;
  for (int r = first_item(seg); r < live; r += gridDim.x)
    attn_row(ws, pool, kv, w[2], w[1], w[4], w[5], w[6], w[8], w[9], scale, r,
             smem);
  seg += live;
}

// -- ATTN_DECODE / ATTN_DECODE_GQA over a linear cache in the workspace: kT
// tiles from b0, V tiles from word 5, valid = word 6, each row folding its
// own current k/v (c0/d0). GQA: the g = arg >> 24 q heads at tiles a0..
// (outputs at out..) share the kv head, the scale is the low 24 bits of
// arg (fixed point 1e-6); ATTN_DECODE is its g = 1 case with the whole
// word as the scale. One item per (live row, q head): each block re-reads
// the head's cache, which the group's other blocks hold in L2.
template <typename T>
__device__ void t_attn_linear(T* ws, const int* w, int& seg, int live,
                              float* smem) {
  const bool gqa = w[0] == ATTN_DECODE_GQA;
  const int g = gqa ? w[7] >> 24 : 1;
  const float scale = (float)(gqa ? w[7] & 0xFFFFFF : w[7]) * 1e-6f;
  const LinearTiles kv{w[3], w[5]};
  const int n = live * g;
  for (int i = first_item(seg); i < n; i += gridDim.x) {
    const int r = i / g, h = i % g;
    attn_row(ws, static_cast<const T*>(ws), kv, w[2] + h, w[1] + h, w[4], 0,
             w[6], w[8], w[9], scale, r, smem);
  }
  seg += n;
}

// -- GEMM_WIDE / GEMM_WIDE_W8: `width` = word 7 output column tiles from
// `out` = A row (k_tiles tiles from a0) @ B, B tile (j, c) at b0 + j *
// b_stride + c in the workspace (B = T) or the e4m3 weight workspace,
// widened to fp32 (exact), fp32 sums, one rounding at the store. Item =
// (column tile, 32-column slice): the block's threads split each B tile's
// 128 rows (16-byte loads: 2, 4 or 8 threads per 32-column row slice), the
// A row is staged in shared memory in the workspace type (32 KiB: all of K
// for one bf16 row up to 16384 wide, else in chunks) and kept across the
// items and consecutive GEMM_WIDE tasks that read the same row (`staged`:
// q, k, v share one row, gate and up another), and the sums over the
// threads' rows go through warp shuffles, then over the 8 warps in index
// order. Word 9 (the TPU's super-strip fetch flag) is not arithmetic and
// is ignored.
template <typename B>
__device__ __forceinline__ uint4 ld_b16(const B* p) {
  return __ldcg(reinterpret_cast<const uint4*>(p));   // may be task-written
}
template <>
__device__ __forceinline__ uint4 ld_b16<__nv_fp8_e4m3>(const __nv_fp8_e4m3* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));    // weights: read-only
}

__device__ __forceinline__ void unpack16(const uint4& u, const float*, float v[4]) {
  v[0] = __uint_as_float(u.x); v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z); v[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack16(const uint4& u, const __nv_bfloat16*,
                                         float v[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack16(const uint4& u, const __nv_fp8_e4m3*,
                                         float v[16]) {
  const __nv_fp8x2_storage_t* e =
      reinterpret_cast<const __nv_fp8x2_storage_t*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) {      // two e4m3 values per conversion, exact
    const float2 f = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(e[i], __NV_E4M3)));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// ML: the live rows one pass holds sums for (1: one-token decode; 2
// otherwise, so rows 0-1 then rows 2-3 of each group of ROW_GROUP rows —
// the sums stay in registers). An item stages its group's A rows and
// streams its B slice once per group: the second group's reads hit L1/L2.
template <typename T, typename B, int ML>
__device__ __noinline__ void gemm_wide_items(T* ws, const B* bws, const int* w,
                                             int& seg, int live, float* smem,
                                             int& staged) {
  constexpr int EPL = 16 / (int)sizeof(B);      // elements per 16-byte load
  constexpr int TPR = GW_COLS / EPL;            // threads per row slice
  constexpr int RPP = THREADS / TPR;            // B rows per pass
  constexpr int PASSES = TILE / RPP;            // passes per B tile
  constexpr int UNROLL = ML == 1 ? 6 : 4;       // loads in flight per thread
  constexpr int A_ELEMS = GW_A_FLOATS * (int)sizeof(float) / (int)sizeof(T);
  if (ML == 1) live = 1;   // the caller's one-row form: the loops fold away
  const int out = w[1], a0 = w[2], b0 = w[3], kt = w[4], b_stride = w[6];
  const int width = w[7];
  T* as = reinterpret_cast<T*>(smem);           // group x (kc_tiles * TILE)
  float* red = smem + GW_A_FLOATS;              // WARPS x ML x GW_COLS
  const int kc_tiles = A_ELEMS / TILE / min(live, ROW_GROUP);  // A tiles per chunk
  const int kc = kc_tiles * TILE;
  // The row fits and one group holds every live row: keep it staged.
  const bool whole = kt <= kc_tiles && live <= ROW_GROUP;
  const int key = (a0 << 8) | kt;               // which row, how much of it
  const int cg = threadIdx.x % TPR, rl = threadIdx.x / TPR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = width * (TILE / GW_COLS);
  for (int it = first_item(seg); it < n; it += gridDim.x) {
    const int wc = it / (TILE / GW_COLS), cs = it % (TILE / GW_COLS);
    for (int g0 = 0; g0 < live; g0 += ROW_GROUP) {
    const int gl = min(ROW_GROUP, live - g0);
    for (int r0 = 0; r0 < gl; r0 += ML) {
      const int nr = min(ML, gl - r0);
      float acc[ML][EPL];
#pragma unroll
      for (int r = 0; r < ML; ++r)
#pragma unroll
        for (int i = 0; i < EPL; ++i) acc[r][i] = 0.0f;
      for (int j0 = 0; j0 < kt; j0 += kc_tiles) {
        const int nt = min(kc_tiles, kt - j0);
        if (!(whole && staged == key)) {
          __syncthreads();              // the last readers of `as` are done
          for (int i = threadIdx.x; i < gl * nt * TILE; i += THREADS) {
            const int r = i / (nt * TILE), k = i % (nt * TILE);
            as[r * kc + k] = __ldcg(static_cast<const T*>(
                tile_at(ws, a0 + j0 + k / TILE, g0 + r, k % TILE)));
          }
          __syncthreads();
          staged = whole ? key : -1;
        }
        // Steps of this chunk: (tile j, pass p) flattened; UNROLL loads
        // in flight per thread before their products.
        const int steps = nt * PASSES;
        for (int s0 = 0; s0 < steps; s0 += UNROLL) {
          uint4 raw[UNROLL];
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            const int s1 = s0 + u;
            if (s1 < steps) {
              const int j = s1 / PASSES, row = (s1 % PASSES) * RPP + rl;
              const B* bt = bws + ((size_t)b0 + (size_t)(j0 + j) * b_stride
                                   + wc) * TILE_ELEMS;
              raw[u] = ld_b16(bt + row * TILE + cs * GW_COLS + cg * EPL);
            }
          }
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            const int s1 = s0 + u;
            if (s1 < steps) {
              float bv[EPL];
              unpack16(raw[u], static_cast<const B*>(nullptr), bv);
              const int k = (s1 / PASSES) * TILE + (s1 % PASSES) * RPP + rl;
#pragma unroll
              for (int r = 0; r < ML; ++r) {
                if (r < nr) {
                  const float a = tdt::to_f(as[(r0 + r) * kc + k]);
#pragma unroll
                  for (int i = 0; i < EPL; ++i) acc[r][i] += a * bv[i];
                }
              }
            }
          }
        }
      }
      // Sum over the threads' rows: lanes of one warp that share a column
      // group differ in lane / TPR; then the 8 warps in index order.
#pragma unroll
      for (int r = 0; r < ML; ++r) {
        if (r < nr) {
#pragma unroll
          for (int i = 0; i < EPL; ++i) {
            float v = acc[r][i];
#pragma unroll
            for (int o = 16; o >= TPR; o >>= 1)
              v += __shfl_xor_sync(0xffffffffu, v, o);
            if (lane < TPR) red[(warp * ML + r) * GW_COLS + cg * EPL + i] = v;
          }
        }
      }
      __syncthreads();
      for (int i = threadIdx.x; i < nr * GW_COLS; i += THREADS) {
        const int r = i / GW_COLS, c = i % GW_COLS;
        float v = 0.0f;
#pragma unroll
        for (int q = 0; q < WARPS; ++q) v += red[(q * ML + r) * GW_COLS + c];
        *tile_at(ws, out + wc, g0 + r0 + r, cs * GW_COLS + c) = tdt::from_f<T>(v);
      }
      __syncthreads();
    }
    }
  }
  seg += n;
}

template <typename T, typename B>
__device__ void t_gemm_wide(T* ws, const B* bws, const int* w, int& seg,
                            int live, float* smem, int& staged) {
  if (live == 1)
    gemm_wide_items<T, B, 1>(ws, bws, w, seg, live, smem, staged);
  else
    gemm_wide_items<T, B, 2>(ws, bws, w, seg, live, smem, staged);
}

// -- GEMM_MAT: out (row) = A row @ W, W stored as 1024-column strips of the
// matrix workspace (strip s at wsm rows [b0 + s*K, b0 + (s+1)*K)).
// Epilogues: 0 store; 1 silu(gate half) * up half of each strip; 2 +=
// residual (tiles from c0); 3 as 2, then rms_norm(stored row) * w (tiles
// from b_stride) into the tiles from d0 (eps in arg >> 8).
__device__ __forceinline__ int gemm_kch(int K) { return K % 256 == 0 ? 256 : 128; }

// ML: the live rows the instantiation holds sums for (ROW_GROUP, or 1
// where the caller knows the step has one live row). Each phase-A item
// loops over groups of ROW_GROUP live rows: its weight chunk comes from HBM
// for the first group and from L1/L2 for the next.
template <typename T, int ML>
__device__ void t_gemm_mat(T* ws, const T* wsm, float* partial,
                           const int* specs, const int* w, int& seg, int live,
                           float* smem, cg::grid_group& grid) {
  if (ML == 1) live = 1;   // the caller's one-row form: the loops fold away
  const int out = w[1], a0 = w[2], b0 = w[3], kt = w[4], norm_w = w[6];
  const int arg = w[7], resid = w[8], xn_out = w[9];
  const int ns = specs[w[5] * 4 + 1], nt_out = specs[w[5] * 4 + 2];
  const int epi = arg & 0xff;
  const float eps = (float)(arg >> 8) * 1e-9f;
  const int K = kt * TILE, kch = gemm_kch(K), n_ks = K / kch;
  const size_t pstride = (size_t)ns * MAT_COLS;   // one (ks, row) slab

  // Phase A: item = (strip, 128-column tile, contraction chunk).
  float* red = smem;                              // KLANES x group x TILE
  float* as = smem + KLANES * ROW_GROUP * TILE;   // group x kch A values
  const int cgrp = threadIdx.x & 15, kl = threadIdx.x >> 4;
  const int n_a = ns * 8 * n_ks;
  for (int it = first_item(seg); it < n_a; it += gridDim.x) {
    const int s = it / (8 * n_ks), ct = (it / n_ks) % 8, ks = it % n_ks;
    const bool used = epi == 1 ? s * 4 + (ct & 3) < nt_out : s * 8 + ct < nt_out;
    if (!used) continue;       // pad columns of the last strip
    const T* wp = wsm + ((size_t)b0 + (size_t)s * K + (size_t)ks * kch) * MAT_COLS
                  + ct * TILE + cgrp * 8;
    for (int g0 = 0; g0 < live; g0 += ML) {
      const int gl = min(ML, live - g0);
      for (int i = threadIdx.x; i < gl * kch; i += THREADS) {
        const int r = i / kch, k = ks * kch + i % kch;
        as[i] = ldw(tile_at(ws, a0 + k / TILE, g0 + r, k % TILE));
      }
      __syncthreads();
      float acc[ML][8];
#pragma unroll
      for (int r = 0; r < ML; ++r)
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[r][i] = 0.0f;
#pragma unroll 4
      for (int k = kl; k < kch; k += KLANES) {
        float wv[8];
        ldm8(wp + (size_t)k * MAT_COLS, wv);
#pragma unroll
        for (int r = 0; r < ML; ++r) {
          if (r < gl) {
            const float a = as[r * kch + k];
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[r][i] += a * wv[i];
          }
        }
      }
#pragma unroll
      for (int r = 0; r < ML; ++r)
        if (r < gl)
#pragma unroll
          for (int i = 0; i < 8; ++i)
            red[(kl * gl + r) * TILE + cgrp * 8 + i] = acc[r][i];
      __syncthreads();
      for (int i = threadIdx.x; i < gl * TILE; i += THREADS) {
        const int r = i / TILE, c = i % TILE;
        float v = 0.0f;
        for (int q = 0; q < KLANES; ++q) v += red[(q * gl + r) * TILE + c];
        partial[((size_t)ks * live + g0 + r) * pstride + s * MAT_COLS + ct * TILE + c] = v;
      }
      __syncthreads();
    }
  }
  grid.sync();
  seg = 0;

  // Phase B: item = (live row, output tile): sum the chunks, epilogue.
  const int n_b = live * nt_out;
  for (int it = first_item(seg); it < n_b; it += gridDim.x) {
    const int r = it / nt_out, t = it % nt_out, c = threadIdx.x;
    if (c < TILE) {
      float v;
      if (epi == 1) {
        const int col = (t / 4) * MAT_COLS + (t % 4) * TILE + c;
        float g = 0.0f, u = 0.0f;
        for (int ks = 0; ks < n_ks; ++ks) {
          const float* p = partial + ((size_t)ks * live + r) * pstride + col;
          g += __ldcg(p);
          u += __ldcg(p + MAT_COLS / 2);
        }
        v = g / (1.0f + expf(-g)) * u;
      } else {
        const int col = (t / 8) * MAT_COLS + (t % 8) * TILE + c;
        v = 0.0f;
        for (int ks = 0; ks < n_ks; ++ks)
          v += __ldcg(partial + ((size_t)ks * live + r) * pstride + col);
        if (epi >= 2) v += ldw(tile_at(ws, resid + t, r, c));
      }
      *tile_at(ws, out + t, r, c) = tdt::from_f<T>(v);
    }
  }
  seg += n_b;
  if (epi != 3) return;
  grid.sync();
  seg = 0;

  // Phase C (epilogue 3): item = (live row, output tile): the norm of the
  // stored row, recomputed per item (a 4096-wide row read from L2).
  const int cols = nt_out * TILE;
  for (int it = first_item(seg); it < n_b; it += gridDim.x) {
    const int r = it / nt_out, t = it % nt_out, c = threadIdx.x;
    float ss = 0.0f;
    for (int k = threadIdx.x; k < cols; k += THREADS) {
      const float x = ldw(tile_at(ws, out + k / TILE, r, k % TILE));
      ss += x * x;
    }
    const float scale = inv_sqrt(block_sum(ss, smem) / (float)cols + eps);
    if (c < TILE) {
      const float x = ldw(tile_at(ws, out + t, r, c));
      const float g = ldw(tile_at(ws, norm_w + t, r, c));
      *tile_at(ws, xn_out + t, r, c) = tdt::from_f<T>(x * scale * g);
    }
  }
  seg += n_b;
}

// -- MOE_TOPK: the logits tile a0 masked to columns < E (word 6) and rows
// < batch (word 9); arg experts per row by iterative argmax, ties to the
// leftmost column; weights exp(l - row max) over the selected, / max(sum,
// 1e-30); stored TRANSPOSED (E, B) at `out`, zeros elsewhere. Item i =
// live rows [8i, 8i + 8): warp q computes row 8i + q (its lanes hold 4
// columns each); item 0 also zeroes the columns past the live rows (the
// host checks batch <= live).
template <typename T>
__device__ void t_moe_topk(T* ws, const int* w, int& seg, int live) {
  const int out = w[1], a0 = w[2], num_e = w[6], k = w[7], batch = w[9];
  const int n = (live + WARPS - 1) / WARPS;
  for (int it = first_item(seg); it < n; it += gridDim.x) {
    if (it == 0)
      for (int i = threadIdx.x; i < TILE_ELEMS; i += THREADS)
        if (i % TILE >= live) ws[(size_t)out * TILE_ELEMS + i] = tdt::from_f<T>(0.0f);
    const int r = it * WARPS + (threadIdx.x >> 5), lane = threadIdx.x & 31;
    if (r < live) {
      float lg[4], work[4];
      bool sel[4];
      float mx = tdt::NEG;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = lane * 4 + i;
        lg[i] = c < num_e && r < batch ? ldw(tile_at(ws, a0, r, c)) : tdt::NEG;
        work[i] = lg[i];
        sel[i] = false;
        mx = fmaxf(mx, lg[i]);
      }
      const float m0 = warp_max(mx);
      for (int t = 0; t < k; ++t) {
        const float m = warp_max(fmaxf(fmaxf(work[0], work[1]),
                                       fmaxf(work[2], work[3])));
        int idx = TILE;
#pragma unroll
        for (int i = 3; i >= 0; --i)
          if (work[i] == m && work[i] > tdt::NEG * 0.5f) idx = lane * 4 + i;
        idx = warp_min(idx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (lane * 4 + i == idx) {
            work[i] = tdt::NEG;
            sel[i] = true;
          }
        }
      }
      float wg[4], z = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wg[i] = sel[i] ? expf(lg[i] - m0) : 0.0f;
        z += wg[i];
      }
      z = fmaxf(warp_sum(z), 1e-30f);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *tile_at(ws, out, lane * 4 + i, r) = tdt::from_f<T>(wg[i] / z);
    }
  }
  seg += n;
}

// One MOE_FFN item's products: acc[b][r][i] += A[r][k] * B_b[k][col0 +
// cg * EPL + i] over the k rows of the staged A chunk (`as`: live rows of
// kc values in the workspace type, nt k-tiles), B_b's k-tile j the
// workspace tile tile(b, j). The threads split the k rows, TPR threads per
// 32-column row slice of 16-byte loads; UNROLL loads in flight per thread
// and product before the multiplies. Rows past the live ones multiply
// whatever `as` holds there (sized for ML rows) and are never stored.
template <typename T, int ML, int NB, typename TileOf>
__device__ __forceinline__ void moe_mac(const T* ws, const T* as, int kc,
                                        int nt, int col0, TileOf tile,
                                        float (&acc)[NB][ML][16 / sizeof(T)]) {
  constexpr int EPL = 16 / (int)sizeof(T);
  constexpr int TPR = MOE_COLS / EPL;
  constexpr int RPP = THREADS / TPR;
  constexpr int PASSES = TILE / RPP;
  constexpr int UNROLL = NB == 1 ? 8 : 4;
  const int cg = threadIdx.x % TPR, rl = threadIdx.x / TPR;
  const int steps = nt * PASSES;
  for (int s0 = 0; s0 < steps; s0 += UNROLL) {
    uint4 raw[NB][UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int s1 = s0 + u;
      if (s1 < steps) {
        const int j = s1 / PASSES, row = (s1 % PASSES) * RPP + rl;
#pragma unroll
        for (int b = 0; b < NB; ++b)
          raw[b][u] = __ldcg(reinterpret_cast<const uint4*>(
              ws + tile(b, j) * TILE_ELEMS + row * TILE + col0 + cg * EPL));
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int s1 = s0 + u;
      if (s1 < steps) {
        const int k = (s1 / PASSES) * TILE + (s1 % PASSES) * RPP + rl;
        float a[ML];
#pragma unroll
        for (int r = 0; r < ML; ++r) a[r] = tdt::to_f(as[r * kc + k]);
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          float bv[EPL];
          unpack16(raw[b][u], static_cast<const T*>(nullptr), bv);
#pragma unroll
          for (int r = 0; r < ML; ++r)
#pragma unroll
            for (int i = 0; i < EPL; ++i) acc[b][r][i] += a[r] * bv[i];
        }
      }
    }
  }
}

// The per-warp sums of an item's NB products (lanes sharing a column slice
// differ in lane / TPR) into red[((warp * NB + b) * ML + r) * MOE_COLS + c];
// the caller sums the 8 warps in index order after a __syncthreads.
template <typename T, int ML, int NB>
__device__ __forceinline__ void moe_warp_sums(
    const float (&acc)[NB][ML][16 / sizeof(T)], float* red) {
  constexpr int EPL = 16 / (int)sizeof(T);
  constexpr int TPR = MOE_COLS / EPL;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cg = threadIdx.x % TPR;
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int r = 0; r < ML; ++r)
#pragma unroll
      for (int i = 0; i < EPL; ++i) {
        float v = acc[b][r][i];
#pragma unroll
        for (int o = 16; o >= TPR; o >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lane < TPR) red[((warp * NB + b) * ML + r) * MOE_COLS + cg * EPL + i] = v;
      }
}

// Stage `rows` rows x (nt * TILE) values into `as` (row stride kc): from
// the workspace row tiles a0.., rows row0.. (src == nullptr) or from fp32
// scratch rows of `stride` values (already rounded to the workspace type:
// exact).
template <typename T>
__device__ __forceinline__ void moe_stage(T* as, int kc, int nt, int rows,
                                          const T* ws, int a0, int row0,
                                          const float* src, size_t stride) {
  __syncthreads();                 // the last readers of `as` are done
  for (int i = threadIdx.x; i < rows * nt * TILE; i += THREADS) {
    const int r = i / (nt * TILE), k = i % (nt * TILE);
    as[r * kc + k] = src ? tdt::from_f<T>(__ldcg(src + r * stride + k))
                         : __ldcg(tile_at(ws, a0 + k / TILE, row0 + r, k % TILE));
  }
  __syncthreads();
}

// MOE_FFN phase 1: item = (active expert a, 32-column strip of the ffn),
// over groups of ML live rows (the group's xn rows staged, the item's
// weights streamed once per group: from HBM for the first, L1/L2 after).
// The xn row (ht tiles from a0) is staged once per block when it fits and
// one group holds every live row.
// act[(a * live + r) * F + col] = round(silu(g) * u * w_tok[r]).
template <typename T, int ML>
__device__ __noinline__ void moe_gate_up_items(const T* ws, const int* w,
                                               int& seg, int live,
                                               float* smem, const int* list,
                                               int n_act, float* act) {
  constexpr int EPL = 16 / (int)sizeof(T);
  constexpr int SPT = TILE / MOE_COLS;          // item strips per tile
  constexpr int A_ELEMS = GW_A_FLOATS * (int)sizeof(float) / (int)sizeof(T);
  if (ML == 1) live = 1;   // the caller's one-row form: the loops fold away
  const int a0 = w[2], wt = w[3], ht = w[4], wg = w[5], wu = w[6];
  const int ft = w[7] >> 16, F = ft * TILE;
  T* as = reinterpret_cast<T*>(smem);
  float* red = smem + GW_A_FLOATS;
  const int kc_tiles = min(ht, A_ELEMS / TILE / ML);
  const int kc = kc_tiles * TILE;
  const int n = n_act * ft * SPT;
  const bool keep = kc_tiles == ht && live <= ML;
  bool staged = false;
  for (int it = first_item(seg); it < n; it += gridDim.x) {
    const int a = it / (ft * SPT), f = (it / SPT) % ft;
    const int col0 = (it % SPT) * MOE_COLS;
    const size_t e = list[a];
    for (int g0 = 0; g0 < live; g0 += ML) {
      const int gl = min(ML, live - g0);
      float acc[2][ML][EPL] = {};
      for (int j0 = 0; j0 < ht; j0 += kc_tiles) {
        const int nt = min(kc_tiles, ht - j0);
        if (!(staged && keep)) {
          moe_stage(as, kc, nt, gl, ws, a0 + j0, g0, nullptr, 0);
          staged = true;
        }
        moe_mac<T, ML, 2>(ws, as, kc, nt, col0,
                          [&](int b, int j) {
                            return (size_t)(b ? wu : wg) + (e * ht + j0 + j) * ft + f;
                          },
                          acc);
      }
      moe_warp_sums<T, ML, 2>(acc, red);
      __syncthreads();
      for (int i = threadIdx.x; i < gl * MOE_COLS; i += THREADS) {
        const int r = i / MOE_COLS, c = i % MOE_COLS;
        float g = 0.0f, u = 0.0f;
#pragma unroll
        for (int q = 0; q < WARPS; ++q) {
          g += red[((q * 2) * ML + r) * MOE_COLS + c];
          u += red[((q * 2 + 1) * ML + r) * MOE_COLS + c];
        }
        const float wtok = ldw(tile_at(ws, wt, (int)e, g0 + r));
        act[((size_t)a * live + g0 + r) * F + f * TILE + col0 + c] =
            round_to<T>(g / (1.0f + expf(-g)) * u * wtok);
      }
      __syncthreads();
    }
  }
  seg += n;
}

// MOE_FFN phase 2: item = 32 hidden columns of the output row, per group of
// ML live rows: the active experts' act rows (staged per expert) @ their
// down weights, summed in list order, stored once in the workspace type.
template <typename T, int ML>
__device__ __noinline__ void moe_down_items(T* ws, const int* w, int& seg,
                                            int live, float* smem,
                                            const int* list, int n_act,
                                            const float* act) {
  constexpr int EPL = 16 / (int)sizeof(T);
  constexpr int SPT = TILE / MOE_COLS;
  constexpr int A_ELEMS = GW_A_FLOATS * (int)sizeof(float) / (int)sizeof(T);
  if (ML == 1) live = 1;   // the caller's one-row form: the loops fold away
  const int out = w[1], ht = w[4], wd = w[8];
  const int ft = w[7] >> 16, F = ft * TILE;
  T* as = reinterpret_cast<T*>(smem);
  float* red = smem + GW_A_FLOATS;
  const int kc_tiles = min(ft, A_ELEMS / TILE / ML);
  const int kc = kc_tiles * TILE;
  const int n = ht * SPT;
  for (int it = first_item(seg); it < n; it += gridDim.x) {
    const int j = it / SPT, col0 = (it % SPT) * MOE_COLS;
    for (int g0 = 0; g0 < live; g0 += ML) {
      const int gl = min(ML, live - g0);
      float acc[1][ML][EPL] = {};
      for (int a = 0; a < n_act; ++a) {
        const size_t e = list[a];
        for (int f0 = 0; f0 < ft; f0 += kc_tiles) {
          const int nt = min(kc_tiles, ft - f0);
          moe_stage(as, kc, nt, gl, ws, 0, 0,
                    act + ((size_t)a * live + g0) * F + f0 * TILE, (size_t)F);
          moe_mac<T, ML, 1>(ws, as, kc, nt, col0,
                            [&](int, int f) {
                              return (size_t)wd + (e * ft + f0 + f) * ht + j;
                            },
                            acc);
        }
      }
      moe_warp_sums<T, ML, 1>(acc, red);
      __syncthreads();
      for (int i = threadIdx.x; i < gl * MOE_COLS; i += THREADS) {
        const int r = i / MOE_COLS, c = i % MOE_COLS;
        float v = 0.0f;
#pragma unroll
        for (int q = 0; q < WARPS; ++q) v += red[(q * ML + r) * MOE_COLS + c];
        *tile_at(ws, out + j, g0 + r, col0 + c) = tdt::from_f<T>(v);
      }
      __syncthreads();
    }
  }
  seg += n;
}

// -- MOE_FFN (word layout: tasks.py MOE_FFN): every block lists the active
// experts — those whose row of the (E, B) weight tile b0 sums above zero
// over the live columns — in expert order; phase 1, a grid barrier, phase
// 2. The activations go through `act` (the launch's fp32 scratch).
template <typename T, int ML>
__device__ void t_moe_ffn(T* ws, float* act, const int* w, int& seg,
                          int live, float* smem, cg::grid_group& grid) {
  int* list = reinterpret_cast<int*>(smem + MOE_LIST_OFF);
  unsigned* masks = reinterpret_cast<unsigned*>(smem + MOE_LIST_OFF + TILE);
  const int e = threadIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float sum = 0.0f;
  if (e < (w[7] & 0xFFFF))
    for (int r = 0; r < live; ++r) sum += ldw(tile_at(ws, w[3], e, r));
  const bool on = sum > 0.0f;
  const unsigned bal = __ballot_sync(0xffffffffu, on);
  __syncthreads();                 // earlier readers of the list are done
  if (lane == 0 && warp < TILE / 32) masks[warp] = bal;
  __syncthreads();
  int before = 0, n_act = 0;
  for (int q = 0; q < TILE / 32; ++q) {
    const int c = __popc(masks[q]);
    before += q < warp ? c : 0;
    n_act += c;
  }
  if (on) list[before + __popc(bal & ((1u << lane) - 1u))] = e;
  __syncthreads();
  moe_gate_up_items<T, ML>(ws, w, seg, live, smem, list, n_act, act);
  grid.sync();
  seg = 0;
  moe_down_items<T, ML>(ws, w, seg, live, smem, list, n_act, act);
}

// -- PREFETCH / PREFETCH_W8: warm tile a0 of the main workspace or of the
// e4m3 weight workspace into L2 (one bulk prefetch, fire and forget; no
// completion to wait for). The consuming GEMM_WIDE(_W8) with c0 == 1 reads
// the tile as usual. One item.
template <typename E>
__device__ void t_prefetch(const E* base, int tile, int& seg) {
  if (first_item(seg) == 0 && threadIdx.x == 0) {
    const E* p = base + (size_t)tile * TILE_ELEMS;
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;"
                 :: "l"(p), "r"((unsigned)(TILE_ELEMS * sizeof(E)))
                 : "memory");
  }
  seg += 1;
}

// -- ALLREDUCE (4) / ALLREDUCE_ROW (22): the TP reductions inside the step
// (kernel.py:569 t_allreduce, :601 t_allreduce_row). AllReduce row k of a
// launch has the epoch e = ar.epoch + k (epochs run on across launches,
// kernel.py ArGroup.next_epochs) and uses slot set p = e & 1 of the AR slot
// buffers ((2, n, max_ar, TILE, TILE) of T a rank). Block b pushes its
// grid-strided vectors of the slab (word 4 tiles from `out`, or one tile;
// the live rows only) into slot `me` of set p of every rank, its own
// included; fences; releases word (p, me, b) at every peer (at n = 1, with
// force_ar, at itself); waits for the words (p, j, b) of the n - 1 peers;
// then sums exactly the vectors it pushed over slots 0..n-1 of its own set
// p in rank order, in fp32 from zero, rounds once and stores them at `out`.
// The grid is the same on every rank of a launch (one queue, one body, one
// card's share), so block b of every rank moves the same vectors, and every
// rank's row is bit-identical. Blocks with no vectors skip both sides (at 1
// row x 32 tiles bf16, all but 2). No grid barrier and no exit barrier: the
// first task held two grid barriers and two flag round trips (the delivery
// flag from block 0 after a grid barrier, and at n > 1 an exit barrier after
// another), the reference's barrier_all.
//
// Why the slots and flags are safe without them. Two AllReduce rows of a
// launch always have a grid barrier between them (sync_before: builder.py
// barrier_rows puts one before every AllReduce row that follows another in
// its interval, and kernel.py refuses a queue without it), and a rank's
// launch ends before its next one starts (stream order). So no block of
// rank r pushes epoch e + 2 (set p again) before every block of r finished
// row e + 1, block 0 included — it always has vectors, and it waited there
// for every peer j's block 0 delivery of e + 1; and j's block 0 pushed e + 1
// only after j's own barrier (or launch boundary) behind row e, i.e. after
// every block of j summed its set p of epoch e. The argument is about whole
// grids, so a grid that differs between launches (grid_blocks per body)
// breaks nothing. Word (p, j, b) sits at (p * n + j) * ar_stride + b, the
// stride the largest grid any body takes on this card (the host's, checked
// against the pad: 2 * n * ar_stride words), so a word means the same in
// every launch. It holds the last epoch of parity p that j's block b
// delivered; a wait for e sees e itself: earlier launches wrote smaller
// epochs, and j delivers e + 2 only after r passed row e + 1, i.e. after
// r's wait for e. One word a parity, so a fast peer's e + 1 never counts
// toward e; flags only grow. The flags' scope is a runtime field (ar_sys:
// the GPU's when every rank of the group is on this card, the system's
// otherwise), not a template argument, which would double mega_kernel's
// instantiations.
//
// Bound: bytes — each rank pushes its live rows to n slots and reads n
// slots back; one flag round trip per task and block.
//
// A wait that passes the deadline writes the rank's error word and
// returns; every later wait of the launch sees the word and returns at
// once, so the whole grid runs the rest of its queue without waiting,
// reaches every grid barrier and ends. The host raises CommTimeoutError
// where it synchronises (DistContext.raise_on_comm_error).
__device__ __forceinline__ unsigned long long ar_load(const Args& a,
                                                      const unsigned long long* f) {
  return a.ar_sys ? tdt::push::ld_acquire<true>(f)
                  : tdt::push::ld_acquire<false>(f);
}

__device__ __forceinline__ void ar_spin(const Args& a, int idx,
                                        unsigned long long want) {
  namespace d = tdt::dist;
  const d::Group& g = a.ar;
  const unsigned long long* f = d::flags(g, g.rank) + idx;
  const volatile long long* err = g.err + 3;
  unsigned long long seen = ar_load(a, f);
  const unsigned long long t0 = d::globaltimer();
  while (seen < want) {
    if (*err != 0) return;
    if ((long long)(d::globaltimer() - t0) > g.timeout_ns) {
      d::record_timeout(g, idx, want, seen);
      return;
    }
    __nanosleep(100);
    seen = ar_load(a, f);
  }
}

// Thread j < n releases word `idx` of rank j's pad (j != rank, or j = rank
// alone at n = 1), after the block's stores: the block met first.
__device__ __forceinline__ void ar_signal(const Args& a, int idx,
                                          unsigned long long val) {
  const tdt::dist::Group& g = a.ar;
  const int j = threadIdx.x;
  if (j < g.n && (j != g.rank || g.n == 1)) {
    unsigned long long* f = tdt::dist::flags(g, j) + idx;
    if (a.ar_sys) {
      tdt::push::fence_to<true>();
      tdt::push::st_release<true>(f, val);
    } else {
      tdt::push::fence_to<false>();
      tdt::push::st_release<false>(f, val);
    }
  }
}

template <typename T>
__device__ __noinline__ void t_allreduce(T* ws, const Args& a, const int* w,
                                         int site, int live) {
  const tdt::dist::Group& g = a.ar;
  constexpr int VR = TILE * sizeof(T) / 16;   // 16-byte vectors a row
  constexpr int E = 16 / sizeof(T);
  const int nt = w[0] == ALLREDUCE_ROW ? w[4] : 1;
  T* slab = ws + (size_t)w[1] * TILE_ELEMS;
  const size_t slot = (size_t)a.max_ar * TILE_ELEMS;   // one rank's slot
  const unsigned long long epoch = g.epoch + site;
  const int p = (int)(epoch & 1);
  const size_t set = (size_t)p * g.n * slot;           // set p's offset
  const long long nvec = (long long)nt * live * VR;
  const long long step = (long long)gridDim.x * THREADS;
  const long long first = (long long)blockIdx.x * THREADS + threadIdx.x;
  if ((long long)blockIdx.x * THREADS >= nvec) return;   // no vectors
  for (long long v = first; v < nvec; v += step) {
    const size_t off = (size_t)(v / (live * VR)) * TILE_ELEMS +
                       (size_t)((v / VR) % live) * TILE;
    const int c = (int)(v % VR);
    const uint4 x = __ldcg(reinterpret_cast<const uint4*>(slab + off) + c);
    for (int j = 0; j < g.n; ++j) {
      T* dst = reinterpret_cast<T*>(g.table[j]) + set + g.rank * slot + off;
      reinterpret_cast<uint4*>(dst)[c] = x;
    }
  }
  __syncthreads();
  const int words = a.ar_stride;
  ar_signal(a, (p * g.n + g.rank) * words + blockIdx.x, epoch);
  const int j = threadIdx.x;
  if (j < g.n && (j != g.rank || g.n == 1))
    ar_spin(a, (p * g.n + j) * words + blockIdx.x, epoch);
  __syncthreads();
  const T* mine = reinterpret_cast<const T*>(g.table[g.rank]) + set;
  for (long long v = first; v < nvec; v += step) {
    const size_t off = (size_t)(v / (live * VR)) * TILE_ELEMS +
                       (size_t)((v / VR) % live) * TILE;
    const int c = (int)(v % VR);
    float acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.0f;
    for (int r = 0; r < g.n; ++r) {
      const uint4 s =
          __ldcg(reinterpret_cast<const uint4*>(mine + r * slot + off) + c);
      const T* se = reinterpret_cast<const T*>(&s);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = acc[e] + tdt::to_f(se[e]);
    }
    uint4 o;
    T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
    for (int e = 0; e < E; ++e) oe[e] = tdt::from_f<T>(acc[e]);
    reinterpret_cast<uint4*>(slab + off)[c] = o;
  }
}

// The task types beyond the paged serving program's (with MOE, the MoE
// types too): false where `type` is none of them. Only the full kernels
// instantiate this.
template <typename T, bool MOE>
__device__ __forceinline__ bool run_linear_task(const Args& args, T* ws,
                                                const int* w, int& seg,
                                                int live, float* smem,
                                                int& staged,
                                                cg::grid_group& grid) {
  if constexpr (MOE) {
    if (w[0] == MOE_TOPK) {
      t_moe_topk(ws, w, seg, live);
      return true;
    }
    if (w[0] == MOE_FFN) {
      if (live == 1)
        t_moe_ffn<T, 1>(ws, args.partial, w, seg, live, smem, grid);
      else
        t_moe_ffn<T, ROW_GROUP>(ws, args.partial, w, seg, live, smem, grid);
      return true;
    }
  }
  switch (w[0]) {
    case COPY:
    case ADD:
    case SILU_MUL:
    case SCALE:
      t_ew(ws, w, seg, live);
      return true;
    case ATTN_DECODE:
    case ATTN_DECODE_GQA:
      t_attn_linear(ws, w, seg, live, smem);
      return true;
    case GEMM_WIDE:
      t_gemm_wide(ws, static_cast<const T*>(ws), w, seg, live, smem, staged);
      return true;
    case GEMM_WIDE_W8:
      t_gemm_wide(ws, args.ws8, w, seg, live, smem, staged);
      return true;
    case NORM_ROPE:
      t_norm_rope(ws, w, seg, live, args.head_dim, smem);
      return true;
    case ADD_NORM:
      t_add_norm(ws, w, seg, live, smem);
      return true;
    case PREFETCH:
      t_prefetch(static_cast<const T*>(ws), w[2], seg);
      return true;
    case PREFETCH_W8:
      t_prefetch(args.ws8, w[2], seg);
      return true;
    default:
      return false;
  }
}

// Three instantiations per workspace type, as the TPU kernel compiles only
// the switch branches a program uses: BODY_LEAN interprets the paged
// serving program's types and nothing else (128 registers, two blocks per
// SM: more inlined handlers would share its register allocation and spill
// its GEMM loop); BODY_LINEAR every ported type but the MoE ones, with one
// block per SM and no register cap, GEMM_MAT specialised for one live row;
// BODY_MOE adds MOE_TOPK and MOE_FFN (whose 4-row loops took the register
// file to its cap and spilled the linear programs' GEMMs when they shared
// BODY_LINEAR: the bf16 linear step ran 1.9x slower). The host picks by
// the queue's types. PROF: the full bodies again with the profile stamp
// in the queue loop, for profiled launches only (the host runs a profiled
// paged program on BODY_LINEAR, which interprets every non-MoE type): the
// stamp's branch and pointer in the loop of every launch took the one-row
// MoE step 5-6% slower.
enum Body : int { BODY_LEAN = 0, BODY_LINEAR = 1, BODY_MOE = 2 };

template <typename T, int BODY, bool PROF>
__global__ void __launch_bounds__(THREADS, BODY == BODY_LEAN ? 2 : 1)
    mega_kernel(Args args) {
  constexpr bool FULL = BODY != BODY_LEAN;
  cg::grid_group grid = cg::this_grid();
  __shared__ float smem[BODY == BODY_MOE ? SMEM_MOE_FLOATS : SMEM_FLOATS];
  T* ws = static_cast<T*>(args.ws);
  const T* wsm = static_cast<const T*>(args.wsm);
  const int live = args.live_rows;
  int seg = 0;
  int ar_site = 0;   // AllReduce rows so far (their epochs' offsets)
  // The A row (tile and width) GEMM_WIDE holds staged in shared memory (-1:
  // none); any other task may use the shared memory or rewrite the row.
  int staged = -1;
  // Queue rows reach the handlers from registers (lean body: the next
  // row's words load while the current task runs) or from shared memory
  // (full body: QCHUNK rows per fetch — the tile-layout program has many
  // one-item tasks, and a per-row fetch would put an L2 round trip on
  // every one of them for every block).
  __shared__ int qrows[FULL ? QCHUNK : 1][WORDS + 1];
  int nxt[WORDS + 1];
  if (!FULL) {
#pragma unroll
    for (int i = 0; i < WORDS; ++i) nxt[i] = __ldg(args.queue + i);
    nxt[WORDS] = 0;
  }
  for (int p = 0; p < args.num_exec; ++p) {
    int wreg[WORDS + 1];
    const int* w = wreg;
    if (FULL) {
      if (p % QCHUNK == 0) {
        __syncthreads();
        const int rows = min(QCHUNK, args.num_exec - p);
        for (int i = threadIdx.x; i < rows * (WORDS + 1); i += THREADS) {
          const int r = i / (WORDS + 1), c = i % (WORDS + 1);
          qrows[r][c] = c < WORDS
                            ? __ldg(args.queue + (size_t)(p + r) * WORDS + c)
                            : (p + r ? __ldg(args.sync_before + p + r) : 0);
        }
        __syncthreads();
      }
      w = qrows[p % QCHUNK];
    } else {
#pragma unroll
      for (int i = 0; i <= WORDS; ++i) wreg[i] = nxt[i];
      if (p + 1 < args.num_exec) {
#pragma unroll
        for (int i = 0; i < WORDS; ++i)
          nxt[i] = __ldg(args.queue + (size_t)(p + 1) * WORDS + i);
        nxt[WORDS] = __ldg(args.sync_before + p + 1);
      }
    }
    if (w[WORDS]) {
      grid.sync();
      seg = 0;
    }
    if constexpr (PROF) {
      if (blockIdx.x == 0 && threadIdx.x == 0) {
        int* row = args.prof + (size_t)p * TILE;
        row[0] = p;
#pragma unroll
        for (int i = 0; i < WORDS; ++i) row[1 + i] = w[i];
      }
    }
    // A warm neither writes the workspace nor touches shared memory.
    if (FULL && w[0] != GEMM_WIDE && w[0] != GEMM_WIDE_W8 && w[0] != PREFETCH
        && w[0] != PREFETCH_W8)
      staged = -1;
    switch (w[0]) {
      case RMS_NORM:
        t_rms_norm(ws, w, seg, live, smem);
        break;
      case ATTN_DECODE_PAGED:
        t_attn_paged(ws, static_cast<const T*>(ws), args.queue, w, seg, live,
                     smem);
        break;
      case ATTN_DECODE_PAGED_F8:
        t_attn_paged(ws, static_cast<const __nv_fp8_e4m3*>(args.wkv8),
                     args.queue, w, seg, live, smem);
        break;
      case APPEND_KV:
        t_append_kv(ws, ws, w, seg);
        break;
      case APPEND_KV_F8:
        t_append_kv(ws, args.wkv8, w, seg);
        break;
      case GEMM_MAT:
        if (FULL && live == 1)
          t_gemm_mat<T, 1>(ws, wsm, args.partial, args.specs, w, seg, live,
                           smem, grid);
        else
          t_gemm_mat<T, ROW_GROUP>(ws, wsm, args.partial, args.specs, w, seg,
                                  live, smem, grid);
        break;
      case NORM_ROPE_QKV:
        t_norm_rope_qkv(ws, w, seg, live, args.head_dim, smem);
        break;
      case PREFETCH_MAT:
        // The TPU warms the consuming GEMM_MAT's first weight chunk into a
        // VMEM slot here. This kernel keeps no cross-task weight buffer:
        // the warm-spec GEMM_MAT streams chunk 0 from wsm like every other
        // chunk, so the warm has no work and no effect on the result.
        break;
      default:
        if constexpr (FULL) {
          if (w[0] == ALLREDUCE || w[0] == ALLREDUCE_ROW) {
            if (args.ar_on) {
              t_allreduce(ws, args, w, ar_site, live);
              seg = 0;
            }
            ++ar_site;
          } else if (!run_linear_task<T, BODY == BODY_MOE>(
                         args, ws, w, seg, live, smem, staged, grid)) {
            __trap();
          }
        } else {
          __trap();
        }
    }
  }
}

// Blocks of the cooperative grid, per instantiation, card and number of
// ranks of a group on that card, found at the first such launch: for one
// rank, up to 2 blocks on every SM; for r ranks on one card (virtual
// ranks), the same on at most 1/r of the SMs. A rank's AllReduce waits for
// its peers' kernels, so the r grids must be resident together: r grids of
// that size fit the card at once (csrc/gemm_comm.cu persistent_grid caps
// its ranks the same way).
constexpr int kMaxDevices = 16;

template <typename T, int BODY, bool PROF>
int& grid_blocks(int dev, int ranks) {
  static int blocks[kMaxDevices][tdt::dist::kMaxRanks + 1] = {};
  return blocks[dev][ranks];
}

template <typename T, int BODY, bool PROF>
cudaError_t launch(const Args& args, int ranks, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || ranks < 1 || ranks > tdt::dist::kMaxRanks)
    return cudaErrorInvalidValue;
  int& blocks = grid_blocks<T, BODY, PROF>(dev, ranks);
  if (blocks == 0) {
    int sms = 0, coop = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err != cudaSuccess) return err;
    if (!coop) return cudaErrorNotSupported;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, mega_kernel<T, BODY, PROF>, THREADS, 0);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorLaunchOutOfResources;
    const int cap = sms / ranks;
    if (cap < 1) return cudaErrorInvalidConfiguration;
    blocks = cap * (per_sm < 2 ? per_sm : 2);
  }
  // The AllReduce's flag words a (parity, source) hold the whole grid.
  if (args.ar_on && blocks > args.ar_stride) return cudaErrorInvalidValue;
  Args a = args;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(mega_kernel<T, BODY, PROF>), dim3(blocks),
      dim3(THREADS), params, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_body(const Args& args, int body, int ranks,
                        cudaStream_t stream) {
  const bool prof = args.prof != nullptr;
  switch (body) {
    case BODY_LEAN:
      return prof ? cudaErrorInvalidValue
                  : launch<T, BODY_LEAN, false>(args, ranks, stream);
    case BODY_LINEAR:
      return prof ? launch<T, BODY_LINEAR, true>(args, ranks, stream)
                  : launch<T, BODY_LINEAR, false>(args, ranks, stream);
    case BODY_MOE:
      return prof ? launch<T, BODY_MOE, true>(args, ranks, stream)
                  : launch<T, BODY_MOE, false>(args, ranks, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int body_blocks(int body, int dev, int ranks) {
  if (dev < 0 || dev >= kMaxDevices || ranks < 1 ||
      ranks > tdt::dist::kMaxRanks)
    return 0;
  switch (body) {
    case BODY_LEAN: return grid_blocks<T, BODY_LEAN, false>(dev, ranks);
    case BODY_LINEAR: return grid_blocks<T, BODY_LINEAR, false>(dev, ranks);
    case BODY_MOE: return grid_blocks<T, BODY_MOE, false>(dev, ranks);
    default: return 0;
  }
}

}  // namespace

// `body`: the instantiation (kernel.py `_kernel_body`): 0 the paged serving
// program's types alone, 1 any other non-MoE type, 2 a MoE program. `prof`:
// the (num_exec, TILE) int32 profile dump, or null (with body 1 or 2).
// The AllReduce group: `ar_on` 1 runs types 4 / 22 over the slot buffers of
// `ar_table` (rank `rank` of `num_ranks`, the launch's first `epoch`,
// slots of `max_ar` tiles, two parity sets), 0 makes them no-ops (one
// rank, no force_ar); `ranks_on_card`: the group's ranks on this card (1
// for one rank), which sizes the grid; `ar_sys`: the flags' scope (1 the
// system's: a peer on another card); `ar_stride`: the flag words a
// (parity, source), at least the grid (kernel.py ar_flag_stride), with 2 x
// num_ranks x ar_stride words inside the pad.
extern "C" int megakernel_run(const int* queue, const int* sync_before,
                              const int* specs, void* ws, const void* wsm,
                              const void* ws8, void* wkv8, float* partial,
                              int* prof, int num_exec, int live_rows,
                              int head_dim, int dtype, int body,
                              const void* ar_table, const void* ar_sig_table,
                              void* ar_err, int rank, int num_ranks,
                              unsigned long long epoch, long long timeout_ns,
                              int ar_on, int max_ar, int ranks_on_card,
                              int ar_sys, int ar_stride, void* stream) {
  if (live_rows < 1 || live_rows > MAX_LIVE) return cudaErrorInvalidValue;
  if (ar_on && (num_ranks < 1 || num_ranks > tdt::dist::kMaxRanks ||
                rank < 0 || rank >= num_ranks || max_ar < 1 ||
                ar_table == nullptr || ar_sig_table == nullptr ||
                ar_err == nullptr || ar_stride < 1 ||
                2LL * num_ranks * ar_stride > tdt::dist::kSignalWords))
    return cudaErrorInvalidValue;
  Args args{queue,   sync_before, specs,     ws,       wsm,
            static_cast<const __nv_fp8_e4m3*>(ws8),
            static_cast<__nv_fp8_e4m3*>(wkv8), partial, prof, num_exec,
            live_rows, head_dim,
            tdt::dist::make_group(ar_table, ar_sig_table, ar_err, rank,
                                  num_ranks, epoch, timeout_ns),
            ar_on, max_ar, ar_sys, ar_stride};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 1 ? launch_body<__nv_bfloat16>(args, body, ranks_on_card, s)
                 : launch_body<float>(args, body, ranks_on_card, s);
  return static_cast<int>(err);
}

extern "C" int megakernel_grid(int dtype, int body, int ranks_on_card) {
  // Blocks of that instantiation's launches on the current card with
  // `ranks_on_card` ranks on it (0 before the first).
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  return dtype == 1 ? body_blocks<__nv_bfloat16>(body, dev, ranks_on_card)
                    : body_blocks<float>(body, dev, ranks_on_card);
}
