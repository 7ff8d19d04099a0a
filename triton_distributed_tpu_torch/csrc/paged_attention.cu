// K2 — paged-KV decode attention for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel triton_distributed_tpu/ops/paged_attention.py:160
// (_paged_decode_kernel): one-token GQA decode through a page table, only
// the pages holding valid tokens are read, online softmax across pages,
// and either a normalized output or the split-KV partial (acc, m, l).
// Pools are float32 or bfloat16 (q's type), or e4m3 (the fp8 KV lane: a
// page is read at half the bf16 bytes and widened to fp32 in shared
// memory, where the TPU kernel widens it in VMEM; q and the output stay
// in the model type).
//
// What bounds it on this card: bytes. One decode step reads every valid
// K/V row of every sequence once (2 * kv_len * hkv * d * itemsize per
// sequence) and does ~4 flops per K/V element read — about two orders of
// magnitude below the ~295 bf16 flops per byte at which the H100 turns
// compute-bound. The least time is the KV bytes over 3.35 TB/s.
//
// What the design does about that, within "simple and right first":
//  - one block per (sequence, KV head): the g query heads that share a KV
//    head are served from one load of each page, so no K/V byte is read
//    from device memory twice;
//  - the block reads its own page-table row and walks only pages
//    j < ceil(kv_len / page), and inside the last page only its valid rows;
//    table entries past the valid pages (-1, or the serving loop's scratch
//    page) are never read, and kv_len = 0 reads nothing and writes zeros;
//  - pages are staged a tile of ~64 tokens at a time (whole pages up to a
//    page of 128; a larger page, such as the 512-row split-KV chunks of
//    ops/flash_decode.py, in 128-token slices), each thread issuing all
//    its 16-byte K/V loads for the tile before it stores any of them, so
//    the tile's loads are in flight together instead of one latency after
//    another;
//  - the softmax statistics of each query head reduce across one warp with
//    shuffles; K rows are padded by one float in shared memory so the
//    threads scoring neighbouring rows hit different banks.
// What it does not do yet: with B * hkv blocks (32 at batch 4 for Qwen3-8B)
// it fills a fraction of the 132 SMs, and each block walks its tiles one
// after another. Split-KV over pages with a combine step is later work.
// Arithmetic matches the TPU kernel: fp32 scores scaled after the dot,
// masked rows at -1e30, fp32 statistics, fp32 PV (p is not rounded here).

#include <stdint.h>

#include "common.cuh"

namespace {

using tdt::from_f;
using tdt::NEG;
using tdt::to_f;

constexpr int PT = 128;        // threads per block (4 warps)
constexpr int TILE_TOK = 64;   // tokens staged per iteration (whole pages)
constexpr int MAX_TILE = 128;  // ... and at most this many
constexpr int NB = 8;          // 16-byte loads a thread keeps in flight

// Unpack one 16-byte chunk into E = 16 / sizeof(T) floats (16 for e4m3).
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float* dst) {
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < (int)(16 / sizeof(T)); ++i) dst[i] = to_f(e[i]);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Tokens per staged tile: whole pages up to TILE_TOK (one page when a page
// holds >= TILE_TOK), at most MAX_TILE (a larger page is walked in slices;
// a tile's rows are addressed one by one, so it need not start a page).
__host__ __device__ inline int tile_tokens(int page) {
  if (page < TILE_TOK) return TILE_TOK / page * page;
  return page < MAX_TILE ? page : MAX_TILE;
}

inline size_t smem_bytes(int g, int d, int page) {
  const size_t tile = (size_t)tile_tokens(page);
  return sizeof(float) * ((size_t)2 * g * d + tile * (2 * d + 1) +
                          (size_t)g * tile + 3 * (size_t)g);
}

// q: (B, hq, D) in T; k_pool, v_pool: (P, page, hkv, D) in TK (T or e4m3);
// table: (B, max_pages) int32; lens: (B,) int32. out: (B, hq, D) in T when
// normalize, else fp32 acc; m, l: (B, hq). Pools must be 16-byte aligned
// (the wrapper checks).
template <typename T, typename TK, int D>
__global__ void __launch_bounds__(PT)
paged_decode_kernel(const T* __restrict__ q, const TK* __restrict__ kp,
                    const TK* __restrict__ vp, const int* __restrict__ table,
                    const int* __restrict__ lens, void* __restrict__ out,
                    float* __restrict__ m_out, float* __restrict__ l_out,
                    int hq, int hkv, int page, int max_pages, int normalize,
                    float scale) {
  constexpr int E = 16 / sizeof(TK);  // pool elements per 16-byte chunk
  constexpr int CH = D / E;           // chunks per K/V row
  extern __shared__ float smem[];
  const int g = hq / hkv;
  const int tile = tile_tokens(page);
  float* Qs = smem;                  // [g][D]
  float* Acc = Qs + g * D;           // [g][D]
  float* Ks = Acc + g * D;           // [tile][D + 1]
  float* Vs = Ks + tile * (D + 1);   // [tile][D]
  float* Ss = Vs + tile * D;         // [g][tile] scores, then p
  float* Ms = Ss + g * tile;         // [g] running max
  float* Ls = Ms + g;                // [g] running sum
  float* Cs = Ls + g;                // [g] this tile's correction

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int len = max(lens[b], 0);
  const int len_c = min(len, max_pages * page);  // rows the table holds
  const size_t q_base = ((size_t)b * hq + (size_t)kvh * g) * D;
  const int* trow = table + (size_t)b * max_pages;

  for (int idx = tid; idx < g * D; idx += PT) {
    Qs[idx] = to_f(q[q_base + idx]);
    Acc[idx] = 0.f;
  }
  for (int gi = tid; gi < g; gi += PT) {
    Ms[gi] = NEG;
    Ls[gi] = 0.f;
  }

  for (int t0 = 0; t0 < len_c; t0 += tile) {
    const int valid = min(tile, len_c - t0);
    __syncthreads();  // the previous tile is consumed
    // Stage the tile's valid rows: every 16-byte load of a batch is issued
    // before any is unpacked into shared memory.
    for (int base = 0; base < valid * CH; base += PT * NB) {
      uint4 kb[NB], vb[NB];
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const int idx = base + i * PT + tid;
        if (idx < valid * CH) {
          const int r = idx / CH;
          const int c = idx - r * CH;
          const int pos = t0 + r;
          const int pid = trow[pos / page];
          const size_t row =
              (((size_t)pid * page + pos % page) * hkv + kvh) * D;
          kb[i] = reinterpret_cast<const uint4*>(kp + row)[c];
          vb[i] = reinterpret_cast<const uint4*>(vp + row)[c];
        }
      }
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const int idx = base + i * PT + tid;
        if (idx < valid * CH) {
          const int r = idx / CH;
          const int c = idx - r * CH;
          unpack<TK>(kb[i], Ks + r * (D + 1) + c * E);
          unpack<TK>(vb[i], Vs + r * D + c * E);
        }
      }
    }
    __syncthreads();
    for (int idx = tid; idx < g * tile; idx += PT) {
      const int gi = idx / tile;
      const int r = idx - gi * tile;
      float s = NEG;
      if (r < valid) {
        const float* qr = Qs + gi * D;
        const float* kr = Ks + r * (D + 1);
        float a = 0.f;
#pragma unroll 8
        for (int c = 0; c < D; ++c) a = fmaf(qr[c], kr[c], a);
        s = a * scale;
      }
      Ss[idx] = s;
    }
    __syncthreads();
    // One warp per query head: tile max, p = exp(s - m_new), tile sum.
    for (int gi = warp; gi < g; gi += PT / 32) {
      float* sr = Ss + gi * tile;
      float mx = NEG;
      for (int r = lane; r < tile; r += 32) mx = fmaxf(mx, sr[r]);
      const float m_prev = Ms[gi];
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float sum = 0.f;
      for (int r = lane; r < tile; r += 32) {
        const float p = r < valid ? expf(sr[r] - m_new) : 0.f;
        sr[r] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        Ls[gi] = Ls[gi] * corr + sum;
        Ms[gi] = m_new;
        Cs[gi] = corr;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < g * D; idx += PT) {
      const int gi = idx / D;
      const int c = idx - gi * D;
      const float* pr = Ss + gi * tile;
      float pv = 0.f;
      for (int r = 0; r < valid; ++r) pv = fmaf(pr[r], Vs[r * D + c], pv);
      Acc[idx] = Acc[idx] * Cs[gi] + pv;
    }
  }
  __syncthreads();

  for (int idx = tid; idx < g * D; idx += PT) {
    if (normalize) {
      const float denom = fmaxf(Ls[idx / D], 1e-30f);
      static_cast<T*>(out)[q_base + idx] = from_f<T>(Acc[idx] / denom);
    } else {
      static_cast<float*>(out)[q_base + idx] = Acc[idx];
    }
  }
  if (!normalize) {
    for (int gi = tid; gi < g; gi += PT) {
      const size_t row = (size_t)b * hq + (size_t)kvh * g + gi;
      m_out[row] = Ms[gi];
      l_out[row] = Ls[gi];
    }
  }
}

template <typename T, typename TK, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* table, const int* lens, void* out, float* m,
                   float* l, int B, int hq, int hkv, int page, int max_pages,
                   int normalize, cudaStream_t stream) {
  static tdt::SmemCap cap;
  const size_t smem = smem_bytes(hq / hkv, D, page);
  const cudaError_t err =
      tdt::ensure_smem(paged_decode_kernel<T, TK, D>, smem, cap);
  if (err != cudaSuccess) return err;
  const dim3 grid(hkv, B);
  paged_decode_kernel<T, TK, D><<<grid, PT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const TK*>(kp),
      static_cast<const TK*>(vp), table, lens, out, m, l, hq, hkv, page,
      max_pages, normalize, (float)(1.0 / sqrt((double)D)));
  return cudaGetLastError();
}

// Pools of q's type (TK = T) or e4m3, at head_dim 64 or 128.
template <typename T>
cudaError_t dispatch_pool(int kv_dtype, int d, const void* q, const void* kp,
                          const void* vp, const int* table, const int* lens,
                          void* out, float* m, float* l, int B, int hq,
                          int hkv, int page, int max_pages, int normalize,
                          cudaStream_t s) {
  const bool e4m3 = kv_dtype == 2;
  if (e4m3 && d == 64)
    return launch<T, __nv_fp8_e4m3, 64>(q, kp, vp, table, lens, out, m, l, B,
                                        hq, hkv, page, max_pages, normalize, s);
  if (e4m3 && d == 128)
    return launch<T, __nv_fp8_e4m3, 128>(q, kp, vp, table, lens, out, m, l,
                                         B, hq, hkv, page, max_pages,
                                         normalize, s);
  if (d == 64)
    return launch<T, T, 64>(q, kp, vp, table, lens, out, m, l, B, hq, hkv,
                            page, max_pages, normalize, s);
  if (d == 128)
    return launch<T, T, 128>(q, kp, vp, table, lens, out, m, l, B, hq, hkv,
                             page, max_pages, normalize, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype (q and out): 0 = float32, 1 = bfloat16. kv_dtype (the pools):
// the same code as dtype, or 2 = e4m3. Returns a cudaError_t.
extern "C" int paged_decode_fwd(const void* q, const void* k_pool,
                                const void* v_pool, const int* table,
                                const int* lens, void* out, float* m,
                                float* l, int B, int hq, int hkv, int d,
                                int page, int max_pages, int normalize,
                                int dtype, int kv_dtype, void* stream) {
  if (B < 1 || hkv < 1 || hq % hkv != 0 || page < 1 || max_pages < 1 ||
      (!normalize && (m == nullptr || l == nullptr)) ||
      (kv_dtype != dtype && kv_dtype != 2))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_pool<float>(kv_dtype, d, q, k_pool, v_pool, table, lens,
                                out, m, l, B, hq, hkv, page, max_pages,
                                normalize, s);
  if (dtype == 1)
    return dispatch_pool<__nv_bfloat16>(kv_dtype, d, q, k_pool, v_pool, table,
                                        lens, out, m, l, B, hq, hkv, page,
                                        max_pages, normalize, s);
  return cudaErrorInvalidValue;
}
