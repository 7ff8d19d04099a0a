// K1 — flash-attention prefill for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel triton_distributed_tpu/ops/flash_attention.py:157
// (_flash_kernel): blockwise online-softmax GQA attention with positional
// causality from (q_offset, k_offset), fully hidden key tiles skipped, and
// either a normalized output or the fp32 (acc, m, l) partials.
//
// What bounds it on this card: at prefill shapes (S ~ 1k, d = 128) the work
// is ~4*S*S/2*d*hq flops against a few MB of q/k/v, far above the H100's
// ~295 bf16 flops per byte, so the bound is the tensor-core rate. This first
// kernel does not reach it: it runs fp32 FMA from shared memory (no wgmma,
// no TMA), so it is bounded by FMA issue and shared-memory loads instead.
//
// What the design does about that, within "simple and right first":
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
// Arithmetic matches the TPU kernel: fp32 QK scaled after the dot, masked
// logits at -1e30, m/l in fp32, p rounded to V's dtype before PV, a dead
// row ends with m = -1e30, l = 0 and a normalized output of 0.
// Making it fast (wgmma + TMA, bf16 operands in shared memory) is later work.

#include <stdint.h>

#include "common.cuh"

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

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, float* m,
                                   float* l, int B, int Sq, int Sk, int hq,
                                   int hkv, int d, int q_off, int k_off,
                                   int causal, int normalize, int dtype,
                                   void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || hkv < 1 || hq % hkv != 0 ||
      (!normalize && (m == nullptr || l == nullptr)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && d == 64)
    return launch<float, 64>(q, k, v, out, m, l, B, Sq, Sk, hq, hkv, q_off,
                             k_off, causal, normalize, s);
  if (dtype == 0 && d == 128)
    return launch<float, 128>(q, k, v, out, m, l, B, Sq, Sk, hq, hkv, q_off,
                              k_off, causal, normalize, s);
  if (dtype == 1 && d == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, out, m, l, B, Sq, Sk, hq, hkv,
                                     q_off, k_off, causal, normalize, s);
  if (dtype == 1 && d == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, out, m, l, B, Sq, Sk, hq, hkv,
                                      q_off, k_off, causal, normalize, s);
  return cudaErrorInvalidValue;
}
