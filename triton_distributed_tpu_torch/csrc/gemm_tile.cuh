// B3's tile code, shared by the kernels that compute a GEMM: csrc/gemm.cu
// (B3 itself, one tile a block) and csrc/gemm_comm.cu (B9-B11, persistent
// blocks that walk many tiles between their waits on peers).
//
// One call of tc_tile / fma_tile computes one BM x BN output tile at
// (m0, n0) of A (M x K, row stride lda) @ B (K x N, row stride ldb) with
// fp32 accumulation and hands each in-range element (r < M, c < N) to
// `store(r, c, value)`: the caller decides where the tile lands (its own
// output, a peer's workspace slot, every rank's slot) and the cast.
//   tc_tile   TC = bf16 (mma.sync m16n8k16) or e4m3 (m16n8k32; sums
//             promoted to fp32 once per staged chunk); an e4m3 B under a
//             bf16 A is upcast as it is staged
//   fma_tile  fp32 A (scalar FMA: the tensor cores would round A to TF32)
// Tiles are staged global -> registers -> shared memory (B transposed, so
// each mma fragment is one 32-bit load). CG_A loads A through L2 only
// (ld.global.cg): the fused kernels read A from a landing workspace that
// peers wrote while this kernel ran. Every call leaves shared memory free
// for the next (its last step is a block barrier), so a persistent block
// may call it again at once.

#pragma once

#include "common.cuh"

#include <cstdint>
#include <cstring>
#include <type_traits>

namespace tdt {
namespace tile {

using bf16 = __nv_bfloat16;
using e4m3 = __nv_fp8_e4m3;

constexpr int NT = 256;  // threads of every configuration

template <typename TC, typename TS>
__device__ __forceinline__ TC cvt(TS x);
template <>
__device__ __forceinline__ float cvt<float, float>(float x) { return x; }
template <>
__device__ __forceinline__ float cvt<float, bf16>(bf16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float cvt<float, e4m3>(e4m3 x) {
  return static_cast<float>(x);
}
template <>
__device__ __forceinline__ bf16 cvt<bf16, bf16>(bf16 x) { return x; }
template <>
__device__ __forceinline__ bf16 cvt<bf16, e4m3>(e4m3 x) {
  return __float2bfloat16(static_cast<float>(x));  // exact: e4m3 fits bf16
}
template <>
__device__ __forceinline__ e4m3 cvt<e4m3, e4m3>(e4m3 x) { return x; }

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <>
__device__ __forceinline__ bf16 zero_of<bf16>() {
  return __float2bfloat16(0.f);
}
template <>
__device__ __forceinline__ e4m3 zero_of<e4m3>() {
  e4m3 z;
  z.__x = 0;
  return z;
}

template <typename TO>
__device__ __forceinline__ TO store_cvt(float x);
template <>
__device__ __forceinline__ float store_cvt<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 store_cvt<bf16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ e4m3 store_cvt<e4m3>(float x) {
  return tdt::to_e4m3(x);
}

template <typename T>
__device__ __forceinline__ uint32_t bits_of(T x);
template <>
__device__ __forceinline__ uint32_t bits_of<bf16>(bf16 x) {
  return __bfloat16_as_ushort(x);
}
template <>
__device__ __forceinline__ uint32_t bits_of<e4m3>(e4m3 x) {
  return x.__x;
}

// Loads of the staged operands: plain, or through L2 only (CG).
template <bool CG>
__device__ __forceinline__ uint4 ld16(const void* p) {
  if constexpr (CG)
    return __ldcg(reinterpret_cast<const uint4*>(p));
  else
    return *reinterpret_cast<const uint4*>(p);
}

template <bool CG, typename T>
__device__ __forceinline__ T ld1(const T* p) {
  if constexpr (CG && sizeof(T) == 4) {
    const unsigned v = __ldcg(reinterpret_cast<const unsigned*>(p));
    T t;
    memcpy(&t, &v, 4);
    return t;
  } else if constexpr (CG && sizeof(T) == 2) {
    const unsigned short v =
        __ldcg(reinterpret_cast<const unsigned short*>(p));
    T t;
    memcpy(&t, &v, 2);
    return t;
  } else {
    return *p;
  }
}

// Stage an R x C tile of a row-major (nrows x ncols, row stride ld) matrix,
// starting at (r0, c0), into shared memory as type TC: dst[r * SD + c], or
// transposed dst[c * SD + r]. Out-of-range elements are zero. Where rows
// are 16-byte aligned (vec_ok) each thread moves 16 bytes per load:
// - transposed into a 1- or 2-byte type, a thread takes the 16 bytes of
//   PK = 4 / sizeof(TC) consecutive rows and stores each column's PK
//   values as one 32-bit word (four e4m3 or two bf16 k-values: one mma
//   fragment register); the lanes of a warp take consecutive row groups,
//   so each store instruction writes consecutive words;
// - transposed into fp32, a warp takes 16 rows of two neighbouring
//   vectors (with the padded strides the two halves of every store fall
//   in distinct banks);
// - not transposed, the rows past nrows are zeroed with 16-byte stores
//   and only the valid rows are loaded (the decode case: M < the tile).
template <typename TS, typename TC, int R, int C, int SD, bool TRANS,
          bool CG = false>
__device__ __forceinline__ void stage(TC* __restrict__ dst,
                                      const TS* __restrict__ src, long ld,
                                      int r0, int c0, int nrows, int ncols,
                                      bool vec_ok) {
  constexpr int VEC = 16 / sizeof(TS);
  constexpr int CV = C / VEC;
  const int tid = threadIdx.x;
  if constexpr (TRANS && sizeof(TC) < 4) {
    constexpr int PK = 4 / sizeof(TC);
    if constexpr (C % VEC == 0 && R % PK == 0) {
      if (vec_ok && r0 + R <= nrows && c0 + C <= ncols) {
        constexpr int RQ = R / PK;
#pragma unroll 2
        for (int v = tid; v < RQ * CV; v += NT) {
          const int r = (v % RQ) * PK, c = (v / RQ) * VEC;
          uint4 raw[PK];
#pragma unroll
          for (int p = 0; p < PK; ++p)
            raw[p] = ld16<CG>(src + (long)(r0 + r + p) * ld + c0 + c);
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            uint32_t w = 0;
#pragma unroll
            for (int p = 0; p < PK; ++p)
              w |= bits_of<TC>(cvt<TC, TS>(
                       reinterpret_cast<const TS*>(&raw[p])[i]))
                   << (8 * sizeof(TC) * p);
            *reinterpret_cast<uint32_t*>(dst + (c + i) * SD + r) = w;
          }
        }
        return;
      }
    }
  } else if constexpr (TRANS) {
    if constexpr (C % VEC == 0 && R % 16 == 0 && CV % 2 == 0) {
      if (vec_ok && r0 + R <= nrows && c0 + C <= ncols) {
#pragma unroll 4
        for (int v = tid; v < R * CV; v += NT) {
          const int lo = v & 31, hi = v >> 5;
          const int r = (hi % (R / 16)) * 16 + (lo & 15);
          const int c = ((hi / (R / 16)) * 2 + (lo >> 4)) * VEC;
          const uint4 raw = ld16<CG>(src + (long)(r0 + r) * ld + c0 + c);
          const TS* e = reinterpret_cast<const TS*>(&raw);
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            dst[(c + i) * SD + r] = cvt<TC, TS>(e[i]);
        }
        return;
      }
    }
  } else {
    constexpr int ROW16 = C * (int)sizeof(TC) / 16;  // 16-byte units a row
    if constexpr (C % VEC == 0 && (C * sizeof(TC)) % 16 == 0 &&
                  (SD * sizeof(TC)) % 16 == 0) {
      if (vec_ok && c0 + C <= ncols) {
        const int valid = max(0, min(R, nrows - r0));
#pragma unroll 4
        for (int v = tid; v < valid * CV; v += NT) {
          const int r = v / CV, c = (v % CV) * VEC;
          const uint4 raw = ld16<CG>(src + (long)(r0 + r) * ld + c0 + c);
          if constexpr (std::is_same<TS, TC>::value) {
            *reinterpret_cast<uint4*>(dst + r * SD + c) = raw;
          } else {
            const TS* e = reinterpret_cast<const TS*>(&raw);
#pragma unroll
            for (int i = 0; i < VEC; ++i)
              dst[r * SD + c + i] = cvt<TC, TS>(e[i]);
          }
        }
        for (int v = tid; v < (R - valid) * ROW16; v += NT) {
          const int r = valid + v / ROW16;
          *reinterpret_cast<uint4*>(
              reinterpret_cast<unsigned char*>(dst + r * SD) +
              (v % ROW16) * 16) = make_uint4(0, 0, 0, 0);
        }
        return;
      }
    }
  }
  for (int idx = tid; idx < R * C; idx += NT) {
    const int r = idx / C, c = idx % C;
    const int gr = r0 + r, gc = c0 + c;
    TC val = zero_of<TC>();
    if (gr < nrows && gc < ncols)
      val = cvt<TC, TS>(ld1<CG>(src + (long)gr * ld + gc));
    if constexpr (TRANS)
      dst[c * SD + r] = val;
    else
      dst[r * SD + c] = val;
  }
}

// ---------------------------------------------------------------------------
// Tensor-core tiles: TC = bf16 (m16n8k16) or e4m3 (m16n8k32).
// Warps form a WM x WN x WK grid; each (wm, wn) owns a (BM/WM) x (BN/WN)
// sub-tile and each wk a BK/WK slice of every staged K chunk.
// ---------------------------------------------------------------------------

template <typename TC>
struct Mma;

template <>
struct Mma<bf16> {
  static constexpr int K = 16;
  __device__ __forceinline__ static void run(float* c, const uint32_t* a,
                                             const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

template <>
struct Mma<e4m3> {
  static constexpr int K = 32;
  __device__ __forceinline__ static void run(float* c, const uint32_t* a,
                                             const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

template <typename TC, int BM, int BN, int BK, int WM, int WN, int WK>
struct TcCfg {
  static_assert(WM * WN * WK * 32 == NT, "8 warps");
  // A rows stay 16-byte aligned (uint4 stores); the transposed B rows are
  // 4-byte aligned (packed stores, fragment loads) and padded off a
  // multiple of 32 words.
  static constexpr int SD = BK + 16 / (int)sizeof(TC);
  static constexpr int SDB = BK + 4;
  static constexpr int MI = BM / WM / 16;
  static constexpr int NI = BN / WN / 8;
  static constexpr int KW = BK / WK;  // k columns per warp per chunk
  static_assert(MI >= 1 && NI >= 1 && KW % Mma<TC>::K == 0, "tile shape");
  static constexpr int STAGE_BYTES =
      (BM * SD + BN * SDB) * (int)sizeof(TC);
  static constexpr int RED_BYTES =
      (WK - 1) * WM * WN * MI * NI * 4 * 32 * (int)sizeof(float);
  static constexpr int SMEM =
      STAGE_BYTES > RED_BYTES ? STAGE_BYTES : RED_BYTES;
};

template <typename TA, typename TB, typename TC, int BM, int BN, int BK,
          int WM, int WN, int WK, bool CG_A, typename Store>
__device__ __forceinline__ void tc_tile(unsigned char* smem,
                                        const TA* __restrict__ A, long lda,
                                        const TB* __restrict__ B, long ldb,
                                        int M, int N, int K, int m0, int n0,
                                        bool vec_a, bool vec_b,
                                        Store store) {
  using Cfg = TcCfg<TC, BM, BN, BK, WM, WN, WK>;
  constexpr int SD = Cfg::SD, SDB = Cfg::SDB;
  constexpr int MI = Cfg::MI, NI = Cfg::NI, KW = Cfg::KW;
  constexpr int KS = Mma<TC>::K;
  constexpr int EPW = 4 / sizeof(TC);  // elements per 32-bit register
  TC* As = reinterpret_cast<TC*>(smem);  // [BM][SD]
  TC* Bs = As + BM * SD;                 // [BN][SDB], B transposed

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wk = warp / (WM * WN), wmn = warp % (WM * WN);
  const int wm = wmn / WN, wn = wmn % WN;
  const int rbase = wm * (BM / WM), cbase = wn * (BN / WN);

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  // The e4m3 mma keeps only about 14 bits of its running sum on Hopper, so
  // that lane sums each staged chunk (<= 4 mma steps) into a fresh
  // accumulator and adds it to the fp32 total with ordinary FADDs.
  constexpr bool PROMOTE = sizeof(TC) == 1;
  float part[PROMOTE ? MI : 1][PROMOTE ? NI : 1][4];
  for (int k0 = 0; k0 < K; k0 += BK) {
    stage<TA, TC, BM, BK, SD, false, CG_A>(As, A, lda, m0, k0, M, K, vec_a);
    stage<TB, TC, BK, BN, SDB, true>(Bs, B, ldb, k0, n0, K, N, vec_b);
    __syncthreads();
    if constexpr (PROMOTE) {
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) part[i][j][q] = 0.f;
    }
#pragma unroll
    for (int s = 0; s < KW / KS; ++s) {
      const int kk = wk * KW + s * KS;
      uint32_t af[MI][4], bfr[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const TC* r0 = As + (rbase + i * 16 + g) * SD + kk + t * EPW;
        const TC* r8 = r0 + 8 * SD;
        af[i][0] = *reinterpret_cast<const uint32_t*>(r0);
        af[i][1] = *reinterpret_cast<const uint32_t*>(r8);
        af[i][2] = *reinterpret_cast<const uint32_t*>(r0 + KS / 2);
        af[i][3] = *reinterpret_cast<const uint32_t*>(r8 + KS / 2);
      }
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const TC* c0 = Bs + (cbase + j * 8 + g) * SDB + kk + t * EPW;
        bfr[j][0] = *reinterpret_cast<const uint32_t*>(c0);
        bfr[j][1] = *reinterpret_cast<const uint32_t*>(c0 + KS / 2);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          if constexpr (PROMOTE)
            Mma<TC>::run(part[i][j], af[i], bfr[j]);
          else
            Mma<TC>::run(acc[i][j], af[i], bfr[j]);
        }
    }
    if constexpr (PROMOTE) {
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][j][q] += part[i][j][q];
    }
    __syncthreads();
  }

  if constexpr (WK > 1) {
    // Warps wk > 0 leave their partials in shared memory (the staging
    // buffers are free after the loop's last barrier); warp wk = 0 of the
    // same (wm, wn) adds them in wk order.
    float* red = reinterpret_cast<float*>(smem);
    constexpr int PER = MI * NI * 4;
    if (wk > 0) {
      float* dst = red + ((wk - 1) * WM * WN + wmn) * PER * 32;
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            dst[((i * NI + j) * 4 + q) * 32 + lane] = acc[i][j][q];
    }
    __syncthreads();
    if (wk == 0) {
      for (int w = 1; w < WK; ++w) {
        const float* srcp = red + ((w - 1) * WM * WN + wmn) * PER * 32;
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NI; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              acc[i][j][q] += srcp[((i * NI + j) * 4 + q) * 32 + lane];
      }
    }
    // The partials are read before the next tile stages over them.
    __syncthreads();
    if (wk != 0) return;
  }

#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int r = m0 + rbase + i * 16 + g;
      const int c = n0 + cbase + j * 8 + t * 2;
      if (r < M && c < N) store(r, c, acc[i][j][0]);
      if (r < M && c + 1 < N) store(r, c + 1, acc[i][j][1]);
      if (r + 8 < M && c < N) store(r + 8, c, acc[i][j][2]);
      if (r + 8 < M && c + 1 < N) store(r + 8, c + 1, acc[i][j][3]);
    }
}

// ---------------------------------------------------------------------------
// The fp32 tile: scalar FMA (the tensor cores would round A to TF32).
// Thread (tr, tc) owns rows tr + i * (BM / TM) and columns tc + j * (BN / TN).
// ---------------------------------------------------------------------------

template <int BM, int BN, int BK, int TM, int TN>
struct FmaCfg {
  static_assert((BM / TM) * (BN / TN) == NT, "256 threads");
  static constexpr int SA = BM + 4, SB = BN + 4;
  static constexpr int SMEM = (BK * SA + BK * SB) * (int)sizeof(float);
};

template <typename TB, int BM, int BN, int BK, int TM, int TN, bool CG_A,
          typename Store>
__device__ __forceinline__ void fma_tile(unsigned char* smem,
                                         const float* __restrict__ A,
                                         long lda, const TB* __restrict__ B,
                                         long ldb, int M, int N, int K,
                                         int m0, int n0, bool vec_a,
                                         bool vec_b, Store store) {
  using Cfg = FmaCfg<BM, BN, BK, TM, TN>;
  constexpr int SA = Cfg::SA, SB = Cfg::SB;
  constexpr int RM = BM / TM, CN = BN / TN;
  float* As = reinterpret_cast<float*>(smem);  // [BK][SA], A transposed
  float* Bs = As + BK * SA;                    // [BK][SB]
  const int tr = threadIdx.x / CN, tc = threadIdx.x % CN;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += BK) {
    stage<float, float, BM, BK, SA, true, CG_A>(As, A, lda, m0, k0, M, K,
                                                vec_a);
    stage<TB, float, BK, BN, SB, false>(Bs, B, ldb, k0, n0, K, N, vec_b);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk * SA + tr + i * RM];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk * SB + tc + j * CN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int r = m0 + tr + i * RM, c = n0 + tc + j * CN;
      if (r < M && c < N) store(r, c, acc[i][j]);
    }
}

}  // namespace tile
}  // namespace tdt
