// Kernel B3: tiled GEMM, out = A @ B with fp32 accumulation.
//
// Replaces the TPU kernel triton_distributed_tpu/ops/gemm.py:32
// (_grid_matmul_kernel, reached through pallas_matmul). On the TPU the k
// grid axis runs in order and carries the fp32 sum in VMEM scratch; here
// one block owns one (BM x BN) output tile and loops over K itself, so no
// sum crosses blocks (no split-K across blocks).
//
// Lanes (A x B -> out), chosen by the wrapper (ops/gemm.py):
//   fp32 x {fp32, bf16, e4m3} -> fp32        scalar FMA, never TF32
//   bf16 x {bf16, e4m3}       -> bf16, fp32  mma.sync m16n8k16 bf16; an
//                                            e4m3 B is upcast to bf16 as it
//                                            is staged (the mixed lane)
//   e4m3 x e4m3               -> e4m3, bf16, fp32  mma.sync m16n8k32 e4m3
// An e4m3 store saturates to +-448 (tdt::to_e4m3), as models/fp8.to_e4m3.
//
// What bounds it on an H100 (989 TFLOP/s bf16, 1979 fp8, 67 fp32 without
// tensor cores, 3.35 TB/s): at M=2048, K=N=5120 the operations (107.4
// GFLOP: 0.109 ms bf16, 0.054 ms e4m3, 1.60 ms fp32); at decode (M <= 16)
// the bytes of B (e.g. 52.4 MB bf16 at K=N=5120: 0.0157 ms). The design is
// the simple one: tiles staged global -> registers -> shared memory (B
// transposed, so each mma fragment is one 32-bit load), mma.sync on
// fp32 accumulators (the e4m3 lane promotes its mma sums to fp32 once per
// staged chunk), and for small M a block that splits its K chunk over
// warps and sums their partials in shared memory. No TMA, wgmma or
// software pipeline yet. The tile code lives in gemm_tile.cuh, shared with
// the fused communication kernels of gemm_comm.cu.

#include "gemm_tile.cuh"

namespace {

using tdt::tile::bf16;
using tdt::tile::e4m3;
using tdt::tile::FmaCfg;
using tdt::tile::NT;
using tdt::tile::store_cvt;
using tdt::tile::TcCfg;

// One block per output tile (blockIdx: column tile, row tile); the tile
// code is gemm_tile.cuh's.
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
// Launch.
// ---------------------------------------------------------------------------

struct Args {
  const void* a;
  const void* b;
  void* out;
  int M, N, K, vec_a, vec_b;
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

// The compiled tile configurations, by index (ops/gemm.py _TC_CONFIGS and
// _FMA_CONFIGS list the same tiles in the same order). BK is in elements:
// the e4m3 lane stages twice the bf16 lane's K per chunk.
//   0: 128 x 128, warps 2x4      (large M)
//   1:  64 x 128, warps 2x4
//   2:  16 x  64, warps 1x2, K split over 4 warps   (decode, M <= 16)
//   3:  16 x  32, warps 1x1, K split over 8 warps
template <typename TA, typename TB, typename TO, typename TC>
cudaError_t run_tc(int cfg, const Args& x) {
  constexpr int S = sizeof(TC) == 1 ? 2 : 1;  // K scale of the e4m3 lane
  switch (cfg) {
    case 0: return launch_tc<TA, TB, TO, TC, 128, 128, 32 * S, 2, 4, 1>(x);
    case 1: return launch_tc<TA, TB, TO, TC, 64, 128, 32 * S, 2, 4, 1>(x);
    case 2: return launch_tc<TA, TB, TO, TC, 16, 64, 256 * S, 1, 2, 4>(x);
    case 3: return launch_tc<TA, TB, TO, TC, 16, 32, 256 * S, 1, 1, 8>(x);
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
// contiguous row-major (M x K), (K x N), (M x N). vec_a / vec_b: the
// operand's base address and row stride are multiples of 16 bytes. Returns
// the launch's cudaError_t; an uncompiled lane or tile is
// cudaErrorInvalidValue (the wrapper refuses those by name first).
extern "C" int gemm_run(const void* a, const void* b, void* out, int M, int N,
                        int K, int a_type, int b_type, int out_type, int cfg,
                        int vec_a, int vec_b, void* stream) {
  const Args x{a, b, out, M, N, K, vec_a, vec_b,
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
