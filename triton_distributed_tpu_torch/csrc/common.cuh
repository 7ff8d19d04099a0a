// Helpers shared by the port's hand-written kernels. Each csrc/*.cu source
// is its own shared library (one translation unit), so this header may
// define the extern "C" error-string entry every library exports.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <atomic>
#include <mutex>

namespace tdt {

constexpr float NEG = -1e30f;  // masked logit and empty-row max, as on TPU

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);   // exact: every e4m3 value is an fp32
}

// The saturating e4m3 store of the fp8 KV pools: round to nearest even,
// clamp to +-448 (never NaN for a finite input) — models/fp8.to_e4m3.
__device__ __forceinline__ __nv_fp8_e4m3 to_e4m3(float x) {
  __nv_fp8_e4m3 r;
  r.__x = __nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E4M3);
  return r;
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}

// Lets `kernel` take `bytes` of dynamic shared memory. The driver call is
// made only when a launch needs more than the cap already granted (48 KiB
// needs none), so a steady-state launch costs one atomic load and no
// driver call. The cap only grows, under a lock. `Cap` is one static per
// kernel instantiation; the port drives one card per process, and
// function attributes are set on the current device.
struct SmemCap {
  std::atomic<int> bytes{48 << 10};
  std::mutex mu;
};

template <typename Kernel>
cudaError_t ensure_smem(Kernel kernel, size_t bytes, SmemCap& cap) {
  if ((long long)bytes <= cap.bytes.load(std::memory_order_acquire))
    return cudaSuccess;
  std::lock_guard<std::mutex> lock(cap.mu);
  if ((long long)bytes <= cap.bytes.load(std::memory_order_relaxed))
    return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess)
    cap.bytes.store((int)bytes, std::memory_order_release);
  return err;
}

}  // namespace tdt

extern "C" const char* tdt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
