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

// Lets `kernel` take `bytes` of dynamic shared memory on the current
// device. `cudaFuncSetAttribute` is called only when a launch needs more
// than the cap already granted on that device (48 KiB needs none), so a
// steady-state launch costs one atomic load and no API call. The cap only
// grows, under a lock. `Cap` is one static per kernel instantiation, with
// one cap per device: the attribute is set per device, and the rank
// threads of a tensor-parallel group launch on several cards.
constexpr int kMaxDevices = 16;

struct SmemCap {
  std::atomic<int> bytes[kMaxDevices];
  std::mutex mu;
  SmemCap() {
    for (auto& b : bytes) b.store(48 << 10);
  }
};

template <typename Kernel>
cudaError_t ensure_smem(Kernel kernel, size_t bytes, SmemCap& cap) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::atomic<int>& have = cap.bytes[dev];
  if ((long long)bytes <= have.load(std::memory_order_acquire))
    return cudaSuccess;
  std::lock_guard<std::mutex> lock(cap.mu);
  if ((long long)bytes <= have.load(std::memory_order_relaxed))
    return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) have.store((int)bytes, std::memory_order_release);
  return err;
}

}  // namespace tdt

extern "C" const char* tdt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
