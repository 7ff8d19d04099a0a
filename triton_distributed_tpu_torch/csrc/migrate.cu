// The KV-page copies of the migration transport (kernel B13).
//
//  migrate_pack     disagg/migrate.py:249 _pack_kernel — gathers the
//                   listed pages of a flattened pool (P·page_rows rows)
//                   into a contiguous send buffer: page pages[i] lands at
//                   rows [i·page_rows, (i+1)·page_rows).
//  migrate_scatter  disagg/migrate.py:277 _scatter_kernel — the pool copied
//                   through whole, with the landed buffer's page i written
//                   at the rewritten id pages[i] (the decode allocator's,
//                   not the sender's). Functional, as the reference's: the
//                   input pool is not changed, the output is a new pool.
//
// The TPU kernels run a double-buffered chain of DMAs, one page at a time,
// two in flight. Here every page (of the list, or of the pool) gets its own
// row of blocks, each block a slice of the page's bytes, 16-byte vector
// copies with neighbouring threads on neighbouring addresses — the whole
// list in flight at once. The page ids are a device int32 array, not baked
// into the build, so one build serves every page list; the host checks
// them (range, no duplicate destination) before the launch. Any dtype is a
// byte copy (fp32, bf16, e4m3).
//
// What bounds them: bytes. The pack reads each listed page once and writes
// it once; the scatter reads the pool (less the target pages) and the
// buffer once and writes the pool once. A block of the scatter finds
// whether its page is a target by scanning the id list (a few dozen ids)
// in shared memory, so the copy-through and the scatter are one launch
// with no grid-wide ordering.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSlices = 64;

__device__ __forceinline__ void copy_slice(uint4* dst, const uint4* src,
                                           long long page_vec) {
  const long long per = (page_vec + gridDim.y - 1) / gridDim.y;
  const long long v0 = min(page_vec, per * blockIdx.y);
  const long long v1 = min(page_vec, v0 + per);
  for (long long v = v0 + threadIdx.x; v < v1; v += blockDim.x)
    dst[v] = __ldcs(src + v);
}

// grid (n_pages, slices): block (i, s) copies slice s of page pages[i].
__global__ void __launch_bounds__(kThreads)
    pack_kernel(const uint4* pool, const int* pages, uint4* out,
                long long page_vec, int pool_pages) {
  const int p = pages[blockIdx.x];
  if (p < 0 || p >= pool_pages) return;   // checked on the host
  copy_slice(out + (long long)blockIdx.x * page_vec,
             pool + (long long)p * page_vec, page_vec);
}

// grid (pool_pages, slices): block (p, s) writes slice s of pool page p —
// the buffer's page i where pages[i] == p, else the input pool's page p.
__global__ void __launch_bounds__(kThreads)
    scatter_kernel(const uint4* pool_in, const uint4* buf, const int* pages,
                   uint4* pool_out, long long page_vec, int n_pages) {
  __shared__ int hit;
  const int p = blockIdx.x;
  if (threadIdx.x == 0) hit = -1;
  __syncthreads();
  for (int i = threadIdx.x; i < n_pages; i += blockDim.x)
    if (pages[i] == p) hit = i;   // destinations are distinct
  __syncthreads();
  const uint4* src = hit >= 0 ? buf + (long long)hit * page_vec
                              : pool_in + (long long)p * page_vec;
  copy_slice(pool_out + (long long)p * page_vec, src, page_vec);
}

int slices_for(long long page_vec) {
  // About eight vectors a thread, at most kMaxSlices blocks a page.
  long long s = (page_vec + kThreads * 8 - 1) / (kThreads * 8);
  return (int)(s < 1 ? 1 : (s > kMaxSlices ? kMaxSlices : s));
}

}  // namespace

extern "C" {

// page_bytes: one page (page_rows rows of the flattened pool), a multiple
// of 16; pages: n_pages device int32 ids. Every entry returns its
// cudaError_t.
int tdt_migrate_pack(const void* pool, const void* pages, void* out,
                     long long page_bytes, int n_pages, int pool_pages,
                     cudaStream_t stream) {
  if (page_bytes <= 0 || page_bytes % 16 || n_pages < 1 || pool_pages < 1)
    return cudaErrorInvalidValue;
  const long long page_vec = page_bytes / 16;
  pack_kernel<<<dim3(n_pages, slices_for(page_vec)), kThreads, 0, stream>>>(
      static_cast<const uint4*>(pool), static_cast<const int*>(pages),
      static_cast<uint4*>(out), page_vec, pool_pages);
  return cudaGetLastError();
}

int tdt_migrate_scatter(const void* pool_in, const void* buf,
                        const void* pages, void* pool_out,
                        long long page_bytes, int n_pages, int pool_pages,
                        cudaStream_t stream) {
  if (page_bytes <= 0 || page_bytes % 16 || n_pages < 1 || pool_pages < 1)
    return cudaErrorInvalidValue;
  const long long page_vec = page_bytes / 16;
  scatter_kernel<<<dim3(pool_pages, slices_for(page_vec)), kThreads, 0,
                   stream>>>(
      static_cast<const uint4*>(pool_in), static_cast<const uint4*>(buf),
      static_cast<const int*>(pages), static_cast<uint4*>(pool_out),
      page_vec, n_pages);
  return cudaGetLastError();
}

}  // extern "C"
