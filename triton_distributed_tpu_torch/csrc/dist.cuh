// Device-side communication primitives of the rank group — the port's
// counterpart of the JAX package's language/distributed_ops.py and
// language/shmem_device.py (rank, num_ranks, putmem, signal, wait, fence,
// quiet; its barrier_all is gemm_comm.cu's grid_barrier, which the fused
// kernels' tile paths meet at entry).
//
// A rank reaches a peer's symmetric buffer through a device table of base
// pointers (runtime/symm.py): on n cards a peer's memory mapped by peer
// access, on one card with n virtual ranks a sibling buffer. The code is
// the same in both cases; only the table differs.
//
// Memory order, the same across cards and across virtual ranks:
//  - a writer's payload stores go to the peer; the block meets at
//    __syncthreads; then one thread fences at system scope and stores the
//    call's epoch into the peer's flag with st.release.sys (signal);
//  - the waiter loads its own flag with ld.acquire.sys until it reaches
//    the epoch, and the block meets again before reading the payload
//    (wait). Payload reads go through L2 (ld.global.cg).
// Flags are 64-bit and only grow: a flag is never reset, the host hands
// every call a larger epoch, and a wait compares with >=.
//
// No wait is endless: a spin that passes the deadline (%globaltimer, ns)
// writes the rank's error word — (flag index, expected, observed, 1) —
// and the kernel returns early. The host reads the word where it
// synchronises anyway (DistContext.raise_on_comm_error) and raises
// CommTimeoutError. The collective kernels run the push protocol
// (push.cuh) on a grid the host sizes by the payload, and each fused GEMM
// kernel (gemm_comm.cu) a persistent grid of one block an SM, both on at
// most 1/r of the SMs, r the ranks on the card, so on one card a spinning
// rank never takes the SMs its peers need; B11's tile paths still push
// through put and the slot reduction here. The megakernel's AllReduce
// (megakernel.cu t_allreduce) keeps its own flags: a word a parity, source
// and block.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace tdt {
namespace dist {

constexpr int kMaxRanks = 8;
constexpr int kThreads = 256;
// The fused GEMM kernels' persistent grids (at most kMaxGemmBlocks blocks):
// barrier flags [0, kMaxGemmBlocks * kMaxRanks), then their data flags
// from kGemmFlagBase, one per (source rank, block) or finer. The pad
// (runtime/symm.SIGNAL_WORDS) holds kSignalWords.
constexpr int kMaxGemmBlocks = 128;
constexpr int kGemmFlagBase = kMaxGemmBlocks * kMaxRanks;
constexpr int kSignalWords = 8192;

// What a collective kernel knows of its group, passed by value.
struct Group {
  int rank;
  int n;
  const long long* table;      // n data base pointers (this rank's device)
  const long long* sig_table;  // n signal pad base pointers
  long long* err;              // this rank's error word, 4 x int64
  unsigned long long epoch;    // this call's epoch (>= 1)
  long long timeout_ns;
};

// The group of one launch, from the host's arguments.
inline Group make_group(const void* table, const void* sig_table, void* err,
                 int rank, int n, unsigned long long epoch,
                 long long timeout_ns) {
  Group g;
  g.rank = rank;
  g.n = n;
  g.table = static_cast<const long long*>(table);
  g.sig_table = static_cast<const long long*>(sig_table);
  g.err = static_cast<long long*>(err);
  g.epoch = epoch;
  g.timeout_ns = timeout_ns;
  return g;
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void st_release_sys(unsigned long long* p,
                                               unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long ld_acquire_sys(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ char* peer_base(const Group& g, int j) {
  return reinterpret_cast<char*>(g.table[j]);
}

__device__ __forceinline__ unsigned long long* flags(const Group& g, int j) {
  return reinterpret_cast<unsigned long long*>(g.sig_table[j]);
}

// fence + quiet: order this thread's earlier stores (local and remote)
// before its later ones at system scope.
__device__ __forceinline__ void fence() { __threadfence_system(); }

// Store `val` into flag `idx` of rank j's pad, after the block's earlier
// stores. Call from every thread of the block: the block meets first.
__device__ __forceinline__ void signal(const Group& g, int j, int idx,
                                       unsigned long long val) {
  __syncthreads();
  if (threadIdx.x == 0) {
    fence();
    st_release_sys(flags(g, j) + idx, val);
  }
}

__device__ __forceinline__ void record_timeout(const Group& g, int idx,
                                               unsigned long long want,
                                               unsigned long long seen) {
  if (atomicCAS(reinterpret_cast<unsigned long long*>(g.err + 3), 0ull,
                1ull) == 0ull) {
    g.err[0] = idx;
    g.err[1] = (long long)want;
    g.err[2] = (long long)seen;
  }
}

// Spin (one thread) until this rank's flag `idx` reaches `want`, or the
// deadline. Returns false on timeout, having written the error word.
__device__ __forceinline__ bool spin(const Group& g, int idx,
                                     unsigned long long want) {
  const unsigned long long* f = flags(g, g.rank) + idx;
  unsigned long long seen = ld_acquire_sys(f);
  if (seen >= want) return true;
  const unsigned long long t0 = globaltimer();
  while (seen < want) {
    if ((long long)(globaltimer() - t0) > g.timeout_ns) {
      record_timeout(g, idx, want, seen);
      return false;
    }
    __nanosleep(100);
    seen = ld_acquire_sys(f);
  }
  return true;
}

// Wait for the flags base + j, one from every peer j != rank (thread j
// spins on its own), then meet.
__device__ __forceinline__ bool wait_peers(const Group& g, int base,
                                           unsigned long long want) {
  int ok = 1;
  const int j = threadIdx.x;
  if (j < g.n && j != g.rank) ok = spin(g, base + j, want);
  return __syncthreads_and(ok) != 0;
}

// Tell every peer j that this block reached epoch: flag base + rank of
// each peer's pad. Call from every thread.
__device__ __forceinline__ void signal_peers(const Group& g, int base,
                                             unsigned long long val) {
  __syncthreads();
  const int j = threadIdx.x;
  if (j < g.n && j != g.rank) {
    fence();
    st_release_sys(flags(g, j) + base + g.rank, val);
  }
}

// This block's share [v0, v1) of `nvec` 16-byte vectors.
__device__ __forceinline__ void block_range(long long nvec, long long* v0,
                                            long long* v1) {
  const long long per = (nvec + gridDim.x - 1) / gridDim.x;
  *v0 = min(nvec, per * blockIdx.x);
  *v1 = min(nvec, *v0 + per);
}

// putmem: copy vectors [v0, v1) of src to dst (either may be a peer's),
// 16 bytes a thread, neighbouring threads on neighbouring addresses.
__device__ __forceinline__ void put(uint4* dst, const uint4* src,
                                    long long v0, long long v1) {
  for (long long v = v0 + threadIdx.x; v < v1; v += blockDim.x)
    dst[v] = __ldcg(src + v);
}

// Elements of T in one 16-byte vector.
template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
};

template <typename T>
__device__ __forceinline__ const T* elems(const uint4& v) {
  return reinterpret_cast<const T*>(&v);
}

// Sum the n slots of `ws` (slot stride `slot_vec` vectors) over vectors
// [v0, v1): fp32 from 0, rank order, one cast — ops/allreduce.py:91
// _reduce_slots. Threads tid of nthreads share the vectors.
template <typename T>
__device__ __forceinline__ void reduce_slots_part(const uint4* ws,
                                                  long long slot_vec, int n,
                                                  uint4* out, long long v0,
                                                  long long v1, int tid,
                                                  int nthreads) {
  constexpr int E = Vec<T>::N;
  for (long long v = v0 + tid; v < v1; v += nthreads) {
    float acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.0f;
    for (int i = 0; i < n; ++i) {
      const uint4 s = __ldcg(ws + i * slot_vec + v);
      const T* se = elems<T>(s);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = acc[e] + tdt::to_f(se[e]);
    }
    uint4 o;
    T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
    for (int e = 0; e < E; ++e) oe[e] = tdt::from_f<T>(acc[e]);
    out[v] = o;
  }
}

// reduce_slots_part over the whole block.
template <typename T>
__device__ __forceinline__ void reduce_slots(const uint4* ws,
                                             long long slot_vec, int n,
                                             uint4* out, long long v0,
                                             long long v1) {
  reduce_slots_part<T>(ws, slot_vec, n, out, v0, v1, threadIdx.x,
                       blockDim.x);
}

// Tell every rank j (this one included) that this block reached `val`:
// flag idx of each rank's pad. Call from every thread.
__device__ __forceinline__ void signal_all(const Group& g, int idx,
                                           unsigned long long val) {
  __syncthreads();
  const int j = threadIdx.x;
  if (j < g.n) {
    fence();
    st_release_sys(flags(g, j) + idx, val);
  }
}

// Wait for `rows` x `count` flags of this rank's pad: base + i * stride + c
// for i < rows, c < count (the block's threads share them), then meet.
// False for every thread on timeout.
__device__ __forceinline__ bool wait_flags(const Group& g, int base,
                                           int rows, int stride, int count,
                                           unsigned long long want) {
  int ok = 1;
  for (int t = threadIdx.x; t < rows * count && ok; t += blockDim.x)
    ok = spin(g, base + (t / count) * stride + t % count, want);
  return __syncthreads_and(ok) != 0;
}

}  // namespace dist
}  // namespace tdt
