// The push protocol and its copy engine: what B4's ring, full-mesh push
// and parity stream (collectives.cu ag_ring, ag_full_mesh, ag_parity),
// B5's one-shot, parity stream and double tree (collectives.cu
// ar_one_shot, ar_parity, ar_tree), B6's reduce-scatter (collectives.cu
// rs_ring), B7's shift and permutation (p2p.cu), B8's AllToAll in both
// forms (all_to_all.cu a2a, a2a_push) and B12's torus AllGather and
// AllReduce (multi_axis.cu ag_torus, ar_torus) share; B11's split-K route
// (gemm_comm.cu) takes its scoped flags (signal_word, spin).
//
// The protocol: the sender writes the receiver's output. A TPU kernel's
// remote DMA lands in the peer's output; here the output is a fresh tensor
// of the receiving rank, so the receiver tells its senders where it is:
//  - the receiver's block 0 stores its output's address into word
//    `addr + receiver` of each sender's signal pad, then (fence, release)
//    the call's epoch into word `ready + receiver`;
//  - a sender's block waits in its own pad for `ready + receiver` to reach
//    the epoch, reads the address, writes its share of the payload
//    straight into the output, and — its stores fenced — releases the
//    epoch into word `data + sender * stride + block` of the receiver's
//    pad;
//  - the receiver's block b waits for `data + src * stride + b` of each of
//    its sources, and the kernel ends with the output whole.
// The output is fresh every call, so no payload buffer is reused and no
// entry barrier is needed. The reused words are the pad's, and the epoch
// guards them: a sender of call t+1 reads an address only after the
// receiver's ready flag reached t+1, which the receiver stores after the
// new address; and the receiver reaches call t+1 only after every source
// signalled call t's data, i.e. after each one read call t's address.
// Flags only grow (the host hands every call a larger epoch), so a stale
// flag never satisfies a wait. The layout (addr, ready, data, stride) is
// computed on the host (ops/_comm.PushLayout) and passed by value.
// Some kernels use the words otherwise. B12's torus AllGather indexes its
// data words by the output's slot, not by the sender (each slot of a
// receiver has one writer, on either hop). B5's tree keeps its own words
// (collectives.cu TreeLayout): a child's address in its parent's pad, and
// flags along the tree's edges. B6's reduce-scatter and B5's one-shot and
// parity stream mirror the roles: a rank publishes its INPUT, its owners
// (the one-shot: every rank, of the whole payload) read from it, and the
// data word `data + owner * stride + b` (in the source's pad) releases the
// input, which the source holds until every owner released it. B12's
// torus AR mirrors them twice, over its own words (multi_axis.cu
// TorusLayout): the input to the grid row, then a per-call mid to the
// grid column. B8's AllToAll publishes two addresses a receiver (its
// output and its splits: the second at word `splits + receiver`,
// ops/_comm.A2ALayout).
//
// The copy engine reads each source byte once and writes it to every
// destination (the push's n outputs, a multicast's destinations), over a
// grid the host sizes by the payload, at most 1/r of the SMs a rank (r
// ranks on the card) and the same on every rank; block b takes the b-th
// contiguous share. Every thread keeps kUnroll 16-byte loads in flight,
// then stores each to every destination: 32 KiB in flight a block, 1-2
// MiB a rank, where the first B4 / B7 kernels held 32 KiB a rank. TMA
// bulk copies through a shared-memory ring (`cp.async.bulk` global ->
// shared on an mbarrier, then shared -> global per destination) were
// measured beside this form and tied with it from 16 KiB to 16 MiB a rank
// (PERF.md §6); this form stays: it takes no shared memory, and it stores
// to a peer card's memory as well.
// The flags' memory scope is a template argument: the GPU's when the group
// lives on one card, the system's across cards (the host's pick). A
// timed-out wait writes the rank's error word (as dist.cuh's spin) and the
// block returns.

#pragma once

#include <cuda_runtime.h>

#include "dist.cuh"

namespace tdt {
namespace push {

using dist::Group;

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

// Word offsets in a rank's signal pad (64-bit words).
struct Layout {
  int addr;     // addr + j: receiver j's output address (sender's pad)
  int ready;    // ready + j: receiver j's epoch, after its address
  int data;     // data + src * stride + b: src's block b landed
  int stride;   // data words a source: at least the grid
};

// The host's layout and grid, checked against the pad: every word inside
// dist::kSignalWords, the three ranges apart.
inline bool bad_layout(const Layout& L, int n, int grid) {
  const int top = L.data + n * L.stride;
  return grid < 1 || L.stride < grid || L.addr < 0 ||
         L.ready < L.addr + n || L.data < L.ready + n ||
         top > dist::kSignalWords || n > dist::kMaxRanks;
}

// This block's contiguous share [lo, hi) of `nbytes` (whole 16-byte units).
__device__ __forceinline__ void share(long long nbytes, long long* lo,
                                      long long* hi) {
  long long v0, v1;
  dist::block_range(nbytes / 16, &v0, &v1);
  *lo = v0 * 16;
  *hi = v1 * 16;
}

// The flags' memory scope: the GPU's when the whole group lives on one card
// (virtual ranks), the system's when a peer is another card: on one card
// the system scope made every call slower.
template <bool SYS>
__device__ __forceinline__ void fence_to() {
  if (SYS)
    __threadfence_system();
  else
    __threadfence();
}

template <bool SYS>
__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  if (SYS)
    asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v)
                 : "memory");
  else
    asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
                 : "memory");
}

template <bool SYS>
__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  if (SYS)
    asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
                 : "=l"(v)
                 : "l"(p)
                 : "memory");
  else
    asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
                 : "=l"(v)
                 : "l"(p)
                 : "memory");
  return v;
}

// dist::spin at the flags' scope: until this rank's flag `idx` reaches
// `want`, or the deadline (the error word written, false).
template <bool SYS>
__device__ __forceinline__ bool spin(const Group& g, int idx,
                                     unsigned long long want) {
  const unsigned long long* f = dist::flags(g, g.rank) + idx;
  unsigned long long seen = ld_acquire<SYS>(f);
  if (seen >= want) return true;
  const unsigned long long t0 = dist::globaltimer();
  while (seen < want) {
    if ((long long)(dist::globaltimer() - t0) > g.timeout_ns) {
      dist::record_timeout(g, idx, want, seen);
      return false;
    }
    __nanosleep(100);
    seen = ld_acquire<SYS>(f);
  }
  return true;
}

// Receiver side: store `out` into word `addr` of rank j's pad, then
// release the call's epoch into word `ready` there. One thread.
template <bool SYS>
__device__ __forceinline__ void publish_at(const Group& g, int j, int addr,
                                           int ready, const void* out) {
  unsigned long long* pad = dist::flags(g, j);
  *reinterpret_cast<volatile unsigned long long*>(pad + addr) =
      reinterpret_cast<unsigned long long>(out);
  fence_to<SYS>();
  st_release<SYS>(pad + ready, g.epoch);
}

// Receiver side: tell sender j where this rank's output is. One thread.
template <bool SYS>
__device__ __forceinline__ void publish(const Group& g, const Layout& L,
                                        int j, const void* out) {
  publish_at<SYS>(g, j, L.addr + g.rank, L.ready + g.rank, out);
}

// Sender side: the address in word `addr` of this rank's pad once word
// `ready` reached the call's epoch, or nullptr on a timeout. One thread.
template <bool SYS>
__device__ __forceinline__ char* await_at(const Group& g, int addr,
                                          int ready) {
  if (!spin<SYS>(g, ready, g.epoch)) return nullptr;
  return reinterpret_cast<char*>(
      *reinterpret_cast<volatile unsigned long long*>(
          dist::flags(g, g.rank) + addr));
}

// Sender side: the output address receiver j published for this call, or
// nullptr on a timeout. One thread.
template <bool SYS>
__device__ __forceinline__ char* await_dest(const Group& g, const Layout& L,
                                            int j) {
  return await_at<SYS>(g, L.addr + j, L.ready + j);
}

// Wait until word `idx` of this rank's pad reaches the call's epoch (one
// thread spins), then meet. False for every thread on a timeout.
template <bool SYS>
__device__ __forceinline__ bool wait_word(const Group& g, int idx) {
  int ok = 1;
  if (threadIdx.x == 0) ok = spin<SYS>(g, idx, g.epoch);
  return __syncthreads_and(ok) != 0;
}

// Release the call's epoch into word `idx` of rank j's pad, after this
// thread's earlier stores (fenced: the block met past its stores first).
template <bool SYS>
__device__ __forceinline__ void signal_word(const Group& g, int j, int idx) {
  fence_to<SYS>();
  st_release<SYS>(dist::flags(g, j) + idx, g.epoch);
}

// Sender side, once the block's threads have met past their stores: tell
// every rank of `mask` but this one that block b's share landed. One
// thread; its fence orders the block's stores before the flags.
template <bool SYS>
__device__ __forceinline__ void signal_data(const Group& g, const Layout& L,
                                            int mask) {
  fence_to<SYS>();
  for (int j = 0; j < g.n; ++j)
    if ((mask >> j & 1) && j != g.rank)
      st_release<SYS>(
          dist::flags(g, j) + L.data + g.rank * L.stride + blockIdx.x,
          g.epoch);
}

// Receiver side: wait for block b's share from every source of `mask` but
// this rank, then meet. False for every thread on a timeout.
template <bool SYS>
__device__ __forceinline__ bool wait_data(const Group& g, const Layout& L,
                                          int mask) {
  int ok = 1;
  const int j = threadIdx.x;
  if (j < g.n && (mask >> j & 1) && j != g.rank)
    ok = spin<SYS>(g, L.data + j * L.stride + blockIdx.x, g.epoch);
  return __syncthreads_and(ok) != 0;
}

// Vectors [v0, v1) of src to each of `nd` destinations, kUnroll 16-byte
// loads in flight a thread. Every thread of the block. kL2: src was
// written during this launch (by a peer, behind a flag this block
// acquired), so it is read through L2 (ld.global.cg), not the read-only
// path, which holds only what stays unchanged for the whole launch.
template <bool kL2 = false>
__device__ __forceinline__ void fan_out(const uint4* src,
                                        uint4* const* dst, int nd,
                                        long long v0, long long v1) {
  const long long T = blockDim.x;
  for (long long base = v0 + threadIdx.x; base < v1; base += T * kUnroll) {
    uint4 r[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long v = base + k * T;
      if (v < v1) r[k] = kL2 ? __ldcg(src + v) : __ldg(src + v);
    }
    for (int d = 0; d < nd; ++d) {
      uint4* o = dst[d];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const long long v = base + k * T;
        if (v < v1) o[v] = r[k];
      }
    }
  }
}

// One block's share [lo, hi) of this rank's payload `x`, written at byte
// `off` of every destination of `mask`: its own `out` for this rank, else
// the output the receiver published. Returns false for every thread on a
// timeout (the error word written). On return the block's stores are
// issued and its threads have met; the caller fences and signals.
template <bool SYS>
__device__ __forceinline__ bool push_share(const Group& g, const Layout& L,
                                           const char* x, char* out,
                                           long long off, int mask,
                                           long long lo, long long hi) {
  __shared__ char* base[dist::kMaxRanks];
  __shared__ char* dst[dist::kMaxRanks];
  __shared__ int nd;
  // Thread j resolves destination j.
  int ok = 1;
  const int j = threadIdx.x;
  if (j < g.n) {
    char* b = nullptr;
    if (mask >> j & 1) {
      b = j == g.rank ? out : await_dest<SYS>(g, L, j);
      ok = b != nullptr;
    }
    base[j] = b;
  }
  if (!__syncthreads_and(ok)) return false;
  if (threadIdx.x == 0) {
    // This rank's own destination first, then me+1 ... me-1.
    int k = 0;
    for (int i = 0; i < g.n; ++i) {
      const int d = (g.rank + i) % g.n;
      if (base[d] != nullptr) dst[k++] = base[d] + off;
    }
    nd = k;
  }
  __syncthreads();
  fan_out(reinterpret_cast<const uint4*>(x),
          reinterpret_cast<uint4* const*>(dst), nd, lo / 16, hi / 16);
  __syncthreads();
  return true;
}

// Vectors [v0, v1) of the n operands src[0..n-1] summed in that order into
// out, kUnroll loads of one operand in flight a thread, through L2 (a
// peer's input, behind the flag this block acquired). kOnce = false: each
// add in fp32, rounded to T (one rounding an add, as the ring's hops:
// ops/reduce_scatter.py:35 _tiled_add's chain; B6). kOnce = true: fp32
// from 0, rounded to T once (ops/allreduce.py:91 _reduce_slots; 0 + (-0)
// is +0; B5's one-shot and parity stream, each phase of B12's torus AR).
template <typename T, bool kOnce>
__device__ __forceinline__ void ordered_sum(const uint4* const* src, int n,
                                            uint4* out, long long v0,
                                            long long v1) {
  constexpr int E = dist::Vec<T>::N;
  constexpr int U = kUnroll;
  const long long TB = blockDim.x;
  for (long long base = v0 + threadIdx.x; base < v1; base += TB * U) {
    uint4 a[U], b[U];
    float acc[kOnce ? U : 1][kOnce ? E : 1];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const long long v = base + k * TB;
      if (v < v1) a[k] = __ldcg(src[0] + v);
    }
    if constexpr (kOnce) {
#pragma unroll
      for (int k = 0; k < U; ++k)
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[k][e] = 0.0f + to_f(dist::elems<T>(a[k])[e]);
    }
    for (int s = 1; s < n; ++s) {
      const uint4* p = src[s];
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const long long v = base + k * TB;
        if (v < v1) b[k] = __ldcg(p + v);
      }
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const T* be = dist::elems<T>(b[k]);
        if constexpr (kOnce) {
#pragma unroll
          for (int e = 0; e < E; ++e) acc[k][e] = acc[k][e] + to_f(be[e]);
        } else {
          T* ae = reinterpret_cast<T*>(&a[k]);
#pragma unroll
          for (int e = 0; e < E; ++e)
            ae[e] = from_f<T>(to_f(ae[e]) + to_f(be[e]));
        }
      }
    }
    if constexpr (kOnce) {
#pragma unroll
      for (int k = 0; k < U; ++k) {
        T* ae = reinterpret_cast<T*>(&a[k]);
#pragma unroll
        for (int e = 0; e < E; ++e) ae[e] = from_f<T>(acc[k][e]);
      }
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const long long v = base + k * TB;
      if (v < v1) out[v] = a[k];
    }
  }
}

// Zeros over bytes [lo, hi) of out (a rank that receives nothing).
__device__ __forceinline__ void zero_share(char* out, long long lo,
                                           long long hi) {
  uint4* o = reinterpret_cast<uint4*>(out);
  const uint4 z = make_uint4(0, 0, 0, 0);
  for (long long v = lo / 16 + threadIdx.x; v < hi / 16; v += blockDim.x)
    o[v] = z;
}

}  // namespace push
}  // namespace tdt
