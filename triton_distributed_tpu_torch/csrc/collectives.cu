// The collective kernels of the tensor-parallel path, on dist.cuh.
//
// Each replaces one TPU kernel of the JAX package and computes what it
// computes, in the same order and rounding (the replicas must end with
// bit-identical sums, or their greedy tokens diverge):
//
//  ar_one_shot   ops/allreduce.py:68 _ar_one_shot_kernel — barrier, push
//                this rank's block into slot `rank` of every peer's
//                workspace, wait for the n-1 deliveries, sum the n slots
//                in rank order 0..n-1 in fp32 from 0, cast once.
//  ar_parity     ops/allreduce.py:104 _ar_one_shot_parity_kernel — the
//                same without the barrier, over a persistent workspace
//                of two parity slabs and per-parity flags (the decode
//                path's repeated calls; safety argument in
//                ops/allreduce.all_reduce_stream).
//  rs_ring       ops/reduce_scatter.py:52 _rs_ring_kernel — ring reduce-
//                scatter: chunk c starts at rank c+1 and gains one
//                contribution a hop, added in the payload type (one
//                rounding a hop), and lands summed at its owner.
//  ag_ring       ops/allgather.py:91 _ag_ring_kernel — ring all-gather
//                through a symmetric gather buffer that doubles as the
//                transport; each rank forwards the chunk it received
//                last step, then copies the gathered buffer out.
//  ag_full_mesh  ops/allgather.py:66 _ag_full_mesh_push_kernel — on the
//                push protocol of push.cuh: every rank publishes its
//                fresh output to every peer, then writes its chunk
//                straight into slot `rank` of every rank's output (its
//                own first, then me+1 ... me-1; the chunk read once,
//                written n times), and waits for the n-1 peers' data
//                flags: one hop, no gather buffer, no copy out, no entry
//                barrier; the ring's output bit for bit (a copy has no
//                rounding). Its grid is the copy engine's (at most 1/r of
//                the SMs), not kMaxBlocks.
//  ag_parity     ops/allgather.py:192 _ag_parity_kernel — the full-mesh
//                push without the barrier, over a persistent workspace of
//                two parity slabs and per-parity flags (the SP decode
//                loop's repeated gathers of its attention partials; the
//                same safety argument as ar_parity, in
//                ops/allgather.all_gather_stream).
//  ar_tree       ops/allreduce.py:169 _ar_tree_kernel — the double
//                binary tree: tree 0 the heap over rank order, tree 1
//                over reversed ranks, each owning half of the rows (rows
//                [0, ceil(m/2)) and the rest; one tree of every row at
//                m = 1). Leaves push their rows to the parent; an
//                interior node adds its own rows, then child 2p+1's,
//                then child 2p+2's in fp32 and rounds to the payload
//                type once (one rounding a level) before it pushes up;
//                the root's sum is broadcast down the same tree. Phases
//                run leaf sends (both trees), interior reduces (both),
//                broadcasts (both), so a node that is a leaf of one tree
//                and interior in the other keeps both in flight.
//
// What bounds them: bytes. Each is a copy with at most an add per
// element, far below the card's 295 operations a byte; on n cards the
// pushes cross NVLink (450 GB/s a direction), on one card with virtual
// ranks every byte goes through the one card's HBM. Small payloads (a
// decode step's 4 rows) are bound by latency instead: the flag round
// trips, and the launch. The design moves 16 bytes a thread with
// neighbouring threads on neighbouring addresses, and splits the payload
// over a few blocks (at most kMaxBlocks), each of which synchronises only
// with the same block of its peers — no grid-wide barrier, and a small
// grid, so virtual ranks on one card never starve each other of SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "dist.cuh"
#include "push.cuh"

using tdt::from_f;
using tdt::to_f;
using namespace tdt::dist;

namespace {

// dst = a + b over vectors [v0, v1), added in T (one rounding an add) —
// ops/reduce_scatter.py:35 _tiled_add.
template <typename T>
__device__ __forceinline__ void add_into(uint4* dst, const uint4* a,
                                         const uint4* b, long long v0,
                                         long long v1) {
  constexpr int E = Vec<T>::N;
  for (long long v = v0 + threadIdx.x; v < v1; v += blockDim.x) {
    const uint4 x = __ldcg(a + v);
    const uint4 y = __ldcg(b + v);
    const T* xe = elems<T>(x);
    const T* ye = elems<T>(y);
    uint4 o;
    T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
    for (int e = 0; e < E; ++e) oe[e] = from_f<T>(to_f(xe[e]) + to_f(ye[e]));
    dst[v] = o;
  }
}

// Push this block's vectors of x into slot `slot` of every rank's
// workspace (this rank's own first: the local copy), then tell each peer.
__device__ __forceinline__ void push_all(const Group& g, const uint4* x,
                                         long long ws_off_bytes,
                                         long long v0, long long v1,
                                         int flag_base,
                                         unsigned long long val) {
  for (int i = 0; i < g.n; ++i) {
    const int j = (g.rank + i) % g.n;
    uint4* dst = reinterpret_cast<uint4*>(peer_base(g, j) + ws_off_bytes);
    put(dst, x, v0, v1);
  }
  signal_peers(g, flag_base, val);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ar_one_shot_kernel(Group g, const uint4* x, uint4* out, long long nvec) {
  long long v0, v1;
  block_range(nvec, &v0, &v1);
  if (!barrier_all(g)) return;
  const long long slot_bytes = nvec * 16;
  const int base = kStepBase + blockIdx.x * kMaxRanks;
  push_all(g, x, g.rank * slot_bytes, v0, v1, base, g.epoch);
  if (!wait_peers(g, base, g.epoch)) return;
  const uint4* ws = reinterpret_cast<const uint4*>(peer_base(g, g.rank));
  reduce_slots<T>(ws, nvec, g.n, out, v0, v1);
}

// g.epoch carries call_index + 1; the parity slab is call_index % 2.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ar_parity_kernel(Group g, const uint4* x, uint4* out, long long nvec) {
  long long v0, v1;
  block_range(nvec, &v0, &v1);
  const int p = (int)((g.epoch - 1) & 1);
  const long long slot_bytes = nvec * 16;
  const long long slab_bytes = slot_bytes * g.n;
  const int base = kStepBase + (p * kMaxBlocks + blockIdx.x) * kMaxRanks;
  push_all(g, x, p * slab_bytes + g.rank * slot_bytes, v0, v1, base,
           g.epoch);
  if (!wait_peers(g, base, g.epoch)) return;
  const uint4* ws = reinterpret_cast<const uint4*>(peer_base(g, g.rank) +
                                                   p * slab_bytes);
  reduce_slots<T>(ws, nvec, g.n, out, v0, v1);
}

// x: (n, chunk) of this rank's contributions; workspace: n-1 comm slots
// of one chunk; out: the summed chunk `rank`. Step s's flag of block b is
// kStepBase + s * kMaxBlocks + b, written by the left neighbour only.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    rs_ring_kernel(Group g, const uint4* x, uint4* out, long long cvec) {
  long long v0, v1;
  block_range(cvec, &v0, &v1);
  if (!barrier_all(g)) return;
  const int n = g.n;
  const int right = (g.rank + 1) % n;
  const uint4* comm = reinterpret_cast<const uint4*>(peer_base(g, g.rank));
  uint4* rcomm = reinterpret_cast<uint4*>(peer_base(g, right));
  for (int s = 0; s < n - 1; ++s) {
    const int c = (g.rank - 1 - s + 2 * n) % n;   // the chunk sent at s
    uint4* dst = rcomm + s * cvec;
    if (s == 0) {
      put(dst, x + c * cvec, v0, v1);
    } else {
      if (!wait(g, kStepBase + (s - 1) * kMaxBlocks + blockIdx.x, g.epoch))
        return;
      add_into<T>(dst, comm + (s - 1) * cvec, x + c * cvec, v0, v1);
    }
    signal(g, right, kStepBase + s * kMaxBlocks + blockIdx.x, g.epoch);
  }
  if (!wait(g, kStepBase + (n - 2) * kMaxBlocks + blockIdx.x, g.epoch))
    return;
  add_into<T>(out, comm + (n - 2) * cvec, x + g.rank * cvec, v0, v1);
}

// x: one chunk; the symmetric gather buffer and out: n chunks.
__global__ void __launch_bounds__(kThreads)
    ag_ring_kernel(Group g, const uint4* x, uint4* out, long long cvec) {
  long long v0, v1;
  block_range(cvec, &v0, &v1);
  if (!barrier_all(g)) return;
  const int n = g.n;
  const int right = (g.rank + 1) % n;
  uint4* buf = reinterpret_cast<uint4*>(peer_base(g, g.rank));
  uint4* rbuf = reinterpret_cast<uint4*>(peer_base(g, right));
  put(buf + g.rank * cvec, x, v0, v1);
  for (int s = 0; s < n - 1; ++s) {
    const int c = (g.rank - s + n) % n;   // own chunk at s = 0
    if (s > 0 &&
        !wait(g, kStepBase + (s - 1) * kMaxBlocks + blockIdx.x, g.epoch))
      return;
    __syncthreads();   // the own chunk's local copy, before it is read
    put(rbuf + c * cvec, buf + c * cvec, v0, v1);
    signal(g, right, kStepBase + s * kMaxBlocks + blockIdx.x, g.epoch);
  }
  if (!wait(g, kStepBase + (n - 2) * kMaxBlocks + blockIdx.x, g.epoch))
    return;
  for (int c = 0; c < n; ++c) put(out + c * cvec, buf + c * cvec, v0, v1);
}

// x: one chunk; out: n chunks, this rank's fresh output. Block 0 publishes
// out to every peer; every block writes its share of x into slot `rank` of
// every rank's output, signals each peer, and waits for the n-1 peers'
// shares of the same block. n = 1 is the loopback (force_kernel): the
// copy into its own slot.
template <bool SYS>
__global__ void __launch_bounds__(tdt::push::kThreads)
    ag_full_mesh_kernel(Group g, tdt::push::Layout L, const char* x,
                        char* out, long long chunk_bytes) {
  namespace pu = tdt::push;
  const int all = (1 << g.n) - 1;
  const int j = threadIdx.x;
  if (blockIdx.x == 0 && j < g.n && j != g.rank)
    pu::publish<SYS>(g, L, j, out);
  long long lo, hi;
  pu::share(chunk_bytes, &lo, &hi);
  if (!pu::push_share<SYS>(g, L, x, out, g.rank * chunk_bytes, all, lo, hi))
    return;
  if (threadIdx.x == 0) pu::signal_data<SYS>(g, L, all);
  pu::wait_data<SYS>(g, L, all);
}

// x: one chunk; the symmetric workspace: two parity slabs of n chunks; out:
// n chunks. g.epoch carries call_index + 1; the slab is call_index % 2.
__global__ void __launch_bounds__(kThreads)
    ag_parity_kernel(Group g, const uint4* x, uint4* out, long long cvec) {
  long long v0, v1;
  block_range(cvec, &v0, &v1);
  const int p = (int)((g.epoch - 1) & 1);
  const long long slab_bytes = cvec * 16 * g.n;
  const int base = kStepBase + (p * kMaxBlocks + blockIdx.x) * kMaxRanks;
  push_all(g, x, p * slab_bytes + g.rank * cvec * 16, v0, v1, base, g.epoch);
  if (!wait_peers(g, base, g.epoch)) return;
  const uint4* slab = reinterpret_cast<const uint4*>(peer_base(g, g.rank) +
                                                     p * slab_bytes);
  for (int c = 0; c < g.n; ++c) put(out + c * cvec, slab + c * cvec, v0, v1);
}

// The tree's flags (kStepBase on): per block, tree and kind — 0 and 1 a
// child's partial in slot 0 / 1, 2 the parent's broadcast.
__device__ __forceinline__ int tree_flag(int tree, int kind) {
  return kStepBase + (blockIdx.x * 2 + tree) * 3 + kind;
}

__device__ __forceinline__ int tree_pos(int rank, int n, int tree) {
  return tree == 0 ? rank : n - 1 - rank;
}

// x, out: (m, cols) as vectors, row_vec a row; the symmetric workspace:
// (n_trees, 3, mh0, cols) — slots 0 / 1 the children's partials, slot 2
// the broadcast. Tree t owns rows [t * mh0, min(m, (t + 1) * mh0)).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ar_tree_kernel(Group g, const uint4* x, uint4* out, long long row_vec,
                   int m, int n_trees) {
  if (!barrier_all(g)) return;
  const int n = g.n;
  const int mh0 = (m + n_trees - 1) / n_trees;
  const long long slot_vec = (long long)mh0 * row_vec;
  uint4* ws = reinterpret_cast<uint4*>(peer_base(g, g.rank));
  long long v0[2], v1[2], off[2];
  for (int t = 0; t < n_trees; ++t) {
    const int rows = min(m, (t + 1) * mh0) - t * mh0;
    off[t] = (long long)t * mh0 * row_vec;
    block_range((long long)rows * row_vec, &v0[t], &v1[t]);
  }
  auto slot = [&](int j, int t, int kind) {
    return reinterpret_cast<uint4*>(peer_base(g, j)) +
           (t * 3 + kind) * slot_vec;
  };
  // Leaf sends: child 2p+1 lands in the parent's slot 0, 2p+2 in slot 1.
  for (int t = 0; t < n_trees; ++t) {
    const int pos = tree_pos(g.rank, n, t);
    if (2 * pos + 1 < n) continue;
    const int parent = tree_pos((pos - 1) / 2, n, t);
    put(slot(parent, t, (pos + 1) % 2), x + off[t], v0[t], v1[t]);
    signal(g, parent, tree_flag(t, (pos + 1) % 2), g.epoch);
  }
  // Interior reduces: own rows + slot 0 (+ slot 1) in fp32, one cast.
  constexpr int E = Vec<T>::N;
  for (int t = 0; t < n_trees; ++t) {
    const int pos = tree_pos(g.rank, n, t);
    if (2 * pos + 1 >= n) continue;
    const bool has2 = 2 * pos + 2 < n;
    if (!wait(g, tree_flag(t, 0), g.epoch)) return;
    if (has2 && !wait(g, tree_flag(t, 1), g.epoch)) return;
    const uint4* w0 = ws + (t * 3) * slot_vec;
    const uint4* w1 = ws + (t * 3 + 1) * slot_vec;
    for (long long v = v0[t] + threadIdx.x; v < v1[t]; v += blockDim.x) {
      const uint4 a = __ldcg(x + off[t] + v);
      const uint4 b = __ldcg(w0 + v);
      float acc[E];
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[e] = to_f(elems<T>(a)[e]) + to_f(elems<T>(b)[e]);
      if (has2) {
        const uint4 c = __ldcg(w1 + v);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] = acc[e] + to_f(elems<T>(c)[e]);
      }
      uint4 o;
      T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int e = 0; e < E; ++e) oe[e] = from_f<T>(acc[e]);
      out[off[t] + v] = o;
    }
    if (pos != 0) {
      __syncthreads();
      const int parent = tree_pos((pos - 1) / 2, n, t);
      put(slot(parent, t, (pos + 1) % 2), out + off[t], v0[t], v1[t]);
      signal(g, parent, tree_flag(t, (pos + 1) % 2), g.epoch);
    }
  }
  // Broadcast down: the root's rows, copied by each node to its children.
  for (int t = 0; t < n_trees; ++t) {
    const int pos = tree_pos(g.rank, n, t);
    if (pos != 0) {
      if (!wait(g, tree_flag(t, 2), g.epoch)) return;
      put(out + off[t], ws + (t * 3 + 2) * slot_vec, v0[t], v1[t]);
      __syncthreads();
    }
    for (int c = 2 * pos + 1; c <= 2 * pos + 2 && c < n; ++c) {
      const int child = tree_pos(c, n, t);
      put(slot(child, t, 2), out + off[t], v0[t], v1[t]);
      signal(g, child, tree_flag(t, 2), g.epoch);
    }
  }
}

// Holds a stream for `ns` nanoseconds: the straggler of the parity test.
__global__ void spin_kernel(long long ns) {
  const unsigned long long t0 = globaltimer();
  while ((long long)(globaltimer() - t0) < ns) __nanosleep(1000);
}

// Holds a stream until the host sets `*go` (a pinned word every rank's
// hold polls, so the streams are released at one instant), or `ns`
// nanoseconds passed: the timing hold of a collective measurement.
__global__ void hold_kernel(const volatile int* go, long long ns) {
  const unsigned long long t0 = globaltimer();
  while (*go == 0 && (long long)(globaltimer() - t0) < ns) __nanosleep(200);
}

int grid_for(long long nvec) {
  // A block per 1024 vectors (16 KiB), 1..kMaxBlocks. The same payload
  // gives the same grid on every rank, which the per-block flags need.
  long long g = (nvec + 1023) / 1024;
  return (int)(g < 1 ? 1 : (g > kMaxBlocks ? kMaxBlocks : g));
}

bool bad_group(int rank, int n, long long nvec) {
  return n < 1 || n > kMaxRanks || rank < 0 || rank >= n || nvec < 1;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16. nbytes: one rank's payload (a multiple of
// 16; pointers 16-byte aligned). Every entry returns its cudaError_t.
int tdt_ar_one_shot(const void* table, const void* sig_table, void* err,
                    int rank, int n, unsigned long long epoch,
                    long long timeout_ns, const void* x, void* out,
                    long long nbytes, int dtype, cudaStream_t stream) {
  const long long nvec = nbytes / 16;
  if (bad_group(rank, n, nvec) || nbytes % 16) return cudaErrorInvalidValue;
  const Group g = make_group(table, sig_table, err, rank, n, epoch,
                             timeout_ns);
  const dim3 grid(grid_for(nvec)), block(kThreads);
  const uint4* xi = static_cast<const uint4*>(x);
  uint4* o = static_cast<uint4*>(out);
  if (dtype == 0)
    ar_one_shot_kernel<float><<<grid, block, 0, stream>>>(g, xi, o, nvec);
  else if (dtype == 1)
    ar_one_shot_kernel<__nv_bfloat16><<<grid, block, 0, stream>>>(g, xi, o,
                                                                  nvec);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

int tdt_ar_parity(const void* table, const void* sig_table, void* err,
                  int rank, int n, unsigned long long call_index,
                  long long timeout_ns, const void* x, void* out,
                  long long nbytes, int dtype, cudaStream_t stream) {
  const long long nvec = nbytes / 16;
  if (bad_group(rank, n, nvec) || nbytes % 16) return cudaErrorInvalidValue;
  const Group g = make_group(table, sig_table, err, rank, n, call_index + 1,
                             timeout_ns);
  const dim3 grid(grid_for(nvec)), block(kThreads);
  const uint4* xi = static_cast<const uint4*>(x);
  uint4* o = static_cast<uint4*>(out);
  if (dtype == 0)
    ar_parity_kernel<float><<<grid, block, 0, stream>>>(g, xi, o, nvec);
  else if (dtype == 1)
    ar_parity_kernel<__nv_bfloat16><<<grid, block, 0, stream>>>(g, xi, o,
                                                                nvec);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// chunk_bytes: one output chunk (x holds n of them).
int tdt_rs_ring(const void* table, const void* sig_table, void* err,
                int rank, int n, unsigned long long epoch,
                long long timeout_ns, const void* x, void* out,
                long long chunk_bytes, int dtype, cudaStream_t stream) {
  const long long cvec = chunk_bytes / 16;
  if (bad_group(rank, n, cvec) || n < 2 || chunk_bytes % 16)
    return cudaErrorInvalidValue;
  const Group g = make_group(table, sig_table, err, rank, n, epoch,
                             timeout_ns);
  const dim3 grid(grid_for(cvec)), block(kThreads);
  const uint4* xi = static_cast<const uint4*>(x);
  uint4* o = static_cast<uint4*>(out);
  if (dtype == 0)
    rs_ring_kernel<float><<<grid, block, 0, stream>>>(g, xi, o, cvec);
  else if (dtype == 1)
    rs_ring_kernel<__nv_bfloat16><<<grid, block, 0, stream>>>(g, xi, o, cvec);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// chunk_bytes: one input chunk (out holds n of them).
int tdt_ag_ring(const void* table, const void* sig_table, void* err,
                int rank, int n, unsigned long long epoch,
                long long timeout_ns, const void* x, void* out,
                long long chunk_bytes, cudaStream_t stream) {
  const long long cvec = chunk_bytes / 16;
  if (bad_group(rank, n, cvec) || n < 2 || chunk_bytes % 16)
    return cudaErrorInvalidValue;
  const Group g = make_group(table, sig_table, err, rank, n, epoch,
                             timeout_ns);
  ag_ring_kernel<<<grid_for(cvec), kThreads, 0, stream>>>(
      g, static_cast<const uint4*>(x), static_cast<uint4*>(out), cvec);
  return cudaGetLastError();
}

// chunk_bytes: one input chunk (out, this rank's fresh output, holds n of
// them). grid, sys (the flags' scope: 1 when a peer is another card) and
// the pad layout (addr, ready, data, stride) come from the host
// (ops/_comm.launch_push), the same on every rank. n = 1 is the loopback
// (force_kernel).
int tdt_ag_full_mesh(const void* table, const void* sig_table, void* err,
                     int rank, int n, unsigned long long epoch,
                     long long timeout_ns, const void* x, void* out,
                     long long chunk_bytes, int grid, int sys, int addr,
                     int ready, int data, int stride, cudaStream_t stream) {
  const long long cvec = chunk_bytes / 16;
  const tdt::push::Layout L{addr, ready, data, stride};
  if (bad_group(rank, n, cvec) || chunk_bytes % 16 ||
      tdt::push::bad_layout(L, n, grid))
    return cudaErrorInvalidValue;
  const Group g = make_group(table, sig_table, err, rank, n, epoch,
                             timeout_ns);
  const char* xi = static_cast<const char*>(x);
  char* o = static_cast<char*>(out);
  if (sys)
    ag_full_mesh_kernel<true><<<grid, tdt::push::kThreads, 0, stream>>>(
        g, L, xi, o, chunk_bytes);
  else
    ag_full_mesh_kernel<false><<<grid, tdt::push::kThreads, 0, stream>>>(
        g, L, xi, o, chunk_bytes);
  return cudaGetLastError();
}

// chunk_bytes: one input chunk (out holds n of them). n = 1 is the
// loopback (force_kernel): the push to itself and the copy out.
int tdt_ag_parity(const void* table, const void* sig_table, void* err,
                  int rank, int n, unsigned long long call_index,
                  long long timeout_ns, const void* x, void* out,
                  long long chunk_bytes, cudaStream_t stream) {
  const long long cvec = chunk_bytes / 16;
  if (bad_group(rank, n, cvec) || chunk_bytes % 16)
    return cudaErrorInvalidValue;
  const Group g = make_group(table, sig_table, err, rank, n, call_index + 1,
                             timeout_ns);
  ag_parity_kernel<<<grid_for(cvec), kThreads, 0, stream>>>(
      g, static_cast<const uint4*>(x), static_cast<uint4*>(out), cvec);
  return cudaGetLastError();
}

// row_bytes: one payload row (a multiple of 16); rows: m; n_trees: 2 (the
// double tree) or 1.
int tdt_ar_tree(const void* table, const void* sig_table, void* err,
                int rank, int n, unsigned long long epoch,
                long long timeout_ns, const void* x, void* out,
                long long row_bytes, int rows, int n_trees, int dtype,
                cudaStream_t stream) {
  const long long row_vec = row_bytes / 16;
  if (bad_group(rank, n, row_vec) || n < 2 || row_bytes % 16 || rows < 1 ||
      n_trees < 1 || n_trees > 2 || n_trees > rows)
    return cudaErrorInvalidValue;
  const Group g = make_group(table, sig_table, err, rank, n, epoch,
                             timeout_ns);
  const long long half = (long long)((rows + n_trees - 1) / n_trees) * row_vec;
  const dim3 grid(grid_for(half)), block(kThreads);
  const uint4* xi = static_cast<const uint4*>(x);
  uint4* o = static_cast<uint4*>(out);
  if (dtype == 0)
    ar_tree_kernel<float><<<grid, block, 0, stream>>>(g, xi, o, row_vec,
                                                      rows, n_trees);
  else if (dtype == 1)
    ar_tree_kernel<__nv_bfloat16><<<grid, block, 0, stream>>>(
        g, xi, o, row_vec, rows, n_trees);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

int tdt_spin(long long ns, cudaStream_t stream) {
  spin_kernel<<<1, 1, 0, stream>>>(ns);
  return cudaGetLastError();
}

// go: a page-locked host word (its host address: with unified addressing
// the card reads it there); ns: the deadline.
int tdt_hold(const void* go, long long ns, cudaStream_t stream) {
  hold_kernel<<<1, 1, 0, stream>>>(static_cast<const volatile int*>(go), ns);
  return cudaGetLastError();
}

// A non-blocking stream on `dev` for one rank. The rank group makes its
// streams one after another here, so each takes the next hardware queue
// (with CUDA_DEVICE_MAX_CONNECTIONS >= ranks + 1): two virtual ranks on
// one queue could deadlock, a rank's kernel waiting behind a peer's that
// waits for it.
int tdt_stream_create(int dev, void** out) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(dev);
  if (err == cudaSuccess) {
    cudaStream_t s;
    err = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
    if (err == cudaSuccess) *out = s;
  }
  cudaSetDevice(prev);
  return err;
}

int tdt_stream_destroy(void* stream) {
  return cudaStreamDestroy(static_cast<cudaStream_t>(stream));
}

// Let `dev` map `peer`'s memory; already enabled counts as success.
int tdt_enable_peer_access(int dev, int peer) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(dev);
  if (err == cudaSuccess) {
    err = cudaDeviceEnablePeerAccess(peer, 0);
    if (err == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();   // clear the error the call left behind
      err = cudaSuccess;
    }
  }
  cudaSetDevice(prev);
  return err;
}

}  // extern "C"
