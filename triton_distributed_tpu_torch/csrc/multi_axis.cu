// The collectives that drive both axes of a 2-axis rank group in one
// kernel (kernel B12), on dist.cuh.
//
//  ag_torus  ops/multi_axis.py:60 _ag_torus_kernel — the ring-of-rings
//            AllGather over an (n0, n1) grid, global rank g = a·n1 + b:
//            shard (a, b) lands at rows [(a·n1 + b)·m, ...) of every
//            rank's output. Barrier; every rank pushes its own shard into
//            slot g of each inner peer (a, j) and of each outer peer
//            (u, b); then, as each inner peer's shard (a, c) lands (a flag
//            per source class c, as the TPU kernel keeps x_recv_sems.at[t]),
//            it forwards that slot to its n0-1 outer peers (u, b). A rank
//            ends with n1-1 slots from its inner peers and (n0-1)·n1 from
//            its outer peers — every slot once —, waits for the outer
//            flags and copies the gathered buffer out. A copy: the result
//            is torch.cat of the shards in global rank order, bit for bit.
//  ar_torus  ops/multi_axis.py:169 _ar_one_shot_torus_kernel — the
//            hierarchical one-shot AllReduce. Phase 1 pushes x into slot b
//            of every inner peer's ws1 (n1 slots), waits for the n1-1
//            inner flags and sums the slots in order 0..n1-1 in fp32 from
//            0, cast once, into mid; phase 2 does the same along the outer
//            axis on mid, into ws0 (slot a) and then the output —
//            _reduce_slots' order and rounding, twice, so the result is
//            bit-identical to its plain version on every rank. The two
//            phases' flags stay apart.
//
// The TPU kernel pushes with remote DMA over both torus axes' links at
// once; here every push is a store through the group's peer-pointer table
// (NVLink across cards, HBM with virtual ranks on one card), and the
// overlap it buys — the outer pushes start as the inner slots land — is
// kept: a rank forwards a slot as soon as its flag arrives, not after the
// whole inner phase.
//
// What bounds them: bytes. ag_torus reads its shard once a peer and
// writes n0·n1 slots out; ar_torus reads n1 + n0 slots and writes two
// rows a peer. Each block handles a slice of the rows and synchronises
// only with the same block of its peers (per-block flags), over a small
// fixed grid, so virtual ranks on one card never starve each other of SMs.
//
// Flags (kStepBase on), per block, 16 words: [0, 8) indexed by the inner
// source (ag: class c; ar: phase 1's source b), [8, 16) by the outer
// source (ag: the slot a'·n1 + c; ar: phase 2's source a).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "dist.cuh"

using namespace tdt::dist;

namespace {

constexpr int kFlagsPerBlock = 16;
constexpr int kOuter = 8;

__device__ __forceinline__ int torus_base() {
  return kStepBase + blockIdx.x * kFlagsPerBlock;
}

// Store `val` into flag `idx` of rank `peer`: threads [0, count) each
// signal one (peer, idx) pair after the block's earlier stores. Call from
// every thread; `pick(t, &peer, &idx)` returns false to skip t.
template <typename Pick>
__device__ __forceinline__ void signal_some(const Group& g, int count,
                                            Pick pick,
                                            unsigned long long val) {
  __syncthreads();
  const int t = threadIdx.x;
  int peer, idx;
  if (t < count && pick(t, &peer, &idx)) {
    fence();
    st_release_sys(flags(g, peer) + idx, val);
  }
}

// Wait for this rank's flags base + t for the t in [0, count) that
// `want_t(t)` names (a thread each), then meet.
template <typename Want>
__device__ __forceinline__ bool wait_some(const Group& g, int base,
                                          int count, Want want_t,
                                          unsigned long long val) {
  int ok = 1;
  const int t = threadIdx.x;
  if (t < count && want_t(t)) ok = spin(g, base + t, val);
  return __syncthreads_and(ok) != 0;
}

__global__ void __launch_bounds__(kThreads)
    ag_torus_kernel(Group g, int n0, int n1, const uint4* x, uint4* out,
                    long long cvec) {
  long long v0, v1;
  block_range(cvec, &v0, &v1);
  if (!barrier_all(g)) return;
  const int a = g.rank / n1, b = g.rank % n1;
  const int base = torus_base();
  uint4* buf = reinterpret_cast<uint4*>(peer_base(g, g.rank));
  auto slot_of = [&](int j, int s) {
    return reinterpret_cast<uint4*>(peer_base(g, j)) + (long long)s * cvec;
  };
  // The own shard: the local slot, then each inner and each outer peer.
  put(buf + (long long)g.rank * cvec, x, v0, v1);
  for (int i = 1; i < n1; ++i)
    put(slot_of(a * n1 + (b + i) % n1, g.rank), x, v0, v1);
  for (int i = 1; i < n0; ++i)
    put(slot_of(((a + i) % n0) * n1 + b, g.rank), x, v0, v1);
  signal_some(
      g, n1 + n0,
      [&](int t, int* peer, int* idx) {
        if (t < n1) {
          if (t == b) return false;
          *peer = a * n1 + t;
          *idx = base + b;
        } else {
          const int u = t - n1;
          if (u == a) return false;
          *peer = u * n1 + b;
          *idx = base + kOuter + g.rank;
        }
        return true;
      },
      g.epoch);
  // Forward each inner shard to the outer peers as it lands, in the
  // inner ring's order (b-1, b-2, ...).
  for (int i = 1; i < n1; ++i) {
    const int c = (b - i + n1) % n1;
    const int s = a * n1 + c;
    if (!wait(g, base + c, g.epoch)) return;
    if (n0 < 2) continue;
    for (int u = 1; u < n0; ++u)
      put(slot_of(((a + u) % n0) * n1 + b, s), buf + (long long)s * cvec,
          v0, v1);
    signal_some(
        g, n0,
        [&](int t, int* peer, int* idx) {
          if (t == a) return false;
          *peer = t * n1 + b;
          *idx = base + kOuter + s;
          return true;
        },
        g.epoch);
  }
  // Every slot of the other rows of the grid, from the outer peers.
  if (!wait_some(g, base + kOuter, n0 * n1,
                 [&](int t) { return t / n1 != a; }, g.epoch))
    return;
  for (int s = 0; s < n0 * n1; ++s)
    put(out + (long long)s * cvec, buf + (long long)s * cvec, v0, v1);
}

// ws (symmetric): slots [0, n1) ws1, [n1, n1 + n0) ws0, slot n1 + n0 mid,
// each nvec vectors.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ar_torus_kernel(Group g, int n0, int n1, const uint4* x, uint4* out,
                    long long nvec) {
  long long v0, v1;
  block_range(nvec, &v0, &v1);
  if (!barrier_all(g)) return;
  const int a = g.rank / n1, b = g.rank % n1;
  const int base = torus_base();
  uint4* ws = reinterpret_cast<uint4*>(peer_base(g, g.rank));
  uint4* mid = ws + (long long)(n1 + n0) * nvec;
  auto slot_of = [&](int j, int s) {
    return reinterpret_cast<uint4*>(peer_base(g, j)) + (long long)s * nvec;
  };
  // Phase 1: one-shot along the inner axis into ws1, reduced into mid.
  for (int i = 0; i < n1; ++i)
    put(slot_of(a * n1 + (b + i) % n1, b), x, v0, v1);
  signal_some(
      g, n1,
      [&](int t, int* peer, int* idx) {
        if (t == b) return false;
        *peer = a * n1 + t;
        *idx = base + b;
        return true;
      },
      g.epoch);
  if (!wait_some(g, base, n1, [&](int t) { return t != b; }, g.epoch))
    return;
  reduce_slots<T>(ws, nvec, n1, mid, v0, v1);
  __syncthreads();
  // Phase 2: one-shot of mid along the outer axis into ws0, reduced out.
  for (int i = 0; i < n0; ++i)
    put(slot_of(((a + i) % n0) * n1 + b, n1 + a), mid, v0, v1);
  signal_some(
      g, n0,
      [&](int t, int* peer, int* idx) {
        if (t == a) return false;
        *peer = t * n1 + b;
        *idx = base + kOuter + a;
        return true;
      },
      g.epoch);
  if (!wait_some(g, base + kOuter, n0, [&](int t) { return t != a; },
                 g.epoch))
    return;
  reduce_slots<T>(ws + (long long)n1 * nvec, nvec, n0, out, v0, v1);
}

int grid_for(long long nvec) {
  // A block per 1024 vectors (16 KiB), 1..kMaxBlocks; the same payload
  // gives the same grid on every rank, which the per-block flags need.
  long long g = (nvec + 1023) / 1024;
  return (int)(g < 1 ? 1 : (g > kMaxBlocks ? kMaxBlocks : g));
}

bool bad_grid(int rank, int n, int n0, int n1, long long nvec) {
  return n0 < 2 || n1 < 2 || n0 * n1 != n || n > kMaxRanks || rank < 0 ||
         rank >= n || nvec < 1;
}

}  // namespace

extern "C" {

// chunk_bytes: one rank's shard (out holds n0·n1 of them); every entry
// returns its cudaError_t.
int tdt_ag_torus(const void* table, const void* sig_table, void* err,
                 int rank, int n, unsigned long long epoch,
                 long long timeout_ns, const void* x, void* out,
                 long long chunk_bytes, int n0, int n1, cudaStream_t stream) {
  const long long cvec = chunk_bytes / 16;
  if (bad_grid(rank, n, n0, n1, cvec) || chunk_bytes % 16)
    return cudaErrorInvalidValue;
  const Group g = make_group(table, sig_table, err, rank, n, epoch,
                             timeout_ns);
  ag_torus_kernel<<<grid_for(cvec), kThreads, 0, stream>>>(
      g, n0, n1, static_cast<const uint4*>(x), static_cast<uint4*>(out),
      cvec);
  return cudaGetLastError();
}

// nbytes: one rank's payload; dtype: 0 float32, 1 bfloat16.
int tdt_ar_torus(const void* table, const void* sig_table, void* err,
                 int rank, int n, unsigned long long epoch,
                 long long timeout_ns, const void* x, void* out,
                 long long nbytes, int n0, int n1, int dtype,
                 cudaStream_t stream) {
  const long long nvec = nbytes / 16;
  if (bad_grid(rank, n, n0, n1, nvec) || nbytes % 16)
    return cudaErrorInvalidValue;
  const Group g = make_group(table, sig_table, err, rank, n, epoch,
                             timeout_ns);
  const dim3 grid(grid_for(nvec)), block(kThreads);
  const uint4* xi = static_cast<const uint4*>(x);
  uint4* o = static_cast<uint4*>(out);
  if (dtype == 0)
    ar_torus_kernel<float><<<grid, block, 0, stream>>>(g, n0, n1, xi, o,
                                                       nvec);
  else if (dtype == 1)
    ar_torus_kernel<__nv_bfloat16><<<grid, block, 0, stream>>>(g, n0, n1,
                                                               xi, o, nvec);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // extern "C"
