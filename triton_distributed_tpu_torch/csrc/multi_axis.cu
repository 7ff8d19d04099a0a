// The collectives that drive both axes of a 2-axis rank group in one
// kernel (kernel B12).
//
//  ag_torus  ops/multi_axis.py:60 _ag_torus_kernel — the ring-of-rings
//            AllGather over an (n0, n1) grid, global rank g = a·n1 + b:
//            shard (a, b) lands at rows [(a·n1 + b)·m, ...) of every
//            rank's output. On the push protocol of push.cuh: each rank's
//            block 0 publishes its fresh output's address, with the
//            call's epoch, to the ranks that write into it (its inner
//            peers (a, j) and its outer peers (u, b)); every block reads
//            its share of the own shard once and writes it into slot g of
//            its own output and of those n1 + n0 - 2 peers' outputs; then,
//            in the inner ring's order (b-1, b-2, ...), as slot (a, c) of
//            its own output lands (a data word a slot and block, as the
//            TPU kernel keeps x_recv_sems.at[t]), it forwards that share
//            from its own output to its n0-1 outer peers' outputs. A rank
//            ends when all n-1 foreign slots landed. A copy: the result is
//            torch.cat of the shards in global rank order, bit for bit.
//            The route stays the rail-aligned two hops: in a two-tier
//            deployment the outer hop is the one between same-b ranks.
//  ar_torus  ops/multi_axis.py:169 _ar_one_shot_torus_kernel — the
//            hierarchical one-shot AllReduce, on dist.cuh. Phase 1 pushes
//            x into slot b of every inner peer's ws1 (n1 slots), waits for
//            the n1-1 inner flags and sums the slots in order 0..n1-1 in
//            fp32 from 0, cast once, into mid; phase 2 does the same along
//            the outer axis on mid, into ws0 (slot a) and then the output
//            — _reduce_slots' order and rounding, twice, so the result is
//            bit-identical to its plain version on every rank. The two
//            phases' flags stay apart.
//
// The TPU kernel pushes with remote DMA over both torus axes' links at
// once; here every push is a store through the group's pointers (NVLink
// across cards, HBM with virtual ranks on one card), and the overlap it
// buys — the outer pushes start as the inner slots land — is kept.
//
// What bounds them: bytes. ag_torus must read its shard once and write
// n0·n1 slots of its output; its route moves the inner shards twice (a
// forward reads its own output's slot once and writes it n0-1 times):
// at (2, 4) with 2 MiB shards, 2 + 16 + 6 = 24 MiB a rank, where the first
// B12 kernel moved ~64 (a gather buffer written, then read and copied
// out, and the shard re-read a destination). Safety without an entry
// barrier is push.cuh's: the output is fresh every call, so no payload
// buffer is reused; the pad's words are guarded by the epoch, and a rank
// reaches call t+1 only after every writer of its output signalled call
// t's slots, i.e. after each read call t's address. The forward hop reads
// the rank's own output, which holds slot (a, c)'s share once that slot's
// data word is acquired; it reads it through L2. ar_torus reads n1 + n0
// slots and writes two rows a peer. Each block synchronises only with the
// same block of its peers (per-block words): ag_torus over push_grid's
// blocks (a block per 64 KiB of the shard, at most 1/r of the SMs, the
// same on every rank), ar_torus over a small fixed grid.
//
// ar_torus's flags (kStepBase on), per block, 16 words: [0, 8) by phase
// 1's source b, [8, 16) by phase 2's source a.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "dist.cuh"
#include "push.cuh"

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

// x: one shard; out: this rank's fresh output, n0·n1 shards. The pad's
// data words are indexed by slot: data + s * stride + block.
template <bool SYS>
__global__ void __launch_bounds__(tdt::push::kThreads)
    ag_torus_kernel(Group g, tdt::push::Layout L, int n0, int n1,
                    const char* x, char* out, long long chunk_bytes) {
  namespace pu = tdt::push;
  const int a = g.rank / n1, b = g.rank % n1;
  const int j = threadIdx.x;
  // The ranks that write into this rank's output, and that it writes:
  // the same set, its row and its column of the grid.
  auto peer = [&](int r) {
    return r != g.rank && (r / n1 == a || r % n1 == b);
  };
  if (blockIdx.x == 0 && j < g.n && peer(j)) pu::publish<SYS>(g, L, j, out);
  long long lo, hi;
  pu::share(chunk_bytes, &lo, &hi);
  __shared__ char* base[kMaxRanks];
  __shared__ uint4* dst[kMaxRanks];
  int ok = 1;
  if (j < g.n) {
    char* p = nullptr;
    if (j == g.rank) {
      p = out;
    } else if (peer(j)) {
      p = pu::await_dest<SYS>(g, L, j);
      ok = p != nullptr;
    }
    base[j] = p;
  }
  if (!__syncthreads_and(ok)) return;
  // The own shard: this rank's slot, then the inner ring (b+1, ...), then
  // the outer ring (a+1, ...): read once, written n1 + n0 - 1 times.
  if (j == 0) {
    int k = 0;
    const long long off = (long long)g.rank * chunk_bytes;
    dst[k++] = reinterpret_cast<uint4*>(out + off);
    for (int i = 1; i < n1; ++i)
      dst[k++] = reinterpret_cast<uint4*>(base[a * n1 + (b + i) % n1] + off);
    for (int i = 1; i < n0; ++i)
      dst[k++] = reinterpret_cast<uint4*>(base[((a + i) % n0) * n1 + b] + off);
  }
  __syncthreads();
  pu::fan_out(reinterpret_cast<const uint4*>(x), dst, n1 + n0 - 1, lo / 16,
              hi / 16);
  __syncthreads();
  if (j < g.n && peer(j))
    pu::signal_word<SYS>(g, j, L.data + g.rank * L.stride + blockIdx.x);
  // Forward each inner slot to the outer peers as its share lands, in the
  // inner ring's order (b-1, b-2, ...).
  for (int i = 1; i < n1; ++i) {
    const int s = a * n1 + (b - i + n1) % n1;
    const long long off = (long long)s * chunk_bytes;
    if (!pu::wait_word<SYS>(g, L.data + s * L.stride + blockIdx.x)) return;
    if (j == 0)
      for (int u = 1; u < n0; ++u)
        dst[u - 1] = reinterpret_cast<uint4*>(
            base[((a + u) % n0) * n1 + b] + off);
    __syncthreads();
    pu::fan_out<true>(reinterpret_cast<const uint4*>(out + off), dst,
                      n0 - 1, lo / 16, hi / 16);
    __syncthreads();
    if (j > 0 && j < n0)
      pu::signal_word<SYS>(g, ((a + j) % n0) * n1 + b,
                           L.data + s * L.stride + blockIdx.x);
  }
  // Every slot of the other rows of the grid, from the outer peers.
  if (j < g.n && j / n1 != a)
    ok = pu::spin<SYS>(g, L.data + j * L.stride + blockIdx.x, g.epoch);
  __syncthreads_and(ok);
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
  // ar_torus: a block per 1024 vectors (16 KiB), 1..kMaxBlocks; the same
  // payload gives the same grid on every rank, which the per-block flags
  // need.
  long long g = (nvec + 1023) / 1024;
  return (int)(g < 1 ? 1 : (g > kMaxBlocks ? kMaxBlocks : g));
}

bool bad_grid(int rank, int n, int n0, int n1, long long nvec) {
  return n0 < 2 || n1 < 2 || n0 * n1 != n || n > kMaxRanks || rank < 0 ||
         rank >= n || nvec < 1;
}

}  // namespace

extern "C" {

// chunk_bytes: one rank's shard (out, this rank's fresh output, holds
// n0·n1 of them). grid, sys (the flags' scope: 1 when a peer is another
// card) and the pad layout (addr, ready, data, stride) come from the host
// (ops/_comm.launch_push), the same on every rank. Every entry returns its
// cudaError_t.
int tdt_ag_torus(const void* table, const void* sig_table, void* err,
                 int rank, int n, unsigned long long epoch,
                 long long timeout_ns, const void* x, void* out,
                 long long chunk_bytes, int n0, int n1, int grid, int sys,
                 int addr, int ready, int data, int stride,
                 cudaStream_t stream) {
  const tdt::push::Layout L{addr, ready, data, stride};
  if (bad_grid(rank, n, n0, n1, chunk_bytes / 16) || chunk_bytes % 16 ||
      tdt::push::bad_layout(L, n, grid))
    return cudaErrorInvalidValue;
  const Group g = make_group(table, sig_table, err, rank, n, epoch,
                             timeout_ns);
  const char* xi = static_cast<const char*>(x);
  char* o = static_cast<char*>(out);
  if (sys)
    ag_torus_kernel<true><<<grid, tdt::push::kThreads, 0, stream>>>(
        g, L, n0, n1, xi, o, chunk_bytes);
  else
    ag_torus_kernel<false><<<grid, tdt::push::kThreads, 0, stream>>>(
        g, L, n0, n1, xi, o, chunk_bytes);
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
