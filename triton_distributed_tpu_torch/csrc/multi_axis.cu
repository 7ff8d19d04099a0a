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
//            hierarchical one-shot AllReduce: each row a of the grid summed
//            over b in order (fp32 from 0, cast once) into a mid, then the
//            n0 mids summed over a the same way into the output —
//            _reduce_slots' order and rounding, twice, so the result is
//            bit-identical to its plain version on every rank. On the push
//            protocol with the roles mirrored (B5's one-shot, twice), over
//            the rail-aligned route the TPU kernel takes: block 0 of rank
//            (a, b) publishes its INPUT to its inner peers (a, j) and a
//            fresh per-call mid to its outer peers (u, b) (disjoint sets:
//            one address word a peer); block k reads share k of the n1
//            inputs of row a (its own locally, a peer's through L2 behind
//            the acquired ready word), sums it into mid share k, releases
//            each inner source and tells each outer peer that mid share k
//            is ready; then it waits for the outer peers' mid shares k,
//            sums the n0 mids (its own, the peers' through L2) into the
//            fresh output and releases each outer source. A block returns
//            only once its inner readers released its input share and its
//            outer readers its mid share: a caller may overwrite or free
//            its input, and the allocator reuse mid, when the kernel ends.
//            No entry barrier, slot workspace (the first kernel pushed x
//            and mid through an (n1 + n0 + 1, m, cols) symmetric buffer)
//            or system-scope flags on one card. The one-hop alternative
//            (every rank reads all n0·n1 inputs) would cross the outer
//            tier with n1 times the bytes, as ag_torus keeps its route.

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
// data word is acquired; it reads it through L2. ar_torus reads n1 inputs
// and n0 mids a rank and writes one mid and one output: at (2, 4) with 16
// rows, 6 x 128 KiB a rank; its phases are two flag hops, and across cards
// only the mid crosses the outer tier. Each block synchronises only with
// the same block of its peers (per-block words), over push_grid's blocks
// (ag_torus a block per 64 KiB of the shard, ar_torus per
// ops/_comm.AR_TORUS_BLOCK_BYTES of the payload; at most 1/r of the SMs,
// the same on every rank).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "dist.cuh"
#include "push.cuh"

using namespace tdt::dist;

namespace {

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

// ar_torus's words in a rank's signal pad (ops/_comm.TorusARLayout), for a
// peer j (global rank) and block k:
//   addr + j, ready + j        j's published input (j an inner peer) or mid
//                              (j an outer peer) and its epoch;
//   released + j * stride + k  inner reader j's block k released this
//                              rank's input share k;
//   mid_ready + j * stride + k outer peer j's mid share k is whole;
//   mid_released + j * stride + k  outer reader j's block k released this
//                              rank's mid share k.
// Three words go to one outer peer a block and call (its mid ready, this
// rank's release of its mid, and the publish's ready): their ranges apart.
struct TorusLayout {
  int addr;
  int ready;
  int released;
  int mid_ready;
  int mid_released;
  int stride;
};

// Every word inside the pad, the five ranges apart.
bool bad_torus_layout(const TorusLayout& L, int n, int grid) {
  return grid < 1 || L.stride < grid || L.addr < 0 ||
         L.ready < L.addr + n || L.released < L.ready + n ||
         L.mid_ready < L.released + n * L.stride ||
         L.mid_released < L.mid_ready + n * L.stride ||
         L.mid_released + n * L.stride > kSignalWords;
}

// x: this rank's payload (nbytes), published to its inner peers; mid: its
// fresh row sum, published to its outer peers; out: its fresh result.
// Block k takes share k of the payload, the same on every rank. Safe
// across calls as the one-shot: a reader of call t+1 reads a source's
// address only once the source's ready word reached t+1, which the source
// releases after storing its call-(t+1) address; and a source reaches call
// t+1 only after every reader's block released its call-t input and mid
// shares, each after its last load of them. A mid share is read only once
// its own mid-ready word reached the call's epoch.
template <typename T, bool SYS>
__global__ void __launch_bounds__(tdt::push::kThreads)
    ar_torus_kernel(Group g, TorusLayout L, int n0, int n1, const char* x,
                    char* mid, char* out, long long nbytes) {
  namespace pu = tdt::push;
  __shared__ const uint4* src[kMaxRanks];
  const int me = g.rank, a = me / n1, b = me % n1;
  const int j = threadIdx.x, k = blockIdx.x;
  const bool inner = j < g.n && j != me && j / n1 == a;
  const bool outer = j < g.n && j != me && j % n1 == b;
  if (k == 0 && (inner || outer))
    pu::publish_at<SYS>(g, j, L.addr + me, L.ready + me, inner ? x : mid);
  long long lo, hi;
  pu::share(nbytes, &lo, &hi);
  // Phase 1: thread c resolves input (a, c); the row summed in order.
  int ok = 1;
  if (j < n1) {
    const int s = a * n1 + j;
    const char* p = s == me ? x : pu::await_at<SYS>(g, L.addr + s,
                                                    L.ready + s);
    ok = p != nullptr;
    src[j] = reinterpret_cast<const uint4*>(p);
  }
  if (!__syncthreads_and(ok)) return;
  pu::ordered_sum<T, true>(src, n1, reinterpret_cast<uint4*>(mid), lo / 16,
                           hi / 16);
  // Every thread's loads returned and its mid stores are issued.
  __syncthreads();
  if (inner) pu::signal_word<SYS>(g, j, L.released + me * L.stride + k);
  if (outer) pu::signal_word<SYS>(g, j, L.mid_ready + me * L.stride + k);
  // Phase 2: thread u resolves mid (u, b) once its share k is whole; the
  // column summed in order.
  ok = 1;
  if (j < n0) {
    const int s = j * n1 + b;
    const char* p = mid;
    if (s != me) {
      p = nullptr;
      if (pu::spin<SYS>(g, L.mid_ready + s * L.stride + k, g.epoch))
        p = pu::await_at<SYS>(g, L.addr + s, L.ready + s);
      ok = p != nullptr;
    }
    src[j] = reinterpret_cast<const uint4*>(p);
  }
  if (!__syncthreads_and(ok)) return;
  pu::ordered_sum<T, true>(src, n0, reinterpret_cast<uint4*>(out), lo / 16,
                           hi / 16);
  __syncthreads();
  if (outer) pu::signal_word<SYS>(g, j, L.mid_released + me * L.stride + k);
  // Hold this rank's input and mid shares until their readers released
  // them.
  ok = 1;
  if (inner) ok = pu::spin<SYS>(g, L.released + j * L.stride + k, g.epoch);
  if (outer) ok = pu::spin<SYS>(g, L.mid_released + j * L.stride + k,
                                g.epoch);
  __syncthreads_and(ok);
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

// nbytes: one rank's payload (x, out and mid, this rank's fresh row sum,
// each hold it); dtype: 0 float32, 1 bfloat16. grid, sys and the pad
// layout (addr, ready, released, mid_ready, mid_released, stride) come
// from the host (ops/_comm.TorusARLayout, launch_push), the same on every
// rank.
int tdt_ar_torus(const void* table, const void* sig_table, void* err,
                 int rank, int n, unsigned long long epoch,
                 long long timeout_ns, const void* x, void* out,
                 long long nbytes, void* mid, int n0, int n1, int dtype,
                 int grid, int sys, int addr, int ready, int released,
                 int mid_ready, int mid_released, int stride,
                 cudaStream_t stream) {
  const TorusLayout L{addr, ready, released, mid_ready, mid_released,
                      stride};
  if (bad_grid(rank, n, n0, n1, nbytes / 16) || nbytes % 16 ||
      bad_torus_layout(L, n, grid))
    return cudaErrorInvalidValue;
  const Group g = make_group(table, sig_table, err, rank, n, epoch,
                             timeout_ns);
  typedef void (*K)(Group, TorusLayout, int, int, const char*, char*, char*,
                    long long);
  const K ks[2][2] = {
      {ar_torus_kernel<float, false>, ar_torus_kernel<float, true>},
      {ar_torus_kernel<__nv_bfloat16, false>,
       ar_torus_kernel<__nv_bfloat16, true>}};
  if (dtype < 0 || dtype > 1) return cudaErrorInvalidValue;
  ks[dtype][sys ? 1 : 0]<<<grid, tdt::push::kThreads, 0, stream>>>(
      g, L, n0, n1, static_cast<const char*>(x), static_cast<char*>(mid),
      static_cast<char*>(out), nbytes);
  return cudaGetLastError();
}

}  // extern "C"
