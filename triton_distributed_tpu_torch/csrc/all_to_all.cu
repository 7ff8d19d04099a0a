// The low-latency AllToAll of the expert-parallel MoE layer (kernel B8):
// the barrier form on dist.cuh, the parity stream on push.cuh.
//
//  a2a         ops/all_to_all.py:65 _a2a_kernel — barrier, then for every
//              peer p (in the order me+1 ... me-1) copy ceil(rows_p /
//              block) blocks of `block` rows of send slot p into slot `me`
//              of p's symmetric receive buffer, with the splits row of
//              slot p beside it; tell each peer, wait for the n-1 peers,
//              copy each received slot's live rows and its splits row out.
//  a2a_push    ops/all_to_all.py:180 _a2a_parity_kernel — the stream form
//              (no barrier; the reference's two parity slabs) on the push
//              protocol of push.cuh: each receiver's block 0 publishes its
//              fresh output and splits to every sender (two address words,
//              the call's epoch, call index + 1, as the release flag);
//              each sender's block b writes its share of slot p's live
//              blocks straight into slot `me` of receiver p's output (its
//              own slot locally), block 0 its splits row into row `me` of
//              p's splits, then releases its data word to every peer,
//              empty slots included; the receiver's block b waits for the
//              n-1 data words of block b, and the call is done — no
//              parity slab and no copy-out.
//
// Slot layout (the JAX package's contract): send and receive buffers are
// (n, cap, row) with cap % block == 0; slot p holds the rows for / from
// rank p, sorted by expert, and rows past a slot's count are unspecified.
// The splits — (n, epr) int32, token counts per destination expert — ride
// the kernel with the payload, written before the source's flag (as the
// original GPU design, low_latency_all_to_all.py:36, carries them), so the
// receiver learns its counts from the kernel: the JAX package exchanges
// them through an XLA all_to_all instead and counts DMA completions.
//
// Stream safety is push.cuh's: the outputs are fresh every call, so no
// payload buffer is reused; the reused words are the pad's, and only grow.
// A sender of call t+1 reads a receiver's addresses only after its ready
// word reached t+1, which the receiver stores after the new addresses; the
// receiver reaches call t+1 only after every sender's call-t data word,
// i.e. after each one read call t's addresses. The host refuses a call
// index out of sequence (ops/all_to_all.fast_all_to_all_stream).
//
// What bounds it: bytes — a copy. Each live row is read once from the send
// buffer and written once (the barrier form writes it into the peer's
// slot, then reads and writes it again in the copy-out); on one card with
// virtual ranks all of it goes through one HBM. Decode-sized payloads (a
// few 16-row blocks a slot) are bound by the launch and the flag round
// trip instead, so the stream form makes one hop behind one flag. Both
// move only the live blocks (traffic follows the real token count, not
// cap), 16 bytes a thread, over a grid the same on every rank (sized by
// cap and the row, which every rank shares): the barrier form's at most
// kMaxBlocks blocks, the stream form's push_grid over the send buffer at a
// block per 16 KiB (at most 1/r of the SMs: a latency-bound decode call
// gains from more, smaller shares), kUnroll loads in flight a thread,
// across slot edges; block b of every rank signals and waits only for
// block b of its peers, so no grid-wide barrier, and virtual ranks on one
// card never take the SMs their peers need.

#include <cuda_runtime.h>

#include "common.cuh"
#include "dist.cuh"
#include "push.cuh"

using namespace tdt::dist;

namespace {

struct Slots {
  const char* send;        // (n, cap, row_bytes)
  const int* send_splits;  // (n, epr)
  char* out;               // (n, cap, row_bytes)
  int* out_splits;         // (n, epr)
  long long row_bytes;     // a multiple of 16
  int cap;
  int block;
  int epr;
  int spl_stride;          // ints per splits row in the barrier workspace
};

__device__ __forceinline__ long long slot_bytes(const Slots& s) {
  return (long long)s.cap * s.row_bytes;
}

// A slot's token count clamped to [0, cap] and rounded up to whole
// blocks: ceil(rows / block) * block.
__device__ __forceinline__ int whole_blocks(long long rows, int cap,
                                           int block) {
  rows = rows < 0 ? 0 : (rows > cap ? cap : rows);
  return (int)((rows + block - 1) / block) * block;
}

// Live rows of a slot: whole_blocks of its splits row's sum.
__device__ __forceinline__ int live_rows(const int* splits, int epr,
                                         int cap, int block) {
  long long rows = 0;
  for (int j = 0; j < epr; ++j) rows += __ldcg(splits + j);
  return whole_blocks(rows, cap, block);
}

// Copy this block's share of `rows` rows (16-byte vectors) src -> dst.
__device__ __forceinline__ void copy_rows(char* dst, const char* src,
                                          int rows, long long row_bytes) {
  long long v0, v1;
  block_range(rows * row_bytes / 16, &v0, &v1);
  put(reinterpret_cast<uint4*>(dst), reinterpret_cast<const uint4*>(src),
      v0, v1);
}

// The barrier form over the symmetric receive buffer (n slots, then n
// splits rows of spl_stride int32).
__global__ void __launch_bounds__(kThreads) a2a_kernel(Group g, Slots s) {
  __shared__ int rows_s[kMaxRanks];
  const int n = g.n, me = g.rank;
  if (!barrier_all(g)) return;
  const long long sb = slot_bytes(s);
  const int base = kStepBase + blockIdx.x * kMaxRanks;
  if (threadIdx.x < n)
    rows_s[threadIdx.x] =
        live_rows(s.send_splits + threadIdx.x * s.epr, s.epr, s.cap, s.block);
  __syncthreads();
  // Push: slot p of the send buffer into slot me of p's workspace, and the
  // splits row beside it (every block writes the same row: the receiver's
  // block b reads it after block b's flag).
  for (int i = 1; i < n; ++i) {
    const int p = (me + i) % n;
    char* ws = peer_base(g, p);
    copy_rows(ws + me * sb, s.send + p * sb, rows_s[p], s.row_bytes);
    int* spl = reinterpret_cast<int*>(ws + n * sb) + me * s.spl_stride;
    for (int j = threadIdx.x; j < s.epr; j += blockDim.x)
      spl[j] = s.send_splits[p * s.epr + j];
  }
  // Own slot: straight to the output.
  copy_rows(s.out + me * sb, s.send + me * sb, rows_s[me], s.row_bytes);
  if (blockIdx.x == 0)
    for (int j = threadIdx.x; j < s.epr; j += blockDim.x)
      s.out_splits[me * s.epr + j] = s.send_splits[me * s.epr + j];
  signal_peers(g, base, g.epoch);
  if (!wait_peers(g, base, g.epoch)) return;
  // Copy out: each peer's slot, as many rows as its splits row says.
  const char* ws = peer_base(g, me);
  const int* spl = reinterpret_cast<const int*>(ws + n * sb);
  if (threadIdx.x < n && threadIdx.x != me)
    rows_s[threadIdx.x] = live_rows(spl + threadIdx.x * s.spl_stride, s.epr,
                                    s.cap, s.block);
  __syncthreads();
  for (int i = 1; i < n; ++i) {
    const int q = (me + i) % n;
    copy_rows(s.out + q * sb, ws + q * sb, rows_s[q], s.row_bytes);
    if (blockIdx.x == 0)
      for (int j = threadIdx.x; j < s.epr; j += blockDim.x)
        s.out_splits[q * s.epr + j] = __ldcg(spl + q * s.spl_stride + j);
  }
}

// The stream form on the push protocol. L: the pad's address, ready and
// data words; `saddr + j`: receiver j's splits address (sender's pad).
// Thread j resolves receiver j's output and splits (its own locally). The
// live vectors of every slot, in write order (its own slot first, then
// me+1 ... me-1), make one index space; block b copies its b-th share of
// it, kUnroll loads in flight a thread across slot edges, so a decode
// call's few 16-row blocks a slot are one round of loads, not one a slot.
template <bool SYS>
__global__ void __launch_bounds__(tdt::push::kThreads)
    a2a_push_kernel(Group g, tdt::push::Layout L, int saddr, Slots s) {
  namespace pu = tdt::push;
  constexpr int U = pu::kUnroll;
  __shared__ uint4* dst[kMaxRanks];
  __shared__ int* sdst[kMaxRanks];
  __shared__ int cnt[kMaxRanks];             // tokens for receiver j
  __shared__ long long pre[kMaxRanks + 1];   // live vectors before slot i
  const int n = g.n, me = g.rank, j = threadIdx.x;
  const int all = (1 << n) - 1;
  const long long sb = slot_bytes(s);
  if (blockIdx.x == 0 && j < n && j != me) {
    unsigned long long* pad = flags(g, j);
    *reinterpret_cast<volatile unsigned long long*>(pad + saddr + me) =
        reinterpret_cast<unsigned long long>(s.out_splits);
    pu::publish<SYS>(g, L, j, s.out);
  }
  // The slots' token counts, the block's threads summing the splits
  // together (a thread's serial sum of a row costs a load latency a value).
  if (j < kMaxRanks) cnt[j] = 0;
  __syncthreads();
  for (int t = j; t < n * s.epr; t += blockDim.x)
    atomicAdd(&cnt[t / s.epr], __ldg(s.send_splits + t));
  int ok = 1;
  if (j < n) {
    char* o = s.out;
    int* so = s.out_splits;
    if (j != me) {
      o = pu::await_dest<SYS>(g, L, j);
      ok = o != nullptr;
      const volatile unsigned long long* pad = flags(g, me);
      so = reinterpret_cast<int*>(pad[saddr + j]);
    }
    dst[j] = reinterpret_cast<uint4*>(ok ? o + me * sb : nullptr);
    sdst[j] = so + me * s.epr;
  }
  if (!__syncthreads_and(ok)) return;
  if (j == 0) {
    pre[0] = 0;
    for (int i = 0; i < n; ++i)
      pre[i + 1] = pre[i] + whole_blocks(cnt[(me + i) % n], s.cap, s.block) *
                                s.row_bytes / 16;
  }
  __syncthreads();
  const uint4* send = reinterpret_cast<const uint4*>(s.send);
  const long long svec = sb / 16;
  long long v0, v1;
  block_range(pre[n], &v0, &v1);
  const long long T = blockDim.x;
  for (long long base = v0 + j; base < v1; base += T * U) {
    uint4 r[U];
    int slot[U];
    long long off[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const long long v = base + k * T;
      slot[k] = -1;
      if (v < v1) {
        int i = 0;
        while (v >= pre[i + 1]) ++i;
        slot[k] = (me + i) % n;
        off[k] = v - pre[i];
        r[k] = __ldg(send + slot[k] * svec + off[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < U; ++k)
      if (slot[k] >= 0) dst[slot[k]][off[k]] = r[k];
  }
  if (blockIdx.x == 0)
    for (int i = 0; i < n; ++i)
      for (int e = j; e < s.epr; e += blockDim.x)
        sdst[i][e] = s.send_splits[i * s.epr + e];
  __syncthreads();
  if (j == 0) pu::signal_data<SYS>(g, L, all);
  pu::wait_data<SYS>(g, L, all);
}

int grid_for(long long nvec) {
  // A block per 1024 vectors (16 KiB) of one full slot, 1..kMaxBlocks: the
  // same on every rank (cap and the row are), which the per-block flags
  // need.
  long long g = (nvec + 1023) / 1024;
  return (int)(g < 1 ? 1 : (g > kMaxBlocks ? kMaxBlocks : g));
}

bool bad_slots(int rank, int n, long long row_bytes, int cap, int block,
               int epr) {
  return n < 1 || n > kMaxRanks || rank < 0 || rank >= n || row_bytes < 16 ||
         row_bytes % 16 || cap < 1 || block < 1 || cap % block || epr < 1;
}

Slots make_slots(const void* send, const void* send_splits, void* out,
                 void* out_splits, long long row_bytes, int cap, int block,
                 int epr, int spl_stride) {
  Slots s;
  s.send = static_cast<const char*>(send);
  s.send_splits = static_cast<const int*>(send_splits);
  s.out = static_cast<char*>(out);
  s.out_splits = static_cast<int*>(out_splits);
  s.row_bytes = row_bytes;
  s.cap = cap;
  s.block = block;
  s.epr = epr;
  s.spl_stride = spl_stride;
  return s;
}

}  // namespace

extern "C" {

// send / out: (n, cap, row_bytes) bytes, 16-byte aligned; send_splits /
// out_splits: (n, epr) int32; the symmetric workspace: n slots of cap rows
// then n splits rows of spl_stride int32. Every entry returns its
// cudaError_t.
int tdt_a2a(const void* table, const void* sig_table, void* err, int rank,
            int n, unsigned long long epoch, long long timeout_ns,
            const void* send, const void* send_splits, void* out,
            void* out_splits, long long row_bytes, int cap, int block,
            int epr, int spl_stride, cudaStream_t stream) {
  if (bad_slots(rank, n, row_bytes, cap, block, epr) || spl_stride < epr ||
      spl_stride % 4)
    return cudaErrorInvalidValue;
  const Group g = make_group(table, sig_table, err, rank, n, epoch,
                             timeout_ns);
  const Slots s = make_slots(send, send_splits, out, out_splits, row_bytes,
                             cap, block, epr, spl_stride);
  a2a_kernel<<<grid_for(cap * row_bytes / 16), kThreads, 0, stream>>>(g, s);
  return cudaGetLastError();
}

// The stream form: send / out (this rank's fresh output) and the splits as
// tdt_a2a's; epoch: the call index + 1. grid (push_grid over the send
// buffer), sys (the flags' scope: 1 when a peer is another card) and the
// pad layout (addr, splits, ready, data, stride: ops/_comm.A2ALayout) come
// from the host (ops/_comm.launch_push), the same on every rank. n = 1 is
// the loopback (force_kernel): the copy of its own slot.
int tdt_a2a_parity(const void* table, const void* sig_table, void* err,
                   int rank, int n, unsigned long long epoch,
                   long long timeout_ns, const void* send, void* out,
                   long long row_bytes, const void* send_splits,
                   void* out_splits, int cap, int block, int epr, int grid,
                   int sys, int addr, int splits, int ready, int data,
                   int stride, cudaStream_t stream) {
  const tdt::push::Layout L{addr, ready, data, stride};
  if (bad_slots(rank, n, row_bytes, cap, block, epr) ||
      tdt::push::bad_layout(L, n, grid) || splits < addr + n ||
      ready < splits + n)
    return cudaErrorInvalidValue;
  const Group g = make_group(table, sig_table, err, rank, n, epoch,
                             timeout_ns);
  const Slots s = make_slots(send, send_splits, out, out_splits, row_bytes,
                             cap, block, epr, epr);
  if (sys)
    a2a_push_kernel<true><<<grid, tdt::push::kThreads, 0, stream>>>(
        g, L, splits, s);
  else
    a2a_push_kernel<false><<<grid, tdt::push::kThreads, 0, stream>>>(
        g, L, splits, s);
  return cudaGetLastError();
}

}  // extern "C"
