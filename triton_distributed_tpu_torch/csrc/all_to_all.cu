// The low-latency AllToAll of the expert-parallel MoE layer (kernel B8):
// both forms on the push protocol of push.cuh, one body (a2a_push) under
// two kernels and entries, so that a profile and the launch counters tell
// them apart.
//
//  a2a         ops/all_to_all.py:65 _a2a_kernel — the barrier form (the EP
//              prefill's dispatch and combine, cap 4096 x 2048 a slot):
//              the TPU kernel's entry barrier protects its receive slots
//              across calls, then each rank copies ceil(rows_p / block)
//              blocks of send slot p into slot `me` of rank p's slots and
//              counts the DMAs. Here no entry barrier, receive buffer or
//              copy-out: each receiver's block 0 publishes its fresh output
//              and splits (two address words) with the call's epoch, each
//              sender's block b writes its share of every slot's live
//              vectors straight into slot `me` of each receiver's output
//              (its own slot locally), block 0 its splits row into row `me`
//              of each receiver's splits, then releases its data word to
//              every peer, empty slots included; the receiver's block b
//              waits for the n-1 data words of block b.
//  a2a_push    ops/all_to_all.py:180 _a2a_parity_kernel — the stream form
//              (the EP decode's; the reference's two parity slabs, no
//              barrier): the same body over the stream's own pad, whose
//              epochs are the call index + 1.
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
// Safety across calls is push.cuh's: the outputs are fresh every call, so
// no payload buffer is reused; the reused words are the pad's, and only
// grow. A sender of call t+1 reads a receiver's addresses only after its
// ready word reached t+1, which the receiver stores after the new
// addresses; the receiver reaches call t+1 only after every sender's
// call-t data word, i.e. after each one read call t's addresses. A
// sender's kernel ends only after its own stores were fenced and every
// peer's data words arrived, so a caller may overwrite its send buffer
// once the call is done. The host refuses a stream call index out of
// sequence (ops/all_to_all.fast_all_to_all_stream).
//
// What bounds it: bytes — a copy. Each live row is read once from the send
// buffer and written once into its receiver's output; on one card with
// virtual ranks all of it goes through one HBM. Both forms move only the
// live blocks (traffic follows the real token count, not cap), 16 bytes a
// thread, loads in flight a thread across slot edges, over a grid the host
// sizes by the send buffer (cap and the row, which every rank shares, so
// the same on every rank; at most 1/r of the SMs): the barrier form,
// bandwidth-bound at the prefill's ~128 MiB of live rows through the card,
// a block per 64 KiB (push_grid's default, 33 blocks at the cap) and 16
// loads a thread; the stream form a block per 16 KiB (a latency-bound
// decode call gains from more, smaller shares) and 8. Block b of every rank signals and waits only
// for block b of its peers, so no grid-wide barrier.

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

// Both forms' body on the push protocol. L: the pad's address, ready and
// data words; `saddr + j`: receiver j's splits address (sender's pad).
// Thread j resolves receiver j's output and splits (its own locally). The
// live vectors of every slot, in write order (its own slot first, then
// me+1 ... me-1), make one index space; block b copies its b-th share of
// it, U loads in flight a thread across slot edges, so a decode call's few
// 16-row blocks a slot are one round of loads, not one a slot.
template <bool SYS, int U>
__device__ __forceinline__ void a2a_push(const Group& g,
                                         const tdt::push::Layout& L,
                                         int saddr, const Slots& s) {
  namespace pu = tdt::push;
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

// The barrier form's loads in flight a thread: the prefill's ~128 MiB of
// live rows are bandwidth-bound, and at cap 4096 x 2048 bf16 on 4 ranks 16
// loads measured 0.0651 ms a call as a span against 0.0709-0.0713 at 8
// (126 registers against 70); 32 loads 0.0658, 16 at 512 threads 0.0640
// and 8 at 1024 threads 0.0638 (a block filling an SM's registers, or
// spilling) added nothing to keep (H100 80GB HBM3, 700 W;
// scripts/time_port_copy.py, PERF.md §6 row 11).
constexpr int kBarrierUnroll = 2 * tdt::push::kUnroll;

// The barrier form: its own kernel, so that a profile tells the forms
// apart.
template <bool SYS>
__global__ void __launch_bounds__(tdt::push::kThreads)
    a2a_kernel(Group g, tdt::push::Layout L, int saddr, Slots s) {
  a2a_push<SYS, kBarrierUnroll>(g, L, saddr, s);
}

// The stream form: a decode call's few rows a slot are one round of
// loads at push.cuh's kUnroll.
template <bool SYS>
__global__ void __launch_bounds__(tdt::push::kThreads)
    a2a_push_kernel(Group g, tdt::push::Layout L, int saddr, Slots s) {
  a2a_push<SYS, tdt::push::kUnroll>(g, L, saddr, s);
}

typedef void (*A2AKernel)(Group, tdt::push::Layout, int, Slots);

bool bad_slots(int rank, int n, long long row_bytes, int cap, int block,
               int epr) {
  return n < 1 || n > kMaxRanks || rank < 0 || rank >= n || row_bytes < 16 ||
         row_bytes % 16 || cap < 1 || block < 1 || cap % block || epr < 1;
}

Slots make_slots(const void* send, const void* send_splits, void* out,
                 void* out_splits, long long row_bytes, int cap, int block,
                 int epr) {
  Slots s;
  s.send = static_cast<const char*>(send);
  s.send_splits = static_cast<const int*>(send_splits);
  s.out = static_cast<char*>(out);
  s.out_splits = static_cast<int*>(out_splits);
  s.row_bytes = row_bytes;
  s.cap = cap;
  s.block = block;
  s.epr = epr;
  return s;
}

// One launch of either form, its arguments checked: the slots' shape and
// the host's layout inside the pad (addr, then splits, then ready).
int launch_a2a(A2AKernel gpu_k, A2AKernel sys_k, const void* table,
               const void* sig_table, void* err, int rank, int n,
               unsigned long long epoch, long long timeout_ns,
               const void* send, void* out, long long row_bytes,
               const void* send_splits, void* out_splits, int cap,
               int block, int epr, int grid, int sys, int addr, int splits,
               int ready, int data, int stride, cudaStream_t stream) {
  const tdt::push::Layout L{addr, ready, data, stride};
  if (bad_slots(rank, n, row_bytes, cap, block, epr) ||
      tdt::push::bad_layout(L, n, grid) || splits < addr + n ||
      ready < splits + n)
    return cudaErrorInvalidValue;
  const Group g = make_group(table, sig_table, err, rank, n, epoch,
                             timeout_ns);
  const Slots s = make_slots(send, send_splits, out, out_splits, row_bytes,
                             cap, block, epr);
  const A2AKernel k = sys ? sys_k : gpu_k;
  k<<<grid, tdt::push::kThreads, 0, stream>>>(g, L, splits, s);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// send / out (this rank's fresh output): (n, cap, row_bytes) bytes,
// 16-byte aligned; send_splits / out_splits: (n, epr) int32. grid
// (push_grid over the send buffer), sys (the flags' scope: 1 when a peer
// is another card) and the pad layout (addr, splits, ready, data, stride:
// ops/_comm.A2ALayout) come from the host (ops/_comm.launch_push), the same
// on every rank. Every entry returns its cudaError_t. The barrier form at
// n = 1 is never launched (the wrapper returns its input).
int tdt_a2a(const void* table, const void* sig_table, void* err, int rank,
            int n, unsigned long long epoch, long long timeout_ns,
            const void* send, void* out, long long row_bytes,
            const void* send_splits, void* out_splits, int cap, int block,
            int epr, int grid, int sys, int addr, int splits, int ready,
            int data, int stride, cudaStream_t stream) {
  return launch_a2a(a2a_kernel<false>, a2a_kernel<true>, table, sig_table,
                    err, rank, n, epoch, timeout_ns, send, out, row_bytes,
                    send_splits, out_splits, cap, block, epr, grid, sys,
                    addr, splits, ready, data, stride, stream);
}

// The stream form, as tdt_a2a; epoch: the call index + 1 (the pad's). n =
// 1 is the loopback (force_kernel): the copy of its own slot.
int tdt_a2a_parity(const void* table, const void* sig_table, void* err,
                   int rank, int n, unsigned long long epoch,
                   long long timeout_ns, const void* send, void* out,
                   long long row_bytes, const void* send_splits,
                   void* out_splits, int cap, int block, int epr, int grid,
                   int sys, int addr, int splits, int ready, int data,
                   int stride, cudaStream_t stream) {
  return launch_a2a(a2a_push_kernel<false>, a2a_push_kernel<true>, table,
                    sig_table, err, rank, n, epoch, timeout_ns, send, out,
                    row_bytes, send_splits, out_splits, cap, block, epr, grid,
                    sys, addr, splits, ready, data, stride, stream);
}

}  // extern "C"
