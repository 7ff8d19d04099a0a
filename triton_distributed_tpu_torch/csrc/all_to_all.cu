// The low-latency AllToAll of the expert-parallel MoE layer (kernel B8),
// on dist.cuh.
//
//  a2a         ops/all_to_all.py:65 _a2a_kernel — barrier, then for every
//              peer p (in the order me+1 ... me-1) copy ceil(rows_p /
//              block) blocks of `block` rows of send slot p into slot `me`
//              of p's symmetric receive buffer, with the splits row of
//              slot p beside it; tell each peer, wait for the n-1 peers,
//              copy each received slot's live rows and its splits row out.
//  a2a_parity  ops/all_to_all.py:180 _a2a_parity_kernel — the same with
//              no barrier, over a persistent workspace of two parity
//              slabs (call index % 2) and flags per (parity, block,
//              source) whose value is call index + 1.
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
// Parity safety: every rank signals every peer on every call, zero-row
// slots included, so a rank's call t+1 finishes only after every peer's
// call t+1 signal, which that peer sends only after its whole call-t
// kernel (stream order) — a rank can therefore write parity p of call t+2
// only after every peer finished copying parity p of call t out. The
// per-parity flags keep a fast peer's call t+1 signal from counting for
// call t. The host refuses a call index out of sequence
// (ops/all_to_all.fast_all_to_all_stream).
//
// What bounds it: bytes — a copy. Each live row is read once from the send
// buffer, written once into the peer's slot, read once and written once
// by the copy-out; on one card with virtual ranks all of it goes through
// one HBM. Decode-sized payloads (a few rows) are bound by the flag round
// trip and the launch instead. The design moves only the live blocks
// (traffic follows the real token count, not cap), 16 bytes a thread,
// over a small fixed grid (at most kMaxBlocks blocks, the same on every
// rank: sized by cap, which every rank shares); block b of every rank
// copies the same share of each slot and waits only for block b of its
// peers, so no grid-wide barrier, and virtual ranks on one card never
// take the SMs their peers need.

#include <cuda_runtime.h>

#include "common.cuh"
#include "dist.cuh"

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
  int spl_stride;          // ints per splits row in the workspace
};

__device__ __forceinline__ long long slot_bytes(const Slots& s) {
  return (long long)s.cap * s.row_bytes;
}

// One parity's workspace: n slots of data, then n splits rows.
__device__ __forceinline__ long long slab_bytes(const Slots& s, int n) {
  return n * slot_bytes(s) + (long long)n * s.spl_stride * 4;
}

// Live rows of a slot rounded up to whole blocks: ceil(sum / block) *
// block, at most cap.
__device__ __forceinline__ int live_rows(const int* splits, int epr,
                                         int cap, int block) {
  long long rows = 0;
  for (int j = 0; j < epr; ++j) rows += __ldcg(splits + j);
  rows = rows < 0 ? 0 : (rows > cap ? cap : rows);
  return (int)((rows + block - 1) / block) * block;
}

// Copy this block's share of `rows` rows (16-byte vectors) src -> dst.
__device__ __forceinline__ void copy_rows(char* dst, const char* src,
                                          int rows, long long row_bytes) {
  long long v0, v1;
  block_range(rows * row_bytes / 16, &v0, &v1);
  put(reinterpret_cast<uint4*>(dst), reinterpret_cast<const uint4*>(src),
      v0, v1);
}

// parity < 0: the barrier form over one slab; else the slab of `parity`.
__global__ void __launch_bounds__(kThreads)
    a2a_kernel(Group g, Slots s, int parity) {
  __shared__ int rows_s[kMaxRanks];
  const int n = g.n, me = g.rank;
  if (parity < 0 && !barrier_all(g)) return;
  const long long off = parity < 0 ? 0 : parity * slab_bytes(s, n);
  const long long sb = slot_bytes(s);
  const int base = kStepBase +
                   ((parity < 0 ? 0 : parity) * kMaxBlocks + blockIdx.x) *
                       kMaxRanks;
  if (threadIdx.x < n)
    rows_s[threadIdx.x] =
        live_rows(s.send_splits + threadIdx.x * s.epr, s.epr, s.cap, s.block);
  __syncthreads();
  // Push: slot p of the send buffer into slot me of p's workspace, and the
  // splits row beside it (every block writes the same row: the receiver's
  // block b reads it after block b's flag).
  for (int i = 1; i < n; ++i) {
    const int p = (me + i) % n;
    char* ws = peer_base(g, p) + off;
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
  const char* ws = peer_base(g, me) + off;
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

int grid_for(long long nvec) {
  // A block per 1024 vectors (16 KiB) of one full slot, 1..kMaxBlocks: the
  // same on every rank (cap and the row are), which the per-block flags
  // need.
  long long g = (nvec + 1023) / 1024;
  return (int)(g < 1 ? 1 : (g > kMaxBlocks ? kMaxBlocks : g));
}

int launch(const void* table, const void* sig_table, void* err, int rank,
           int n, unsigned long long epoch, long long timeout_ns,
           const void* send, const void* send_splits, void* out,
           void* out_splits, long long row_bytes, int cap, int block,
           int epr, int spl_stride, int parity, cudaStream_t stream) {
  if (n < 1 || n > kMaxRanks || rank < 0 || rank >= n || row_bytes < 16 ||
      row_bytes % 16 || cap < 1 || block < 1 || cap % block || epr < 1 ||
      spl_stride < epr || spl_stride % 4)
    return cudaErrorInvalidValue;
  const Group g = make_group(table, sig_table, err, rank, n, epoch,
                             timeout_ns);
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
  a2a_kernel<<<grid_for(cap * row_bytes / 16), kThreads, 0, stream>>>(
      g, s, parity);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// send / out: (n, cap, row_bytes) bytes, 16-byte aligned; send_splits /
// out_splits: (n, epr) int32; the symmetric workspace: n slots of cap rows
// then n splits rows of spl_stride int32 (tdt_a2a_parity: two of them).
// Every entry returns its cudaError_t.
int tdt_a2a(const void* table, const void* sig_table, void* err, int rank,
            int n, unsigned long long epoch, long long timeout_ns,
            const void* send, const void* send_splits, void* out,
            void* out_splits, long long row_bytes, int cap, int block,
            int epr, int spl_stride, cudaStream_t stream) {
  return launch(table, sig_table, err, rank, n, epoch, timeout_ns, send,
                send_splits, out, out_splits, row_bytes, cap, block, epr,
                spl_stride, -1, stream);
}

int tdt_a2a_parity(const void* table, const void* sig_table, void* err,
                   int rank, int n, unsigned long long call_index,
                   long long timeout_ns, const void* send,
                   const void* send_splits, void* out, void* out_splits,
                   long long row_bytes, int cap, int block, int epr,
                   int spl_stride, cudaStream_t stream) {
  return launch(table, sig_table, err, rank, n, call_index + 1, timeout_ns,
                send, send_splits, out, out_splits, row_bytes, cap, block,
                epr, spl_stride, (int)(call_index & 1), stream);
}

}  // extern "C"
