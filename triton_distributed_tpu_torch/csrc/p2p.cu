// The point-to-point transport of the pipeline-parallel layer (kernel B7),
// on dist.cuh.
//
//  p2p_shift    ops/p2p.py:30 _p2p_shift_kernel — barrier, then every rank
//               pushes its block to rank (me + shift) mod n: into that
//               rank's symmetric receive buffer, with a flag; each rank
//               waits for its own delivery and copies the receive buffer
//               to its output.
//  p2p_permute  ops/p2p.py:102 _p2p_permute_kernel — barrier, then a
//               static set of (src, dst) pairs: a source pushes its block
//               into the receive buffer of each of its destinations
//               (multicast), with a flag a source; a destination waits for
//               the flag of its one source and copies out; a rank that
//               receives nothing writes zeros to its output. Only senders
//               push, only receivers wait, and a receiver never writes its
//               receive buffer.
//
// The receive buffer is what the TPU kernel's output is: the place a peer's
// DMA lands. Here the output is a fresh tensor the peer cannot see, so the
// peer writes into a persistent symmetric buffer and its owner copies out.
// The entry barrier (block b of every rank meets block b of every other)
// is what makes the reuse safe: a peer's block b writes this rank's receive
// buffer for call t+1 only after this rank's block b reached call t+1's
// barrier, i.e. after this rank's whole call-t kernel — its copy-out
// included — finished (stream order).
//
// What bounds them: bytes — a copy. A sender reads its block once and
// writes it once per destination; a receiver reads the receive buffer once
// and writes its output once (a non-receiver only writes zeros). The
// design moves 16 bytes a thread over a small fixed grid (at most
// kMaxBlocks blocks, the same on every rank: sized by the block, which
// every rank shares), so virtual ranks on one card never take the SMs
// their peers need.

#include <cuda_runtime.h>

#include "common.cuh"
#include "dist.cuh"

using namespace tdt::dist;

namespace {

// The data flag of a delivery from `src` to block b: kStepBase + b *
// kMaxRanks + src, in the receiver's pad.
__device__ __forceinline__ int data_flag(int src) {
  return kStepBase + blockIdx.x * kMaxRanks + src;
}

// send_mask: bit d set for each destination d of this rank; recv_src: the
// rank this one receives from, or -1 (its output becomes zeros).
__global__ void __launch_bounds__(kThreads)
    p2p_kernel(Group g, const uint4* x, uint4* out, long long nvec,
               int send_mask, int recv_src) {
  long long v0, v1;
  block_range(nvec, &v0, &v1);
  if (!barrier_all(g)) return;
  for (int i = 0; i < g.n; ++i) {
    const int d = (g.rank + i) % g.n;
    if (!(send_mask >> d & 1)) continue;
    put(reinterpret_cast<uint4*>(peer_base(g, d)), x, v0, v1);
    signal(g, d, data_flag(g.rank), g.epoch);
  }
  if (recv_src < 0) {
    const uint4 z = make_uint4(0, 0, 0, 0);
    for (long long v = v0 + threadIdx.x; v < v1; v += blockDim.x) out[v] = z;
    return;
  }
  if (!wait(g, data_flag(recv_src), g.epoch)) return;
  put(out, reinterpret_cast<const uint4*>(peer_base(g, g.rank)), v0, v1);
}

int grid_for(long long nvec) {
  // A block per 1024 vectors (16 KiB), 1..kMaxBlocks: the same on every
  // rank (the block's shape is), which the per-block flags need.
  long long g = (nvec + 1023) / 1024;
  return (int)(g < 1 ? 1 : (g > kMaxBlocks ? kMaxBlocks : g));
}

int launch(const void* table, const void* sig_table, void* err, int rank,
           int n, unsigned long long epoch, long long timeout_ns,
           const void* x, void* out, long long nbytes, int send_mask,
           int recv_src, cudaStream_t stream) {
  const long long nvec = nbytes / 16;
  if (n < 1 || n > kMaxRanks || rank < 0 || rank >= n || nvec < 1 ||
      nbytes % 16 || send_mask < 0 || send_mask >= (1 << n) ||
      recv_src < -1 || recv_src >= n)
    return cudaErrorInvalidValue;
  const Group g = make_group(table, sig_table, err, rank, n, epoch,
                             timeout_ns);
  p2p_kernel<<<grid_for(nvec), kThreads, 0, stream>>>(
      g, static_cast<const uint4*>(x), static_cast<uint4*>(out), nvec,
      send_mask, recv_src);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// nbytes: one rank's block (a multiple of 16; pointers 16-byte aligned);
// the symmetric receive buffer holds one block. shift: the ring distance
// (any int; taken mod n). Every entry returns its cudaError_t.
int tdt_p2p_shift(const void* table, const void* sig_table, void* err,
                  int rank, int n, unsigned long long epoch,
                  long long timeout_ns, const void* x, void* out,
                  long long nbytes, int shift, cudaStream_t stream) {
  if (n < 1) return cudaErrorInvalidValue;
  const int s = ((shift % n) + n) % n;
  return launch(table, sig_table, err, rank, n, epoch, timeout_ns, x, out,
                nbytes, 1 << ((rank + s) % n), (rank - s + n) % n, stream);
}

// send_mask: this rank's destinations as a bit set; recv_src: its source
// or -1. The host derives both from the permutation, the same on every
// rank.
int tdt_p2p_permute(const void* table, const void* sig_table, void* err,
                    int rank, int n, unsigned long long epoch,
                    long long timeout_ns, const void* x, void* out,
                    long long nbytes, int send_mask, int recv_src,
                    cudaStream_t stream) {
  return launch(table, sig_table, err, rank, n, epoch, timeout_ns, x, out,
                nbytes, send_mask, recv_src, stream);
}

}  // extern "C"
