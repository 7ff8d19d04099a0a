// The point-to-point transport of the pipeline-parallel layer (kernel B7),
// on the push protocol of push.cuh.
//
//  p2p_shift    ops/p2p.py:30 _p2p_shift_kernel — every rank pushes its
//               block into the output of rank (me + shift) mod n.
//  p2p_permute  ops/p2p.py:102 _p2p_permute_kernel — a static set of
//               (src, dst) pairs: a source pushes its block into the
//               output of each of its destinations (multicast: the block
//               read once, written to each), a destination waits for its
//               one source, a rank that receives nothing writes zeros to
//               its output.
//
// As on the TPU, the sender writes the receiver's output: each receiver
// publishes its fresh output's address to its source (the call's epoch as
// the release flag), the source writes straight into it and signals a data
// flag a block, the receiver waits for them. No receive buffer, no copy
// out, no entry barrier (the protocol and its safety: push.cuh).
//
// What bounds them: bytes — a copy. A sender reads its block once and
// writes it once per destination; a non-receiver writes zeros. The grid
// (at most 1/r of the SMs a rank, sized by the block, the same on every
// rank: each block signals its own data flag) keeps many bytes in flight:
// kUnroll 16-byte loads a thread, each stored to every destination.

#include <cuda_runtime.h>

#include "common.cuh"
#include "dist.cuh"
#include "push.cuh"

using namespace tdt::dist;
using tdt::push::Layout;

namespace {

// send_mask: bit d set for each destination d of this rank; recv_src: the
// rank this one receives from, or -1 (its output becomes zeros).
template <bool SYS>
__global__ void __launch_bounds__(tdt::push::kThreads)
    p2p_kernel(Group g, Layout L, const char* x, char* out, long long nbytes,
               int send_mask, int recv_src) {
  namespace pu = tdt::push;
  if (blockIdx.x == 0 && threadIdx.x == 0 && recv_src >= 0 &&
      recv_src != g.rank)
    pu::publish<SYS>(g, L, recv_src, out);
  long long lo, hi;
  pu::share(nbytes, &lo, &hi);
  if (send_mask != 0) {
    if (!pu::push_share<SYS>(g, L, x, out, 0, send_mask, lo, hi)) return;
    if (threadIdx.x == 0) pu::signal_data<SYS>(g, L, send_mask);
  }
  if (recv_src < 0)
    pu::zero_share(out, lo, hi);
  else
    pu::wait_data<SYS>(g, L, 1 << recv_src);
}

int launch(const void* table, const void* sig_table, void* err, int rank,
           int n, unsigned long long epoch, long long timeout_ns,
           const void* x, void* out, long long nbytes, int send_mask,
           int recv_src, int grid, int sys, int addr, int ready, int data,
           int stride, cudaStream_t stream) {
  const Layout L{addr, ready, data, stride};
  if (n < 1 || n > kMaxRanks || rank < 0 || rank >= n || nbytes < 16 ||
      nbytes % 16 || send_mask < 0 || send_mask >= (1 << n) ||
      recv_src < -1 || recv_src >= n || tdt::push::bad_layout(L, n, grid))
    return cudaErrorInvalidValue;
  const Group g = make_group(table, sig_table, err, rank, n, epoch,
                             timeout_ns);
  const char* xi = static_cast<const char*>(x);
  char* o = static_cast<char*>(out);
  if (sys)
    p2p_kernel<true><<<grid, tdt::push::kThreads, 0, stream>>>(
        g, L, xi, o, nbytes, send_mask, recv_src);
  else
    p2p_kernel<false><<<grid, tdt::push::kThreads, 0, stream>>>(
        g, L, xi, o, nbytes, send_mask, recv_src);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// nbytes: one rank's block (a multiple of 16; pointers 16-byte aligned),
// x this rank's block, out its output (fresh: senders write it). shift:
// the ring distance (any int; taken mod n). grid, sys (the flags' scope: 1
// when a peer is another card) and the pad layout
// (addr, ready, data, stride) come from the host (ops/_comm.launch_push),
// the same on every rank. Every entry returns its cudaError_t.
int tdt_p2p_shift(const void* table, const void* sig_table, void* err,
                  int rank, int n, unsigned long long epoch,
                  long long timeout_ns, const void* x, void* out,
                  long long nbytes, int shift, int grid, int sys, int addr,
                  int ready, int data, int stride, cudaStream_t stream) {
  if (n < 1) return cudaErrorInvalidValue;
  const int s = ((shift % n) + n) % n;
  return launch(table, sig_table, err, rank, n, epoch, timeout_ns, x, out,
                nbytes, 1 << ((rank + s) % n), (rank - s + n) % n, grid,
                sys, addr, ready, data, stride, stream);
}

// send_mask: this rank's destinations as a bit set; recv_src: its source
// or -1. The host derives both from the permutation, the same on every
// rank.
int tdt_p2p_permute(const void* table, const void* sig_table, void* err,
                    int rank, int n, unsigned long long epoch,
                    long long timeout_ns, const void* x, void* out,
                    long long nbytes, int send_mask, int recv_src, int grid,
                    int sys, int addr, int ready, int data, int stride,
                    cudaStream_t stream) {
  return launch(table, sig_table, err, rank, n, epoch, timeout_ns, x, out,
                nbytes, send_mask, recv_src, grid, sys, addr, ready, data,
                stride, stream);
}

}  // extern "C"
