// The collective kernels of the tensor-parallel path, all on the push
// protocol of push.cuh (over dist.cuh's group, flags and timeouts).
//
// Each replaces one TPU kernel of the JAX package and computes what it
// computes, in the same order and rounding (the replicas must end with
// bit-identical sums, or their greedy tokens diverge):
//
//  ar_one_shot   ops/allreduce.py:68 _ar_one_shot_kernel — the n inputs
//                summed in rank order 0..n-1 in fp32 from 0 and cast once,
//                on the push protocol with every rank an owner of the whole
//                payload (rs_ring's roles, below, with one chunk): block 0
//                of each rank publishes its INPUT's address to every peer
//                with the call's epoch; block b of each rank reads share b
//                of every rank's input (its own locally, a peer's through
//                L2 behind the acquired ready word), sums it into its fresh
//                output, then releases the epoch into word `data + rank *
//                stride + b` of each source's pad; a source's block b
//                returns only once every reader released it, since a
//                caller may overwrite or free its input when the kernel
//                ends. One hop behind one flag; no entry barrier, slot
//                workspace (the first kernel pushed every byte into an (n,
//                m, cols) slot buffer and read it back) or dependent hops.
//                Safe across calls as rs_ring: a reader of call t+1 reads
//                a source's address only after the source's ready word
//                reached t+1, which the source stores after the new
//                address; and a source reaches call t+1 only after every
//                reader released call t, i.e. after each one's last load
//                of the source's call-t input returned.
//  ar_parity     ops/allreduce.py:104 _ar_one_shot_parity_kernel — the
//                decode path's repeated AllReduces: the one-shot's body
//                (ar_one_shot_body) over the stream's own pad, its epoch
//                the call index + 1 (the TPU kernel's two parity slabs
//                and their per-parity flags gone: no slot a peer pushes
//                into, so none is reused); the same sum, bit for bit.
//                Safe across the stream's calls by the same argument, with
//                the epoch counting calls (see ar_parity_kernel).
//  rs_ring       ops/reduce_scatter.py:52 _rs_ring_kernel — ring reduce-
//                scatter: chunk c summed in the ring's order, x_{c+1} +
//                x_{c+2} + ... + x_c, each add in fp32 and rounded to the
//                payload type (the ring's one rounding a hop). On the push
//                protocol with the roles mirrored: the owner reads. Each
//                rank publishes its INPUT's address to every peer (block
//                0, the call's epoch as the release flag); owner c's block
//                b reads share b of chunk c straight from every source's
//                input (its own locally) and sums it in that order into its
//                fresh output, then releases the epoch into word `data +
//                c * stride + b` of each source's pad; a source's block b
//                returns only once every owner released it, since a
//                caller may overwrite or free its input when the kernel
//                ends. One hop behind one flag, each byte read once; no
//                entry barrier, relay slots or dependent hops (the ring
//                made n-1 of them through an (n-1, chunk) workspace).
//                Safe across calls by push.cuh's argument mirrored: an
//                owner of call t+1 reads a source's address only after
//                the source's ready word reached t+1, and a source reaches
//                call t+1 only after every owner released call t.
//  ag_ring       ops/allgather.py:91 _ag_ring_kernel — the ring
//                all-gather (the two-shot AllReduce's second half), on the
//                push protocol in one hop: the full-mesh push's body
//                (ag_push) under the ring's own kernel and entry. The TPU
//                ring forwards each chunk n-1 times for a torus's links; on
//                one card every byte goes through one HBM, and behind
//                NVSwitch every pair of cards has the same path, so a
//                rank sends its n-1 copies either way and the ring's n-2
//                dependent hops (a flag round trip each), its entry barrier,
//                its gather buffer and its copy-out bought nothing. The
//                output is the ring's bit for bit (a copy has no rounding).
//  ag_full_mesh  ops/allgather.py:66 _ag_full_mesh_push_kernel — on the
//                push protocol of push.cuh: every rank publishes its
//                fresh output to every peer, then writes its chunk
//                straight into slot `rank` of every rank's output (its
//                own first, then me+1 ... me-1; the chunk read once,
//                written n times), and waits for the n-1 peers' data
//                flags: one hop, no gather buffer, no copy out, no entry
//                barrier; the ring's output bit for bit (a copy has no
//                rounding). Its grid is the copy engine's (at most 1/r of
//                the SMs).
//  ag_parity     ops/allgather.py:192 _ag_parity_kernel — the SP decode
//                loop's repeated gathers of its attention partials: the
//                same push protocol and body as ag_full_mesh, over the
//                stream's own pad (the TPU kernel's parity slabs and the
//                copy-out gone: the output is fresh every call, the pad's
//                epochs order its reuse — push.cuh's argument), on a grid
//                of a block per 8 KiB of the chunk: the gather is
//                latency-bound (65 KiB a rank at the main shape).
//  ar_tree       ops/allreduce.py:169 _ar_tree_kernel — the double
//                binary tree: tree 0 the heap over rank order, tree 1
//                over reversed ranks, each owning half of the rows (rows
//                [0, ceil(m/2)) and the rest; one tree of every row at
//                m = 1). A leaf writes its rows into its parent's slot; an
//                interior node adds its own rows, then child 2p+1's, then
//                child 2p+2's in fp32 and rounds to the payload type once
//                (one rounding a level), writing the sum straight into its
//                parent's slot; the root's sum goes, in the same pass of
//                registers, to its own output and its children's, and each
//                interior node passes its rows on from its output to its
//                children's (read once, written twice). On the push
//                protocol (push.cuh): each child publishes its fresh output
//                to its parent in each tree; each parent's block frees its
//                two slots to its children at its start (a slot written
//                for call t only after the parent's call-t kernel began,
//                which stream order puts after its call t-1 read them), so
//                no entry barrier and no broadcast slot. Each tree runs on
//                its own blocks ([0, G) tree 0, [G, 2G) tree 1), so a rank
//                that is a leaf of one tree and interior in the other never
//                holds one tree's work behind the other's waits.
//
// What bounds them: bytes. Each is a copy with at most an add per
// element, far below the card's 295 operations a byte; on n cards the
// pushes cross NVLink (450 GB/s a direction), on one card with virtual
// ranks every byte goes through the one card's HBM. Small payloads (a
// decode step's 4 rows) are bound by latency instead: the flag round
// trips, and the launch. The design moves 16 bytes a thread with
// neighbouring threads on neighbouring addresses, and splits the payload
// over blocks, each of which synchronises only with the same block of its
// peers — no grid-wide barrier, and a grid within 1/r of the SMs (r ranks
// on the card), so virtual ranks on one card never starve each other of
// SMs. Every kernel here is on the push protocol and sizes its grid on the
// host: the AllGathers, rs_ring, the one-shot and the parity stream by
// their payload (a 256-row slice's 2 MiB input: 32 blocks, under the cap
// of 33 at 4 ranks a card; a decode step's 32 KiB: 4), each thread keeping
// push::kUnroll 16-byte loads in flight. They are safe across calls by
// push.cuh's argument: the output is fresh every call, a sender reads a
// receiver's address only once the receiver's ready word reached the
// call's epoch, and a receiver reaches its next call only after every
// sender's data word of this one.
// The tree is latency-bound at its main shape (a 203-row
// prefill's 1.6 MB: four dependent data hops at n = 4, two up and two
// down, each a flag round trip): its design cuts a hop's cost — no entry
// barrier, every byte moved once a hop (the first tree stored each
// interior partial into its own output and read it back, and copied the
// broadcast out of a slot), both trees at once on their own blocks, and
// shares small enough (a block per 32 KiB, 512 threads) that a hop is one
// round of loads a thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "dist.cuh"
#include "push.cuh"

using tdt::from_f;
using tdt::to_f;
using namespace tdt::dist;

namespace {

// x: this rank's payload (nbytes), published to every peer; out: this
// rank's fresh sum. Block b reads share b of every rank's input (the same
// share on every rank), operand k the input of rank k, so the sum is in
// rank order; then it releases every source and holds this rank's input
// until every reader released it. n = 1 reads its own input alone. The
// body of ar_one_shot and ar_parity.
template <typename T, bool SYS>
__device__ __forceinline__ void ar_one_shot_body(const Group& g,
                                                 const tdt::push::Layout& L,
                                                 const char* x, char* out,
                                                 long long nbytes) {
  namespace pu = tdt::push;
  __shared__ const uint4* src[kMaxRanks];
  const int n = g.n, me = g.rank, j = threadIdx.x;
  const int all = (1 << n) - 1;
  if (blockIdx.x == 0 && j < n && j != me) pu::publish<SYS>(g, L, j, x);
  // Thread j resolves source j's input.
  int ok = 1;
  if (j < n) {
    const char* b = j == me ? x : pu::await_dest<SYS>(g, L, j);
    ok = b != nullptr;
    src[j] = reinterpret_cast<const uint4*>(b);
  }
  if (!__syncthreads_and(ok)) return;
  long long lo, hi;
  pu::share(nbytes, &lo, &hi);
  pu::ordered_sum<T, true>(src, n, reinterpret_cast<uint4*>(out), lo / 16,
                           hi / 16);
  __syncthreads();
  if (j == 0) pu::signal_data<SYS>(g, L, all);
  pu::wait_data<SYS>(g, L, all);
}

template <typename T, bool SYS>
__global__ void __launch_bounds__(tdt::push::kThreads)
    ar_one_shot_kernel(Group g, tdt::push::Layout L, const char* x,
                       char* out, long long nbytes) {
  ar_one_shot_body<T, SYS>(g, L, x, out, nbytes);
}

// The parity stream: the one-shot's body over the stream's own pad, its own
// kernel so that a profile tells the two apart. g.epoch is the call index
// + 1, the same sequence on every rank, with no host sync between calls.
// A rank's call t+1 never reads a peer's call-t address: it reads source
// j's address only once j's ready word in this rank's pad reached t+2,
// which j releases after storing its call-(t+1) input address; and j
// stores that address only after its call-t kernel ended, i.e. after every
// reader's block released j's call-t input, each one having read j's
// address and its last byte of that input first. So the input a reader
// sums is the one its source passed for the same call, and a source may
// overwrite or free its input once its kernel ends. A call out of sequence
// waits for words no peer raises and times out (the host refuses it
// first: ops/allreduce.all_reduce_stream).
template <typename T, bool SYS>
__global__ void __launch_bounds__(tdt::push::kThreads)
    ar_parity_kernel(Group g, tdt::push::Layout L, const char* x, char* out,
                     long long nbytes) {
  ar_one_shot_body<T, SYS>(g, L, x, out, nbytes);
}

// x: (n, chunk) of this rank's contributions, published to every peer; out:
// this rank's fresh summed chunk. Block b reads share b of chunk `rank` from
// every source (the same share on every rank), operand k the input of rank
// rank+1+k (mod n), so the last is this rank's own.
template <typename T, bool SYS>
__global__ void __launch_bounds__(tdt::push::kThreads)
    rs_ring_kernel(Group g, tdt::push::Layout L, const char* x, char* out,
                   long long chunk_bytes) {
  namespace pu = tdt::push;
  __shared__ const uint4* src[kMaxRanks];
  const int n = g.n, me = g.rank, j = threadIdx.x;
  const int all = (1 << n) - 1;
  if (blockIdx.x == 0 && j < n && j != me) pu::publish<SYS>(g, L, j, x);
  // Thread j resolves source j's input: operand (j - me - 1) mod n.
  int ok = 1;
  if (j < n) {
    const char* b = j == me ? x : pu::await_dest<SYS>(g, L, j);
    ok = b != nullptr;
    src[(j - me - 1 + n) % n] = reinterpret_cast<const uint4*>(
        ok ? b + me * chunk_bytes : nullptr);
  }
  if (!__syncthreads_and(ok)) return;
  long long lo, hi;
  pu::share(chunk_bytes, &lo, &hi);
  pu::ordered_sum<T, false>(src, n, reinterpret_cast<uint4*>(out), lo / 16,
                            hi / 16);
  // Every thread's loads returned (their sums are stored); release the
  // sources, then hold this rank's input until every owner released it.
  __syncthreads();
  if (j == 0) pu::signal_data<SYS>(g, L, all);
  pu::wait_data<SYS>(g, L, all);
}

// x: one chunk; out: n chunks, this rank's fresh output. Block 0 publishes
// out to every peer; every block writes its share of x into slot `rank` of
// every rank's output, signals each peer, and waits for the n-1 peers'
// shares of the same block. n = 1 is the loopback (force_kernel): the
// copy into its own slot. The body of ag_ring, ag_full_mesh and
// ag_parity.
template <bool SYS>
__device__ __forceinline__ void ag_push(const Group& g,
                                        const tdt::push::Layout& L,
                                        const char* x, char* out,
                                        long long chunk_bytes) {
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

template <bool SYS>
__global__ void __launch_bounds__(tdt::push::kThreads)
    ag_full_mesh_kernel(Group g, tdt::push::Layout L, const char* x,
                        char* out, long long chunk_bytes) {
  ag_push<SYS>(g, L, x, out, chunk_bytes);
}

// The ring: the same push, its own kernel so that a profile tells it
// apart (the two-shot AllReduce's second half).
template <bool SYS>
__global__ void __launch_bounds__(tdt::push::kThreads)
    ag_ring_kernel(Group g, tdt::push::Layout L, const char* x, char* out,
                   long long chunk_bytes) {
  ag_push<SYS>(g, L, x, out, chunk_bytes);
}

// The parity stream: the same push over the stream's own pad, its grid
// sized for a latency-bound copy (ops/_comm.AGP_BLOCK_BYTES); its own
// kernel so that a profile tells the two apart.
template <bool SYS>
__global__ void __launch_bounds__(tdt::push::kThreads)
    ag_parity_kernel(Group g, tdt::push::Layout L, const char* x, char* out,
                     long long chunk_bytes) {
  ag_push<SYS>(g, L, x, out, chunk_bytes);
}

// The tree's words in a rank's signal pad (ops/_comm.TreeLayout), for
// tree t, child slot c (0 for child 2p+1, 1 for 2p+2) and the tree's
// block k:
//   addr + 2t + c, ready + 2t + c  child c's output and its epoch (the
//                                  parent's pad);
//   free + t * stride + k          the parent's block k let this rank
//                                  write its slot (the child's pad);
//   up + (2t + c) * stride + k     child c's block k wrote its slot (the
//                                  parent's pad);
//   down + t * stride + k          the parent's block k wrote this rank's
//                                  rows of tree t (the child's pad).
struct TreeLayout {
  int addr;
  int ready;
  int free;
  int up;
  int down;
  int stride;
};

// Every word inside the pad, the five ranges apart.
bool bad_tree_layout(const TreeLayout& L, int blocks) {
  return blocks < 1 || L.stride < blocks || L.addr < 0 ||
         L.ready < L.addr + 4 || L.free < L.ready + 4 ||
         L.up < L.free + 2 * L.stride || L.down < L.up + 4 * L.stride ||
         L.down + 2 * L.stride > kSignalWords;
}

__device__ __forceinline__ int tree_pos(int rank, int n, int tree) {
  return tree == 0 ? rank : n - 1 - rank;
}

// The tree's blocks: 512 threads, so that a block's share of a 203-row
// prefill's rows (~51 KiB) is one round of kUnroll loads a thread: each
// of a call's four data hops is one round, not two (on an H100 80GB HBM3
// at 700 W, 256 threads and a block per 64 KiB measured 0.0313 ms a call
// against 0.0246 at the main shape: PERF.md §6).
constexpr int kTreeThreads = 512;

// The node's own rows plus its children's slots (1 or 2), added in fp32
// in that order and cast once, over vectors [v0, v1) of the tree's rows,
// stored to each of `nd` destinations. kUnroll vectors a thread in flight.
template <typename T>
__device__ __forceinline__ void reduce_fan(const uint4* x, const uint4* w0,
                                           const uint4* w1, bool has2,
                                           uint4* const* dst, int nd,
                                           long long v0, long long v1) {
  constexpr int E = Vec<T>::N;
  constexpr int U = tdt::push::kUnroll;
  const long long TB = blockDim.x;
  for (long long base = v0 + threadIdx.x; base < v1; base += TB * U) {
    uint4 a[U], b[U], c[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const long long v = base + k * TB;
      if (v < v1) {
        a[k] = __ldg(x + v);
        b[k] = __ldcg(w0 + v);
        if (has2) c[k] = __ldcg(w1 + v);
      }
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      float acc[E];
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[e] = to_f(elems<T>(a[k])[e]) + to_f(elems<T>(b[k])[e]);
      if (has2) {
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[e] = acc[e] + to_f(elems<T>(c[k])[e]);
      }
      T* oe = reinterpret_cast<T*>(&a[k]);
#pragma unroll
      for (int e = 0; e < E; ++e) oe[e] = from_f<T>(acc[e]);
    }
    for (int d = 0; d < nd; ++d) {
      uint4* o = dst[d];
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const long long v = base + k * TB;
        if (v < v1) o[v] = a[k];
      }
    }
  }
}

// x, out: (m, cols) as vectors, row_vec a row; out this rank's fresh
// output; the symmetric workspace: (n_trees, 2, mh0, cols), slot c of
// tree t child c's partial. Tree t owns rows [t * mh0, min(m, (t + 1) *
// mh0)) and blocks [t * G, (t + 1) * G); its block k the k-th share of
// them, the same on every rank.
template <typename T, bool SYS>
__global__ void __launch_bounds__(kTreeThreads)
    ar_tree_kernel(Group g, TreeLayout L, const uint4* x, uint4* out,
                   long long row_vec, int m, int n_trees, int G) {
  namespace pu = tdt::push;
  const int t = blockIdx.x / G, k = blockIdx.x % G;
  const int n = g.n, j = threadIdx.x;
  const int mh0 = (m + n_trees - 1) / n_trees;
  const int rows = min(m, (t + 1) * mh0) - t * mh0;
  const long long slot_vec = (long long)mh0 * row_vec;
  const long long off = (long long)t * slot_vec;
  const long long nvec = (long long)rows * row_vec;
  const long long per = (nvec + G - 1) / G;
  const long long v0 = min(nvec, per * k), v1 = min(nvec, v0 + per);
  const int pos = tree_pos(g.rank, n, t);
  const int parent = pos == 0 ? -1 : tree_pos((pos - 1) / 2, n, t);
  const int mine = (pos + 1) % 2;            // this rank's slot at parent
  const int nc = min(2, max(0, n - 1 - 2 * pos));
  auto child = [&](int c) { return tree_pos(2 * pos + 1 + c, n, t); };
  __shared__ uint4* dst[3];
  // Publish this call's output to the parent (the tree's first block);
  // free this rank's slots to its children (every block, its share).
  if (k == 0 && j == 0 && parent >= 0)
    pu::publish_at<SYS>(g, parent, L.addr + 2 * t + mine,
                        L.ready + 2 * t + mine, out);
  if (j < nc)
    pu::signal_word<SYS>(g, child(j), L.free + t * L.stride + k);
  uint4* up = nullptr;                       // this rank's parent slot
  if (parent >= 0)
    up = reinterpret_cast<uint4*>(peer_base(g, parent)) +
         (2 * t + mine) * slot_vec;
  const uint4* ws = reinterpret_cast<const uint4*>(peer_base(g, g.rank));
  // Up: a leaf's rows, or own + children's partials, into the parent's
  // slot once it is free; the root's sum to its output and its children's.
  int ok = 1;
  if (j < nc) ok = pu::spin<SYS>(g, L.up + (2 * t + j) * L.stride + k,
                                 g.epoch);
  if (j == 0 && parent >= 0 && ok)
    ok = pu::spin<SYS>(g, L.free + t * L.stride + k, g.epoch);
  if (j == 0 && ok) {
    if (parent >= 0) {
      dst[0] = up;
    } else {
      dst[0] = out + off;
    }
  }
  if (j < nc && parent < 0 && ok) {
    char* o = pu::await_at<SYS>(g, L.addr + 2 * t + j, L.ready + 2 * t + j);
    ok = o != nullptr;
    dst[1 + j] = reinterpret_cast<uint4*>(o) + off;
  }
  if (!__syncthreads_and(ok)) return;
  const int nd = parent >= 0 ? 1 : 1 + nc;
  if (nc == 0)
    pu::fan_out(x + off, dst, nd, v0, v1);
  else
    reduce_fan<T>(x + off, ws + (2 * t) * slot_vec,
                  ws + (2 * t + 1) * slot_vec, nc == 2, dst, nd, v0, v1);
  __syncthreads();
  if (j == 0 && parent >= 0)
    pu::signal_word<SYS>(g, parent, L.up + (2 * t + mine) * L.stride + k);
  if (j < nc && parent < 0)
    pu::signal_word<SYS>(g, child(j), L.down + t * L.stride + k);
  if (parent < 0) return;
  // Down: this rank's rows from its parent, then on to its children.
  if (!pu::wait_word<SYS>(g, L.down + t * L.stride + k) || nc == 0) return;
  if (j < nc) {
    char* o = pu::await_at<SYS>(g, L.addr + 2 * t + j, L.ready + 2 * t + j);
    ok = o != nullptr;
    dst[j] = reinterpret_cast<uint4*>(o) + off;
  }
  if (!__syncthreads_and(ok)) return;
  pu::fan_out<true>(out + off, dst, nc, v0, v1);
  __syncthreads();
  if (j < nc) pu::signal_word<SYS>(g, child(j), L.down + t * L.stride + k);
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

bool bad_group(int rank, int n, long long nvec) {
  return n < 1 || n > kMaxRanks || rank < 0 || rank >= n || nvec < 1;
}

// The AllReduces on ar_one_shot_body: one kernel a dtype (0 float32, 1
// bfloat16) and scope.
typedef void (*ArPushKernel)(Group, tdt::push::Layout, const char*, char*,
                             long long);

// One launch of an AllReduce on ar_one_shot_body, its arguments checked:
// whole 16-byte vectors, a known dtype, the host's layout inside the pad.
int launch_ar(const ArPushKernel (&k)[2][2], const void* table,
              const void* sig_table, void* err, int rank, int n,
              unsigned long long epoch, long long timeout_ns, const void* x,
              void* out, long long nbytes, int dtype, int grid, int sys,
              int addr, int ready, int data, int stride,
              cudaStream_t stream) {
  const tdt::push::Layout L{addr, ready, data, stride};
  if (bad_group(rank, n, nbytes / 16) || nbytes % 16 || dtype < 0 ||
      dtype > 1 || tdt::push::bad_layout(L, n, grid))
    return cudaErrorInvalidValue;
  const Group g = make_group(table, sig_table, err, rank, n, epoch,
                             timeout_ns);
  k[dtype][sys ? 1 : 0]<<<grid, tdt::push::kThreads, 0, stream>>>(
      g, L, static_cast<const char*>(x), static_cast<char*>(out), nbytes);
  return cudaGetLastError();
}

const ArPushKernel kOneShot[2][2] = {
    {ar_one_shot_kernel<float, false>, ar_one_shot_kernel<float, true>},
    {ar_one_shot_kernel<__nv_bfloat16, false>,
     ar_one_shot_kernel<__nv_bfloat16, true>}};
const ArPushKernel kParity[2][2] = {
    {ar_parity_kernel<float, false>, ar_parity_kernel<float, true>},
    {ar_parity_kernel<__nv_bfloat16, false>,
     ar_parity_kernel<__nv_bfloat16, true>}};

// The AllGathers on ag_push: one kernel a scope.
typedef void (*AgPushKernel)(Group, tdt::push::Layout, const char*, char*,
                             long long);

// One launch of an AllGather on ag_push, its arguments checked: at least
// `min_n` ranks, whole 16-byte vectors, the host's layout inside the pad.
int launch_ag(AgPushKernel gpu_k, AgPushKernel sys_k, int min_n,
              const void* table, const void* sig_table, void* err, int rank,
              int n, unsigned long long epoch, long long timeout_ns,
              const void* x, void* out, long long chunk_bytes, int grid,
              int sys, int addr, int ready, int data, int stride,
              cudaStream_t stream) {
  const tdt::push::Layout L{addr, ready, data, stride};
  if (bad_group(rank, n, chunk_bytes / 16) || n < min_n || chunk_bytes % 16 ||
      tdt::push::bad_layout(L, n, grid))
    return cudaErrorInvalidValue;
  const Group g = make_group(table, sig_table, err, rank, n, epoch,
                             timeout_ns);
  const AgPushKernel k = sys ? sys_k : gpu_k;
  k<<<grid, tdt::push::kThreads, 0, stream>>>(
      g, L, static_cast<const char*>(x), static_cast<char*>(out),
      chunk_bytes);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16. nbytes: one rank's payload (a multiple of
// 16; pointers 16-byte aligned). Every entry returns its cudaError_t.
// x: this rank's input, out: its fresh sum. grid (sized by the payload),
// sys (the flags' scope: 1 when a peer is another card) and the pad layout
// (addr, ready, data, stride) come from the host (ops/_comm.launch_push),
// the same on every rank.
int tdt_ar_one_shot(const void* table, const void* sig_table, void* err,
                    int rank, int n, unsigned long long epoch,
                    long long timeout_ns, const void* x, void* out,
                    long long nbytes, int dtype, int grid, int sys, int addr,
                    int ready, int data, int stride, cudaStream_t stream) {
  return launch_ar(kOneShot, table, sig_table, err, rank, n, epoch,
                   timeout_ns, x, out, nbytes, dtype, grid, sys, addr, ready,
                   data, stride, stream);
}

// As tdt_ar_one_shot, over the parity stream's pad: epoch is the call
// index + 1 (the pad's). n = 1 is the loopback (force_kernel).
int tdt_ar_parity(const void* table, const void* sig_table, void* err,
                  int rank, int n, unsigned long long epoch,
                  long long timeout_ns, const void* x, void* out,
                  long long nbytes, int dtype, int grid, int sys, int addr,
                  int ready, int data, int stride, cudaStream_t stream) {
  return launch_ar(kParity, table, sig_table, err, rank, n, epoch,
                   timeout_ns, x, out, nbytes, dtype, grid, sys, addr, ready,
                   data, stride, stream);
}

// chunk_bytes: one output chunk (x, this rank's input, holds n of them;
// out is this rank's fresh output). grid (sized by x's bytes), sys (the
// flags' scope: 1 when a peer is another card) and the pad layout (addr,
// ready, data, stride) come from the host (ops/_comm.launch_push), the same
// on every rank.
int tdt_rs_ring(const void* table, const void* sig_table, void* err,
                int rank, int n, unsigned long long epoch,
                long long timeout_ns, const void* x, void* out,
                long long chunk_bytes, int dtype, int grid, int sys,
                int addr, int ready, int data, int stride,
                cudaStream_t stream) {
  const long long cvec = chunk_bytes / 16;
  const tdt::push::Layout L{addr, ready, data, stride};
  if (bad_group(rank, n, cvec) || n < 2 || chunk_bytes % 16 ||
      tdt::push::bad_layout(L, n, grid))
    return cudaErrorInvalidValue;
  const Group g = make_group(table, sig_table, err, rank, n, epoch,
                             timeout_ns);
  const dim3 blocks(grid), block(tdt::push::kThreads);
  const char* xi = static_cast<const char*>(x);
  char* o = static_cast<char*>(out);
  if (dtype == 0 && sys)
    rs_ring_kernel<float, true><<<blocks, block, 0, stream>>>(g, L, xi, o,
                                                             chunk_bytes);
  else if (dtype == 0)
    rs_ring_kernel<float, false><<<blocks, block, 0, stream>>>(g, L, xi, o,
                                                              chunk_bytes);
  else if (dtype == 1 && sys)
    rs_ring_kernel<__nv_bfloat16, true><<<blocks, block, 0, stream>>>(
        g, L, xi, o, chunk_bytes);
  else if (dtype == 1)
    rs_ring_kernel<__nv_bfloat16, false><<<blocks, block, 0, stream>>>(
        g, L, xi, o, chunk_bytes);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// chunk_bytes: one input chunk (out, this rank's fresh output, holds n of
// them). grid, sys (the flags' scope: 1 when a peer is another card) and
// the pad layout (addr, ready, data, stride) come from the host
// (ops/_comm.launch_push), the same on every rank. The ring needs n >= 2
// (a one-rank group returns its input without a launch).
int tdt_ag_ring(const void* table, const void* sig_table, void* err,
                int rank, int n, unsigned long long epoch,
                long long timeout_ns, const void* x, void* out,
                long long chunk_bytes, int grid, int sys, int addr,
                int ready, int data, int stride, cudaStream_t stream) {
  return launch_ag(ag_ring_kernel<false>, ag_ring_kernel<true>, 2, table,
                   sig_table, err, rank, n, epoch, timeout_ns, x, out,
                   chunk_bytes, grid, sys, addr, ready, data, stride, stream);
}

// As tdt_ag_ring; n = 1 is the loopback (force_kernel).
int tdt_ag_full_mesh(const void* table, const void* sig_table, void* err,
                     int rank, int n, unsigned long long epoch,
                     long long timeout_ns, const void* x, void* out,
                     long long chunk_bytes, int grid, int sys, int addr,
                     int ready, int data, int stride, cudaStream_t stream) {
  return launch_ag(ag_full_mesh_kernel<false>, ag_full_mesh_kernel<true>, 1,
                   table, sig_table, err, rank, n, epoch, timeout_ns, x, out,
                   chunk_bytes, grid, sys, addr, ready, data, stride, stream);
}

// As tdt_ag_full_mesh, over the parity stream's pad: epoch is the call
// index + 1 (the pad's), so a call out of sequence waits for words no
// peer raises and times out. n = 1 is the loopback (force_kernel).
int tdt_ag_parity(const void* table, const void* sig_table, void* err,
                  int rank, int n, unsigned long long epoch,
                  long long timeout_ns, const void* x, void* out,
                  long long chunk_bytes, int grid, int sys, int addr,
                  int ready, int data, int stride, cudaStream_t stream) {
  return launch_ag(ag_parity_kernel<false>, ag_parity_kernel<true>, 1, table,
                   sig_table, err, rank, n, epoch, timeout_ns, x, out,
                   chunk_bytes, grid, sys, addr, ready, data, stride, stream);
}

// row_bytes: one payload row (a multiple of 16); rows: m; n_trees: 2 (the
// double tree) or 1; out: this rank's fresh output. grid (G blocks a
// tree), sys (the flags' scope) and the pad layout (addr, ready, free, up,
// down, stride) come from the host (ops/_comm.launch_tree), the same on
// every rank.
int tdt_ar_tree(const void* table, const void* sig_table, void* err,
                int rank, int n, unsigned long long epoch,
                long long timeout_ns, const void* x, void* out,
                long long row_bytes, int rows, int n_trees, int dtype,
                int grid, int sys, int addr, int ready, int free_w, int up,
                int down, int stride, cudaStream_t stream) {
  const long long row_vec = row_bytes / 16;
  const TreeLayout L{addr, ready, free_w, up, down, stride};
  if (bad_group(rank, n, row_vec) || n < 2 || row_bytes % 16 || rows < 1 ||
      n_trees < 1 || n_trees > 2 || n_trees > rows ||
      bad_tree_layout(L, grid))
    return cudaErrorInvalidValue;
  const Group g = make_group(table, sig_table, err, rank, n, epoch,
                             timeout_ns);
  const dim3 blocks(grid * n_trees), block(kTreeThreads);
  const uint4* xi = static_cast<const uint4*>(x);
  uint4* o = static_cast<uint4*>(out);
  if (dtype == 0 && sys)
    ar_tree_kernel<float, true><<<blocks, block, 0, stream>>>(
        g, L, xi, o, row_vec, rows, n_trees, grid);
  else if (dtype == 0)
    ar_tree_kernel<float, false><<<blocks, block, 0, stream>>>(
        g, L, xi, o, row_vec, rows, n_trees, grid);
  else if (dtype == 1 && sys)
    ar_tree_kernel<__nv_bfloat16, true><<<blocks, block, 0, stream>>>(
        g, L, xi, o, row_vec, rows, n_trees, grid);
  else if (dtype == 1)
    ar_tree_kernel<__nv_bfloat16, false><<<blocks, block, 0, stream>>>(
        g, L, xi, o, row_vec, rows, n_trees, grid);
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
