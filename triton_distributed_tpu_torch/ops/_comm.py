"""What the collective wrappers share: the kernels of
``csrc/collectives.cu``, ``csrc/all_to_all.cu``, ``csrc/gemm_comm.cu``,
``csrc/p2p.cu`` and ``csrc/multi_axis.cu``,
their launch, the payload checks, the CPU rendezvous through a symmetric
buffer's slots, the push protocol's plan (pad layout, grid, scope) and
the straggler hook.

A wrapper takes the kernel only for a CUDA tensor and the plain version
only for a CPU tensor; nothing falls back.
"""

from __future__ import annotations

import ctypes
import dataclasses
import time

import torch

from triton_distributed_tpu_torch.runtime.build import (
    CudaKernel, current_stream, ptr,
)
from triton_distributed_tpu_torch.runtime.context import (
    DistContext, current_rank,
)
from triton_distributed_tpu_torch.runtime.symm import SymmBuffer

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# The byte-copy kernels (the all-gathers, the AllToAll) carry any of these.
COPY_DTYPES = (torch.float32, torch.bfloat16, torch.float8_e4m3fn)

_GROUP_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                        ctypes.c_ulonglong, ctypes.c_longlong,
                                        ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_longlong]

# The push protocol's launch arguments (csrc/push.cuh): the grid, the
# flags' scope, and the pad layout's addr, ready, data and stride.
_PUSH_ARGS = [ctypes.c_int] * 6
# B5's one-shot on the push protocol (every rank reads every input) and its
# parity stream (the same body over the stream's pad): the dtype code, then
# the push arguments.
ONE_SHOT_KERNEL = CudaKernel("collectives.cu", "tdt_ar_one_shot",
                             _GROUP_ARGS + [ctypes.c_int] + _PUSH_ARGS
                             + [ctypes.c_void_p])
PARITY_KERNEL = CudaKernel("collectives.cu", "tdt_ar_parity",
                           _GROUP_ARGS + [ctypes.c_int] + _PUSH_ARGS
                           + [ctypes.c_void_p])
# B4's ring: the full-mesh push's body in one hop, its own entry.
AG_RING_KERNEL = CudaKernel("collectives.cu", "tdt_ag_ring",
                            _GROUP_ARGS + _PUSH_ARGS + [ctypes.c_void_p])
# B6's ring reduce-scatter on the push protocol (the owner reads): the
# dtype code, then the push arguments.
RS_RING_KERNEL = CudaKernel("collectives.cu", "tdt_rs_ring",
                            _GROUP_ARGS + [ctypes.c_int] + _PUSH_ARGS
                            + [ctypes.c_void_p])
# B5's double tree on the push protocol: rows, trees and the dtype code,
# then the grid (blocks a tree), the scope and its pad layout (TreeLayout).
TREE_KERNEL = CudaKernel("collectives.cu", "tdt_ar_tree",
                         _GROUP_ARGS + [ctypes.c_int] * 3
                         + [ctypes.c_int] * 8 + [ctypes.c_void_p])
AG_FULL_MESH_KERNEL = CudaKernel("collectives.cu", "tdt_ag_full_mesh",
                                 _GROUP_ARGS + _PUSH_ARGS
                                 + [ctypes.c_void_p])
AG_PARITY_KERNEL = CudaKernel("collectives.cu", "tdt_ag_parity",
                              _GROUP_ARGS + _PUSH_ARGS + [ctypes.c_void_p])
# B7, the PP transport (csrc/p2p.cu): the ring shift (its shift) and the
# static permutation (this rank's destination set and source).
P2P_SHIFT_KERNEL = CudaKernel("p2p.cu", "tdt_p2p_shift",
                              _GROUP_ARGS + [ctypes.c_int] + _PUSH_ARGS
                              + [ctypes.c_void_p])
P2P_PERMUTE_KERNEL = CudaKernel("p2p.cu", "tdt_p2p_permute",
                                _GROUP_ARGS + [ctypes.c_int, ctypes.c_int]
                                + _PUSH_ARGS + [ctypes.c_void_p])
# B12, the collectives over both axes of a 2-axis group
# (csrc/multi_axis.cu), both push-protocol kernels: the grid's (n0, n1)
# ride after the byte count (the AllReduce's per-call mid before them, its
# dtype code after), then the grid, the scope and the layout's words
# (the AllReduce's TorusARLayout: six).
AG_TORUS_KERNEL = CudaKernel("multi_axis.cu", "tdt_ag_torus",
                             _GROUP_ARGS + [ctypes.c_int, ctypes.c_int]
                             + _PUSH_ARGS + [ctypes.c_void_p])
AR_TORUS_KERNEL = CudaKernel("multi_axis.cu", "tdt_ar_torus",
                             _GROUP_ARGS + [ctypes.c_void_p]
                             + [ctypes.c_int] * 3 + [ctypes.c_int] * 8
                             + [ctypes.c_void_p])
# B8, the EP AllToAll (csrc/all_to_all.cu): the barrier form and the
# parity stream, both on the push protocol (the send buffer and the output
# as the payload, the row's bytes, then both splits, cap, block and
# experts a rank, then the grid, the scope and A2ALayout's five words).
_A2A_ARGS = (_GROUP_ARGS + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
             + [ctypes.c_int] * 7 + [ctypes.c_void_p])
A2A_KERNEL = CudaKernel("all_to_all.cu", "tdt_a2a", _A2A_ARGS)
A2A_PARITY_KERNEL = CudaKernel("all_to_all.cu", "tdt_a2a_parity", _A2A_ARGS)
# The fused GEMM + communication kernels B9 (AG+GEMM), B10 (GEMM+RS) and
# B11 (GEMM+AR): one entry, one CudaKernel each, so each counts its own.
_GEMM_COMM_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                            ctypes.c_ulonglong,
                                            ctypes.c_longlong]
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12
                   + [ctypes.c_void_p])
# The fused kernels' routes, by the tile code the wrappers pass
# (ops/allgather_gemm.gemm_tile_for, ops/gemm_allreduce.gemm_ar_route):
# B3's tall and short mma.sync tiles, the wgmma + TMA mainloop (B9, B10)
# and B11's split-K weight stream. Each launch counts under its route's
# name in ``variant_launches``.
GEMM_ROUTES = ("mma_tall", "mma_short", "wgmma", "splitk")
AG_GEMM_KERNEL = CudaKernel("gemm_comm.cu", "tdt_gemm_comm", _GEMM_COMM_ARGS)
GEMM_RS_KERNEL = CudaKernel("gemm_comm.cu", "tdt_gemm_comm", _GEMM_COMM_ARGS)
GEMM_AR_KERNEL = CudaKernel("gemm_comm.cu", "tdt_gemm_comm", _GEMM_COMM_ARGS)
# Not a collective: holds a stream (the straggler), and the library's
# peer-access entry.
SPIN = CudaKernel("collectives.cu", "tdt_spin",
                  [ctypes.c_longlong, ctypes.c_void_p])
# Not a collective either: holds a stream until a page-locked host word is
# set (a timing harness releases every rank's stream at one instant).
HOLD = CudaKernel("collectives.cu", "tdt_hold",
                  [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p])
PEER_ACCESS = CudaKernel("collectives.cu", "tdt_enable_peer_access",
                         [ctypes.c_int, ctypes.c_int])
STREAMS = CudaKernel("collectives.cu", "tdt_stream_create",
                     [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p)])

COLLECTIVE_KERNELS = (ONE_SHOT_KERNEL, PARITY_KERNEL, RS_RING_KERNEL,
                      AG_RING_KERNEL, TREE_KERNEL, AG_GEMM_KERNEL,
                      GEMM_RS_KERNEL, GEMM_AR_KERNEL, AG_FULL_MESH_KERNEL,
                      A2A_KERNEL, A2A_PARITY_KERNEL, AG_PARITY_KERNEL,
                      P2P_SHIFT_KERNEL, P2P_PERMUTE_KERNEL, AG_TORUS_KERNEL,
                      AR_TORUS_KERNEL)
_GEMM_OP = {AG_GEMM_KERNEL: 0, GEMM_RS_KERNEL: 1, GEMM_AR_KERNEL: 2}


# The push protocol of every collective kernel (csrc/push.cuh; B11's
# split-K route takes its flags): the receiver publishes its fresh output's
# address into its senders' signal pads, each sender writes its block
# straight into that output and raises a data flag a block (B6, B5's
# one-shot and parity stream and B12's torus AR mirror the roles: a rank
# publishes its input, its owners read it and release it). The host lays
# the pad out, sizes the grid and picks the flags' scope; the kernel checks
# them.
MAX_RANKS = 8                    # csrc/dist.cuh kMaxRanks
PUSH_MAX_BLOCKS = 128            # the data flags a source: the largest grid
PUSH_BLOCK_BYTES = 64 << 10      # the least payload a block is given
# B8's parity stream: a block per 16 KiB of the send buffer. A decode call
# moves a few 16-row blocks a slot and is bound by latency, so more and
# smaller shares: at cap 32 x 2048 bf16 on 4 ranks 32 blocks measured
# 0.0134 ms a call as a span against 0.0142 at 16 and 0.0146-0.0149 at 8
# (H100 80GB HBM3, 700 W; scripts/time_port_copy.py, PERF.md §6 PR 19).
A2A_BLOCK_BYTES = 16 << 10
# B4's parity stream: a block per AGP_BLOCK_BYTES of a rank's chunk. The SP
# decode's gather (128 x 130 fp32, 65 KiB a rank) is latency-bound, so
# small shares (9 blocks): on 4 ranks 4, 8 and 16 KiB measured 0.0121,
# 0.0118 and 0.0121 ms a call as a span, 32 KiB 0.0134 (H100 80GB HBM3,
# 700 W; scripts/time_port_copy.py's case, PERF.md §6).
AGP_BLOCK_BYTES = 8 << 10
# B4's ring: a block per AG_RING_BLOCK_BYTES of a rank's chunk. The 256-row
# prefill slice's gather (64 x 4096 bf16, 512 KiB a rank) is latency-bound:
# on 4 ranks 16 and 32 KiB a block measured 0.0140 / 0.0141 ms a call as a
# span against 0.0174-0.0177 at 64 KiB (8 blocks: two rounds of loads a
# thread); at 2048 rows all three hit the cap of 33 blocks and tied at
# 0.0451-0.0454 (H100 80GB HBM3, 700 W; scripts/time_port_copy.py
# --ring-block, PERF.md §6 row 4).
AG_RING_BLOCK_BYTES = 32 << 10
# B5's one-shot: a block per AR_ONE_SHOT_BLOCK_BYTES of the payload. The
# verify step's 16 x 4096 bf16 (128 KiB a rank) is latency-bound: on 4
# ranks 4, 8 and 16 KiB a block (32 / 16 / 8 blocks) measured 0.0122-0.0132,
# 0.0125-0.0136 and 0.0128-0.0129 ms a call as a span, 32 KiB 0.0132-0.0139,
# 64 KiB (the copy engine's default, 2 blocks) 0.0150; at 2048 rows all hit
# the cap of 33 and tied at 0.0825-0.0840 (H100 80GB HBM3, 700 W;
# scripts/time_port_copy.py --one-shot-block, PERF.md §6 row 6). B5's
# parity stream runs the same body at the same block: a decode step's 4 x
# 4096 bf16 (32 KiB) takes 4 blocks.
AR_ONE_SHOT_BLOCK_BYTES = 8 << 10
# B12's torus AR: a block per AR_TORUS_BLOCK_BYTES of the payload (16
# blocks, the cap at 8 ranks a card, at 16 x 4096 bf16).
AR_TORUS_BLOCK_BYTES = 8 << 10


@dataclasses.dataclass(frozen=True)
class PushLayout:
    """Word offsets of the push protocol in a rank's signal pad: ``addr +
    j`` receiver j's output address and ``ready + j`` its epoch (in the
    sender's pad); ``data + src * stride + b`` source src's block b landed
    (in the receiver's pad)."""

    addr: int = 0
    ready: int = MAX_RANKS
    data: int = 2 * MAX_RANKS
    stride: int = PUSH_MAX_BLOCKS

    def words(self, n: int, grid: int) -> dict:
        """The words a call at n ranks and ``grid`` blocks uses, by
        kind."""
        return {"addr": [self.addr + j for j in range(n)],
                "ready": [self.ready + j for j in range(n)],
                "data": [self.data + s * self.stride + b
                         for s in range(n) for b in range(grid)]}

    def args(self) -> tuple:
        return (self.addr, self.ready, self.data, self.stride)


PUSH_LAYOUT = PushLayout()


@dataclasses.dataclass(frozen=True)
class A2ALayout(PushLayout):
    """B8 (both forms) on the push protocol: :class:`PushLayout` plus
    ``splits + j``, receiver j's splits address (in the sender's pad; a
    receiver publishes its output and its splits)."""

    splits: int = MAX_RANKS
    ready: int = 2 * MAX_RANKS
    data: int = 3 * MAX_RANKS

    def words(self, n: int, grid: int) -> dict:
        return {**super().words(n, grid),
                "splits": [self.splits + j for j in range(n)]}

    def args(self) -> tuple:
        return (self.addr, self.splits, self.ready, self.data, self.stride)


A2A_LAYOUT = A2ALayout()


@dataclasses.dataclass(frozen=True)
class TreeLayout:
    """Word offsets of B5's double tree on the push protocol
    (``csrc/collectives.cu`` TreeLayout), for tree t, child slot c (0 for
    child 2p+1, 1 for 2p+2) and the tree's block k: ``addr + 2t + c`` /
    ``ready + 2t + c`` child c's output address and epoch (in the parent's
    pad); ``free + t * stride + k`` the parent's block k freed this rank's
    slot (in the child's pad); ``up + (2t + c) * stride + k`` child c's
    block k wrote its slot (in the parent's pad); ``down + t * stride +
    k`` the parent's block k wrote this rank's rows (in the child's
    pad)."""

    addr: int = 0
    ready: int = 4
    free: int = 8
    up: int = 8 + 2 * PUSH_MAX_BLOCKS
    down: int = 8 + 6 * PUSH_MAX_BLOCKS
    stride: int = PUSH_MAX_BLOCKS

    def words(self, trees: int, grid: int) -> dict:
        """The words a call with ``trees`` trees of ``grid`` blocks each
        uses, by kind."""
        return {"addr": [self.addr + 2 * t + c for t in range(trees)
                         for c in range(2)],
                "ready": [self.ready + 2 * t + c for t in range(trees)
                          for c in range(2)],
                "free": [self.free + t * self.stride + k
                         for t in range(trees) for k in range(grid)],
                "up": [self.up + (2 * t + c) * self.stride + k
                       for t in range(trees) for c in range(2)
                       for k in range(grid)],
                "down": [self.down + t * self.stride + k
                         for t in range(trees) for k in range(grid)]}

    def args(self) -> tuple:
        return (self.addr, self.ready, self.free, self.up, self.down,
                self.stride)


TREE_LAYOUT = TreeLayout()


@dataclasses.dataclass(frozen=True)
class TorusARLayout:
    """Word offsets of B12's torus AllReduce on the push protocol
    (``csrc/multi_axis.cu`` TorusLayout), for peer j (a global rank) and
    block k: ``addr + j`` / ``ready + j`` j's published input (an inner
    peer) or mid (an outer peer) and its epoch; ``released + j * stride +
    k`` inner reader j released this rank's input share k;
    ``mid_ready + j * stride + k`` outer peer j's mid share k is whole;
    ``mid_released + j * stride + k`` outer reader j released this rank's
    mid share k — all in the receiving rank's pad."""

    addr: int = 0
    ready: int = MAX_RANKS
    released: int = 2 * MAX_RANKS
    mid_ready: int = 2 * MAX_RANKS + MAX_RANKS * PUSH_MAX_BLOCKS
    mid_released: int = 2 * MAX_RANKS + 2 * MAX_RANKS * PUSH_MAX_BLOCKS
    stride: int = PUSH_MAX_BLOCKS

    def words(self, n: int, grid: int) -> dict:
        """The words a call at n ranks and ``grid`` blocks uses, by
        kind."""
        per_block = {k: [getattr(self, k) + j * self.stride + b
                         for j in range(n) for b in range(grid)]
                     for k in ("released", "mid_ready", "mid_released")}
        return {"addr": [self.addr + j for j in range(n)],
                "ready": [self.ready + j for j in range(n)], **per_block}

    def args(self) -> tuple:
        return (self.addr, self.ready, self.released, self.mid_ready,
                self.mid_released, self.stride)


TORUS_AR_LAYOUT = TorusARLayout()


@dataclasses.dataclass
class StreamWorkspace:
    """The persistent workspace of a parity stream (B4's AllGather,
    B5's AllReduce): on a card ``buf`` is a signal pad (no payload: the
    push protocol meets in the callers' own tensors); on the CPU, where the
    plain version meets through slots, a symmetric buffer of two parity
    slabs of ``shape``. ``epochs[r]``: rank r's next call index."""

    buf: SymmBuffer
    shape: tuple
    dtype: torch.dtype

    @property
    def epochs(self) -> list:
        return self.buf.epochs

    @property
    def tensors(self) -> list:
        """Each rank's buffer: its two parity slabs on the CPU; a pad's
        empty tensor on a card."""
        return self.buf.tensors


def push_grid(nbytes: int, caps, block_bytes: int = PUSH_BLOCK_BYTES
              ) -> int:
    """The copy engine's grid for a payload of ``nbytes`` a rank (the bytes
    a rank reads): a block per ``block_bytes``, at least 1, at most the
    least of ``caps`` (each card's SMs over the group's ranks on it) and
    PUSH_MAX_BLOCKS — so the same on every rank of the group."""
    cap = min([PUSH_MAX_BLOCKS, *caps])
    if cap < 1:
        raise ValueError(f"no SMs for the push: caps {list(caps)}")
    return max(1, min(cap, -(-nbytes // block_bytes)))


TREE_BLOCK_BYTES = 32 << 10      # the least share of a tree's block


def tree_grid(tree_bytes: int, trees: int, caps) -> int:
    """B5's tree: G blocks a tree over one tree's bytes (``tree_bytes``,
    its larger half), a block per TREE_BLOCK_BYTES — the tree is
    latency-bound, so more, smaller shares than the copy engine's —, with
    each card's cap split between the trees, so the ``trees`` x G blocks
    stay within 1/r of the SMs and are the same on every rank."""
    cap = min([PUSH_MAX_BLOCKS, *[c // trees for c in caps]])
    if cap < 1:
        raise ValueError(f"no SMs for the tree: caps {list(caps)}")
    return max(1, min(cap, -(-tree_bytes // TREE_BLOCK_BYTES)))


def _sm_caps(ctx) -> list:
    return [torch.cuda.get_device_properties(d).multi_processor_count
            // ctx.ranks_on(d) for d in dict.fromkeys(ctx.devices)]


def push_scope(ctx) -> int:
    """The flags' memory scope: 0 (the GPU's) when the whole group lives on
    one card, 1 (the system's) when a peer is another card."""
    return 0 if len(set(ctx.devices)) == 1 else 1


def launch_push(kernel: CudaKernel, pad: SymmBuffer, rank: int,
                x: torch.Tensor, out: torch.Tensor, nbytes: int,
                *extra, grid: int | None = None,
                grid_bytes: int | None = None,
                block_bytes: int = PUSH_BLOCK_BYTES,
                layout=PUSH_LAYOUT) -> None:
    """One launch of a push-protocol kernel (B4's ring, full-mesh push and
    parity stream, B5's one-shot and parity stream, B6, B7, B8's two forms
    and B12's torus AR with their layouts, B12's torus AllGather; B5's tree
    with its ``grid`` and ``layout``) at the rank group's meeting
    (:func:`_launch_at_meeting`), on the pad ``pad`` (a
    :func:`~triton_distributed_tpu_torch.runtime.symm.symm_pad`, or the
    tree's workspace): ``out`` is this rank's fresh output, which its
    senders write (B6: its owner's sum). ``grid``: else :func:`push_grid`
    over ``grid_bytes``, else over ``nbytes``, a block per
    ``block_bytes``."""
    ctx = pad.ctx
    if grid is None:
        grid = push_grid(grid_bytes or nbytes, _sm_caps(ctx), block_bytes)
    epoch = pad.next_epoch(rank)
    _launch_at_meeting(kernel, pad, rank, x.device, "push.launch", (
        ptr(pad.table[rank]), ptr(pad.signal_table[rank]),
        ptr(ctx.error_word(rank)), rank, ctx.num_ranks, epoch,
        int(ctx.timeout_s * 1e9), ptr(x), ptr(out), nbytes, *extra, grid,
        push_scope(ctx), *layout.args(), current_stream(x.device)))


def launch_tree(ws: SymmBuffer, rank: int, x: torch.Tensor,
                out: torch.Tensor, trees: int) -> None:
    """One launch of B5's double tree (``csrc/collectives.cu`` ar_tree) on
    its workspace ``ws`` (the parents' slots, (trees, 2, mh, cols); its
    signal pad holds the tree's words), as :func:`launch_push`: ``x``
    (m, cols) this rank's rows, ``out`` its fresh output; G blocks a tree
    (:func:`tree_grid`)."""
    m, cols = x.shape
    row = cols * x.element_size()
    grid = tree_grid(-(-m // trees) * row, trees, _sm_caps(ws.ctx))
    launch_push(TREE_KERNEL, ws, rank, x, out, row, m, trees,
                DTYPE_CODE[x.dtype], grid=grid, layout=TREE_LAYOUT)


def check_out(ctx: DistContext, rank: int, out: torch.Tensor, shape,
              dtype, what: str) -> torch.Tensor:
    """A caller's ``out=`` (a harness's sentinel-filled output): of the
    result's shape and type, contiguous, on the rank's device."""
    if (tuple(out.shape) != tuple(shape) or out.dtype != dtype
            or out.device != ctx.devices[rank] or not out.is_contiguous()
            or out.data_ptr() % 16):
        raise ValueError(f"{what}: out must be a contiguous, 16-byte aligned"
                         f" {tuple(shape)} {dtype} tensor on "
                         f"{ctx.devices[rank]}; got {tuple(out.shape)} "
                         f"{out.dtype} on {out.device}")
    return out


def rank_of(axis, num_ranks: int | None) -> tuple[DistContext, int, int]:
    """(group, rank, n) of the calling rank thread along ``axis``,
    ``num_ranks`` checked against it (the reference requires it inside
    ``shard_map``). On a one-axis group that is the group itself; on a
    multi-axis one, the rank's fiber along ``axis`` (a
    ``runtime/context.Fiber``) and its rank there — what the kernels
    address, as the reference's address ``dl.rank(axis)``."""
    if num_ranks is None:
        raise ValueError("num_ranks required inside the rank runner")
    ctx, rank = current_rank()
    ctx, rank = ctx.fiber(rank, axis)
    n = ctx.num_ranks
    if n != num_ranks:
        raise ValueError(f"num_ranks = {num_ranks} but the rank group has "
                         f"{n} — argument num_ranks")
    return ctx, rank, n


def check_payload(ctx: DistContext, rank: int, x: torch.Tensor, what: str,
                  *, copy: bool = False, dims: int = 2) -> torch.Tensor:
    """The kernels take a ``dims``-D float32 / bfloat16 payload (``copy``:
    a byte copy, so float8_e4m3fn too) of whole 16-byte vectors,
    contiguous and 16-byte aligned, on the rank's device. A misaligned or
    strided view is copied once; anything else raises."""
    if x.dim() != dims:
        raise ValueError(f"{what}: payload must have {dims} dims, got "
                         f"{tuple(x.shape)}")
    ok = COPY_DTYPES if copy else tuple(DTYPE_CODE)
    if x.dtype not in ok:
        raise ValueError(f"{what}: dtype {x.dtype} unsupported "
                         f"({', '.join(str(d) for d in ok)})")
    if x.device != ctx.devices[rank]:
        raise ValueError(f"{what}: rank {rank}'s payload on {x.device}, its "
                         f"device is {ctx.devices[rank]}")
    if x.numel() * x.element_size() % 16:
        raise ValueError(f"{what}: payload of {x.numel() * x.element_size()}"
                         " bytes is not whole 16-byte vectors")
    if not x.is_contiguous() or x.data_ptr() % 16:
        x = x.contiguous().clone()
    return x


def _launch_at_meeting(kernel: CudaKernel, buf: SymmBuffer, rank: int,
                       dev, what: str, args,
                       variants: tuple = ()) -> None:
    """One collective launch on the rank's current stream, made at the
    rank group's meeting: the last rank to arrive launches every rank's
    kernel (``DistContext.meet``), so no kernel of the collective runs
    before every rank's part before it was enqueued, and every rank's
    kernel is launched before any rank goes on — a rank thread that later
    blocks on the device waits only for work that can finish. ``args``:
    the launch's arguments, or a function making them, called inside the
    meeting's action — state it moves (an epoch counter) then moves only
    once every rank has met."""
    kernel.library()              # a first-use build, before the meeting
    buf.await_ready(rank)

    def act():
        with torch.cuda.device(dev):
            kernel.launch(*(args() if callable(args) else args),
                          variants=variants)

    buf.ctx.meet(rank, what, act)


def launch_gemm_comm(kernel: CudaKernel, buf: SymmBuffer, rank: int,
                     epoch: int, x: torch.Tensor, b: torch.Tensor,
                     out: torch.Tensor, *, m: int, mp: int, k: int,
                     ncols: int, ldb: int, parts: int, tile: int,
                     vec_b: bool) -> None:
    """One launch of a fused GEMM kernel (``csrc/gemm_comm.cu``) at the
    rank group's meeting (:func:`_launch_at_meeting`). ``tile``: the route
    of :data:`GEMM_ROUTES` (0 the tall mma.sync tile, 1 the short one, 2
    the wgmma mainloop, 3 B11's split-K), counted under its name. The
    kernel sizes its persistent grid to its share of the card: the ranks
    on this rank's device (n for virtual ranks, 1 with a card a rank); the
    split-K route's flags take :func:`push_scope`."""
    ctx = buf.ctx
    dev = x.device
    # The whole group's ranks on this card, not the fiber's: the cap keeps
    # every rank on the card its share of the SMs.
    on_card = ctx.ranks_on(dev)
    _launch_at_meeting(kernel, buf, rank, dev, "gemm_comm.launch", (
        ptr(buf.table[rank]), ptr(buf.signal_table[rank]),
        ptr(ctx.error_word(rank)), rank, ctx.num_ranks, epoch,
        int(ctx.timeout_s * 1e9), ptr(x), ptr(b), ptr(out),
        ptr(buf.tensors[rank]), _GEMM_OP[kernel], m, mp, k, ncols, ldb,
        parts, DTYPE_CODE[x.dtype], tile, int(vec_b), on_card,
        push_scope(ctx), current_stream(dev)), variants=(GEMM_ROUTES[tile],))


def rank_shards(ctx: DistContext, axis: str, x, dim: int = 0) -> list:
    """The n per-rank inputs of a host-level call: ``x`` as a list of n,
    or a tensor cut into n along ``dim``."""
    n = ctx.axis_size(axis)
    xs = (list(x) if isinstance(x, (list, tuple))
          else list(torch.chunk(x, n, dim=dim)))
    if len(xs) != n:
        raise ValueError(f"{len(xs)} shards for {n} ranks")
    return xs


def push_slots(ctx: DistContext, rank: int, buf: SymmBuffer, x, index,
               what: str) -> None:
    """The plain versions' rendezvous: store ``x`` into ``[index]`` of
    every rank's copy of ``buf`` (a push, as the kernels do), then meet."""
    for t in buf.tensors:
        t[index].copy_(x)
    ctx.barrier(rank, what)


def straggle(straggler, n: int, rank: int, call_index: int | None) -> None:
    """Fault injection: ``straggler=(rank, ns)`` holds that rank back
    ``ns`` nanoseconds before it pushes; ``("rotate", ns)`` picks rank
    ``call_index % n`` (the reference's ``resolve_straggler``). On the
    card the rank's stream spins; on the CPU its thread sleeps."""
    if straggler is None:
        return
    who, ns = straggler
    if who == "rotate":
        who = (call_index or 0) % n
    if who != rank:
        return
    ctx, _ = current_rank()
    if ctx.is_cuda:
        SPIN.launch(int(ns), current_stream(ctx.devices[rank]))
    else:
        time.sleep(ns / 1e9)
