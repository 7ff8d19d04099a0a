"""GEMM + AllReduce — kernel B11, counterpart of the JAX package's
``ops/gemm_allreduce.py`` (``_gemm_ar_stream_kernel``), as the
hand-written CUDA kernel ``gemm_ar`` of ``csrc/gemm_comm.cu``.

:func:`gemm_ar_stream` is the decode loop's fused row-parallel
projection: x (m, k_local) @ w (k_local, ncols), summed over the ranks.
The output columns are computed in ``n_chunks`` chunks; each chunk's
partial, cast to the payload type, is stored into slot ``rank`` of every
rank's persistent parity workspace (2, n_chunks, n, mp, nc); the kernel
then waits for the ranks' partials of this parity and sums the n slots in
rank order, from 0 in fp32, one cast. No barrier: the parity protocol of
``ops/allreduce.all_reduce_stream`` (a persistent (workspace, call index)
pair per stream of calls, the index in sequence on every rank) makes the
reuse safe. A slot's rows are padded to the reference's sublane
alignment (``ops/tiling.sublane_align``), which sets the workspace's
shape; the kernel computes and stores only the m real rows (the plain
version computes the padded ones as zeros), and no one reads the rest.

Two routes (:func:`gemm_ar_route`, picked before the launch): bf16 at
m <= 16 with aligned operands takes ``"splitk"``, a weight stream — each
block of a persistent grid owns strips of 64 output columns over the
whole K shard (:func:`splitk_plan`), pushes each finished strip into its
slot on every rank, then raises one flag and waits for the n flags of the
blocks that wrote its strips, and reduces them; fp32, more rows and
unaligned operands keep B3's ``mma.sync`` tiles, every block waiting for
every block's flags.

:func:`gemm_ar_local` is the one-off compose: the product, then
``all_reduce_local``. On a CUDA tensor the stream launches B11 (counted
in ``GEMM_AR_KERNEL.launches``, by route in ``variant_launches``); on a
CPU tensor its plain version runs through the workspace's slots.
"""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.ops._comm import (
    GEMM_AR_KERNEL, MAX_RANKS, check_payload, launch_gemm_comm, rank_of,
    straggle,
)
from triton_distributed_tpu_torch.ops.allgather_gemm import (
    _rank_parts, aligned_rows, check_weight, gemm_tile_for,
)
from triton_distributed_tpu_torch.ops.allreduce import (
    AllReduceMethod, all_reduce_local, reduce_slots_plain,
)
from triton_distributed_tpu_torch.ops.tiling import sublane_align
from triton_distributed_tpu_torch.runtime.context import (
    DistContext, get_context,
)
from triton_distributed_tpu_torch.runtime.symm import SymmBuffer, symm_zeros


def _gemm_ar_chunks(ncols: int, n_chunks: int) -> int:
    """The reference's chunk count: at most ``n_chunks``, shrunk until it
    divides the 128-column tiles of ``ncols`` (or ``ncols`` itself when
    that is not a multiple of 128)."""
    col_tiles = ncols // 128 if ncols % 128 == 0 else 1
    while n_chunks > 1 and (col_tiles % n_chunks or ncols % n_chunks):
        n_chunks -= 1
    return n_chunks


# B11's split-K route (csrc/gemm_comm.cu gemm_ar_splitk): a strip is
# SPLITK_COLS output columns of one chunk; a block's warps take K in
# SPLITK_STEP-row steps; A's rows of all of K, the warps' partials and the
# strip's sums live in the block's shared memory, at least RESERVE_SMEM
# (one block an SM) and at most MAX_SMEM.
SPLITK_ROUTE = 3                 # _comm.GEMM_ROUTES index
SPLITK_MAX_ROWS = 16
SPLITK_COLS = 64
SPLITK_STEP = 32
SPLITK_WARPS = 8
RESERVE_SMEM = 120 << 10         # csrc/gemm_comm.cu kReserveSmem
MAX_SMEM = 232448                # a block's shared memory on an H100
MAX_GEMM_BLOCKS = 128            # csrc/dist.cuh kMaxGemmBlocks
GEMM_FLAG_BASE = MAX_GEMM_BLOCKS * MAX_RANKS     # dist.cuh kGemmFlagBase


def splitk_smem(m: int, k: int) -> int:
    """Shared memory the split-K route needs (``gemm_comm.cu``
    ``sk_smem``): A's m rows of K padded to whole steps, 16 bytes more a
    row; the 8 warps' float4 partials of 4 x (1 or 2) tiles a lane; the
    strip's 16 x 64 bf16 sums."""
    pitch = -(-k // SPLITK_STEP) * SPLITK_STEP * 2 + 16
    mt = 1 if m <= 8 else 2
    return m * pitch + SPLITK_WARPS * mt * 4 * 32 * 16 + 16 * SPLITK_COLS * 2


def gemm_ar_route(m: int, k: int, nc: int, dtype, aligned: bool) -> int:
    """B11's route (``_comm.GEMM_ROUTES``), from the shape before the
    launch: 3, the split-K weight stream, for bf16 at m <= 16 whose A rows
    (k), chunk columns (nc) and B (``aligned``: its base and rows of ldb,
    and nc) are whole 16-byte units and whose A rows fit a block's shared
    memory; else B3's mma.sync tiles (``gemm_tile_for``: the short tile
    below 64 rows)."""
    if (dtype == torch.bfloat16 and m <= SPLITK_MAX_ROWS and aligned
            and (k * 2) % 16 == 0 and (nc * 2) % 16 == 0
            and splitk_smem(m, k) <= MAX_SMEM):
        return SPLITK_ROUTE
    return gemm_tile_for(m)


def splitk_plan(ncols: int, n_chunks: int, sm_cap: int) -> dict:
    """The split-K route's work plan (``gemm_comm.cu`` gemm_ar_splitk),
    the same on every rank: ``strips`` — (chunk, first column in the
    chunk, columns) of each strip, chunk-major, the chunk's last strip cut
    at nc = ncols / n_chunks —, the persistent ``grid`` (a block a strip at
    most, at most ``sm_cap`` = the card's SMs over its ranks and
    MAX_GEMM_BLOCKS: ``persistent_grid``) and ``blocks`` — block b's
    strips b, b + grid, ... ."""
    nch = _gemm_ar_chunks(ncols, n_chunks)
    nc = ncols // nch
    strips = [(c, c0, min(SPLITK_COLS, nc - c0)) for c in range(nch)
              for c0 in range(0, nc, SPLITK_COLS)]
    grid = max(1, min(len(strips), sm_cap, MAX_GEMM_BLOCKS))
    return {"n_chunks": nch, "nc": nc, "strips": strips, "grid": grid,
            "blocks": [list(range(b, len(strips), grid))
                       for b in range(grid)]}


def splitk_flag(parity: int, source: int, block: int) -> int:
    """The signal-pad word of block ``block`` of rank ``source`` at parity
    ``parity`` (``gemm_comm.cu``: raised on every rank after the block's
    last strip; block b of each rank waits for (parity, s, b) of every
    source s)."""
    return (GEMM_FLAG_BASE + (parity * MAX_RANKS + source) * MAX_GEMM_BLOCKS
            + block)


def _padded_rows(m: int, dtype) -> int:
    a = sublane_align(dtype)
    return -(-m // a) * a


def gemm_ar_stream_workspace(n: int, m: int, ncols: int, dtype, *,
                             n_chunks: int = 4, ctx: DistContext | None = None,
                             tag: str = "gemm_ar_stream"
                             ) -> tuple[SymmBuffer, int]:
    """The persistent (workspace, call_index) pair of
    :func:`gemm_ar_stream`: a symmetric (2, n_chunks, n, mp, ncols /
    n_chunks) buffer (mp: m padded to the sublane alignment), allocated
    once per (shape, dtype, tag) on the context, and the index of its next
    call. Thread both through the decode loop; give each stream of calls
    its own ``tag``."""
    ctx = ctx or get_context()
    if ctx.num_ranks != n:
        raise ValueError(f"n = {n} but the rank group has {ctx.num_ranks}")
    nch = _gemm_ar_chunks(ncols, n_chunks)
    ws = symm_zeros(ctx, (2, nch, n, _padded_rows(m, dtype), ncols // nch),
                    dtype, tag=tag)
    return ws, ws.epochs[0]


def gemm_ar_partials(x: torch.Tensor, b: torch.Tensor, nch: int) -> list:
    """One rank's partial column chunks, each an fp32 product cast to the
    payload type."""
    nc = b.shape[1] // nch
    xf = x.float()
    return [(xf @ b[:, c * nc:(c + 1) * nc].float()).to(x.dtype)
            for c in range(nch)]


def gemm_ar_plain(xs, bs, n_chunks: int = 4) -> torch.Tensor:
    """Plain version of B11: the n ranks' ``xs`` (m, k_local) and ``bs``
    (k_local, ncols) → each rank's partial chunks cast to the payload
    type, the n slots of each chunk summed in rank order from 0 in fp32,
    one cast; (m, ncols)."""
    GEMM_AR_KERNEL.count_plain()
    nch = _gemm_ar_chunks(bs[0].shape[1], n_chunks)
    parts = [gemm_ar_partials(x, b, nch) for x, b in zip(xs, bs)]
    return torch.cat([reduce_slots_plain([p[c] for p in parts])
                      for c in range(nch)], dim=1)


def gemm_ar_stream(x_local: torch.Tensor, b_local: torch.Tensor,
                   ws: SymmBuffer, call_index: int, *, axis: str = "tp",
                   num_ranks: int | None = None, n_chunks: int = 4,
                   force_kernel: bool = False,
                   straggler: tuple | None = None):
    """Rank-local fused GEMM+AR inside ``DistContext.run`` (the decode
    steady state). x_local: (m, k_local); b_local: (k_local, ncols); ws
    from :func:`gemm_ar_stream_workspace`; ``call_index``: a host int, the
    same sequence on every rank. Returns (sum (m, ncols), ws,
    call_index + 1). ``force_kernel``: run the kernel at n = 1 too (the
    0-peer loopback); ``straggler`` as ``all_reduce_stream``'s."""
    ctx, rank, n = rank_of(axis, num_ranks)
    m, k = x_local.shape
    ncols = b_local.shape[1]
    if n == 1 and not force_kernel:
        return x_local @ b_local, ws, call_index + 1
    nch = _gemm_ar_chunks(ncols, n_chunks)
    mp = _padded_rows(m, x_local.dtype)
    shape = tuple(ws.tensors[rank].shape)
    if shape != (2, nch, n, mp, ncols // nch):
        raise ValueError(f"workspace shape {shape} != (2, {nch}, {n}, {mp}, "
                         f"{ncols // nch}) — allocate via "
                         "gemm_ar_stream_workspace")
    if ws.tensors[rank].dtype != x_local.dtype:
        raise ValueError(f"workspace dtype {ws.tensors[rank].dtype} != "
                         f"input {x_local.dtype}")
    if call_index != ws.epochs[rank]:
        raise ValueError(
            f"gemm_ar_stream: call_index {call_index} on rank {rank}, but "
            f"this workspace's next call is {ws.epochs[rank]} — a (ws, "
            "call_index) pair must stay persistent and in sequence (a "
            "second stream of calls needs its own workspace tag)")
    ws.epochs[rank] = call_index + 1
    straggle(straggler, n, rank, call_index)
    p = call_index % 2
    if x_local.device.type == "cuda":
        x = check_payload(ctx, rank, x_local, "gemm_ar_stream")
        b = check_weight(ctx, rank, x, b_local, "gemm_ar_stream")
        nc = ncols // nch
        if (nc * x.element_size()) % 16:
            raise ValueError(f"gemm_ar_stream: chunks of {nc} columns are "
                             "not whole 16-byte vectors")
        out = torch.empty((m, ncols), dtype=x.dtype, device=x.device)
        vec_b = aligned_rows(b) and aligned_rows(b, nc)
        launch_gemm_comm(GEMM_AR_KERNEL, ws, rank, call_index, x, b, out,
                         m=m, mp=mp, k=k, ncols=nc, ldb=ncols, parts=nch,
                         tile=gemm_ar_route(m, k, nc, x.dtype, vec_b),
                         vec_b=vec_b)
        return out, ws, call_index + 1
    if x_local.device.type != "cpu":
        raise ValueError(f"gemm_ar_stream: no kernel for device "
                         f"{x_local.device}")
    GEMM_AR_KERNEL.count_plain()
    xp = torch.cat([x_local, x_local.new_zeros((mp - m, k))])
    for c, part in enumerate(gemm_ar_partials(xp, b_local, nch)):
        for t in ws.tensors:
            t[p, c, rank].copy_(part)
    ctx.barrier(rank, "gemm_ar_stream")
    slab = ws.tensors[rank][p]
    out = torch.cat([reduce_slots_plain(slab[c]) for c in range(nch)], dim=1)
    return out[:m], ws, call_index + 1


def gemm_ar_local(x_local: torch.Tensor, b_local: torch.Tensor,
                  axis: str = "tp", num_ranks: int | None = None,
                  method: AllReduceMethod | str = AllReduceMethod.AUTO
                  ) -> torch.Tensor:
    """Rank-local GEMM+AR for one-off calls: the product in the payload
    type, then ``all_reduce_local`` (whose one-shot opens with a barrier:
    the sound protocol without a persistent workspace)."""
    return all_reduce_local(x_local @ b_local, axis=axis,
                            num_ranks=num_ranks, method=method)


def gemm_allreduce(a, b, ctx: DistContext | None = None, axis: str = "tp",
                   method: AllReduceMethod | str = AllReduceMethod.AUTO
                   ) -> list:
    """Host-level GEMM+AR: ``a`` — the n ranks' (m, k) activations of
    their k shards, ``b`` — their (k, ncols) weight rows (each a list, or
    stacked with n leading) → the n ranks' (m, ncols) sums."""
    ctx = ctx or get_context()
    n = ctx.axis_size(axis)
    xs, bs = _rank_parts(ctx, a), _rank_parts(ctx, b)
    outs = ctx.run(lambda r: gemm_ar_local(xs[r], bs[r], axis=axis,
                                           num_ranks=n, method=method))
    ctx.raise_on_comm_error()
    return outs
