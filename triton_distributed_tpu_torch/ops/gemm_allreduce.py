"""GEMM + AllReduce — kernel B11, counterpart of the JAX package's
``ops/gemm_allreduce.py`` (``_gemm_ar_stream_kernel``), as the
hand-written CUDA kernel ``gemm_ar`` of ``csrc/gemm_comm.cu``.

:func:`gemm_ar_stream` is the decode loop's fused row-parallel
projection: x (m, k_local) @ w (k_local, ncols), summed over the ranks.
The output columns are computed in ``n_chunks`` chunks; each chunk's
partial, cast to the payload type, is stored into slot ``rank`` of every
rank's persistent parity workspace (2, n_chunks, n, mp, nc) while the
next chunk computes; after the last chunk the kernel waits for every
rank's partials of this parity and sums the n slots in rank order, from
0 in fp32, one cast. No barrier: the parity protocol of
``ops/allreduce.all_reduce_stream`` (a persistent (workspace, call index)
pair per stream of calls, the index in sequence on every rank) makes the
reuse safe. A slot's rows are padded to the reference's sublane
alignment (``ops/tiling.sublane_align``), which sets the workspace's
shape; the kernel computes and stores only the m real rows (the plain
version computes the padded ones as zeros), and no one reads the rest.

:func:`gemm_ar_local` is the one-off compose: the product, then
``all_reduce_local``. On a CUDA tensor the stream launches B11 (counted
in ``GEMM_AR_KERNEL.launches``); on a CPU tensor its plain version runs
through the workspace's slots.
"""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.ops._comm import (
    GEMM_AR_KERNEL, check_payload, launch_gemm_comm, rank_of, straggle,
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
        launch_gemm_comm(GEMM_AR_KERNEL, ws, rank, call_index, x, b, out,
                         m=m, mp=mp, k=k, ncols=nc, ldb=ncols, parts=nch,
                         tile=gemm_tile_for(m),
                         vec_b=aligned_rows(b) and aligned_rows(b, nc))
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
