"""Overlapped GEMM + ReduceScatter — kernel B10, counterpart of the JAX
package's ``ops/gemm_reduce_scatter.py`` (``_gemm_rs_kernel``), as the
hand-written CUDA kernel ``gemm_rs`` of ``csrc/gemm_comm.cu``.

out_d = Σ_r partial_r[rows of d]: every rank holds the (m, k) activations
of its k shard and the (k, ncols) rows of B — the row-parallel projection
of a row-sharded prefill — and gets the summed (m/n, ncols) rows it owns.
The kernel opens with a barrier, computes the partial row chunks in the
order rank+1, ..., rank (its own last), casts each tile to the payload
type and stores it into slot ``rank`` of the owner's symmetric (n, m/n,
ncols) workspace; once every rank's chunk landed it sums the n slots in
slot order, from 0 in fp32, and casts once.

On a CUDA tensor :func:`gemm_rs_local` launches B10 (counted in
``GEMM_RS_KERNEL.launches``, and under its route in ``variant_launches``,
picked by ``allgather_gemm.gemm_tile_for``); on a CPU tensor its plain
version runs through the symmetric buffer's slots. At n = 1 it runs B3.
"""

from __future__ import annotations

import dataclasses

import torch

from triton_distributed_tpu_torch.ops._comm import (
    GEMM_RS_KERNEL, check_payload, launch_gemm_comm, rank_of, straggle,
)
from triton_distributed_tpu_torch.ops.allgather_gemm import (
    _rank_parts, aligned_rows, check_weight, gemm_tile_for, resolve_gemm_cfg,
)
from triton_distributed_tpu_torch.ops.allreduce import reduce_slots_plain
from triton_distributed_tpu_torch.runtime.context import (
    DistContext, get_context,
)
from triton_distributed_tpu_torch.runtime.symm import symm_zeros


@dataclasses.dataclass(frozen=True)
class GemmRSConfig:
    """The reference's configuration: B3's tile caps at n = 1 (the CUDA
    kernel picks its own tile) and the straggler hook of
    ``AGGemmConfig``."""

    tile_m: int = 512
    tile_n: int = 1024
    tile_k: int = 1024
    straggler: tuple | None = None
    call_index: int = 0


def gemm_rs_partials(x: torch.Tensor, b: torch.Tensor, n: int,
                     rank: int) -> list:
    """Rank ``rank``'s partial row chunks in the kernel's order (rank+1,
    ..., rank): [(owner c, fp32 product cast to the payload type)]."""
    mc = x.shape[0] // n
    bf = b.float()
    out = []
    for i in range(n):
        c = (rank + 1 + i) % n
        out.append((c, (x[c * mc:(c + 1) * mc].float() @ bf).to(x.dtype)))
    return out


def gemm_rs_plain(xs, bs, rank: int) -> torch.Tensor:
    """Plain version of B10 for ``rank``: the n ranks' activations ``xs``
    and weight rows ``bs`` → their partials of ``rank``'s rows, each cast
    to the payload type, summed in slot order from 0 in fp32, one cast."""
    GEMM_RS_KERNEL.count_plain()
    n = len(xs)
    slots = [dict(gemm_rs_partials(x, b, n, j))[rank]
             for j, (x, b) in enumerate(zip(xs, bs))]
    return reduce_slots_plain(slots)


def gemm_rs_local(x_local: torch.Tensor, b_local: torch.Tensor,
                  axis: str = "tp", num_ranks: int | None = None,
                  cfg: GemmRSConfig = GemmRSConfig()) -> torch.Tensor:
    """Rank-local overlapped GEMM+RS inside ``DistContext.run``.
    x_local: (m, k) activations of this rank's k shard; b_local: (k,
    ncols). Returns the (m/n, ncols) rows this rank owns, summed."""
    ctx, rank, n = rank_of(axis, num_ranks)
    m, k = x_local.shape
    if b_local.shape[0] != k:
        raise ValueError(f"inner dims mismatch: A has k={k}, B has "
                         f"k={b_local.shape[0]}")
    if m % n:
        raise ValueError(f"rows {m} not divisible by num_ranks {n}")
    if n == 1:
        from triton_distributed_tpu_torch.ops.gemm import pallas_matmul

        return pallas_matmul(x_local, b_local, tile_m=cfg.tile_m,
                             tile_n=cfg.tile_n, tile_k=cfg.tile_k)
    mc, ncols = m // n, b_local.shape[1]
    straggle(cfg.straggler, n, rank, cfg.call_index)
    if x_local.device.type == "cuda":
        x = check_payload(ctx, rank, x_local, "gemm_rs")
        b = check_weight(ctx, rank, x, b_local, "gemm_rs")
        if (ncols * x.element_size()) % 16:
            raise ValueError(f"gemm_rs: output rows of {ncols} elements are "
                             "not whole 16-byte vectors")
        buf = symm_zeros(ctx, (n, mc, ncols), x.dtype, tag="gemm_rs")
        out = torch.empty((mc, ncols), dtype=x.dtype, device=x.device)
        launch_gemm_comm(GEMM_RS_KERNEL, buf, rank, buf.next_epoch(rank), x,
                         b, out, m=m, mp=m, k=k, ncols=ncols, ldb=ncols,
                         parts=1, tile=gemm_tile_for(mc, x.dtype,
                                                     aligned_rows(b)),
                         vec_b=aligned_rows(b))
        return out
    if x_local.device.type != "cpu":
        raise ValueError(f"gemm_rs: no kernel for device {x_local.device}")
    GEMM_RS_KERNEL.count_plain()
    buf = symm_zeros(ctx, (n, mc, ncols), x_local.dtype, tag="gemm_rs")
    ctx.barrier(rank, "gemm_rs.entry")
    for c, part in gemm_rs_partials(x_local, b_local, n, rank):
        buf.tensors[c][rank].copy_(part)
    ctx.barrier(rank, "gemm_rs.data")
    return reduce_slots_plain(buf.tensors[rank])


def gemm_rs(a, b, ctx: DistContext | None = None, axis: str = "tp",
            cfg: GemmRSConfig | None = None) -> list:
    """Host-level overlapped GEMM+RS (reference ``gemm_rs``): ``a`` — the
    n ranks' (m, k) activations of their k shards, ``b`` — their (k,
    ncols) weight rows (each a list, or stacked with n leading) → the n
    ranks' (m/n, ncols) row chunks of the sum, rank r's rows
    [r·m/n, (r+1)·m/n)."""
    ctx = ctx or get_context()
    n = ctx.axis_size(axis)
    xs, bs = _rank_parts(ctx, a), _rank_parts(ctx, b)
    cfg = resolve_gemm_cfg(cfg, GemmRSConfig, xs[0].shape[0] // n,
                           xs[0].shape[1], bs[0].shape[1], xs[0].dtype,
                           xs[0].device)
    outs = ctx.run(lambda r: gemm_rs_local(xs[r], bs[r], axis=axis,
                                           num_ranks=n, cfg=cfg))
    ctx.raise_on_comm_error()
    return outs
