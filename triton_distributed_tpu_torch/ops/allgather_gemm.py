"""Overlapped AllGather + GEMM — kernel B9, counterpart of the JAX
package's ``ops/allgather_gemm.py`` (``_ag_gemm_kernel``), as the
hand-written CUDA kernel ``ag_gemm`` of ``csrc/gemm_comm.cu``.

C = all_gather(A) @ B_local: every rank holds an (m, k) row shard of A
and the (k, ncols) column shard of B; each gets the (n·m, ncols) full rows
of its output columns — the column-parallel projection of a row-sharded
prefill. The kernel opens with a barrier; every rank pushes its A shard,
in ``sub`` sub-blocks, into slot ``rank`` of every rank's landing
workspace (a symmetric (n·m, k) buffer), each sub-block with a flag of
its own; then it computes the output rows in rank-swizzled order (own
rows first), each sub-block's rows as soon as that sub-block's flag
arrived, fp32 accumulation and one cast.

On a CUDA tensor :func:`ag_gemm_local` launches B9 (counted in
``AG_GEMM_KERNEL.launches``, and under its route in ``variant_launches``:
:func:`gemm_tile_for` sends bf16 at the tall tile to the wgmma + TMA
mainloop, whose own-rank tiles read the input while the pushes fly, and
the rest to B3's mma.sync tiles); on a CPU tensor it runs the plain version
(:func:`ag_gemm_plain` after a push through the symmetric buffer's
slots). At n = 1 it runs B3 (``pallas_matmul``), as the reference runs
its Pallas matmul there.
"""

from __future__ import annotations

import dataclasses

import torch

from triton_distributed_tpu_torch.ops._comm import (
    AG_GEMM_KERNEL, check_payload, launch_gemm_comm, push_slots, rank_of,
    straggle,
)
from triton_distributed_tpu_torch.ops.tiling import (
    sublane_align, swizzled_ranks,
)
from triton_distributed_tpu_torch.runtime.context import (
    DistContext, get_context,
)
from triton_distributed_tpu_torch.runtime.symm import symm_zeros

MAX_SUB_CHUNKS = 4        # csrc/gemm_comm.cu's flag layout
SHORT_TILE_ROWS = 64      # below this many rows a GEMM takes the short tile


@dataclasses.dataclass(frozen=True)
class AGGemmConfig:
    """The reference's configuration. ``tile_m`` / ``tile_n`` /
    ``tile_k`` are caps for B3 at n = 1 (the CUDA kernel picks its own
    tile); ``straggler``: ``(rank, ns)`` holds that rank back ``ns``
    nanoseconds before it pushes, ``("rotate", ns)`` picks rank
    ``call_index % n``; ``sub_chunks``: sub-blocks of a rank's shard, each
    with its own delivery flag (shrunk to a divisor of the rows that keeps
    the reference's alignment, at most 4); ``force_kernel``: run the
    kernel at n = 1 too (its 0-peer loopback)."""

    tile_m: int = 512
    tile_n: int = 1024
    tile_k: int = 1024
    straggler: tuple | None = None
    call_index: int = 0
    sub_chunks: int = 2
    force_kernel: bool = False


def _ag_sub_chunks(m: int, want: int, dtype) -> int:
    """The reference's sub-block count: at most ``want`` (and 4), shrunk
    until it divides the rows and each sub-block keeps the sublane
    alignment of ``dtype``."""
    sa = sublane_align(dtype)
    sub = max(1, min(want, MAX_SUB_CHUNKS))
    while sub > 1 and (m % sub or (m // sub) % sa):
        sub -= 1
    return sub


def gemm_tile_for(rows: int, dtype=None, aligned: bool = False) -> int:
    """The route of the fused kernels for GEMMs of ``rows`` rows
    (``_comm.GEMM_ROUTES``): 1 the short mma.sync tile (16 x 64, decode)
    below ``SHORT_TILE_ROWS``; at the tall tile 2, the wgmma + TMA
    mainloop (``csrc/gemm_wgmma.cuh``: 128 x 256 tiles from 512 output
    columns, 128 x 128 below), for bf16 whose B rows and base are whole
    16-byte units (``aligned``; A's are checked by the wrappers), else 0,
    the tall mma.sync tile (128 x 128). Decided from the shape before the
    launch; B11 passes no dtype and keeps the mma.sync tiles."""
    if rows < SHORT_TILE_ROWS:
        return 1
    return 2 if dtype == torch.bfloat16 and aligned else 0


def aligned_rows(t: torch.Tensor, ld: int | None = None) -> bool:
    """``t``'s base address and a row of ``ld`` elements (default its
    width) are whole 16-byte units."""
    ld = t.shape[-1] if ld is None else ld
    return t.data_ptr() % 16 == 0 and (ld * t.element_size()) % 16 == 0


def check_weight(ctx: DistContext, rank: int, x: torch.Tensor,
                 b: torch.Tensor, what: str) -> torch.Tensor:
    """A fused kernel's B: 2-D, A's type and device, K rows; contiguous."""
    if b.dim() != 2 or b.shape[0] != x.shape[1]:
        raise ValueError(f"{what}: inner dims mismatch: A {tuple(x.shape)},"
                         f" B {tuple(b.shape)}")
    if b.dtype != x.dtype or b.device != x.device:
        raise ValueError(f"{what}: B is {b.dtype} on {b.device}, A "
                         f"{x.dtype} on {x.device} — the fused kernels take "
                         "one type on the rank's device")
    if (x.shape[1] * x.element_size()) % 16:
        raise ValueError(f"{what}: rows of {x.shape[1]} elements are not "
                         "whole 16-byte vectors")
    return b.contiguous()


def ag_gemm_plain(gathered: torch.Tensor, b: torch.Tensor, n: int,
                  sub: int, rank: int) -> torch.Tensor:
    """Plain version of B9 for ``rank``: ``gathered`` — the n shards in
    rank order (n·m, k) — times ``b``, one fp32 matmul per (source,
    sub-block) in the kernel's visiting order, one cast."""
    AG_GEMM_KERNEL.count_plain()
    m = gathered.shape[0] // n
    m_sub = m // sub
    out = torch.empty((gathered.shape[0], b.shape[1]), dtype=gathered.dtype,
                      device=gathered.device)
    bf = b.float()
    for r in swizzled_ranks(rank, n):
        for s in range(sub):
            rows = slice(r * m + s * m_sub, r * m + (s + 1) * m_sub)
            out[rows] = (gathered[rows].float() @ bf).to(gathered.dtype)
    return out


def ag_gemm_local(x_local: torch.Tensor, b_local: torch.Tensor,
                  axis: str = "tp", num_ranks: int | None = None,
                  cfg: AGGemmConfig = AGGemmConfig(),
                  return_gathered: bool = False):
    """Rank-local overlapped AG+GEMM inside ``DistContext.run``.
    x_local: (m, k) A shard; b_local: (k, ncols). Returns (n·m, ncols) =
    all_gather(A) @ B_local; with ``return_gathered``, also the gathered
    (n·m, k) A the kernel assembled."""
    ctx, rank, n = rank_of(axis, num_ranks)
    m, k = x_local.shape
    if b_local.shape[0] != k:
        raise ValueError(f"inner dims mismatch: A has k={k}, B has "
                         f"k={b_local.shape[0]}")
    if n == 1 and not cfg.force_kernel:
        from triton_distributed_tpu_torch.ops.gemm import pallas_matmul

        out = pallas_matmul(x_local, b_local, tile_m=cfg.tile_m,
                            tile_n=cfg.tile_n, tile_k=cfg.tile_k)
        return (out, x_local) if return_gathered else out
    sub = _ag_sub_chunks(m, cfg.sub_chunks, x_local.dtype)
    straggle(cfg.straggler, n, rank, cfg.call_index)
    if x_local.device.type == "cuda":
        x = check_payload(ctx, rank, x_local, "ag_gemm")
        b = check_weight(ctx, rank, x, b_local, "ag_gemm")
        buf = symm_zeros(ctx, (n * m, k), x.dtype, tag="ag_gemm")
        out = torch.empty((n * m, b.shape[1]), dtype=x.dtype,
                          device=x.device)
        launch_gemm_comm(AG_GEMM_KERNEL, buf, rank, buf.next_epoch(rank), x,
                         b, out, m=m, mp=m, k=k, ncols=b.shape[1],
                         ldb=b.shape[1], parts=sub,
                         tile=gemm_tile_for(m // sub, x.dtype,
                                            aligned_rows(b)),
                         vec_b=aligned_rows(b))
        if return_gathered:
            return out, buf.tensors[rank].clone()
        return out
    if x_local.device.type != "cpu":
        raise ValueError(f"ag_gemm: no kernel for device {x_local.device}")
    buf = symm_zeros(ctx, (n * m, k), x_local.dtype, tag="ag_gemm")
    ctx.barrier(rank, "ag_gemm.entry")
    push_slots(ctx, rank, buf, x_local, slice(rank * m, (rank + 1) * m),
               "ag_gemm.data")
    gathered = buf.tensors[rank]
    out = ag_gemm_plain(gathered, b_local, n, sub, rank)
    return (out, gathered.clone()) if return_gathered else out


def resolve_gemm_cfg(cfg, cfg_cls, m_chunk: int, k: int, ncols: int, dtype,
                     device=None):
    """``cfg``, or for None the config of B3's tuned tiles at the
    per-chunk GEMM shape (``runtime/autotuner.tuned_matmul_tiles``: on the
    card, disk-cached), else ``cfg_cls()``'s defaults. The tiles reach B3
    at n = 1; the fused kernels pick their own."""
    if cfg is not None:
        return cfg
    from triton_distributed_tpu_torch.runtime.autotuner import (
        tuned_matmul_tiles,
    )

    tiles = tuned_matmul_tiles(m_chunk, k, ncols, dtype, device=device)
    if tiles is None:
        return cfg_cls()
    tm, tn, tk = tiles
    return cfg_cls(tile_m=tm, tile_n=tn, tile_k=tk)


def _rank_parts(ctx: DistContext, x) -> list:
    from triton_distributed_tpu_torch.ops.allreduce import split_ranks

    return [t.to(d) for t, d in zip(split_ranks(ctx, x), ctx.devices)]


def ag_gemm(a, b, ctx: DistContext | None = None, axis: str = "tp",
            cfg: AGGemmConfig | None = None) -> list:
    """Host-level overlapped AG+GEMM (reference ``ag_gemm``): ``a`` —
    the n ranks' (m, k) row shards, ``b`` — their (k, ncols) column
    shards (each a list, or stacked with n leading) → the n ranks'
    (n·m, ncols) outputs, rank r's the columns of its B shard. With
    ``cfg=None`` and ``TDTPU_AUTOTUNE_COMM=1`` the whole config is
    measured (``runtime/autotuner.tune_ag_gemm``)."""
    ctx = ctx or get_context()
    n = ctx.axis_size(axis)
    xs, bs = _rank_parts(ctx, a), _rank_parts(ctx, b)
    if cfg is None and n > 1:
        from triton_distributed_tpu_torch.runtime.autotuner import (
            comm_autotune_enabled, tune_ag_gemm,
        )

        if comm_autotune_enabled(xs[0].device):
            cfg = tune_ag_gemm(xs, bs, ctx, axis=axis)
    cfg = resolve_gemm_cfg(cfg, AGGemmConfig, xs[0].shape[0], xs[0].shape[1],
                           bs[0].shape[1], xs[0].dtype, xs[0].device)
    outs = ctx.run(lambda r: ag_gemm_local(xs[r], bs[r], axis=axis,
                                           num_ranks=n, cfg=cfg))
    ctx.raise_on_comm_error()
    return outs
