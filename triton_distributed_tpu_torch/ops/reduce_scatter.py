"""Ring reduce-scatter over the rank group — counterpart of the JAX
package's ``ops/reduce_scatter.py``: kernel B6 (``_rs_ring_kernel``) as
hand-written CUDA in ``csrc/collectives.cu`` (``rs_ring``).

What it computes is the ring's: chunk c is summed in the order x_{c+1} +
x_{c+2} + ... + x_c (:func:`ring_order`), each add in the payload type —
one rounding a hop — and the plain version adds in that order, so it is
the kernel's yardstick bit for bit. How the kernel gets there is one hop
on the push protocol (``csrc/push.cuh``) with the roles mirrored: each
rank publishes its input's address to every peer, owner c reads share b
of chunk c straight from every source's input and sums it in that order
into its fresh output, then releases the source; a source's kernel ends
only once every owner released it. Only a signal pad is kept (tag
``"rs_ring"``): no entry barrier, no relay workspace, no dependent hops.
"""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.ops._comm import (
    DTYPE_CODE, RS_RING_KERNEL, check_payload, launch_push, push_slots,
    rank_of,
)
from triton_distributed_tpu_torch.runtime.context import (
    DistContext, get_context,
)
from triton_distributed_tpu_torch.runtime.symm import symm_pad, symm_zeros


def ring_order(n: int, owner: int) -> list:
    """The sources of chunk ``owner`` in the order the ring adds them: rank
    owner+1 first (where the chunk starts), the owner's own last. The
    kernel reads each source's chunk once, in this order."""
    return [(owner + k) % n for k in range(1, n + 1)]


def rs_ring_plain(xs, rank: int) -> torch.Tensor:
    """Plain version of the ring RS for ``rank``: ``xs`` — the n ranks'
    (n*m, cols) contributions — → chunk ``rank`` summed in ring order
    (x_{c+1} + x_{c+2} + ... + x_c, c = rank), each add in the payload
    type."""
    n = len(xs)
    m = xs[0].shape[0] // n
    first, *rest = ring_order(n, rank)
    acc = xs[first][rank * m:(rank + 1) * m]
    for j in rest:
        acc = acc + xs[j][rank * m:(rank + 1) * m]
    return acc


def _rs_ring(x: torch.Tensor, n: int, ctx: DistContext, rank: int
             ) -> torch.Tensor:
    mt, cols = x.shape
    m = mt // n
    if x.device.type == "cuda":
        x = check_payload(ctx, rank, x, "reduce_scatter")
        out = torch.empty((m, cols), dtype=x.dtype, device=x.device)
        launch_push(RS_RING_KERNEL, symm_pad(ctx, tag="rs_ring"), rank, x,
                    out, m * cols * x.element_size(), DTYPE_CODE[x.dtype],
                    grid_bytes=mt * cols * x.element_size())
        return out
    if x.device.type != "cpu":
        raise ValueError(f"reduce_scatter: no kernel for device {x.device}")
    RS_RING_KERNEL.count_plain()
    # The plain version meets through the slots of an (n, n*m, cols)
    # buffer: every rank's whole contribution, then the ring's order.
    buf = symm_zeros(ctx, (n, mt, cols), x.dtype, tag="rs_ring_plain")
    ctx.barrier(rank, "rs_ring.entry")
    push_slots(ctx, rank, buf, x, rank, "rs_ring.data")
    return rs_ring_plain(buf.tensors[rank], rank)


def reduce_scatter_local(x_local: torch.Tensor, axis: str = "tp",
                         num_ranks: int | None = None) -> torch.Tensor:
    """Rank-local ring reduce-scatter inside ``DistContext.run``:
    ``x_local`` (n*m, cols) → (m, cols), chunk ``rank`` summed over the
    ranks."""
    if isinstance(axis, (tuple, list)):
        # The multi-axis form (ops/multi_axis.py): num_ranks is (n0, n1).
        if num_ranks is None:
            raise ValueError("num_ranks (n0, n1) required inside the rank "
                             "runner")
        from triton_distributed_tpu_torch.ops.multi_axis import (
            reduce_scatter_torus_local,
        )

        return reduce_scatter_torus_local(x_local, axes=tuple(axis),
                                          dims=tuple(num_ranks))
    ctx, rank, n = rank_of(axis, num_ranks)
    if n == 1:
        return x_local
    if x_local.shape[0] % n:
        raise ValueError(f"rows {x_local.shape[0]} not divisible by "
                         f"num_ranks {n}")
    return _rs_ring(x_local, n, ctx, rank)


def reduce_scatter(x, ctx: DistContext | None = None, axis: str = "tp"
                   ) -> list:
    """Host-level ring reduce-scatter: ``x`` — n per-rank (n*m, cols)
    contributions (a list, or stacked) → the n per-rank (m, cols) chunks,
    rank r's holding rows [r*m, (r+1)*m) of the sum."""
    from triton_distributed_tpu_torch.ops.allreduce import split_ranks

    ctx = ctx or get_context()
    n = ctx.axis_size(axis)
    xs = split_ranks(ctx, x)
    outs = ctx.run(lambda r: reduce_scatter_local(
        xs[r].to(ctx.devices[r]), axis=axis, num_ranks=n))
    ctx.raise_on_comm_error()
    return outs
