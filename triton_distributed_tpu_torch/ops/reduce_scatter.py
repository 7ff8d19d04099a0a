"""Ring reduce-scatter over the rank group — counterpart of the JAX
package's ``ops/reduce_scatter.py``: kernel B6 (``_rs_ring_kernel``) as
hand-written CUDA in ``csrc/collectives.cu`` (``rs_ring``).

The ring: chunk c starts at rank c+1, gains one rank's contribution a
hop, and lands summed at its owner after n-1 hops. Each hop's partial
lands in its own slot of the receiver's symmetric comm workspace (n-1
slots), so a fast upstream rank never overwrites a slot not yet read; a
block-scope barrier at entry protects the workspace across calls. The
partials travel and are added in the payload type — one rounding a hop,
in the chunk order above — and the plain version adds in that order, so
it is the kernel's yardstick bit for bit.
"""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.ops._comm import (
    DTYPE_CODE, RS_RING_KERNEL, check_payload, launch, push_slots, rank_of,
)
from triton_distributed_tpu_torch.runtime.context import (
    DistContext, get_context,
)
from triton_distributed_tpu_torch.runtime.symm import symm_zeros


def rs_ring_plain(xs, rank: int) -> torch.Tensor:
    """Plain version of the ring RS for ``rank``: ``xs`` — the n ranks'
    (n*m, cols) contributions — → chunk ``rank`` summed in ring order
    (x_{c+1} + x_{c+2} + ... + x_c, c = rank), each add in the payload
    type."""
    n = len(xs)
    m = xs[0].shape[0] // n

    def chunk(j):
        return xs[j % n][rank * m:(rank + 1) * m]

    acc = chunk(rank + 1)
    for k in range(2, n + 1):
        acc = acc + chunk(rank + k)
    return acc


def _rs_ring(x: torch.Tensor, n: int, ctx: DistContext, rank: int
             ) -> torch.Tensor:
    mt, cols = x.shape
    m = mt // n
    if x.device.type == "cuda":
        buf = symm_zeros(ctx, (n - 1, m, cols), x.dtype, tag="rs_ring")
        x = check_payload(ctx, rank, x, "reduce_scatter")
        out = torch.empty((m, cols), dtype=x.dtype, device=x.device)
        launch(RS_RING_KERNEL, buf, rank, buf.next_epoch(rank), x, out,
               m * cols * x.element_size(), DTYPE_CODE[x.dtype])
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
