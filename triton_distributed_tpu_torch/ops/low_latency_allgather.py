"""Low-latency AllGather for decode-shaped small payloads — counterpart of
the JAX package's ``ops/low_latency_allgather.py``.

The single-hop full-mesh push (B4's ``ag_full_mesh`` in
``csrc/collectives.cu``) is the whole method space here, as in the
reference. :class:`AllGatherLayer` pads a rank's rows up to a bucket
(the smallest power-of-two multiple of the reference's row alignment at
least the rows), as the reference's staged buffers do; the push writes
into each call's fresh output and keeps only a signal pad, so the buckets
share it. The pad rows never leave the op.
"""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.ops._comm import rank_shards
from triton_distributed_tpu_torch.ops.allgather import (
    AllGatherMethod, all_gather_local,
)
from triton_distributed_tpu_torch.ops.tiling import sublane_align
from triton_distributed_tpu_torch.runtime.context import (
    DistContext, get_context,
)


def fast_allgather_local(x_local: torch.Tensor, *, axis: str = "tp",
                         num_ranks: int | None = None) -> torch.Tensor:
    """Rank-local low-latency AllGather: always the single-hop full-mesh
    push."""
    return all_gather_local(x_local, axis=axis, num_ranks=num_ranks,
                            method=AllGatherMethod.FULL_MESH_PUSH)


def _bucket(m: int, align: int) -> int:
    """Smallest power-of-two multiple of ``align`` >= m."""
    b = align
    while b < m:
        b *= 2
    return b


class AllGatherLayer:
    """Decode comm layer: the bucketed low-latency AllGather (reference
    ``low_latency_allgather_layer.py``'s staged buffers become the
    bucket's padded rows, pushed into each call's output)."""

    def __init__(self, ctx: DistContext | None = None, axis: str = "tp"):
        self.ctx = ctx or get_context()
        self.axis = axis
        self.n = self.ctx.axis_size(axis)

    def __call__(self, x) -> list:
        """x: the n ranks' (m_local, cols) rows (a list, or an (n·m_local,
        cols) tensor split by rows). Returns the n ranks' gathered
        (n·m_local, cols) copies."""
        n, ctx = self.n, self.ctx
        xs = rank_shards(ctx, self.axis, x)
        m_local, cols = xs[0].shape
        bucket = _bucket(max(m_local, 1), sublane_align(xs[0].dtype))

        def body(r):
            xl = xs[r].to(ctx.devices[r])
            xp = torch.zeros((bucket, cols), dtype=xl.dtype, device=xl.device)
            xp[:m_local] = xl
            out = fast_allgather_local(xp, axis=self.axis, num_ranks=n)
            return out.reshape(n, bucket, cols)[:, :m_local].reshape(
                n * m_local, cols)

        outs = ctx.run(body)
        ctx.raise_on_comm_error()
        return outs


def fast_allgather(x, ctx: DistContext | None = None,
                   axis: str = "tp") -> list:
    """One host-level low-latency AllGather (the layer without keeping
    it)."""
    return AllGatherLayer(ctx, axis)(x)
