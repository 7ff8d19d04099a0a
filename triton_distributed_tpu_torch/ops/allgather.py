"""All-gather over the rank group — counterpart of the JAX package's
``ops/allgather.py``: kernel B4 in its ring form (``_ag_ring_kernel``) and
its full-mesh push (``_ag_full_mesh_push_kernel``) as hand-written CUDA in
``csrc/collectives.cu`` (``ag_ring``, ``ag_full_mesh``).

The ring forwards, at step s, the chunk received at step s-1 (its own at
s = 0) to the right neighbour; the symmetric gather buffer doubles as the
transport, so chunks land in their final slots, and each rank copies the
gathered buffer out at the end. The full-mesh push stores each rank's
chunk into its slot of every peer's gather buffer in one hop (AUTO's
pick at n <= 2 and for small payloads: the sequential ``"overlap"``
TP-MoE gathers its tokens through it). Both open with a block-scope
barrier that protects the buffer across calls, and both give the same
bits (a copy).

Not ported, refused by name: the barrier-free ``all_gather_stream``
(``_ag_parity_kernel``) — no path of the port runs it. ``XLA`` (the JAX
package's ``jax.lax.all_gather``) is a plain gather through the rank
group.
"""

from __future__ import annotations

import enum

import torch

from triton_distributed_tpu_torch.ops._comm import (
    AG_FULL_MESH_KERNEL, AG_RING_KERNEL, CollectiveUnsupportedError,
    check_payload, launch, push_slots, rank_of,
)
from triton_distributed_tpu_torch.runtime.context import (
    DistContext, get_context, group_all_gather,
)
from triton_distributed_tpu_torch.runtime.symm import symm_zeros


class AllGatherMethod(enum.Enum):
    AUTO = "auto"
    FULL_MESH_PUSH = "full_mesh_push"
    RING_1D = "ring_1d"
    XLA = "xla"


def get_auto_all_gather_method(nbytes: int, num_ranks: int, spec=None
                               ) -> AllGatherMethod:
    """The reference's selection: full-mesh push at n <= 2 or when its
    modeled time is no worse, else the ring. ``nbytes``: the GATHERED
    payload."""
    if num_ranks <= 2:
        return AllGatherMethod.FULL_MESH_PUSH
    from triton_distributed_tpu_torch.runtime.perf_model import (
        allgather_full_mesh_time_s, allgather_ring_time_s,
    )

    if (allgather_full_mesh_time_s(nbytes, num_ranks, spec)
            <= allgather_ring_time_s(nbytes, num_ranks, spec)):
        return AllGatherMethod.FULL_MESH_PUSH
    return AllGatherMethod.RING_1D


def ag_plain(xs) -> torch.Tensor:
    """Plain version of the ring AG and the full-mesh push: the ranks'
    chunks in rank order."""
    return torch.cat(list(xs), dim=0)


def _ag_kernel(kernel, x: torch.Tensor, n: int, ctx: DistContext,
               rank: int) -> torch.Tensor:
    """The ring (``AG_RING_KERNEL``) or the full-mesh push
    (``AG_FULL_MESH_KERNEL``) on a CUDA tensor, their plain version on a
    CPU one. Both are byte copies, so e4m3 rides them too."""
    m, cols = x.shape
    tag = "ag_ring" if kernel is AG_RING_KERNEL else "ag_full_mesh"
    buf = symm_zeros(ctx, (n, m, cols), x.dtype, tag=tag)
    if x.device.type == "cuda":
        x = check_payload(ctx, rank, x, "all_gather", copy=True)
        out = torch.empty((n * m, cols), dtype=x.dtype, device=x.device)
        launch(kernel, buf, rank, buf.next_epoch(rank), x, out,
               m * cols * x.element_size())
        return out
    if x.device.type != "cpu":
        raise ValueError(f"all_gather: no kernel for device {x.device}")
    kernel.count_plain()
    ctx.barrier(rank, f"{tag}.entry")
    push_slots(ctx, rank, buf, x, rank, f"{tag}.data")
    return ag_plain(buf.tensors[rank])


def all_gather_local(x_local: torch.Tensor, axis: str = "tp",
                     num_ranks: int | None = None,
                     method: AllGatherMethod | str = AllGatherMethod.AUTO
                     ) -> torch.Tensor:
    """Rank-local AllGather inside ``DistContext.run``: ``x_local``
    (m, cols) → (n*m, cols), rank j's rows at [j*m, (j+1)*m)."""
    if isinstance(axis, (tuple, list)):
        raise CollectiveUnsupportedError(
            "multi-axis all-gather (ops/multi_axis.py) is not ported — "
            "argument axis")
    method = AllGatherMethod(method)
    ctx, rank, n = rank_of(axis, num_ranks)
    if n == 1:
        return x_local
    if method == AllGatherMethod.AUTO:
        method = get_auto_all_gather_method(
            x_local.numel() * x_local.element_size() * n, n)
    if method == AllGatherMethod.XLA:
        return group_all_gather(x_local, axis=axis, num_ranks=n)
    if method == AllGatherMethod.FULL_MESH_PUSH:
        return _ag_kernel(AG_FULL_MESH_KERNEL, x_local, n, ctx, rank)
    return _ag_kernel(AG_RING_KERNEL, x_local, n, ctx, rank)


def all_gather_stream(*args, **kwargs):
    """The reference's barrier-free parity AG (``_ag_parity_kernel``) —
    not ported, refused by name."""
    raise CollectiveUnsupportedError(
        "all_gather_stream (ops/allgather.py:192 _ag_parity_kernel) is not "
        "ported: no path of the port runs it")


def all_gather(x, ctx: DistContext | None = None, axis: str = "tp",
               method: AllGatherMethod | str = AllGatherMethod.AUTO) -> list:
    """Host-level AllGather: ``x`` — the n per-rank (m, cols) shards (a
    list, or a (n*m, cols) tensor split by rows) → the n per-rank
    gathered (n*m, cols) copies."""
    ctx = ctx or get_context()
    n = ctx.axis_size(axis)
    xs = (list(x) if isinstance(x, (list, tuple))
          else list(torch.chunk(x, n, dim=0)))
    if len(xs) != n:
        raise ValueError(f"{len(xs)} shards for {n} ranks")
    outs = ctx.run(lambda r: all_gather_local(
        xs[r].to(ctx.devices[r]), axis=axis, num_ranks=n, method=method))
    ctx.raise_on_comm_error()
    return outs
