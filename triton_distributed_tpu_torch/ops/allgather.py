"""All-gather over the rank group — counterpart of the JAX package's
``ops/allgather.py``: kernel B4 in its ring form (``_ag_ring_kernel``), its
full-mesh push (``_ag_full_mesh_push_kernel``) and its barrier-free parity
stream (``_ag_parity_kernel``) as hand-written CUDA in
``csrc/collectives.cu`` (``ag_ring``, ``ag_full_mesh``, ``ag_parity``, all
three on one body, ``ag_push``).

The full-mesh push writes each rank's chunk straight into its slot of
every rank's output in one hop, as the TPU kernel's remote DMA does: every
rank publishes its fresh output's address to its peers, each writes,
signals, and waits for the others' (the push protocol, ``csrc/push.cuh``;
only a signal pad is kept, no gather buffer, copy out or barrier). The
TPU ring forwards, at step s, the chunk received at step s-1 to the right
neighbour, for a torus's links; on one card every byte goes through one
HBM and behind NVSwitch every pair of cards has the same path, so on the
card the ring runs the push's body in one hop under its own kernel
(``ag_ring``), launch counter and pad (tag ``"ag_ring"``): no entry
barrier, gather buffer, dependent hops or copy-out. Its plain version
keeps the ring's rendezvous through a symmetric buffer's slots. AUTO
takes the push at n <= 2 and for small payloads (the sequential
``"overlap"`` TP-MoE layer, SP-AG attention, ``flash_decode``'s
``"pallas"`` method and the two-level intra gathers reach it); the
two-shot AllReduces pin the ring for their second half. Both give the
same bits (a copy).
:func:`all_gather_stream` is the SP decode loop's gather of its attention
partials (``ops/flash_decode.py``) over a persistent (workspace, call
index) pair: on a card the same push protocol (the workspace a signal
pad, the grid sized for a latency-bound copy), on the CPU a plain gather
through two parity slabs.
``XLA`` (the JAX package's ``jax.lax.all_gather``) is a plain gather
through the rank group.
"""

from __future__ import annotations

import enum

import torch

from triton_distributed_tpu_torch.ops._comm import (
    AG_FULL_MESH_KERNEL, AG_PARITY_KERNEL, AG_RING_BLOCK_BYTES,
    AG_RING_KERNEL, AGP_BLOCK_BYTES, StreamWorkspace, check_out,
    check_payload, launch_push, push_slots, rank_of, rank_shards, straggle,
)
from triton_distributed_tpu_torch.runtime.context import (
    DistContext, get_context, group_all_gather, group_context,
)
from triton_distributed_tpu_torch.runtime.symm import symm_pad, symm_zeros


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


def _ag_ring(x: torch.Tensor, n: int, ctx: DistContext,
             rank: int) -> torch.Tensor:
    """The ring on a CUDA tensor, its plain version on a CPU one. On the
    card, one hop on the push protocol: each receiver's block 0 publishes
    its fresh output with the call's epoch, each sender's block b writes
    its share of its chunk into slot ``rank`` of every output, its own
    first, and releases its data word; only the ``"ag_ring"`` pad is
    kept, the grid ``push_grid`` over the chunk at a block per
    AG_RING_BLOCK_BYTES (the slice's gather is latency-bound). On the CPU
    each rank pushes its chunk into slot ``rank`` of every peer's
    symmetric (n, m, cols) buffer, meets them and copies its buffer
    out."""
    m, cols = x.shape
    if x.device.type == "cuda":
        x = check_payload(ctx, rank, x, "all_gather", copy=True)
        out = torch.empty((n * m, cols), dtype=x.dtype, device=x.device)
        launch_push(AG_RING_KERNEL, symm_pad(ctx, tag="ag_ring"), rank, x,
                    out, m * cols * x.element_size(),
                    block_bytes=AG_RING_BLOCK_BYTES)
        return out
    if x.device.type != "cpu":
        raise ValueError(f"all_gather: no kernel for device {x.device}")
    AG_RING_KERNEL.count_plain()
    buf = symm_zeros(ctx, (n, m, cols), x.dtype, tag="ag_ring")
    ctx.barrier(rank, "ag_ring.entry")
    push_slots(ctx, rank, buf, x, rank, "ag_ring.data")
    return ag_plain(buf.tensors[rank])


def _ag_push(x: torch.Tensor, n: int, ctx: DistContext, rank: int,
             out: torch.Tensor | None) -> torch.Tensor:
    """The full-mesh push on a CUDA tensor, its plain version on a CPU
    one: each rank's chunk into slot ``rank`` of every rank's output (a
    byte copy, so e4m3 rides it too). ``out``: the output to write (a
    harness's sentinel), else a fresh one."""
    m, cols = x.shape
    if out is not None:
        out = check_out(ctx, rank, out, (n * m, cols), x.dtype, "all_gather")
    if x.device.type == "cuda":
        x = check_payload(ctx, rank, x, "all_gather", copy=True)
        if out is None:
            out = torch.empty((n * m, cols), dtype=x.dtype, device=x.device)
        launch_push(AG_FULL_MESH_KERNEL, symm_pad(ctx, tag="ag_full_mesh"),
                    rank, x, out, m * cols * x.element_size())
        return out
    if x.device.type != "cpu":
        raise ValueError(f"all_gather: no kernel for device {x.device}")
    AG_FULL_MESH_KERNEL.count_plain()
    if out is None:
        out = torch.empty((n * m, cols), dtype=x.dtype)
    for o in ctx.exchange(rank, out, "ag_full_mesh.addr"):
        o[rank * m:(rank + 1) * m].copy_(x)
    ctx.barrier(rank, "ag_full_mesh.data")
    return out


def all_gather_local(x_local: torch.Tensor, axis: str = "tp",
                     num_ranks: int | None = None,
                     method: AllGatherMethod | str = AllGatherMethod.AUTO,
                     *, force_kernel: bool = False,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """Rank-local AllGather inside ``DistContext.run``: ``x_local``
    (m, cols) → (n*m, cols), rank j's rows at [j*m, (j+1)*m).
    ``force_kernel`` runs the full-mesh push at n = 1 too (the loopback:
    the rank writes its own slot); ``out`` is the tensor the push writes
    (every element), else a fresh one — both for the push alone, and
    ``out`` for the torus kernel of a tuple ``axis``."""
    if isinstance(axis, (tuple, list)):
        # The multi-axis form (ops/multi_axis.py): num_ranks is (n0, n1);
        # the ring-of-rings for "auto" / "ring_1d", the plain gather over
        # both axes for "xla"; a pinned method without a 2-axis form is
        # refused, not swapped for another kernel.
        if num_ranks is None:
            raise ValueError("num_ranks (n0, n1) required inside the rank "
                             "runner")
        mk = AllGatherMethod(method).value
        if force_kernel or (out is not None and mk == "xla"):
            raise ValueError("force_kernel / out=: the tuple-axis AG takes "
                             "out= on the torus kernel alone")
        if mk == "xla":
            return group_all_gather(x_local, axis=tuple(axis))
        if mk not in ("auto", "ring_1d"):
            raise ValueError(
                f"method {mk!r} has no multi-axis form; tuple-axis AG "
                "supports auto (ring-of-rings) or xla")
        from triton_distributed_tpu_torch.ops.multi_axis import (
            all_gather_torus_local,
        )

        return all_gather_torus_local(x_local, axes=tuple(axis),
                                      dims=tuple(num_ranks), out=out)
    method = AllGatherMethod(method)
    ctx, rank, n = rank_of(axis, num_ranks)
    if (force_kernel or out is not None) and \
            method != AllGatherMethod.FULL_MESH_PUSH:
        raise ValueError("force_kernel / out are the full-mesh push's — "
                         f"method {method.value!r}")
    if n == 1 and not force_kernel:
        if out is not None:
            raise ValueError("all_gather: out= needs the kernel (n > 1 or "
                             "force_kernel)")
        return x_local
    if method == AllGatherMethod.AUTO:
        method = get_auto_all_gather_method(
            x_local.numel() * x_local.element_size() * n, n)
    if method == AllGatherMethod.XLA:
        return group_all_gather(x_local, axis=axis, num_ranks=n)
    if method == AllGatherMethod.FULL_MESH_PUSH:
        return _ag_push(x_local, n, ctx, rank, out)
    return _ag_ring(x_local, n, ctx, rank)


def ag_stream_workspace(n: int, m: int, cols: int, dtype, *,
                        ctx: DistContext | None = None,
                        tag: str = "ag_stream"
                        ) -> tuple[StreamWorkspace, int]:
    """The persistent (workspace, call_index) pair of
    :func:`all_gather_stream` for (m, cols) ``dtype`` chunks, allocated
    once per (shape, dtype, tag) on the context, and the index of the next
    call (0 for a new tag). Thread both through the decode loop; give each
    stream of calls its own ``tag``. Called inside a rank thread it
    returns that rank's next index."""
    ctx = group_context(ctx)
    if ctx.num_ranks != n:
        raise ValueError(f"n = {n} but the rank group has {ctx.num_ranks}")
    if ctx.is_cuda:
        buf = symm_pad(ctx, tag=f"{tag}-{n}x{m}x{cols}-{dtype}")
    else:
        buf = symm_zeros(ctx, (2, n * m, cols), dtype, tag=tag)
    return StreamWorkspace(buf, (2, n * m, cols), dtype), buf.call_index()


def all_gather_stream(x_local: torch.Tensor, ws: StreamWorkspace,
                      call_index: int, *, axis: str = "tp",
                      num_ranks: int | None = None,
                      straggler: tuple | None = None,
                      force_kernel: bool = False,
                      out: torch.Tensor | None = None):
    """Barrier-free full-mesh-push AllGather over a persistent workspace
    (reference ``all_gather_stream``; kernel ``ag_parity`` of
    ``csrc/collectives.cu``). x_local: (m, cols); ws from
    :func:`ag_stream_workspace`; ``call_index``: a host int, the same
    sequence on every rank. Returns ((n·m, cols), ws, call_index + 1),
    rank j's rows at [j·m, (j+1)·m). ``out``: the output to write (a
    harness's sentinel), else a fresh one.

    On a card, the push protocol (``csrc/push.cuh``): each receiver's
    block 0 publishes its fresh output with the call's epoch (call_index +
    1); each sender's block b reads its share of its chunk once, writes it
    into slot ``rank`` of every receiver's output, its own first, and
    releases block b's data word in each receiver's pad; the receiver's
    block b waits for its sources' words. No slab, copy-out or entry
    barrier: the output is fresh every call, and the pad's epochs order
    its reuse. On the CPU, call t uses parity slab ``t % 2``: each rank
    pushes its block into slot ``rank`` of every peer's slab, meets them
    and copies its slab out. At n = 1 the input comes back unless
    ``force_kernel`` (the loopback: the kernel pushes to itself)."""
    ctx, rank, n = rank_of(axis, num_ranks)
    if n == 1 and not force_kernel:
        if out is not None:
            raise ValueError("all_gather_stream: out= needs the kernel (n > "
                             "1 or force_kernel)")
        return x_local, ws, call_index + 1
    m, cols = x_local.shape
    if ws.shape != (2, n * m, cols):
        raise ValueError(f"workspace shape {ws.shape} != (2, {n * m}, "
                         f"{cols})")
    if ws.dtype != x_local.dtype:
        raise ValueError(f"workspace dtype {ws.dtype} != input"
                         f" {x_local.dtype} — allocate ag_stream_workspace "
                         "with the payload dtype")
    if call_index != ws.epochs[rank]:
        raise ValueError(
            f"all_gather_stream: call_index {call_index} on rank {rank}, but "
            f"this workspace's next call is {ws.epochs[rank]} — a (ws, "
            "call_index) pair must stay persistent and in sequence (a "
            "second stream of calls needs its own workspace tag)")
    if out is not None:
        out = check_out(ctx, rank, out, (n * m, cols), x_local.dtype,
                        "all_gather_stream")
    straggle(straggler, n, rank, call_index)
    if x_local.device.type == "cuda":
        x = check_payload(ctx, rank, x_local, "all_gather_stream", copy=True)
        if out is None:
            out = torch.empty((n * m, cols), dtype=x.dtype, device=x.device)
        # The pad's next epoch is call_index + 1: the kernel's flags.
        launch_push(AG_PARITY_KERNEL, ws.buf, rank, x, out,
                    m * cols * x.element_size(), block_bytes=AGP_BLOCK_BYTES)
        return out, ws, call_index + 1
    if x_local.device.type != "cpu":
        raise ValueError(f"all_gather_stream: no kernel for device "
                         f"{x_local.device}")
    AG_PARITY_KERNEL.count_plain()
    ws.epochs[rank] = call_index + 1
    p = call_index % 2
    push_slots(ctx, rank, ws.buf, x_local,
               (p, slice(rank * m, (rank + 1) * m)), "ag_stream")
    got = ws.buf.tensors[rank][p]
    if out is None:
        return got.clone(), ws, call_index + 1
    out.copy_(got)
    return out, ws, call_index + 1


def all_gather(x, ctx: DistContext | None = None, axis: str = "tp",
               method: AllGatherMethod | str = AllGatherMethod.AUTO) -> list:
    """Host-level AllGather: ``x`` — the n per-rank (m, cols) shards (a
    list, or a (n*m, cols) tensor split by rows) → the n per-rank
    gathered (n*m, cols) copies."""
    ctx = ctx or get_context()
    xs = rank_shards(ctx, axis, x)
    n = len(xs)
    outs = ctx.run(lambda r: all_gather_local(
        xs[r].to(ctx.devices[r]), axis=axis, num_ranks=n, method=method))
    ctx.raise_on_comm_error()
    return outs
