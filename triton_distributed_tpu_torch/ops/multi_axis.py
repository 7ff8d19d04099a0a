"""Collectives over both axes of a 2-axis rank group — counterpart of the
JAX package's ``ops/multi_axis.py``: kernel B12 (``_ag_torus_kernel``,
``_ar_one_shot_torus_kernel``) as the hand-written CUDA kernels
``ag_torus`` and ``ar_torus`` of ``csrc/multi_axis.cu``.

Ranks are row-major over ``axes = (ax0, ax1)``: rank (a, b) has the
joint index g = a·n1 + b, as ``P((ax0, ax1))`` shards.

- :func:`all_gather_torus_local`: the ring-of-rings AllGather — each
  rank's shard to its inner and outer peers, and each inner shard
  forwarded to the outer peers as it lands; shard (a, b) at rows
  [(a·n1 + b)·m, ...). On the push protocol (``csrc/push.cuh``): every
  writer stores straight into its receivers' fresh outputs, whose
  addresses they publish (:func:`torus_schedule`); only a signal pad is
  kept, no gather buffer.
- :func:`all_reduce_torus_local`: ``"one_shot"`` — the hierarchical
  one-shot (along ax1, then the reduced block along ax0, one kernel; each
  phase sums in order in fp32 and casts once). On the push protocol with
  the roles mirrored: each rank publishes its input to its grid row and a
  fresh per-call mid to its grid column, sums its row's inputs into the
  mid, then its column's mids into its output (:func:`torus_ar_schedule`);
  only a signal pad is kept, no slot workspace. ``"two_shot"`` —
  :func:`reduce_scatter_torus_local` then :func:`all_gather_torus_local`;
  ``"auto"`` — one-shot on a real grid.
- :func:`reduce_scatter_torus_local`: the ring RS (B6) along ax0 on n0
  super-chunks, then along ax1 — two B6 rings in sequence, each on the
  rank's fiber of its axis.

A degenerate grid (``n0 == 1`` or ``n1 == 1``) takes the 1-D op of the
other axis; ``n0·n1 == 1`` is the identity. On a CUDA tensor the wrappers
launch the kernels (counted in ``AG_TORUS_KERNEL`` / ``AR_TORUS_KERNEL``);
on a CPU tensor they run the plain versions, which replay the kernels'
schedules through the rank threads' exchange. Call the ``*_local``
functions inside ``DistContext.run``; the host-level forms run them on
every rank.
"""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.ops._comm import (
    AG_TORUS_KERNEL, AR_TORUS_BLOCK_BYTES, AR_TORUS_KERNEL, DTYPE_CODE,
    TORUS_AR_LAYOUT, check_out, check_payload, launch_push, rank_of,
)
from triton_distributed_tpu_torch.ops.allreduce import reduce_slots_plain
from triton_distributed_tpu_torch.runtime.build import ptr
from triton_distributed_tpu_torch.runtime.context import (
    DistContext, get_context,
)
from triton_distributed_tpu_torch.runtime.symm import symm_pad


def ar_torus_plain(slots, n0: int, n1: int) -> torch.Tensor:
    """Plain version of ``ar_torus``: ``slots`` — the n0·n1 ranks'
    (m, cols) contributions in joint order — reduced as the kernel does:
    each row a of the grid summed over b in order (fp32 from 0, one cast),
    then those n0 sums over a the same way."""
    mids = [reduce_slots_plain([slots[a * n1 + b] for b in range(n1)])
            for a in range(n0)]
    return reduce_slots_plain(mids)


def torus_schedule(n0: int, n1: int) -> list:
    """What every rank of an (n0, n1) grid writes in the torus AllGather,
    as ``csrc/multi_axis.cu`` ag_torus does it: rank g = (a, b) its ``own``
    shard into slot g of its own output, then of its inner peers (a, b+1),
    (a, b+2), ... and its outer peers (a+1, b), (a+2, b), ...; then its
    ``forward`` hops in the inner ring's order (b-1, b-2, ...): slot (a, c)
    from its own output into its outer peers' outputs, once that slot
    landed. Each rank's ``writers`` (the ranks it publishes its output to)
    are its inner and outer peers. One dict a rank, in rank order."""
    plan = []
    for g in range(n0 * n1):
        a, b = divmod(g, n1)
        inner = [a * n1 + (b + i) % n1 for i in range(1, n1)]
        outer = [((a + i) % n0) * n1 + b for i in range(1, n0)]
        plan.append({
            "own": [g, *inner, *outer],
            "forward": [(a * n1 + (b - i) % n1, outer)
                        for i in range(1, n1)],
            "writers": sorted(inner + outer)})
    return plan


def torus_ar_schedule(n0: int, n1: int) -> list:
    """What every rank of an (n0, n1) grid does in the torus AllReduce, as
    ``csrc/multi_axis.cu`` ar_torus does it: rank g = (a, b) ``publish``es
    its input to its ``inner`` peers (a, j) and its mid to its ``outer``
    peers (u, b); phase 1 sums the inputs of ``row`` (a, 0), (a, 1), ...
    in that order into its mid, phase 2 the mids of ``column`` (0, b),
    (1, b), ... in that order into its output; it releases each source
    after reading it, and ends once its ``inner`` readers released its
    input and its ``outer`` readers its mid. One dict a rank, in rank
    order."""
    plan = []
    for g in range(n0 * n1):
        a, b = divmod(g, n1)
        inner = [a * n1 + j for j in range(n1) if j != b]
        outer = [u * n1 + b for u in range(n0) if u != a]
        plan.append({
            "publish": {**{j: "input" for j in inner},
                        **{u: "mid" for u in outer}},
            "inner": inner, "outer": outer,
            "row": [a * n1 + j for j in range(n1)],
            "column": [u * n1 + b for u in range(n0)]})
    return plan


def _grid_call(x_local: torch.Tensor, axes, dims, what: str):
    ctx, rank, n = rank_of(tuple(axes), dims[0] * dims[1])
    if x_local.dim() != 2:
        raise ValueError(f"{what}: payload must be (m, cols), got "
                         f"{tuple(x_local.shape)}")
    return ctx, rank, n


def all_gather_torus_local(x_local: torch.Tensor, *, axes: tuple[str, str],
                           dims: tuple[int, int],
                           out: torch.Tensor | None = None) -> torch.Tensor:
    """Rank-local 2-axis AllGather inside ``DistContext.run``:
    ``x_local`` (m, cols) → (n0·n1·m, cols), joint-rank-major over
    (axes[0], axes[1]). ``out``: the output its writers fill (every
    element; a harness's sentinel), else a fresh one — on a real grid
    only (a degenerate one takes the 1-D ring)."""
    ax0, ax1 = axes
    n0, n1 = dims
    if (n0 == 1 or n1 == 1) and out is not None:
        raise ValueError("all_gather_torus: out= needs the torus kernel "
                         f"(a real grid), not {dims}")
    if n0 * n1 == 1:
        return x_local
    if n0 == 1 or n1 == 1:
        from triton_distributed_tpu_torch.ops.allgather import (
            AllGatherMethod, all_gather_local,
        )

        axis, n = (ax1, n1) if n0 == 1 else (ax0, n0)
        return all_gather_local(x_local, axis=axis, num_ranks=n,
                                method=AllGatherMethod.RING_1D)
    ctx, rank, n = _grid_call(x_local, axes, dims, "all_gather_torus")
    m, cols = x_local.shape
    if out is not None:
        out = check_out(ctx, rank, out, (n * m, cols), x_local.dtype,
                        "all_gather_torus")
    if x_local.device.type == "cuda":
        x = check_payload(ctx, rank, x_local, "all_gather_torus", copy=True)
        if out is None:
            out = torch.empty((n * m, cols), dtype=x.dtype, device=x.device)
        launch_push(AG_TORUS_KERNEL, symm_pad(ctx, tag="ag_torus"), rank, x,
                    out, m * cols * x.element_size(), n0, n1)
        return out
    if x_local.device.type != "cpu":
        raise ValueError(f"all_gather_torus: no kernel for device "
                         f"{x_local.device}")
    AG_TORUS_KERNEL.count_plain()
    if out is None:
        out = torch.empty((n * m, cols), dtype=x_local.dtype)
    plan = torus_schedule(n0, n1)[rank]
    outs = ctx.exchange(rank, out, "ag_torus.addr")
    for d in plan["own"]:
        outs[d][rank * m:(rank + 1) * m].copy_(x_local)
    ctx.barrier(rank, "ag_torus.inner")
    for s, dests in plan["forward"]:
        for d in dests:
            outs[d][s * m:(s + 1) * m].copy_(out[s * m:(s + 1) * m])
    ctx.barrier(rank, "ag_torus.data")
    return out


def all_reduce_torus_local(x_local: torch.Tensor, *, axes: tuple[str, str],
                           dims: tuple[int, int],
                           method: str = "one_shot",
                           out: torch.Tensor | None = None) -> torch.Tensor:
    """Rank-local 2-axis AllReduce inside ``DistContext.run``:
    ``x_local`` (m, cols) → (m, cols) summed over the n0·n1 grid, the
    same bits on every rank. ``method``: ``"one_shot"`` (the hierarchical
    one-shot), ``"two_shot"`` (RS then AG over both axes), ``"auto"``
    (one-shot on a real grid; the 1-D AUTO on a degenerate one). ``out``:
    the output the one-shot writes (every element; a harness's sentinel),
    else a fresh one — on a real grid only."""
    ax0, ax1 = axes
    n0, n1 = dims
    if out is not None and (n0 == 1 or n1 == 1
                            or method not in ("one_shot", "auto")):
        raise ValueError("all_reduce_torus: out= is the one-shot's on a "
                         f"real grid, not {method!r} on {dims}")
    if n0 * n1 == 1:
        return x_local
    if n0 == 1 or n1 == 1:
        from triton_distributed_tpu_torch.ops.allreduce import (
            all_reduce_local,
        )

        axis, n = (ax1, n1) if n0 == 1 else (ax0, n0)
        return all_reduce_local(x_local, axis=axis, num_ranks=n,
                                method=method)
    if method == "auto":
        method = "one_shot"
    if method == "two_shot":
        total = n0 * n1
        m = x_local.shape[0]
        if m % total:
            raise ValueError(
                f"two_shot requires rows {m} divisible by n0*n1 {total}")
        scattered = reduce_scatter_torus_local(x_local, axes=axes, dims=dims)
        return all_gather_torus_local(scattered, axes=axes, dims=dims)
    if method != "one_shot":
        raise ValueError(f"unknown torus AR method {method!r}")
    ctx, rank, n = _grid_call(x_local, axes, dims, "all_reduce_torus")
    if out is not None:
        out = check_out(ctx, rank, out, x_local.shape, x_local.dtype,
                        "all_reduce_torus")
    if x_local.device.type == "cuda":
        x = check_payload(ctx, rank, x_local, "all_reduce_torus")
        # The row sum, fresh a call: the outer peers read it while this
        # rank's kernel holds it (allocated on the rank's stream, so it
        # is not handed out again before that kernel ends).
        mid = torch.empty_like(x)
        if out is None:
            out = torch.empty_like(x)
        launch_push(AR_TORUS_KERNEL, symm_pad(ctx, tag="ar_torus"), rank, x,
                    out, x.numel() * x.element_size(), ptr(mid), n0, n1,
                    DTYPE_CODE[x.dtype], block_bytes=AR_TORUS_BLOCK_BYTES,
                    layout=TORUS_AR_LAYOUT)
        return out
    if x_local.device.type != "cpu":
        raise ValueError(f"all_reduce_torus: no kernel for device "
                         f"{x_local.device}")
    AR_TORUS_KERNEL.count_plain()
    plan = torus_ar_schedule(n0, n1)[rank]
    # What each rank published: its input to its row, its mid to its
    # column (every rank's, read by index).
    ins = ctx.exchange(rank, x_local, "ar_torus.input")
    mid = reduce_slots_plain([ins[s] for s in plan["row"]])
    mids = ctx.exchange(rank, mid, "ar_torus.mid")
    got = reduce_slots_plain([mids[s] for s in plan["column"]])
    # The sources are held until every reader is done.
    ctx.barrier(rank, "ar_torus.released")
    if out is None:
        return got
    out.copy_(got)
    return out


def reduce_scatter_torus_local(x_local: torch.Tensor, *,
                               axes: tuple[str, str],
                               dims: tuple[int, int]) -> torch.Tensor:
    """Rank-local 2-axis ReduceScatter inside ``DistContext.run``:
    ``x_local`` (n0·n1·mo, cols) contributions → (mo, cols), rank (a, b)
    owning chunk a·n1 + b summed over the grid. The ring RS along
    ``axes[0]`` on n0 super-chunks of n1·mo rows, then along ``axes[1]``
    (a true data dependence: no cross-phase pipeline)."""
    from triton_distributed_tpu_torch.ops.reduce_scatter import (
        reduce_scatter_local,
    )

    ax0, ax1 = axes
    n0, n1 = dims
    if n0 * n1 == 1:
        return x_local
    if n0 == 1:
        return reduce_scatter_local(x_local, axis=ax1, num_ranks=n1)
    if n1 == 1:
        return reduce_scatter_local(x_local, axis=ax0, num_ranks=n0)
    mt = x_local.shape[0]
    if mt % (n0 * n1):
        raise ValueError(f"rows {mt} not divisible by n0*n1 {n0 * n1}")
    mid = reduce_scatter_local(x_local, axis=ax0, num_ranks=n0)
    return reduce_scatter_local(mid, axis=ax1, num_ranks=n1)


# ---------------------------------------------------------------------------
# Host-level forms: the per-rank inputs in joint order over ``axes``, the
# per-rank outputs in group rank order.
# ---------------------------------------------------------------------------

def _resolve_axes(ctx: DistContext, axes) -> tuple[tuple[str, str],
                                                   tuple[int, int]]:
    if axes is None:
        names = tuple(ctx.axis_names)
        if len(names) != 2:
            raise ValueError(
                f"torus collectives need two mesh axes; the group has "
                f"{names} — pass axes=(outer, inner) explicitly")
        axes = names
    ax0, ax1 = axes
    return (ax0, ax1), (ctx.axis_size(ax0), ctx.axis_size(ax1))


def _run_grid(ctx: DistContext, axes, parts: list, fn) -> list:
    """``fn(part)`` on every rank, rank r taking the part of its joint
    index over ``axes``; the group's ranks must be exactly the grid."""
    if ctx.axis_size(axes) != ctx.num_ranks:
        raise ValueError(f"axes {axes} cover {ctx.axis_size(axes)} of the "
                         f"group's {ctx.num_ranks} ranks")
    outs = ctx.run(lambda r: fn(
        parts[ctx.axis_index(r, axes)].to(ctx.devices[r])))
    ctx.raise_on_comm_error()
    return outs


def _grid_parts(x, n0: int, n1: int) -> list:
    """n0·n1 per-rank contributions in joint order: a list, or a tensor
    stacked (n0, n1, ...)."""
    if isinstance(x, (list, tuple)):
        parts = list(x)
    else:
        if tuple(x.shape[:2]) != (n0, n1):
            raise ValueError(f"stacked contributions {tuple(x.shape)} do not "
                             f"start with the grid ({n0}, {n1})")
        parts = list(x.reshape(n0 * n1, *x.shape[2:]).unbind(0))
    if len(parts) != n0 * n1:
        raise ValueError(f"{len(parts)} contributions for {n0 * n1} ranks")
    return parts


def all_gather_torus(x, ctx: DistContext | None = None,
                     axes: tuple[str, str] | None = None) -> list:
    """Host-level 2-axis AllGather: ``x`` (n0·n1·m, cols) row-sharded
    joint-major over ``axes`` (or the n0·n1 shards as a list) → every
    rank's gathered (n0·n1·m, cols)."""
    ctx = ctx or get_context()
    axes, dims = _resolve_axes(ctx, axes)
    n = dims[0] * dims[1]
    parts = (list(x) if isinstance(x, (list, tuple))
             else list(torch.chunk(x, n, dim=0)))
    return _run_grid(ctx, axes, parts, lambda p: all_gather_torus_local(
        p, axes=axes, dims=dims))


def all_reduce_torus(x, ctx: DistContext | None = None,
                     axes: tuple[str, str] | None = None,
                     method: str = "one_shot") -> list:
    """Host-level 2-axis AllReduce: ``x`` (n0, n1, m, cols) stacked
    contributions (or a list in joint order) → every rank's (m, cols)
    sum."""
    ctx = ctx or get_context()
    axes, dims = _resolve_axes(ctx, axes)
    parts = _grid_parts(x, *dims)
    return _run_grid(ctx, axes, parts, lambda p: all_reduce_torus_local(
        p, axes=axes, dims=dims, method=method))


def reduce_scatter_torus(x, ctx: DistContext | None = None,
                         axes: tuple[str, str] | None = None) -> list:
    """Host-level 2-axis ReduceScatter: ``x`` (n0, n1, N·mo, cols)
    stacked contributions (N = n0·n1; or a list in joint order) → every
    rank's (mo, cols) chunk of the sum, rank (a, b) holding chunk
    a·n1 + b."""
    ctx = ctx or get_context()
    axes, dims = _resolve_axes(ctx, axes)
    parts = _grid_parts(x, *dims)
    return _run_grid(ctx, axes, parts, lambda p: reduce_scatter_torus_local(
        p, axes=axes, dims=dims))
