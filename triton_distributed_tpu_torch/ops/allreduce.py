"""AllReduce over the rank group — counterpart of the JAX package's
``ops/allreduce.py``: kernel B5 in its one-shot form
(``_ar_one_shot_kernel``), its barrier-free parity form
(``_ar_one_shot_parity_kernel``, the decode path) and its double binary
tree (``_ar_tree_kernel``), all hand-written CUDA in
``csrc/collectives.cu``; two-shot as ring reduce-scatter (B6) then ring
all-gather (B4); AUTO by the perf model.

Methods:

- ``ONE_SHOT``: every rank reads every rank's input and sums the n of
  them in rank order in fp32, casting once. One hop, n x traffic: the
  small payloads' method. On the push protocol with every rank an owner
  of the whole payload (B6's roles): each rank publishes its input's
  address, reads its peers' inputs straight from them and releases each
  source, whose kernel holds its input until every reader released it —
  no entry barrier and no slot workspace (only the ``"ar_one_shot"``
  signal pad).
- ``TWO_SHOT``: ``reduce_scatter_local`` then ``all_gather_local(RING_1D)``
  — 2(n-1) hops of 1/n of the payload: the large payloads' method.
- ``TREE``: the double binary tree — tree 0 the heap over rank order,
  tree 1 over reversed ranks, each reducing half of the rows up to its
  root and broadcasting the sum down (one tree of every row at m = 1).
  On the push protocol: each partial lands in the parent's symmetric slot
  once the parent freed it, and each sum is written straight into the
  children's fresh outputs (:func:`tree_schedule`).
  AUTO selects it at n = 4 between ~1.35 and ~1.8 MB (165-219 bf16 rows
  x 4096: an ``"ar"`` prefill of that many rows).
- ``XLA``: the JAX package's ``psum`` — a plain sum through the rank
  group (``runtime/context.group_psum``).

The decode path's repeated AllReduces take :func:`all_reduce_stream`
(the reference's parity form): on a card the one-shot's body over the
stream's own pad, its epoch the call index + 1.

Every method's order and rounding is part of its contract — the replicas
must end bit-identical —, and each kernel's plain version keeps it:
one-shot and parity add in fp32 from 0 in rank order and cast once; the
ring RS adds in the payload type a hop; the tree adds a node's own rows
and its children's in fp32 and rounds once a level.

Call the ``*_local`` functions inside ``DistContext.run`` (the
``shard_map`` counterpart); the host-level :func:`all_reduce` runs them on
every rank.
"""

from __future__ import annotations

import enum

import torch

from triton_distributed_tpu_torch.ops._comm import (
    AR_ONE_SHOT_BLOCK_BYTES, DTYPE_CODE, ONE_SHOT_KERNEL, PARITY_KERNEL,
    TREE_KERNEL, StreamWorkspace, check_out, check_payload, launch_push,
    launch_tree, push_slots, rank_of, straggle,
)
from triton_distributed_tpu_torch.ops.allgather import (
    AllGatherMethod, all_gather_local,
)
from triton_distributed_tpu_torch.ops.reduce_scatter import (
    reduce_scatter_local,
)
from triton_distributed_tpu_torch.runtime.context import (
    DistContext, get_context, group_context, group_psum,
)
from triton_distributed_tpu_torch.runtime.symm import symm_pad, symm_zeros


class AllReduceMethod(enum.Enum):
    AUTO = "auto"
    ONE_SHOT = "one_shot"
    TWO_SHOT = "two_shot"
    TREE = "tree"
    XLA = "xla"


def get_auto_allreduce_method(nbytes: int, num_ranks: int,
                              tree_halves: int = 2, spec=None, *,
                              two_shot: bool = True) -> AllReduceMethod:
    """The method with the least modeled time for a payload of
    ``nbytes`` (runtime/perf_model.allreduce_time_s): one-shot at n <= 2,
    else the cheapest of one-shot, two-shot and tree. ``two_shot=False``
    leaves two-shot out: it needs the rows to divide by n (the reference
    would pick it and then refuse the rows)."""
    if num_ranks <= 2:
        return AllReduceMethod.ONE_SHOT
    from triton_distributed_tpu_torch.runtime.perf_model import (
        allreduce_time_s,
    )

    methods = ("one_shot", "two_shot", "tree") if two_shot else (
        "one_shot", "tree")
    times = {m: allreduce_time_s(nbytes, num_ranks, m, spec,
                                 tree_halves=tree_halves)
             for m in methods}
    return AllReduceMethod(min(times, key=times.get))


def _tree_halves(m: int, dtype=None) -> int:
    """2 when the rows split into two halves (the double tree), else 1.
    The reference asks each half to fill whole (8, 128) sublane tiles;
    Hopper has no such tiling, so any m >= 2 splits: tree 0 takes rows
    [0, ceil(m/2)), tree 1 the rest."""
    return 2 if m >= 2 else 1


def tree_plain(xs) -> torch.Tensor:
    """Plain version of the double-tree AllReduce: ``xs`` — the n ranks'
    (m, cols) contributions — reduced level by level exactly as the
    kernel does: a leaf's rows go up as they are; an interior node at
    heap position p adds its own rows, then child 2p+1's, then child
    2p+2's in fp32 and rounds to the payload type once; the root's rows
    are the sum every rank ends with. Tree 0 over rank order owns rows
    [0, ceil(m/2)), tree 1 over reversed ranks the rest."""
    n, m = len(xs), xs[0].shape[0]
    trees = _tree_halves(m)
    mh = -(-m // trees)
    out = torch.empty_like(xs[0])
    for t in range(trees):
        rows = slice(t * mh, min(m, (t + 1) * mh))

        def node(pos):
            own = xs[pos if t == 0 else n - 1 - pos][rows]
            if 2 * pos + 1 >= n:
                return own
            acc = own.float() + node(2 * pos + 1).float()
            if 2 * pos + 2 < n:
                acc = acc + node(2 * pos + 2).float()
            return acc.to(own.dtype)

        out[rows] = node(0)
    return out


def tree_schedule(n: int, trees: int) -> list:
    """The double tree's edges as ``csrc/collectives.cu`` ar_tree walks
    them: for each tree t (tree 0 the heap over rank order, tree 1 over
    reversed ranks), one dict a rank with its heap position ``pos``, its
    ``level`` (the root 0), its ``parent`` (a rank, or None at the root),
    ``slot`` (its slot at the parent: 0 for child 2p+1, 1 for 2p+2) and
    its ``children`` (ranks, child 2p+1 first)."""
    def rank_at(pos, t):
        return pos if t == 0 else n - 1 - pos

    plan = []
    for t in range(trees):
        nodes = [None] * n
        for pos in range(n):
            nodes[rank_at(pos, t)] = {
                "pos": pos, "level": (pos + 1).bit_length() - 1,
                "parent": None if pos == 0 else rank_at((pos - 1) // 2, t),
                "slot": (pos + 1) % 2,
                "children": [rank_at(c, t) for c in (2 * pos + 1,
                                                     2 * pos + 2) if c < n]}
        plan.append(nodes)
    return plan


def _tree(x: torch.Tensor, n: int, ctx: DistContext, rank: int,
          out: torch.Tensor | None = None) -> torch.Tensor:
    """The double tree on a CUDA tensor, its plain version on a CPU one:
    the partials land in the parents' symmetric slots (trees, 2, mh,
    cols), the sums in the ranks' own outputs (``out``, a harness's
    sentinel, else fresh)."""
    m, cols = x.shape
    trees = _tree_halves(m)
    mh = -(-m // trees)
    ws = symm_zeros(ctx, (trees, 2, mh, cols), x.dtype, tag="ar_tree")
    if out is not None:
        out = check_out(ctx, rank, out, (m, cols), x.dtype, "all_reduce tree")
    if x.device.type == "cuda":
        x = check_payload(ctx, rank, x, "all_reduce tree")
        if out is None:
            out = torch.empty_like(x)
        launch_tree(ws, rank, x, out, trees)
        return out
    if x.device.type != "cpu":
        raise ValueError(f"all_reduce: no kernel for device {x.device}")
    TREE_KERNEL.count_plain()
    if out is None:
        out = torch.empty_like(x)
    plan = tree_schedule(n, trees)
    outs = ctx.exchange(rank, out, "ar_tree.addr")
    depth = max(node["level"] for node in plan[0])
    # Up, deepest level first: a node's partial into its parent's slot,
    # the root's sum into its output and its children's; the ranks meet
    # after each level.
    for level in range(depth, -1, -1):
        for t in range(trees):
            node = plan[t][rank]
            if node["level"] != level:
                continue
            rows = slice(t * mh, min(m, (t + 1) * mh))
            nr = rows.stop - rows.start
            part = x[rows]
            if node["children"]:
                acc = part.float() + ws.tensors[rank][t, 0, :nr].float()
                if len(node["children"]) == 2:
                    acc = acc + ws.tensors[rank][t, 1, :nr].float()
                part = acc.to(x.dtype)
            if node["parent"] is None:
                for d in [rank, *node["children"]]:
                    outs[d][rows].copy_(part)
            else:
                ws.tensors[node["parent"]][t, node["slot"], :nr].copy_(part)
        ctx.barrier(rank, f"ar_tree.up{level}")
    # Down: each interior node passes its rows on to its children.
    for level in range(1, depth):
        for t in range(trees):
            node = plan[t][rank]
            if node["level"] == level:
                rows = slice(t * mh, min(m, (t + 1) * mh))
                for c in node["children"]:
                    outs[c][rows].copy_(out[rows])
        ctx.barrier(rank, f"ar_tree.down{level}")
    return out


def reduce_slots_plain(slots) -> torch.Tensor:
    """Plain version of the one-shot and parity kernels' reduction
    (reference ``_reduce_slots``): ``slots`` (n, m, cols) — or a list of n
    (m, cols) — summed in rank order in fp32 starting from 0, cast once
    to the payload type. Starting from 0 matters: 0 + (-0) is +0."""
    acc = torch.zeros(slots[0].shape, dtype=torch.float32,
                      device=slots[0].device)
    for s in slots:
        acc = acc + s.float()
    return acc.to(slots[0].dtype)


def _one_shot(x: torch.Tensor, n: int, ctx: DistContext, rank: int
              ) -> torch.Tensor:
    """The one-shot on a CUDA tensor (the push protocol over the
    ``"ar_one_shot"`` pad: no payload buffer), its plain version on a CPU
    one (a rendezvous through the slots of an (n, m, cols) buffer)."""
    m, cols = x.shape
    if x.device.type == "cuda":
        x = check_payload(ctx, rank, x, "all_reduce one_shot")
        out = torch.empty_like(x)
        launch_push(ONE_SHOT_KERNEL, symm_pad(ctx, tag="ar_one_shot"), rank,
                    x, out, x.numel() * x.element_size(),
                    DTYPE_CODE[x.dtype], block_bytes=AR_ONE_SHOT_BLOCK_BYTES)
        return out
    if x.device.type != "cpu":
        raise ValueError(f"all_reduce: no kernel for device {x.device}")
    ONE_SHOT_KERNEL.count_plain()
    buf = symm_zeros(ctx, (n, m, cols), x.dtype, tag="ar_one_shot_plain")
    ctx.barrier(rank, "ar_one_shot.entry")
    push_slots(ctx, rank, buf, x, rank, "ar_one_shot.data")
    return reduce_slots_plain(buf.tensors[rank])


def all_reduce_local(x_local: torch.Tensor, axis: str = "tp",
                     num_ranks: int | None = None,
                     method: AllReduceMethod | str = AllReduceMethod.AUTO,
                     *, out: torch.Tensor | None = None) -> torch.Tensor:
    """Rank-local AllReduce inside ``DistContext.run``: ``x_local``
    (m, cols) on every rank → (m, cols) = the ranks' sum, bit-identical on
    every rank. ``out``: the output the double tree writes (every element;
    a harness's sentinel), for ``method="tree"`` alone — or, over a tuple
    axis, the torus one-shot's. Repeated steady-state calls (decode) take
    :func:`all_reduce_stream`."""
    if isinstance(axis, (tuple, list)):
        # The multi-axis form (ops/multi_axis.py): num_ranks is (n0, n1);
        # "xla" is the plain sum over both axes, "auto" passes through
        # (the torus op maps it to the hierarchical one-shot on a real
        # grid and runs the 1-D AUTO on a degenerate one).
        if num_ranks is None:
            raise ValueError("num_ranks (n0, n1) required inside the rank "
                             "runner")
        from triton_distributed_tpu_torch.ops.multi_axis import (
            all_reduce_torus_local,
        )

        m = AllReduceMethod(method).value
        if m == "xla" and out is None:
            return group_psum(x_local, axis=tuple(axis))
        return all_reduce_torus_local(x_local, axes=tuple(axis),
                                      dims=tuple(num_ranks), method=m,
                                      out=out)
    if out is not None and AllReduceMethod(method) != AllReduceMethod.TREE:
        raise ValueError("all_reduce: out= is the tree's — method "
                         f"{AllReduceMethod(method).value!r}")
    method = AllReduceMethod(method)
    ctx, rank, n = rank_of(axis, num_ranks)
    if n == 1:
        if out is not None:
            raise ValueError("all_reduce: out= needs the tree (n > 1)")
        return x_local
    if method == AllReduceMethod.AUTO:
        method = get_auto_allreduce_method(
            x_local.numel() * x_local.element_size(), n,
            tree_halves=_tree_halves(x_local.shape[0]),
            two_shot=x_local.shape[0] % n == 0)
    if method == AllReduceMethod.XLA:
        return group_psum(x_local, axis=axis, num_ranks=n)
    if method == AllReduceMethod.TREE:
        return _tree(x_local, n, ctx, rank, out)
    if method == AllReduceMethod.TWO_SHOT:
        m = x_local.shape[0]
        if m % n:
            raise ValueError(f"two_shot requires rows {m} divisible by "
                             f"num_ranks {n}")
        scattered = reduce_scatter_local(x_local, axis=axis, num_ranks=n)
        return all_gather_local(scattered, axis=axis, num_ranks=n,
                                method=AllGatherMethod.RING_1D)
    return _one_shot(x_local, n, ctx, rank)


# ---------------------------------------------------------------------------
# Barrier-free steady-state AR (the decode path).
# ---------------------------------------------------------------------------

def ar_stream_workspace(n: int, m: int, cols: int, dtype, *,
                        ctx: DistContext | None = None,
                        tag: str = "ar_stream"
                        ) -> tuple[StreamWorkspace, int]:
    """The persistent (workspace, call_index) pair of
    :func:`all_reduce_stream` for (m, cols) ``dtype`` payloads, allocated
    once per (shape, dtype, tag) on the context, and the index of the next
    call (0 for a new tag). Thread both through the decode loop; give each
    stream of calls its own ``tag``; asking again for a tag in use returns
    its workspace with the index of its next call (the calling rank's,
    inside a rank thread). The reference pads the rows to the TPU's
    sublane tiling (``_ar_rows_padded``); Hopper has no such tiling, so the
    rows stay as they are."""
    ctx = group_context(ctx)
    if ctx.num_ranks != n:
        raise ValueError(f"n = {n} but the rank group has {ctx.num_ranks}")
    if ctx.is_cuda:
        buf = symm_pad(ctx, tag=f"{tag}-{n}x{m}x{cols}-{dtype}")
    else:
        buf = symm_zeros(ctx, (2, n, m, cols), dtype, tag=tag)
    return StreamWorkspace(buf, (2, n, m, cols), dtype), buf.call_index()


def all_reduce_stream(x_local: torch.Tensor, ws: StreamWorkspace,
                      call_index: int, *, axis: str = "tp",
                      num_ranks: int | None = None,
                      straggler: tuple | None = None,
                      force_kernel: bool = False):
    """Barrier-free one-shot AllReduce over a persistent workspace
    (reference ``all_reduce_stream``; kernel ``ar_parity`` of
    ``csrc/collectives.cu``). x_local: (m, cols); ws from
    :func:`ar_stream_workspace`; ``call_index``: a host int, the same
    sequence on every rank. Returns (sum, ws, call_index + 1), the sum in
    rank order in fp32 from 0, cast once (:func:`reduce_slots_plain`).

    On a card, the one-shot's push protocol over the stream's pad with
    the epoch call_index + 1: each rank's block 0 publishes its input to
    every peer, block b reads share b of every rank's input in rank order
    into a fresh output and releases each source, and a rank's kernel
    holds its input until every reader released it — no slab, slot or
    entry barrier; the pad's epochs order its reuse across calls (the
    kernel's comment gives the argument). The caller's input is the
    transport: it must not be written before the call's kernel ends on the
    rank's stream, which stream order gives any later work there. On the
    CPU, call t uses parity slab ``t % 2``: each rank pushes its block
    into slot ``rank`` of every peer's slab, meets them and sums its slab.
    A (ws, call_index) pair must stay persistent per batch shape and
    rank, threaded through the loop; a call out of sequence is refused.
    At n = 1 the input comes back unless ``force_kernel`` (the loopback:
    the kernel sums the one input into a fresh output)."""
    ctx, rank, n = rank_of(axis, num_ranks)
    if n == 1 and not force_kernel:
        return x_local, ws, call_index + 1
    m, cols = x_local.shape
    if ws.shape != (2, n, m, cols):
        raise ValueError(f"workspace shape {ws.shape} != (2, {n}, {m}, "
                         f"{cols}) — allocate via ar_stream_workspace")
    if ws.dtype != x_local.dtype:
        raise ValueError(f"workspace dtype {ws.dtype} != input"
                         f" {x_local.dtype} — allocate ar_stream_workspace "
                         "with the activation dtype")
    if call_index != ws.epochs[rank]:
        raise ValueError(
            f"all_reduce_stream: call_index {call_index} on rank {rank}, but "
            f"this workspace's next call is {ws.epochs[rank]} — a (ws, "
            "call_index) pair must stay persistent and in sequence (a "
            "second stream of calls needs its own workspace tag)")
    straggle(straggler, n, rank, call_index)
    if x_local.device.type == "cuda":
        x = check_payload(ctx, rank, x_local, "all_reduce_stream")
        out = torch.empty_like(x)
        # The pad's next epoch is call_index + 1: the kernel's flags.
        launch_push(PARITY_KERNEL, ws.buf, rank, x, out,
                    x.numel() * x.element_size(), DTYPE_CODE[x.dtype],
                    block_bytes=AR_ONE_SHOT_BLOCK_BYTES)
        return out, ws, call_index + 1
    if x_local.device.type != "cpu":
        raise ValueError(f"all_reduce_stream: no kernel for device "
                         f"{x_local.device}")
    PARITY_KERNEL.count_plain()
    ws.epochs[rank] = call_index + 1
    p = call_index % 2
    push_slots(ctx, rank, ws.buf, x_local, (p, rank), "ar_stream")
    return reduce_slots_plain(ws.tensors[rank][p]), ws, call_index + 1


def split_ranks(ctx: DistContext, x) -> list:
    """Per-rank contributions of a host-level call: a list of n tensors,
    or a tensor whose leading dim is n (the reference's stacked global
    array)."""
    n = ctx.num_ranks
    xs = list(x) if isinstance(x, (list, tuple)) else list(x.unbind(0))
    if len(xs) != n:
        raise ValueError(f"{len(xs)} contributions for {n} ranks")
    return xs


def all_reduce(x, ctx: DistContext | None = None, axis: str = "tp",
               method: AllReduceMethod | str = AllReduceMethod.AUTO
               ) -> list:
    """Host-level AllReduce: ``x`` — n per-rank (m, cols) contributions
    (a list, or stacked as (n, m, cols)) → the n per-rank sums, rank r's
    on ``ctx.devices[r]``. Reads the ranks' error words after the run."""
    ctx = ctx or get_context()
    n = ctx.axis_size(axis)
    xs = split_ranks(ctx, x)
    outs = ctx.run(lambda r: all_reduce_local(
        xs[r].to(ctx.devices[r]), axis=axis, num_ranks=n, method=method))
    ctx.raise_on_comm_error()
    return outs
