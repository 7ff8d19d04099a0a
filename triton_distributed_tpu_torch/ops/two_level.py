"""Two-level collectives — counterpart of the JAX package's
``ops/two_level.py``: the hand-written kernels on the intra axis, the rank
group's plain operations on the inter axis.

The reference runs Pallas kernels within a TPU slice (ICI) and
``jax.lax`` collectives across slices (DCN). On H100s the tiers are
NVLink within a host and the network between hosts: the intra axis rides
the port's kernels over the fiber's peer pointers (B4 ring AG, B6 ring
RS, B8 AllToAll), the inter axis the group's ``group_all_gather``,
``group_psum``, ``group_psum_scatter`` and ``group_all_to_all``
(``runtime/context.py``), where the reference calls ``jax.lax``.

Group convention: 2 axes ``(inter_axis, intra_axis)``, e.g.
``initialize_distributed(mesh_shape=(2, 4), axis_names=("dcn", "tp"))``;
a rank's global shard index is ``inter · n_intra + intra``.
"""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.ops.allgather import (
    AllGatherMethod, all_gather_local,
)
from triton_distributed_tpu_torch.ops.reduce_scatter import (
    reduce_scatter_local,
)
from triton_distributed_tpu_torch.runtime.context import (
    DistContext, get_context, group_all_gather, group_all_to_all,
    group_psum, group_psum_scatter,
)


def _need(n_intra, n_inter) -> None:
    if n_intra is None or n_inter is None:
        raise ValueError("n_intra/n_inter required inside the rank runner")


def all_gather_2d_local(x_local: torch.Tensor, *, intra_axis: str = "tp",
                        inter_axis: str = "dcn", n_intra: int | None = None,
                        n_inter: int | None = None) -> torch.Tensor:
    """Hierarchical AllGather: the intra kernel first, then the slice's
    gathered block across the inter tier once. x_local: (m, cols) →
    (n_inter·n_intra·m, cols), rows by global shard index."""
    _need(n_intra, n_inter)
    intra = all_gather_local(x_local, axis=intra_axis, num_ranks=n_intra)
    if n_inter == 1:
        return intra
    return group_all_gather(intra, axis=inter_axis, num_ranks=n_inter)


def reduce_scatter_2d_local(x_local: torch.Tensor, *, intra_axis: str = "tp",
                            inter_axis: str = "dcn",
                            n_intra: int | None = None,
                            n_inter: int | None = None) -> torch.Tensor:
    """Hierarchical ReduceScatter: the inter tier first (it carries
    1/n_inter of the bytes, once), then the intra ring. x_local: (N·m,
    cols), N = n_inter·n_intra → (m, cols), this rank's global chunk."""
    _need(n_intra, n_inter)
    if n_inter > 1:
        x_local = group_psum_scatter(x_local, axis=inter_axis,
                                     num_ranks=n_inter)
    if n_intra == 1:
        return x_local
    return reduce_scatter_local(x_local, axis=intra_axis, num_ranks=n_intra)


def all_reduce_2d_local(x_local: torch.Tensor, *, intra_axis: str = "tp",
                        inter_axis: str = "dcn", n_intra: int | None = None,
                        n_inter: int | None = None) -> torch.Tensor:
    """Hierarchical AllReduce: intra ring RS → the inter tier's sum on
    1/n_intra of the rows → intra ring AG (the two-tier two-shot). Rows
    that do not divide over the intra axis take the plain sums."""
    _need(n_intra, n_inter)
    m = x_local.shape[0]
    if n_intra == 1 or m % n_intra:
        summed = (x_local if n_intra == 1 else
                  group_psum(x_local, axis=intra_axis, num_ranks=n_intra))
        return (group_psum(summed, axis=inter_axis, num_ranks=n_inter)
                if n_inter > 1 else summed)
    scattered = reduce_scatter_local(x_local, axis=intra_axis,
                                     num_ranks=n_intra)
    if n_inter > 1:
        scattered = group_psum(scattered, axis=inter_axis, num_ranks=n_inter)
    return all_gather_local(scattered, axis=intra_axis, num_ranks=n_intra,
                            method=AllGatherMethod.RING_1D)


# ---------------------------------------------------------------------------
# Host-level forms: rank r takes global shard inter·n_intra + intra.
# ---------------------------------------------------------------------------

def _two_level(ctx: DistContext, local_fn, parts: list, intra_axis: str,
               inter_axis: str) -> list:
    n_intra = ctx.axis_size(intra_axis)
    n_inter = ctx.axis_size(inter_axis)
    axes = (inter_axis, intra_axis)
    if n_intra * n_inter != ctx.num_ranks or len(parts) != ctx.num_ranks:
        raise ValueError(f"{len(parts)} shards over axes {axes} of a group "
                         f"of {ctx.num_ranks} ranks")
    outs = ctx.run(lambda r: local_fn(
        parts[ctx.axis_index(r, axes)].to(ctx.devices[r]),
        intra_axis=intra_axis, inter_axis=inter_axis, n_intra=n_intra,
        n_inter=n_inter))
    ctx.raise_on_comm_error()
    return outs


def _split(x, n: int, stacked: bool) -> list:
    if isinstance(x, (list, tuple)):
        return list(x)
    return list(x.unbind(0)) if stacked else list(torch.chunk(x, n, dim=0))


def all_gather_2d(x, ctx: DistContext | None = None, intra_axis: str = "tp",
                  inter_axis: str = "dcn") -> list:
    """Host-level hierarchical AllGather: ``x`` (N·m, cols) sharded over
    both axes by global shard index (or the N shards) → every rank's
    gathered copy."""
    ctx = ctx or get_context()
    return _two_level(ctx, all_gather_2d_local,
                      _split(x, ctx.num_ranks, False), intra_axis, inter_axis)


def all_reduce_2d(x, ctx: DistContext | None = None, intra_axis: str = "tp",
                  inter_axis: str = "dcn") -> list:
    """Host-level hierarchical AllReduce: ``x`` (N, m, cols) stacked
    contributions by global shard index → every rank's (m, cols) sum."""
    ctx = ctx or get_context()
    return _two_level(ctx, all_reduce_2d_local,
                      _split(x, ctx.num_ranks, True), intra_axis, inter_axis)


def reduce_scatter_2d(x, ctx: DistContext | None = None,
                      intra_axis: str = "tp", inter_axis: str = "dcn"
                      ) -> list:
    """Host-level hierarchical ReduceScatter: ``x`` (N, N·m, cols) stacked
    contributions → every rank's (m, cols) chunk, by global shard
    index."""
    ctx = ctx or get_context()
    return _two_level(ctx, reduce_scatter_2d_local,
                      _split(x, ctx.num_ranks, True), intra_axis, inter_axis)


def fast_all_to_all_2d_local(send_buf: torch.Tensor,
                             send_splits: torch.Tensor, *,
                             intra_axis: str = "tp", inter_axis: str = "dcn",
                             n_intra: int | None = None,
                             n_inter: int | None = None):
    """Hierarchical EP AllToAll: one inter hop groups the token slots by
    destination slice, then the intra AllToAll kernel (B8) delivers each
    source slice's block. send_buf: (N, cap, hidden), slot g the tokens
    for global rank g's experts; send_splits: (N, epr). Returns
    (recv_buf (N, cap, hidden), recv_splits (N, epr) int32) by global
    SOURCE rank — ``ops/all_to_all.fast_all_to_all_local``'s contract."""
    _need(n_intra, n_inter)
    from triton_distributed_tpu_torch.ops.all_to_all import (
        fast_all_to_all_local,
    )

    N, cap, hidden = send_buf.shape
    epr = send_splits.shape[1]
    if N != n_inter * n_intra:
        raise ValueError(f"send_buf slots {N} != {n_inter}*{n_intra}")
    if n_inter == 1:
        return fast_all_to_all_local(send_buf, send_splits, axis=intra_axis,
                                     num_ranks=n_intra)
    # The inter hop: rank (a, i) sends its slice-b block to (b, i);
    # afterwards block [s] holds what (s, i) meant for this slice's ranks.
    buf = group_all_to_all(send_buf.reshape(n_inter, n_intra, cap, hidden),
                           axis=inter_axis, num_ranks=n_inter)
    spl = group_all_to_all(send_splits.reshape(n_inter, n_intra, epr),
                           axis=inter_axis, num_ranks=n_inter)
    rbs, rss = [], []
    for s in range(n_inter):
        rb, rs = fast_all_to_all_local(buf[s].contiguous(),
                                       spl[s].contiguous(), axis=intra_axis,
                                       num_ranks=n_intra)
        rbs.append(rb)
        rss.append(rs)
    return (torch.stack(rbs).reshape(N, cap, hidden),
            torch.stack(rss).reshape(N, epr))


def sp_ag_attention_2d_local(q: torch.Tensor, k_shard: torch.Tensor,
                             v_shard: torch.Tensor, *,
                             intra_axis: str = "tp", inter_axis: str = "dcn",
                             n_intra: int | None = None,
                             n_inter: int | None = None,
                             causal: bool = True,
                             tiles: tuple[int, int] | None = None
                             ) -> torch.Tensor:
    """Hierarchical SP attention: the pipelined form of
    ``ops/hierarchical.sp_ag_attention_2d_local`` (the slice's KV gathers
    through the intra kernel, then rotates over the inter tier, each
    slice merged as it lands). q/k_shard/v_shard: (B, S/N, h*, d) by
    global shard index; returns (B, S/N, hq, d)."""
    from triton_distributed_tpu_torch.ops.hierarchical import (
        sp_ag_attention_2d_local as pipelined,
    )

    return pipelined(q, k_shard, v_shard, intra_axis=intra_axis,
                     inter_axis=inter_axis, n_intra=n_intra,
                     n_inter=n_inter, causal=causal, tiles=tiles)
