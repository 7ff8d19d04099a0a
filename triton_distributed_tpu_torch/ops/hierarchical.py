"""Two-tier fused operations and the slice pipeline — counterpart of the
JAX package's ``ops/hierarchical.py``.

The intra tier runs the port's fused kernels within a slice (B9 AG+GEMM
with its gathered rows, B10 GEMM+RS, the SP attention's gather through
B4, K1's partials); the inter tier rotates each slice-aggregated block
around the inter ring through the group's ``group_ppermute``, where the
reference calls ``jax.lax.ppermute``, and the consumer takes each block
as it lands (B3 for a remote slice's rows). On one host's virtual ranks
the inter hop is a handover between rank threads, so the overlap the
reference gets from XLA's scheduler is not claimed here: the pipeline's
order and arithmetic are the reference's, hop by hop.

Group convention as ``ops/two_level.py``: axes ``(inter_axis,
intra_axis)``, global shard index ``g = inter · n_intra + intra``.
"""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.ops.allgather import all_gather_local
from triton_distributed_tpu_torch.ops.allgather_gemm import (
    AGGemmConfig, ag_gemm_local, resolve_gemm_cfg,
)
from triton_distributed_tpu_torch.ops.gemm_reduce_scatter import (
    GemmRSConfig, gemm_rs_local,
)
from triton_distributed_tpu_torch.runtime.context import (
    DistContext, axis_index, get_context, group_ppermute,
)


# ---------------------------------------------------------------------------
# The slice pipeline.
# ---------------------------------------------------------------------------

def _ring_perm(n: int) -> tuple:
    """The inter ring's right rotation: slice a → a + 1."""
    return tuple((i, (i + 1) % n) for i in range(n))


def dcn_slice_pipeline(block, state, consume, *, inter_axis: str,
                       n_inter: int, me_inter: int):
    """Rotate ``block`` around the inter ring, consuming each arrival:
    ``consume(state, src_slice, block) -> state`` once per REMOTE slice;
    after h hops the resident block came from slice ``(me_inter - h) mod
    n_inter``. The caller consumed its own slice's block before."""
    perm = _ring_perm(n_inter)
    for h in range(1, n_inter):
        block = group_ppermute(block, perm, axis=inter_axis,
                               num_ranks=n_inter)
        state = consume(state, (me_inter - h) % n_inter, block)
    return state


def dcn_ring_reduce(produce, *, inter_axis: str, n_inter: int,
                    me_inter: int):
    """Ring reduce-scatter over per-slice chunks: ``produce(c)`` is this
    rank's (already intra-reduced) partial of slice chunk c. Chunk c
    enters the ring at slice c + 1 and gains a partial a hop, in the
    payload type; returns chunk ``me_inter`` summed in the order (me+1,
    me+2, ..., me)."""
    perm = _ring_perm(n_inter)
    acc = produce((me_inter - 1) % n_inter)
    for s in range(n_inter - 1):
        sent = group_ppermute(acc, perm, axis=inter_axis, num_ranks=n_inter)
        acc = sent + produce((me_inter - 2 - s) % n_inter)
    return acc


def slice_consumer_tiles(m_slice: int, k: int, ncols: int, dtype,
                         cfg: AGGemmConfig) -> tuple[int, int, int]:
    """(tm, tn, tk) caps of the consumer GEMM a remote slice's block
    runs (kernel B3). The reference derives the tiles from the TPU's
    tiling rule (``gemm_tiles``); B3 picks its own compiled tile under
    caps, so the caps are the config's."""
    del m_slice, k, ncols, dtype
    return cfg.tile_m, cfg.tile_n, cfg.tile_k


def _slice_gemm(block, b_local, tiles):
    from triton_distributed_tpu_torch.ops.gemm import pallas_matmul

    tm, tn, tk = tiles
    return pallas_matmul(block, b_local, tile_m=tm, tile_n=tn, tile_k=tk)


def _need(n_intra, n_inter) -> None:
    if n_intra is None or n_inter is None:
        raise ValueError("n_intra/n_inter required inside the rank runner")


# ---------------------------------------------------------------------------
# ag_gemm_2d / gemm_rs_2d.
# ---------------------------------------------------------------------------

def ag_gemm_2d_local(x_local: torch.Tensor, b_local: torch.Tensor, *,
                     intra_axis: str = "tp", inter_axis: str = "dcn",
                     n_intra: int | None = None, n_inter: int | None = None,
                     cfg: AGGemmConfig = AGGemmConfig()) -> torch.Tensor:
    """Rank-local two-tier AG+GEMM. x_local: (m, k), global row block
    ``g``; b_local: (k, ncols). Returns (N·m, ncols), N = n_inter·n_intra:
    every row for this rank's output columns. The own slice's rows come
    from B9 (``ag_gemm_local(return_gathered=True)``), which also hands
    back the slice's gathered A; that block rotates over the inter tier
    and each remote slice's rows are B3's product of the landed block."""
    _need(n_intra, n_inter)
    m, k = x_local.shape
    ncols = b_local.shape[1]
    if n_inter == 1:
        return ag_gemm_local(x_local, b_local, axis=intra_axis,
                             num_ranks=n_intra, cfg=cfg)
    me_inter = axis_index(inter_axis)
    own, block = ag_gemm_local(x_local, b_local, axis=intra_axis,
                               num_ranks=n_intra, cfg=cfg,
                               return_gathered=True)
    tiles = slice_consumer_tiles(n_intra * m, k, ncols, x_local.dtype, cfg)
    slice_rows = n_intra * m
    out = torch.empty((n_inter * slice_rows, ncols), dtype=own.dtype,
                      device=own.device)
    out[me_inter * slice_rows:(me_inter + 1) * slice_rows] = own

    def consume(out, src, blk):
        out[src * slice_rows:(src + 1) * slice_rows] = _slice_gemm(
            blk, b_local, tiles)
        return out

    return dcn_slice_pipeline(block, out, consume, inter_axis=inter_axis,
                              n_inter=n_inter, me_inter=me_inter)


def gemm_rs_2d_local(x_local: torch.Tensor, b_local: torch.Tensor, *,
                     intra_axis: str = "tp", inter_axis: str = "dcn",
                     n_intra: int | None = None, n_inter: int | None = None,
                     cfg: GemmRSConfig = GemmRSConfig()) -> torch.Tensor:
    """Rank-local two-tier GEMM+RS. x_local: (m_total, k_local)
    activations of this rank's k shard; b_local: (k_local, ncols).
    Returns (m_total/N, ncols): this rank's global row chunk, summed. Per
    slice-sized row chunk B10 computes the partial and reduce-scatters it
    in the slice; the finished chunk then rides the inter ring
    (:func:`dcn_ring_reduce`), gaining a slice's partial a hop."""
    _need(n_intra, n_inter)
    m_total = x_local.shape[0]
    N = n_inter * n_intra
    if m_total % N:
        raise ValueError(f"rows {m_total} not divisible by world {N}")
    if n_inter == 1:
        return gemm_rs_local(x_local, b_local, axis=intra_axis,
                             num_ranks=n_intra, cfg=cfg)
    slice_rows = n_intra * (m_total // N)
    me_inter = axis_index(inter_axis)

    def produce(c):
        rows = x_local[c * slice_rows:(c + 1) * slice_rows]
        return gemm_rs_local(rows, b_local, axis=intra_axis,
                             num_ranks=n_intra, cfg=cfg)

    return dcn_ring_reduce(produce, inter_axis=inter_axis, n_inter=n_inter,
                           me_inter=me_inter)


def _joint_parts(ctx: DistContext, x, axes, dim: int) -> list:
    n = ctx.axis_size(axes)
    parts = (list(x) if isinstance(x, (list, tuple))
             else list(torch.chunk(x, n, dim=dim)))
    if len(parts) != n or n != ctx.num_ranks:
        raise ValueError(f"{len(parts)} shards over axes {axes} of a group "
                         f"of {ctx.num_ranks} ranks")
    return parts


def ag_gemm_2d(a, b, ctx: DistContext | None = None, intra_axis: str = "tp",
               inter_axis: str = "dcn", cfg: AGGemmConfig | None = None
               ) -> list:
    """Host-level two-tier AG+GEMM. ``a``: (N·m, k), row-sharded over
    both axes by global shard index; ``b``: (k, n_intra·ncols),
    column-sharded over the intra axis only (replicated across slices).
    Returns every rank's (N·m, ncols) — its intra rank's columns."""
    ctx = ctx or get_context()
    n_intra, n_inter = ctx.axis_size(intra_axis), ctx.axis_size(inter_axis)
    axes = (inter_axis, intra_axis)
    xs = _joint_parts(ctx, a, axes, 0)
    bs = (list(b) if isinstance(b, (list, tuple))
          else list(torch.chunk(b, n_intra, dim=1)))
    cfg = resolve_gemm_cfg(cfg, AGGemmConfig, xs[0].shape[0], xs[0].shape[1],
                           bs[0].shape[1], xs[0].dtype, xs[0].device)

    def body(r):
        dev = ctx.devices[r]
        return ag_gemm_2d_local(
            xs[ctx.axis_index(r, axes)].to(dev).contiguous(),
            bs[ctx.axis_index(r, intra_axis)].to(dev).contiguous(),
            intra_axis=intra_axis, inter_axis=inter_axis, n_intra=n_intra,
            n_inter=n_inter, cfg=cfg)

    outs = ctx.run(body)
    ctx.raise_on_comm_error()
    return outs


def gemm_rs_2d(a, b, ctx: DistContext | None = None, intra_axis: str = "tp",
               inter_axis: str = "dcn", cfg: GemmRSConfig | None = None
               ) -> list:
    """Host-level two-tier GEMM+RS. ``a``: (m, N·k), column(k)-sharded
    over both axes; ``b``: (N·k, ncols), row-sharded over both. Returns
    every rank's (m/N, ncols) row chunk of the sum, by global shard
    index."""
    ctx = ctx or get_context()
    n_intra, n_inter = ctx.axis_size(intra_axis), ctx.axis_size(inter_axis)
    axes = (inter_axis, intra_axis)
    xs = _joint_parts(ctx, a, axes, 1)
    bs = _joint_parts(ctx, b, axes, 0)
    N = n_intra * n_inter
    cfg = resolve_gemm_cfg(cfg, GemmRSConfig, xs[0].shape[0] // N,
                           xs[0].shape[1], bs[0].shape[1], xs[0].dtype,
                           xs[0].device)

    def body(r):
        dev = ctx.devices[r]
        g = ctx.axis_index(r, axes)
        return gemm_rs_2d_local(
            xs[g].to(dev).contiguous(), bs[g].to(dev).contiguous(),
            intra_axis=intra_axis, inter_axis=inter_axis, n_intra=n_intra,
            n_inter=n_inter, cfg=cfg)

    outs = ctx.run(body)
    ctx.raise_on_comm_error()
    return outs


# ---------------------------------------------------------------------------
# sp_ag_attention_2d — the pipelined two-tier SP attention.
# ---------------------------------------------------------------------------

def sp_ag_attention_2d_local(q: torch.Tensor, k_shard: torch.Tensor,
                             v_shard: torch.Tensor, *,
                             intra_axis: str = "tp", inter_axis: str = "dcn",
                             n_intra: int | None = None,
                             n_inter: int | None = None,
                             causal: bool = True,
                             tiles: tuple[int, int] | None = None
                             ) -> torch.Tensor:
    """Rank-local two-tier SP attention: the slice's KV shards gather
    through the intra AllGather kernel, then the slice block rotates over
    the inter tier, each arriving slice's chunks merged into the flash
    state (K1's partials, the online-LSE merge). q/k_shard/v_shard: (B,
    S/N, h*, d) sequence shards by global index; returns (B, S/N, hq, d).
    ``tiles``: the reference's flash tile caps; K1 picks its own."""
    _need(n_intra, n_inter)
    from triton_distributed_tpu_torch.ops.flash_attention import (
        _merge, shard_attention_partial,
    )

    del tiles
    b, sq, hq, d = q.shape
    sk, hkv = k_shard.shape[1], k_shard.shape[2]
    me_intra = axis_index(intra_axis)
    me_inter = axis_index(inter_axis)
    g = me_inter * n_intra + me_intra
    q_off = g * sq
    flat = torch.cat([k_shard.reshape(b * sk, hkv * d),
                      v_shard.reshape(b * sk, hkv * d)], dim=1)
    slice_kv = all_gather_local(flat, axis=intra_axis, num_ranks=n_intra)
    # The diagonal chunk first (local).
    state = shard_attention_partial(q, k_shard, v_shard, q_offset=q_off,
                                    k_offset=g * sk, causal=causal)

    def merge_slice(state, src_slice, block):
        kv = block.reshape(n_intra, b, sk, 2, hkv, d)
        for j in range(n_intra):
            r = src_slice * n_intra + j
            acc, m, l = shard_attention_partial(
                q, kv[j, :, :, 0].contiguous(), kv[j, :, :, 1].contiguous(),
                q_offset=q_off, k_offset=r * sk, causal=causal)
            keep = float(r != g)            # the diagonal is merged above
            state = _merge(state, (acc * keep, m, l * keep))
        return state

    state = merge_slice(state, me_inter, slice_kv)
    if n_inter > 1:
        state = dcn_slice_pipeline(slice_kv, state, merge_slice,
                                   inter_axis=inter_axis, n_inter=n_inter,
                                   me_inter=me_inter)
    acc, _, l = state
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def sp_ag_attention_2d(q, k, v, ctx: DistContext | None = None,
                       intra_axis: str = "tp", inter_axis: str = "dcn",
                       causal: bool = True) -> list:
    """Host-level two-tier SP attention: q/k/v (B, S, h*, d) sharded on
    dim 1 over both axes by global shard index. Returns every rank's (B,
    S/N, hq, d) output shard."""
    ctx = ctx or get_context()
    n_intra, n_inter = ctx.axis_size(intra_axis), ctx.axis_size(inter_axis)
    axes = (inter_axis, intra_axis)
    qs, ks, vs = (_joint_parts(ctx, t, axes, 1) for t in (q, k, v))

    def body(r):
        dev = ctx.devices[r]
        g = ctx.axis_index(r, axes)
        return sp_ag_attention_2d_local(
            qs[g].to(dev).contiguous(), ks[g].to(dev).contiguous(),
            vs[g].to(dev).contiguous(), intra_axis=intra_axis,
            inter_axis=inter_axis, n_intra=n_intra, n_inter=n_inter,
            causal=causal)

    outs = ctx.run(body)
    ctx.raise_on_comm_error()
    return outs
