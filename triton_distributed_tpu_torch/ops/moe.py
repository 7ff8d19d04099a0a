"""MoE expert MLP over a tensor-parallel group — counterpart of the JAX
package's ``ops/moe.py`` (the TP-MoE forms the dense model runs, and the
grouped products the expert-parallel layer shares).

Routing, the expert sort and the grouped products are plain tensor code
(XLA ops in the JAX package):

- ``route_and_sort``: fp32 router logits, top-k (ties to the lower expert
  index, as ``jax.lax.top_k``), softmax over the selected logits, then a
  stable sort of the flat assignments by expert;
- ``ragged_dot_dtype_aware``: the grouped product as one ``torch.matmul``
  per non-empty expert group of the expert-sorted rows. The group sizes
  cross to the host once per grouped product set (``moe_tp_fwd_local``
  reads them and passes the list down; the ring forms once per token
  chunk), so the eager lane pays a host sync per MoE layer and chunk. A
  hand-written grouped GEMM is later work;
- the combine (:func:`segment_sum_rows`): each token's ``topk`` weighted
  rows added one at a time in expert-sorted order, each add rounded to
  the working type, as ``jax.ops.segment_sum`` adds them (so bf16 matches
  the reference's rounding; ``index_add_`` on the card would add them
  with atomics in a run-dependent order).

On a TP group (``num_ranks`` > 1, inside ``DistContext.run``; expert ffn
weights sharded per ``models/dense.dense_llm_specs``) the modes are the
reference's:

- ``"ring"`` (the default; the dense model's ``"overlap"`` prefill):
  :func:`moe_ring_fwd_local` — each rank's token chunk rotates over the
  ring (``group_ppermute``) while every hop runs the whole per-chunk
  expert MLP, then the ring reduce-scatter (kernel B6);
- ``"overlap"``: the tokens gathered by ``all_gather_local`` AUTO (at
  n <= 2 kernel B4's full-mesh push), the grouped MLP, and the
  overlapped tail :func:`moe_reduce_rs_overlap_local` (the RS accumulator
  rotating while later chunks' down projections run);
- ``"xla"``: the plain gather and ``psum_scatter`` through the group;
- ``"ar"`` / ``"xla_rep"`` (decode, replicated rows): the combine summed
  by ``ar_fn`` (the decode loop's parity AllReduce, B5) or
  ``all_reduce_local``, or by the plain ``psum``.

e4m3 expert stacks (the fp8 weight lane) run each group's product on
kernel B3's e4m3 lane (:func:`ragged_dot_dtype_aware`).
"""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.layers.common import swiglu
from triton_distributed_tpu_torch.models.fp8 import E4M3, to_e4m3
from triton_distributed_tpu_torch.ops.allgather import (
    AllGatherMethod, all_gather_local,
)
from triton_distributed_tpu_torch.ops.gemm import pallas_matmul
from triton_distributed_tpu_torch.ops.reduce_scatter import (
    reduce_scatter_local,
)
from triton_distributed_tpu_torch.runtime.context import (
    current_rank, group_all_gather, group_ppermute, group_psum,
    group_psum_scatter,
)


def sort_by_expert(expert_ids: torch.Tensor, num_experts: int):
    """Stable sort of flat expert assignments. Returns (sort_idx (T,)
    int64, group_sizes (E,) int32)."""
    ids = expert_ids.reshape(-1).long()
    sort_idx = torch.argsort(ids, stable=True)
    group_sizes = torch.bincount(ids, minlength=num_experts).to(torch.int32)
    return sort_idx, group_sizes


def _host_sizes(group_sizes) -> list[int]:
    if isinstance(group_sizes, torch.Tensor):
        return [int(n) for n in group_sizes.tolist()]      # host sync
    return [int(n) for n in group_sizes]


def ragged_dot_dtype_aware(x: torch.Tensor, w: torch.Tensor,
                           group_sizes) -> torch.Tensor:
    """Grouped product over expert-sorted rows: rows of group g (the
    ``group_sizes[g]`` rows after the earlier groups) times ``w[g]``.
    x: (T, k); w: (E, k, n); ``group_sizes``: a tensor, or the host list
    of the sizes (no sync). Empty groups are skipped. Returns (T, n) in
    the activations' type (fp32 for e4m3 activations).

    e4m3 expert stacks (``quantize_dense_weights``) run the pure fp8
    product, as ``fp8_dot``: the activation quantized through ``to_e4m3``,
    then e4m3 x e4m3 into fp32 — one B3 launch per non-empty group on the
    card. The mixed bf16 x e4m3 form is never run."""
    sizes = _host_sizes(group_sizes)
    fp8 = w.dtype == E4M3
    out_dt = torch.float32 if x.dtype == E4M3 else x.dtype
    xq = to_e4m3(x) if fp8 else x
    out = x.new_empty((x.shape[0], w.shape[-1]), dtype=out_dt)
    start = 0
    for g, n in enumerate(sizes):
        if n:
            rows = xq[start:start + n]
            out[start:start + n] = (
                pallas_matmul(rows, w[g], out_dtype=torch.float32)
                if fp8 else rows @ w[g])
        start += n
    return out


def grouped_mlp_gate_up(x_sorted: torch.Tensor, group_sizes,
                        w_gate: torch.Tensor, w_up: torch.Tensor
                        ) -> torch.Tensor:
    """silu(x @ w_gate[g]) * (x @ w_up[g]) per group, in x's type."""
    gate = ragged_dot_dtype_aware(x_sorted, w_gate, group_sizes)
    up = ragged_dot_dtype_aware(x_sorted, w_up, group_sizes)
    return swiglu(gate, up).to(x_sorted.dtype)


def grouped_mlp(x_sorted: torch.Tensor, group_sizes, w_gate: torch.Tensor,
                w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU expert MLP over expert-sorted tokens. x_sorted: (T, h);
    w_gate/w_up: (E, h, ffn); w_down: (E, ffn, h). Returns (T, h)."""
    act = grouped_mlp_gate_up(x_sorted, group_sizes, w_gate, w_up)
    return ragged_dot_dtype_aware(act, w_down, group_sizes)


def segment_sum_rows(data: torch.Tensor, seg: torch.Tensor,
                     num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum(data, seg, num_segments)`` where every
    segment has the same number of rows (a token's top-k copies): each
    segment's rows added one at a time in the order they appear, each add
    rounded to ``data``'s type, as the reference's scatter-add adds
    them."""
    k = data.shape[0] // num_segments
    idx = torch.argsort(seg, stable=True).reshape(num_segments, k)
    rows = data[idx]
    acc = rows[:, 0]
    for j in range(1, k):
        acc = acc + rows[:, j]
    return acc


def _tp(num_ranks: int | None, axis: str) -> tuple[int, int]:
    """(n, the calling rank thread's index along ``axis``); (1, 0) at one
    rank. The reference's rank-local functions take no default group
    size, so ``None`` raises its error (a call that omitted it inside a
    rank group would compute one rank's slice and return it
    unreduced)."""
    if num_ranks is None:
        raise ValueError("num_ranks required inside shard_map")
    n = num_ranks
    if n == 1:
        return 1, 0
    ctx, rank = current_rank()
    if ctx.axis_size(axis) != n:
        raise ValueError(f"num_ranks = {n} but the rank group has "
                         f"{ctx.axis_size(axis)} — argument num_ranks")
    return n, ctx.axis_index(rank, axis)


def ag_group_gemm_local(x_local: torch.Tensor, expert_ids: torch.Tensor,
                        w_experts: torch.Tensor,
                        topk_weights: torch.Tensor | None = None, *,
                        axis: str = "tp", num_ranks: int | None = None,
                        method: AllGatherMethod | str = AllGatherMethod.AUTO):
    """Rank-local AG + grouped GEMM (reference ``ag_group_gemm``).
    x_local: (M/n, h) row-sharded tokens; expert_ids: (M·topk,) replicated
    flat assignment (token t's k-th expert at t·topk + k); w_experts: (E,
    h, ffn_local). Returns (y_sorted (M·topk, ffn_local) in expert-sorted
    order, sort_idx, group_sizes)."""
    n, _ = _tp(num_ranks, axis)
    x_full = (x_local if n == 1 else
              all_gather_local(x_local, axis=axis, num_ranks=n,
                               method=method))
    topk = expert_ids.shape[0] // x_full.shape[0]
    sort_idx, group_sizes = sort_by_expert(expert_ids, w_experts.shape[0])
    y = ragged_dot_dtype_aware(x_full[sort_idx // topk], w_experts,
                               group_sizes)
    if topk_weights is not None:
        y = y * topk_weights.reshape(-1)[sort_idx][:, None]
    return y.to(x_local.dtype), sort_idx, group_sizes


def ag_group_gemm_ring_local(x_local: torch.Tensor, expert_ids: torch.Tensor,
                             w_experts: torch.Tensor,
                             topk_weights: torch.Tensor | None = None, *,
                             axis: str = "tp",
                             num_ranks: int | None = None):
    """AG + grouped GEMM with per-source readiness: each source's token
    chunk runs its grouped GEMM as it arrives on the ring. The contract
    of :func:`ag_group_gemm_local` (global expert-sorted order)."""
    n, me = _tp(num_ranks, axis)
    E = w_experts.shape[0]
    if n == 1:
        return ag_group_gemm_local(x_local, expert_ids, w_experts,
                                   topk_weights, num_ranks=1)
    mc = x_local.shape[0]
    topk = expert_ids.shape[0] // (mc * n)
    ffn = w_experts.shape[2]
    w_flat = None if topk_weights is None else topk_weights.reshape(-1)

    def chunk_gemm(src, xc):
        f0 = src * mc * topk
        sidx_c, gsz_c = sort_by_expert(expert_ids[f0:f0 + mc * topk], E)
        y = ragged_dot_dtype_aware(xc[sidx_c // topk], w_experts, gsz_c)
        if w_flat is not None:
            y = y * w_flat[f0:f0 + mc * topk][sidx_c][:, None]
        out = y.new_zeros((mc * topk, ffn))
        out[sidx_c] = y
        return out.to(x_local.dtype)

    out = x_local.new_zeros((n, mc * topk, ffn))
    perm = [(i, (i + 1) % n) for i in range(n)]
    xc = group_ppermute(x_local, perm, axis=axis, num_ranks=n)
    out[me] = chunk_gemm(me, x_local)
    for i in range(1, n - 1):
        xc_next = group_ppermute(xc, perm, axis=axis, num_ranks=n)
        out[(me - i) % n] = chunk_gemm((me - i) % n, xc)
        xc = xc_next
    out[(me - (n - 1)) % n] = chunk_gemm((me - (n - 1)) % n, xc)
    sort_idx, group_sizes = sort_by_expert(expert_ids, E)
    return out.reshape(n * mc * topk, ffn)[sort_idx], sort_idx, group_sizes


def moe_reduce_rs_local(y_sorted: torch.Tensor, sort_idx: torch.Tensor,
                        group_sizes, w_down: torch.Tensor,
                        topk_weights: torch.Tensor, num_tokens: int, *,
                        axis: str = "tp", num_ranks: int | None = None,
                        mode: str = "overlap", ar_fn=None) -> torch.Tensor:
    """Down projection + top-k weighted combine + the mode's reduction
    (reference ``run_moe_reduce_rs``). y_sorted: (M·topk, ffn_local)
    expert-sorted activations; topk_weights: (M, topk). Returns (M/n, h)
    row-sharded (``"overlap"``: the ring RS; ``"xla"``: the plain
    ``psum_scatter``) or (M, h) replicated (``"ar"``: ``ar_fn`` or
    ``all_reduce_local``; ``"xla_rep"``: the plain ``psum``); at n = 1
    the combine, in y's type."""
    n, _ = _tp(num_ranks, axis)
    topk = sort_idx.shape[0] // num_tokens
    partial = ragged_dot_dtype_aware(y_sorted, w_down, group_sizes)
    partial = partial * topk_weights.reshape(-1)[sort_idx][:, None]
    combined = segment_sum_rows(partial, sort_idx // topk,
                                num_tokens).to(y_sorted.dtype)
    if n == 1:
        return combined
    if mode == "overlap":
        return reduce_scatter_local(combined, axis=axis, num_ranks=n)
    if mode == "xla":
        return group_psum_scatter(combined, axis=axis, num_ranks=n)
    if mode == "ar":
        if ar_fn is not None:
            return ar_fn(combined)
        from triton_distributed_tpu_torch.ops.allreduce import (
            all_reduce_local,
        )

        return all_reduce_local(combined, axis=axis, num_ranks=n)
    if mode == "xla_rep":
        return group_psum(combined, axis=axis, num_ranks=n)
    raise ValueError(f"unknown MoE mode {mode!r}")


def moe_reduce_rs_overlap_local(act_sorted: torch.Tensor,
                                sort_idx: torch.Tensor, group_sizes,
                                w_down: torch.Tensor,
                                topk_weights: torch.Tensor, num_tokens: int,
                                *, axis: str = "tp",
                                num_ranks: int | None = None
                                ) -> torch.Tensor:
    """The overlapped MoE tail: the M rows split into n ring chunks; at
    step s a rank computes the down projection + combine of chunk
    (me-2-s) while the running reduce-scatter accumulator of the previous
    chunk travels (``group_ppermute``); after n-1 hops it holds its own
    chunk, fully reduced. Returns (M/n, h), the ``"overlap"`` layout of
    :func:`moe_reduce_rs_local` (which it falls back to when the rows do
    not divide)."""
    n, me = _tp(num_ranks, axis)
    M = num_tokens
    if n == 1 or M % n:
        return moe_reduce_rs_local(act_sorted, sort_idx, group_sizes, w_down,
                                   topk_weights, M, axis=axis, num_ranks=n,
                                   mode="overlap" if n > 1 else "ar")
    topk = sort_idx.shape[0] // M
    E = w_down.shape[0]
    mc = M // n
    dev = act_sorted.device
    inv = torch.argsort(sort_idx)
    sizes = (group_sizes if isinstance(group_sizes, torch.Tensor)
             else torch.tensor(group_sizes, dtype=torch.int32))
    csum = torch.cumsum(sizes.to(dev).long(), 0)
    w_flat = topk_weights.reshape(-1)

    def chunk_partial(c):
        fr = c * mc * topk + torch.arange(mc * topk, device=dev)
        pos = inv[fr]
        e_c = torch.searchsorted(csum, pos, right=True)
        sidx_c, gsz_c = sort_by_expert(e_c, E)
        part = ragged_dot_dtype_aware(act_sorted[pos[sidx_c]], w_down, gsz_c)
        part = part * w_flat[fr][sidx_c][:, None]
        tloc = (fr // topk - c * mc)[sidx_c]
        return segment_sum_rows(part, tloc, mc).to(act_sorted.dtype)

    perm = [(i, (i + 1) % n) for i in range(n)]
    carry = chunk_partial((me - 1) % n)
    for s in range(n - 1):
        sent = group_ppermute(carry, perm, axis=axis, num_ranks=n)
        carry = sent + chunk_partial((me - 2 - s) % n)
    return carry


def route_and_sort(x: torch.Tensor, gate_w: torch.Tensor, topk: int):
    """The routing convention: fp32 router logits → top-k (ties to the
    lower expert index) → softmax over the selected logits →
    expert-stable sort. Returns (x_sorted, sort_idx, group_sizes,
    token_of_flat, topk_weights (M, topk) fp32)."""
    num_experts = gate_w.shape[1]
    logits = x.float() @ gate_w.float()
    order = torch.sort(logits, dim=-1, descending=True, stable=True)
    topk_logits = order.values[:, :topk]
    topk_ids = order.indices[:, :topk]
    topk_weights = torch.softmax(topk_logits, dim=-1)
    sort_idx, group_sizes = sort_by_expert(topk_ids, num_experts)
    token_of_flat = sort_idx // topk
    return (x[token_of_flat], sort_idx, group_sizes, token_of_flat,
            topk_weights)


def _chunk_moe(xc: torch.Tensor, gate_w: torch.Tensor, w_gate: torch.Tensor,
               w_up: torch.Tensor, w_down: torch.Tensor, topk: int
               ) -> torch.Tensor:
    """The whole expert-MLP partial of one token chunk (mc, h): router →
    top-k → sort → gate/up → SwiGLU → down → weighted combine. The top-k
    weights stay fp32 here, as the reference's: the weighted rows and
    their sum are fp32, cast to the chunk's type once."""
    x_sorted, sort_idx, group_sizes, token_of_flat, topk_weights = \
        route_and_sort(xc, gate_w, topk)
    sizes = _host_sizes(group_sizes)
    act = grouped_mlp_gate_up(x_sorted, sizes, w_gate, w_up)
    part = ragged_dot_dtype_aware(act, w_down, sizes)
    part = part * topk_weights.reshape(-1)[sort_idx][:, None]
    return segment_sum_rows(part, token_of_flat,
                            xc.shape[0]).to(xc.dtype)


def moe_ring_fwd_local(x_local: torch.Tensor, gate_w: torch.Tensor,
                       w_gate: torch.Tensor, w_up: torch.Tensor,
                       w_down: torch.Tensor, topk: int, *, axis: str = "tp",
                       num_ranks: int, combine: str = "overlap"
                       ) -> torch.Tensor:
    """Ring-pipelined TP-MoE: hop i computes the whole MoE partial of the
    chunk that just arrived while ``group_ppermute`` passes the buffer
    on; exactly n-1 rotations. The (M, h) partials then reduce-scatter —
    the ring RS kernel (``combine="overlap"``) or the plain
    ``psum_scatter``. Returns (M/n, h) row-sharded."""
    n, me = _tp(num_ranks, axis)
    mc, h = x_local.shape
    out = x_local.new_zeros((n, mc, h))
    perm = [(i, (i + 1) % n) for i in range(n)]

    def compute(src, xc):
        out[src] = _chunk_moe(xc, gate_w, w_gate, w_up, w_down, topk)

    xc = group_ppermute(x_local, perm, axis=axis, num_ranks=n)
    compute(me, x_local)
    for i in range(1, n - 1):
        xc_next = group_ppermute(xc, perm, axis=axis, num_ranks=n)
        compute((me - i) % n, xc)
        xc = xc_next
    compute((me - (n - 1)) % n, xc)
    combined = out.reshape(n * mc, h)
    if combine == "overlap":
        return reduce_scatter_local(combined, axis=axis, num_ranks=n)
    return group_psum_scatter(combined, axis=axis, num_ranks=n)


def moe_tp_fwd_local(x_local: torch.Tensor, gate_w: torch.Tensor,
                     w_gate: torch.Tensor, w_up: torch.Tensor,
                     w_down: torch.Tensor, topk: int, *, axis: str = "tp",
                     num_ranks: int | None = None, mode: str = "ring",
                     ar_fn=None
                     ) -> torch.Tensor:
    """The TP-MoE forward (reference ``moe_tp_fwd_local``): router →
    gate/up grouped products → SwiGLU → down → combine → the mode's
    reduction. x_local: (M/n, h) row-sharded (``"ring"``, ``"overlap"``,
    ``"xla"``) or (M, h) replicated (``"ar"``, ``"xla_rep"``); gate_w:
    (h, E) replicated; w_gate/w_up: (E, h, ffn_local); w_down: (E,
    ffn_local, h). Returns the layout it was given; at n = 1 every mode
    is the one-rank MLP (the group sizes cross to the host once)."""
    n, _ = _tp(num_ranks, axis)
    if mode == "ring" and n > 1:
        return moe_ring_fwd_local(x_local, gate_w, w_gate, w_up, w_down,
                                  topk, axis=axis, num_ranks=n)
    if n == 1 or mode in ("ar", "xla_rep"):
        x_full = x_local
    elif mode == "overlap":
        x_full = all_gather_local(x_local, axis=axis, num_ranks=n)
    elif mode == "xla":
        x_full = group_all_gather(x_local, axis=axis, num_ranks=n)
    else:
        raise ValueError(f"unknown MoE mode {mode!r}")
    M = x_full.shape[0]
    x_sorted, sort_idx, group_sizes, _, topk_weights = route_and_sort(
        x_full, gate_w, topk)
    sizes = _host_sizes(group_sizes)
    act = grouped_mlp_gate_up(x_sorted, sizes, w_gate, w_up)
    weights = topk_weights.to(x_local.dtype)
    if mode == "overlap" and n > 1 and M % n == 0:
        return moe_reduce_rs_overlap_local(act, sort_idx, sizes, w_down,
                                           weights, M, axis=axis,
                                           num_ranks=n)
    return moe_reduce_rs_local(act, sort_idx, sizes, w_down, weights, M,
                               axis=axis, num_ranks=n,
                               mode="overlap" if mode == "ring" else mode,
                               ar_fn=ar_fn)


def moe_tp_fwd(x: torch.Tensor, gate_w: torch.Tensor, w_gate: torch.Tensor,
               w_up: torch.Tensor, w_down: torch.Tensor, topk: int,
               ctx=None, axis: str = "tp", mode: str = "ring") -> list:
    """Host-level TP-MoE forward: x (M, h) row-sharded over the group's
    ranks (every rank gets all M rows in the replicated modes ``"ar"`` and
    ``"xla_rep"``); the router replicated; the expert weights sharded on
    the ffn dim (w_gate/w_up dim 2, w_down dim 1). Returns the n ranks'
    outputs, rank r's on ``ctx.devices[r]``."""
    from triton_distributed_tpu_torch.runtime.context import get_context

    ctx = ctx or get_context()
    n = ctx.axis_size(axis)
    f = w_gate.shape[2] // n
    rows = x.shape[0] // n
    replicated = mode in ("ar", "xla_rep")

    def one(r):
        d = ctx.devices[r]
        xr = x if replicated else x[r * rows:(r + 1) * rows]
        return moe_tp_fwd_local(
            xr.to(d), gate_w.to(d), w_gate[:, :, r * f:(r + 1) * f].to(d),
            w_up[:, :, r * f:(r + 1) * f].to(d),
            w_down[:, r * f:(r + 1) * f].to(d), topk, axis=axis,
            num_ranks=n, mode=mode)

    outs = ctx.run(one)
    ctx.raise_on_comm_error()
    return outs
