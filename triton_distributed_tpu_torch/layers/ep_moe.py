"""Expert-parallel MoE layer — counterpart of the JAX package's
``layers/ep_moe.py``: AllToAll dispatch → local experts → combine.

EP sharding: each rank owns ``num_experts / n`` experts at full ffn width
(:func:`ep_moe_specs`; the TP-MoE of ``ops/moe.py`` gives every rank an
ffn slice of every expert instead). Tokens travel to their experts' ranks
over kernel B8 (``ops/all_to_all``) and come back the same way; the
return trip reuses the forward slot layout, so no second sort is needed.
The parameters (``init_ep_moe``) also feed the TP form the dense model
runs.

The combine is the reference's ``reshape(m, topk, h).sum(axis=1)`` (an
XLA reduce there, a torch sum here — fp32 bit for bit at top-2, bf16
within a rounding).
"""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.ops.all_to_all import (
    combine_layout, dispatch_layout, fast_all_to_all_local,
    fast_all_to_all_stream,
)
from triton_distributed_tpu_torch.ops.moe import (
    _host_sizes, ragged_dot_dtype_aware, sort_by_expert,
)
from triton_distributed_tpu_torch.layers.common import swiglu
from triton_distributed_tpu_torch.runtime.context import P
from triton_distributed_tpu_torch.runtime.device import resolve_device


def init_ep_moe(hidden: int, ffn: int, num_experts: int, dtype, *,
                generator: torch.Generator, device=None) -> dict:
    """Router (hidden, E) and stacked expert weights w_gate/w_up
    (E, hidden, ffn), w_down (E, ffn, hidden), with the JAX package's
    scales, drawn from ``generator`` (which must live on ``device``;
    None: the card)."""
    device = resolve_device(device)

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=device) * scale

    return {
        "router": normal((hidden, num_experts), hidden ** -0.5),
        "w_gate": normal((num_experts, hidden, ffn), hidden ** -0.5),
        "w_up": normal((num_experts, hidden, ffn), hidden ** -0.5),
        "w_down": normal((num_experts, ffn, hidden), ffn ** -0.5),
    }


def ep_moe_specs(axis: str = "tp") -> dict:
    """Experts sharded over dim 0, the router replicated."""
    return {"router": P(), "w_gate": P(axis), "w_up": P(axis),
            "w_down": P(axis)}


def router_topk(x: torch.Tensor, router_w: torch.Tensor, topk: int):
    """fp32 router: (top-k ids (m, k) int32 — ties to the lower expert,
    as ``jax.lax.top_k`` —, weights (m, k) fp32 softmaxed over the
    selected experts)."""
    logits = x.float() @ router_w.float()
    order = torch.sort(logits, dim=-1, descending=True, stable=True)
    weights = torch.softmax(order.values[:, :topk], dim=-1)
    return order.indices[:, :topk].to(torch.int32), weights


def ep_moe_fwd(params: dict, x: torch.Tensor, topk: int, *,
               axis: str = "tp", num_ranks: int = 1,
               capacity: int | None = None, a2a_state=None,
               return_overflow: bool = False):
    """Rank-local EP-MoE forward inside ``DistContext.run`` (or alone at
    n = 1). x: (m, h) this rank's tokens (data-parallel over the ranks);
    params["w_*"]: this rank's experts (E/n, ...). Returns (m, h).

    ``capacity``: the slot size a destination rank; default the lossless
    m·topk rounded up to the block. A smaller one can drop token copies:
    ``return_overflow=True`` appends the dispatch layout's drop count
    (int32, 0 = lossless). ``a2a_state``: (ws, call_index) from
    ``ops/all_to_all.a2a_stream_workspace`` — dispatch and combine ride
    the barrier-free parity AllToAll over that one workspace; then the
    return is (y, a2a_state'), with the count after it if asked."""
    n = num_ranks
    m, h = x.shape
    epr = params["w_gate"].shape[0]
    E = epr * n
    top_ids, weights = router_topk(x, params["router"], topk)
    weights = weights.to(x.dtype)

    if n == 1:
        sort_idx, gs = sort_by_expert(top_ids.reshape(-1), E)
        xs = x.repeat_interleave(topk, dim=0)[sort_idx]
        y = _expert_mlp(xs, gs, params)
        y = y * weights.reshape(-1)[sort_idx][:, None]
        y = y[torch.argsort(sort_idx)].reshape(m, topk, h).sum(1).to(x.dtype)
        out = (y, a2a_state) if a2a_state is not None else (y,)
        if return_overflow:      # no cap on the local path
            out = out + (torch.zeros((), dtype=torch.int32, device=x.device),)
        return out if len(out) > 1 else out[0]

    block = 16
    cap = capacity or -(-(m * topk) // block) * block

    # 1. dispatch: the token copies to their experts' ranks.
    lay = dispatch_layout(x.repeat_interleave(topk, dim=0),
                          top_ids.reshape(-1), E, n, cap)
    if a2a_state is not None:
        ws, idx = a2a_state
        recv_buf, recv_splits, ws, idx = fast_all_to_all_stream(
            lay.send_buf, lay.send_splits, ws, idx, axis=axis, num_ranks=n)
    else:
        recv_buf, recv_splits = fast_all_to_all_local(
            lay.send_buf, lay.send_splits, axis=axis, num_ranks=n)

    # 2. the local experts over the received rows, grouped by local
    # expert, the rows past every slot's count in one padding group.
    flat, local_eid, group_sizes = combine_layout(recv_buf, recv_splits)
    order = torch.argsort(local_eid, stable=True)
    y_sorted = _expert_mlp(flat[order], group_sizes, params, pad_group=True)
    y_slots = torch.empty_like(flat)
    y_slots[order] = y_sorted
    y_slots = y_slots.reshape(n, cap, h)

    # 3. combine: the same slot layout in reverse (recv_splits say what
    # each source sent, so they are the return trip's splits).
    if a2a_state is not None:
        back_buf, _, ws, idx = fast_all_to_all_stream(
            y_slots, recv_splits, ws, idx, axis=axis, num_ranks=n)
    else:
        back_buf, _ = fast_all_to_all_local(y_slots, recv_splits, axis=axis,
                                            num_ranks=n)

    # 4. un-permute: sorted copy i went to (sorted_rank, pos_in_slot) and
    # came back there. Copies the cap dropped never travelled: they read a
    # clamped row and are zeroed (the loss overflow reports).
    kept = lay.pos_in_slot < cap
    got = back_buf[lay.sorted_rank, lay.pos_in_slot.clamp(max=cap - 1)]
    w_sorted = weights.reshape(-1)[lay.sort_idx]
    got = torch.where(kept[:, None], got * w_sorted[:, None],
                      torch.zeros_like(got))
    y = got[torch.argsort(lay.sort_idx)].reshape(m, topk, h).sum(1)
    y = y.to(x.dtype)
    out = (y, (ws, idx)) if a2a_state is not None else (y,)
    if return_overflow:
        out = out + (lay.overflow,)
    return out if len(out) > 1 else out[0]


def _expert_mlp(x_sorted: torch.Tensor, group_sizes, params: dict,
                pad_group: bool = False) -> torch.Tensor:
    """SwiGLU over expert-sorted rows (e4m3 stacks take B3's e4m3 lane,
    as the TP form's). ``pad_group``: the rows after the experts' groups
    are a padding group, which the reference runs against zero weights:
    they come out zero here without being computed."""
    sizes = _host_sizes(group_sizes)
    epr = params["w_gate"].shape[0]
    live = sum(sizes[:epr])
    xs = x_sorted[:live] if pad_group else x_sorted
    gate = ragged_dot_dtype_aware(xs, params["w_gate"], sizes[:epr])
    up = ragged_dot_dtype_aware(xs, params["w_up"], sizes[:epr])
    act = swiglu(gate, up).to(x_sorted.dtype)
    y = ragged_dot_dtype_aware(act, params["w_down"], sizes[:epr]
                               ).to(x_sorted.dtype)
    if not pad_group:
        return y
    out = x_sorted.new_zeros(x_sorted.shape[:1] + y.shape[1:])
    out[:live] = y
    return out
