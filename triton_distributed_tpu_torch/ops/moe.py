"""MoE expert MLP at tensor-parallel degree 1 — counterpart of the JAX
package's ``ops/moe.py`` (its single-rank path: ``moe_tp_fwd_local`` at
n = 1, as ``models/dense._mlp_or_moe`` calls it).

At n = 1 the JAX path runs no Pallas kernel: routing, the expert sort and
``jax.lax.ragged_dot`` are XLA ops, and ``moe_reduce_rs_local`` returns
before its reduce-scatter. So this module is plain tensor code:

- ``route_and_sort``: fp32 router logits, top-k (ties to the lower expert
  index, as ``jax.lax.top_k``), softmax over the selected logits, then a
  stable sort of the flat assignments by expert;
- ``ragged_dot_dtype_aware``: the grouped product as one ``torch.matmul``
  per non-empty expert group of the expert-sorted rows. The group sizes
  cross to the host once per MoE layer (``moe_tp_fwd_local`` reads them
  and passes the list down), so the eager lane pays one host sync per
  MoE layer and step. A hand-written grouped GEMM is later work;
- the combine: each token's ``topk`` weighted rows added one at a time
  in expert-sorted order, each add rounded to the working type, as
  ``jax.ops.segment_sum`` adds them (so bf16 matches the reference's
  rounding; ``index_add_`` on the card would add them with atomics in a
  run-dependent order).

e4m3 expert stacks (the fp8 weight lane) run each group's product on
kernel B3's e4m3 lane (:func:`ragged_dot_dtype_aware`). Not ported: the
multi-rank modes (AG + grouped GEMM, the ring pipeline, the
reduce-scatter combine), which raise :class:`MoeUnsupportedError`.
"""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.layers.common import swiglu
from triton_distributed_tpu_torch.models.fp8 import E4M3, to_e4m3
from triton_distributed_tpu_torch.ops.gemm import pallas_matmul


class MoeUnsupportedError(NotImplementedError):
    """A MoE configuration the port has not ported: more than one rank or
    a multi-rank mode. Raised by name."""


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


def moe_reduce_rs_local(y_sorted: torch.Tensor, sort_idx: torch.Tensor,
                        group_sizes, w_down: torch.Tensor,
                        topk_weights: torch.Tensor, num_tokens: int, *,
                        num_ranks: int = 1, mode: str = "overlap"
                        ) -> torch.Tensor:
    """Down projection + top-k weighted combine (the JAX function's n = 1
    branch: no reduce-scatter). y_sorted: (M·topk, ffn) expert-sorted
    activations; topk_weights: (M, topk). Returns (M, h) in y's type."""
    _check_single_rank(num_ranks, mode)
    topk = sort_idx.shape[0] // num_tokens
    partial = ragged_dot_dtype_aware(y_sorted, w_down, group_sizes)
    partial = partial * topk_weights.reshape(-1)[sort_idx][:, None]
    # Flat slot f = token·topk + k sits at sorted position inv[f]. Each
    # token's rows are added one at a time in sorted order, each add
    # rounded to the working type, as jax.ops.segment_sum adds them.
    inv = torch.empty_like(sort_idx)
    inv[sort_idx] = torch.arange(sort_idx.shape[0], device=sort_idx.device)
    rows = partial[torch.sort(inv.reshape(num_tokens, topk), dim=1).values]
    combined = rows[:, 0]
    for j in range(1, topk):
        combined = combined + rows[:, j]
    return combined.to(y_sorted.dtype)


def _check_single_rank(num_ranks: int, mode: str) -> None:
    if num_ranks != 1:
        raise MoeUnsupportedError(
            f"num_ranks = {num_ranks}: the port's MoE runs on one rank (the "
            "tensor-parallel and expert-parallel forms come with the "
            "multi-GPU slices)")
    if mode != "overlap":
        raise MoeUnsupportedError(
            f"MoE mode {mode!r} is not ported: at one rank the port runs "
            "the JAX package's n = 1 path (mode 'overlap')")


def moe_tp_fwd_local(x: torch.Tensor, gate_w: torch.Tensor,
                     w_gate: torch.Tensor, w_up: torch.Tensor,
                     w_down: torch.Tensor, topk: int, *,
                     num_ranks: int = 1, mode: str = "overlap"
                     ) -> torch.Tensor:
    """The MoE FFN on one rank: router → gate/up grouped products →
    SwiGLU → down grouped product → weighted combine. x: (M, h); gate_w:
    (h, E); w_gate/w_up: (E, h, ffn); w_down: (E, ffn, h). Returns (M, h).
    The group sizes cross to the host once."""
    _check_single_rank(num_ranks, mode)
    x_sorted, sort_idx, group_sizes, _, topk_weights = route_and_sort(
        x, gate_w, topk)
    sizes = _host_sizes(group_sizes)
    act = grouped_mlp_gate_up(x_sorted, sizes, w_gate, w_up)
    return moe_reduce_rs_local(act, sort_idx, sizes, w_down,
                               topk_weights.to(x.dtype), x.shape[0])
