"""Tensor-parallel SwiGLU MLP — counterpart of the JAX package's
``layers/tp_mlp.py``: column-parallel gate/up, row-parallel down.

The matmuls stay ``torch.matmul``, as the JAX package leaves them to XLA,
unless a ``dot_fn`` replaces them (the fp8 weight lane's ``fp8_dot``).
Modes at n > 1 (call inside ``DistContext.run``):

- ``"overlap"``: x row-sharded (m/n, h) in and out — gate and up through
  the AG+GEMM kernel B9 (``ops/allgather_gemm.ag_gemm_local``), down
  through the GEMM+RS kernel B10 (``ops/gemm_reduce_scatter``);
- ``"xla"``: the same layout through the rank group's plain all-gather
  and reduce-scatter around ``torch.matmul``;
- ``"ar"``: x replicated, the down projection's partial sums through the
  AllReduce kernels (``layers/common.tp_reduce``), or the decode loop's
  parity stream given as ``ar_fn``, or — ``gemm_ar_fn`` — the fused
  GEMM+AR kernel B11 in place of the down projection and its reduction;
- ``"xla_rep"``: x replicated, the rank group's plain sum;
- ``"overlap2d"`` (a TP group spanning a second, inter tier:
  ``n_inter`` > 1): x row-sharded over both tiers, (m/(n·n_inter), h) in
  and out — gate and up through ``ops/hierarchical.ag_gemm_2d_local`` (B9
  in the slice, the slice blocks rotating over the inter tier into B3),
  down through ``gemm_rs_2d_local`` (B10 a slice chunk, the chunks
  reduced around the inter ring). On such a group ``"ar"`` reduces
  through the two-tier ``tp_reduce`` and ``"xla_rep"`` sums over both
  axes."""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.layers.common import (
    plain_dot, swiglu, tp_reduce,
)
from triton_distributed_tpu_torch.runtime.context import (
    P, group_all_gather, group_psum, group_psum_scatter,
)
from triton_distributed_tpu_torch.runtime.device import resolve_device

# "overlap2d": rows sharded over both tiers of a 2-axis group (the
# two-tier AG+GEMM / GEMM+RS of ops/hierarchical.py).
ROW_SHARDED_MODES = ("overlap", "xla", "overlap2d")
REPLICATED_MODES = ("ar", "xla_rep")


def init_tp_mlp(hidden: int, ffn: int, dtype, *,
                generator: torch.Generator, device=None) -> dict:
    """Random weights with the JAX package's scales, (in, out) layout, on
    ``device`` (None: the card)."""
    device = resolve_device(device)

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=device) * scale

    return {
        "w_gate": normal((hidden, ffn), hidden ** -0.5),
        "w_up": normal((hidden, ffn), hidden ** -0.5),
        "w_down": normal((ffn, hidden), ffn ** -0.5),
    }


def tp_mlp_specs(axis: str = "tp") -> dict:
    return {"w_gate": P(None, axis), "w_up": P(None, axis),
            "w_down": P(axis, None)}


def pick_mode(mode: str, m_total: int, n: int, *, hidden: int | None = None,
              ffn: int | None = None, itemsize: int = 2,
              n_inter: int = 1, spec=None) -> str:
    """Resolve ``"auto"`` (reference ``pick_mode``) on the port's perf
    model: ``"overlap"`` (AG+GEMM then GEMM+RS) when the rows divide into
    shards of >= 8 and its modeled time beats the replicated GEMMs plus
    the AllReduce, else ``"ar"``. ``n_inter`` > 1 (a 2-axis (inter, tp)
    group) adds the two-tier ``"overlap2d"`` candidate: rows sharded over
    both tiers (the joint degree n·n_inter must divide them into >= 8),
    its modeled time carrying the inter hops' latency, so AUTO declines it
    at small row counts; the replicated path's reduction then also pays
    the inter tier (``perf_model.dcn_collective_time_s``)."""
    if mode != "auto":
        return mode
    N = n * n_inter
    can_1d = n > 1 and m_total % n == 0 and m_total // n >= 8
    can_2d = (n_inter > 1 and N > 1 and m_total % N == 0
              and m_total // N >= 8)
    if not can_1d and not can_2d:
        return "ar"
    if hidden is None or ffn is None:
        return "overlap2d" if can_2d else "overlap"
    from triton_distributed_tpu_torch.runtime.perf_model import (
        ag_gemm_2d_time_s, ag_gemm_time_s, allreduce_time_s,
        dcn_collective_time_s, gemm_rs_2d_time_s, gemm_rs_time_s,
        gemm_time_s,
    )

    t_ar = (gemm_time_s(m_total, ffn, hidden, itemsize, spec)
            + gemm_time_s(m_total, hidden, ffn, itemsize, spec)
            + allreduce_time_s(m_total * hidden * itemsize, n, spec=spec))
    if n_inter > 1:
        t_ar += dcn_collective_time_s(m_total * hidden * itemsize, n_inter,
                                      spec)
    best, t_best = "ar", t_ar
    if can_1d:
        t_overlap = (ag_gemm_time_s(m_total, ffn, hidden, n, itemsize, spec)
                     + gemm_rs_time_s(m_total, hidden, ffn, n, itemsize,
                                      spec))
        if t_overlap <= t_best:
            best, t_best = "overlap", t_overlap
    if can_2d:
        t_2d = (ag_gemm_2d_time_s(m_total, ffn, hidden, n, n_inter,
                                  itemsize, spec)
                + gemm_rs_2d_time_s(m_total, hidden, ffn, n, n_inter,
                                    itemsize, spec))
        if t_2d < t_best:
            return "overlap2d"
    return best


def check_mode(mode: str, what: str) -> None:
    """Refuse an unknown mode by name."""
    if mode not in ROW_SHARDED_MODES + REPLICATED_MODES:
        raise ValueError(f"{what}: unknown TP mode {mode!r} — argument mode")


def tp_mlp_fwd(params: dict, x: torch.Tensor, *, axis: str = "tp",
               num_ranks: int = 1, mode: str = "overlap",
               inter_axis: str = "dcn", n_inter: int = 1, ar_fn=None,
               gemm_ar_fn=None, dot_fn=None) -> torch.Tensor:
    """x → (rows of x, h) with a concrete ``mode`` (see the module
    docstring for the layouts); ``dot_fn(a, w)`` replaces every ``a @ w``
    of the replicated modes (the row-sharded ones fuse the products into
    their collectives). ``ar_fn`` replaces the ``"ar"`` reduction (the
    decode loop's parity stream); ``gemm_ar_fn(act, w_down)`` replaces
    the down projection and its reduction (the fused GEMM+AR). At
    n·n_inter = 1 a given hook still runs. ``n_inter`` > 1: the TP group
    spans the inter tier ``inter_axis`` too (weights sharded over both)."""
    dot = dot_fn or plain_dot
    n = num_ranks
    wg, wu, wd = params["w_gate"], params["w_up"], params["w_down"]
    if n * n_inter == 1:
        act = swiglu(dot(x, wg), dot(x, wu))
        if gemm_ar_fn is not None:
            return gemm_ar_fn(act, wd)
        y = dot(act, wd)
        return ar_fn(y) if ar_fn is not None else y
    if mode == "auto":
        raise ValueError("resolve 'auto' with pick_mode() before calling "
                         "(the activation layout depends on the mode)")
    check_mode(mode, "tp_mlp_fwd")
    if mode == "overlap":
        from triton_distributed_tpu_torch.ops.allgather_gemm import (
            ag_gemm_local,
        )
        from triton_distributed_tpu_torch.ops.gemm_reduce_scatter import (
            gemm_rs_local,
        )

        gate = ag_gemm_local(x, wg, axis=axis, num_ranks=n)
        up = ag_gemm_local(x, wu, axis=axis, num_ranks=n)
        return gemm_rs_local(swiglu(gate, up), wd, axis=axis, num_ranks=n)
    if mode == "overlap2d":
        from triton_distributed_tpu_torch.ops.hierarchical import (
            ag_gemm_2d_local, gemm_rs_2d_local,
        )

        kw = dict(intra_axis=axis, inter_axis=inter_axis, n_intra=n,
                  n_inter=n_inter)
        gate = ag_gemm_2d_local(x, wg, **kw)
        up = ag_gemm_2d_local(x, wu, **kw)
        return gemm_rs_2d_local(swiglu(gate, up), wd, **kw)
    if mode == "xla":
        full = group_all_gather(x, axis=axis, num_ranks=n)
        h = swiglu(full @ wg, full @ wu)
        return group_psum_scatter(h @ wd, axis=axis, num_ranks=n)
    act = swiglu(dot(x, wg), dot(x, wu))
    if mode == "ar":
        if gemm_ar_fn is not None:
            return gemm_ar_fn(act, wd)
        y = dot(act, wd)
        if ar_fn is not None:
            return ar_fn(y)
        return tp_reduce(y, axis=axis, n=n, inter_axis=inter_axis,
                         n_inter=n_inter)
    return group_psum(dot(act, wd),
                      axis=(inter_axis, axis) if n_inter > 1 else axis)
