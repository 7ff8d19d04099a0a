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
- ``"xla_rep"``: x replicated, the rank group's plain sum.

The two-tier ``"overlap2d"`` (a TP group spanning a DCN axis) is not
ported and is refused by name."""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.layers.common import (
    plain_dot, swiglu, tp_reduce,
)
from triton_distributed_tpu_torch.runtime.context import (
    P, group_all_gather, group_psum, group_psum_scatter,
)
from triton_distributed_tpu_torch.runtime.device import resolve_device

ROW_SHARDED_MODES = ("overlap", "xla")
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
    the AllReduce, else ``"ar"``. The two-tier form (``n_inter`` > 1) is
    not ported and is refused by name."""
    if mode != "auto":
        return mode
    if n_inter > 1:
        raise ValueError("pick_mode: the hierarchical 'overlap2d' candidate "
                         "(n_inter > 1) is not ported — argument n_inter")
    if not (n > 1 and m_total % n == 0 and m_total // n >= 8):
        return "ar"
    if hidden is None or ffn is None:
        return "overlap"
    from triton_distributed_tpu_torch.runtime.perf_model import (
        ag_gemm_time_s, allreduce_time_s, gemm_rs_time_s, gemm_time_s,
    )

    t_ar = (gemm_time_s(m_total, ffn, hidden, itemsize, spec)
            + gemm_time_s(m_total, hidden, ffn, itemsize, spec)
            + allreduce_time_s(m_total * hidden * itemsize, n, spec=spec))
    t_overlap = (ag_gemm_time_s(m_total, ffn, hidden, n, itemsize, spec)
                 + gemm_rs_time_s(m_total, hidden, ffn, n, itemsize, spec))
    return "overlap" if t_overlap <= t_ar else "ar"


def refuse_row_sharded(mode: str, what: str) -> None:
    """Name the mode whose kernels are not ported (the two-tier
    ``"overlap2d"``); refuse an unknown one."""
    if mode == "overlap2d":
        raise ValueError(
            f"{what}: mode 'overlap2d' (the two-tier hierarchical AG+GEMM / "
            "GEMM+RS of a TP group spanning a DCN axis, n_inter > 1) is not "
            "ported — the port runs 'overlap', 'xla', 'ar' and 'xla_rep' — "
            "argument mode")
    if mode not in ROW_SHARDED_MODES + REPLICATED_MODES:
        raise ValueError(f"{what}: unknown TP mode {mode!r} — argument mode")


def tp_mlp_fwd(params: dict, x: torch.Tensor, *, axis: str = "tp",
               num_ranks: int = 1, mode: str = "overlap", ar_fn=None,
               gemm_ar_fn=None, dot_fn=None) -> torch.Tensor:
    """x → (rows of x, h) with a concrete ``mode`` (see the module
    docstring for the layouts); ``dot_fn(a, w)`` replaces every ``a @ w``
    of the replicated modes (the row-sharded ones fuse the products into
    their collectives). ``ar_fn`` replaces the ``"ar"`` reduction (the
    decode loop's parity stream); ``gemm_ar_fn(act, w_down)`` replaces
    the down projection and its reduction (the fused GEMM+AR). At n = 1
    a given hook still runs."""
    dot = dot_fn or plain_dot
    n = num_ranks
    wg, wu, wd = params["w_gate"], params["w_up"], params["w_down"]
    if n == 1:
        act = swiglu(dot(x, wg), dot(x, wu))
        if gemm_ar_fn is not None:
            return gemm_ar_fn(act, wd)
        y = dot(act, wd)
        return ar_fn(y) if ar_fn is not None else y
    if mode == "auto":
        raise ValueError("resolve 'auto' with pick_mode() before calling "
                         "(the activation layout depends on the mode)")
    refuse_row_sharded(mode, "tp_mlp_fwd")
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
        return tp_reduce(y, axis=axis, n=n)
    return group_psum(dot(act, wd), axis=axis, num_ranks=n)
