"""Tensor-parallel SwiGLU MLP — counterpart of the JAX package's
``layers/tp_mlp.py``: column-parallel gate/up, row-parallel down.

The matmuls stay ``torch.matmul``, as the JAX package leaves them to XLA,
unless a ``dot_fn`` replaces them (the fp8 weight lane's ``fp8_dot``).
At n > 1 the activations are replicated and the down projection's
partial sums are reduced: mode ``"ar"`` through the AllReduce kernels
(``layers/common.tp_reduce``, or the decode loop's parity stream given as
``ar_fn``), mode ``"xla_rep"`` through the rank group's plain sum. The
row-sharded modes (``"overlap"`` — AG+GEMM / GEMM+RS, kernels B9/B10 —,
``"overlap2d"`` and ``"xla"``) come with ``Engine.serve`` on a TP group
and are refused by name. Call inside ``DistContext.run`` at n > 1."""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.layers.common import (
    plain_dot, swiglu, tp_reduce,
)
from triton_distributed_tpu_torch.runtime.context import P, group_psum
from triton_distributed_tpu_torch.runtime.device import resolve_device

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
    """Name the modes whose kernels are not ported yet."""
    if mode in ROW_SHARDED_MODES:
        raise ValueError(
            f"{what}: mode {mode!r} (row-sharded activations: AG+GEMM / "
            "GEMM+RS, kernels B9/B10, or their XLA form) is not ported — "
            "it comes with Engine.serve on a TP group; the port runs "
            "'ar' and 'xla_rep' — argument mode")
    if mode not in REPLICATED_MODES:
        raise ValueError(f"{what}: unknown TP mode {mode!r} — argument mode")


def tp_mlp_fwd(params: dict, x: torch.Tensor, *, axis: str = "tp",
               num_ranks: int = 1, mode: str = "ar", ar_fn=None,
               dot_fn=None) -> torch.Tensor:
    """x (m, h) → (m, h); ``dot_fn(a, w)`` replaces every ``a @ w``. At
    n > 1 (weights sharded per ``tp_mlp_specs``, x replicated) the down
    projection's partial sums reduce per ``mode``; ``ar_fn`` replaces the
    ``"ar"`` reduction (the decode loop's parity stream). At n = 1 a
    given ``ar_fn`` still runs."""
    dot = dot_fn or plain_dot
    n = num_ranks
    if n > 1:
        if mode == "auto":
            raise ValueError("resolve 'auto' with pick_mode() before calling "
                             "(the activation layout depends on the mode)")
        refuse_row_sharded(mode, "tp_mlp_fwd")
    act = swiglu(dot(x, params["w_gate"]), dot(x, params["w_up"]))
    y = dot(act, params["w_down"])
    if ar_fn is not None and (n == 1 or mode == "ar"):
        return ar_fn(y)
    if n == 1:
        return y
    if mode == "ar":
        return tp_reduce(y, axis=axis, n=n)
    return group_psum(y, axis=axis, num_ranks=n)
