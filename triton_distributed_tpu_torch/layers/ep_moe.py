"""Qwen3-MoE expert parameters — counterpart of the JAX package's
``layers/ep_moe.py`` (its ``init_ep_moe``).

The parameters feed both MoE forms there: the tensor-parallel one the
dense model runs (``ops/moe.moe_tp_fwd_local``, which the port has at one
rank) and the expert-parallel all-to-all one (``ep_moe_fwd``), which
comes with the multi-GPU slices.
"""

from __future__ import annotations

import torch

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
