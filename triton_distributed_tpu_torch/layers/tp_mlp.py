"""SwiGLU MLP at tensor-parallel degree 1 — counterpart of the JAX
package's ``layers/tp_mlp.py`` (its single-rank branch). The matmuls stay
``torch.matmul``, as the JAX package leaves them to XLA, unless a
``dot_fn`` replaces them (the fp8 weight lane's ``fp8_dot``); the
overlapped multi-rank modes come with the multi-GPU slices."""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.layers.common import plain_dot, swiglu
from triton_distributed_tpu_torch.runtime.device import resolve_device


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


def tp_mlp_fwd(params: dict, x: torch.Tensor, *, dot_fn=None
               ) -> torch.Tensor:
    """x (m, h) → (m, h); ``dot_fn(a, w)`` replaces every ``a @ w``."""
    dot = dot_fn or plain_dot
    act = swiglu(dot(x, params["w_gate"]), dot(x, params["w_up"]))
    return dot(act, params["w_down"])
