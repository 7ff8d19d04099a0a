"""Shared layer math: RMSNorm, RoPE, SwiGLU, the plain projection and
the TP reduction — counterpart of the JAX package's ``layers/common.py``.
Plain tensor code: on the card these are PyTorch's own elementwise
kernels, as the JAX package leaves them to XLA; :func:`tp_reduce` is the
collective (``ops/allreduce``)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from triton_distributed_tpu_torch.models.fp8 import E4M3


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """RMSNorm computed in fp32 and cast back to ``x.dtype``."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """fp32 (cos, sin) tables for ``positions`` (any shape) →
    (*pos, head_dim/2)."""
    dev = positions.device
    inv_freq = 1.0 / (theta ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=dev)
        / head_dim))
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """Rotate split halves (HF non-interleaved convention).

    x: (..., seq, heads, head_dim); cos/sin: (..., seq, head_dim/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]            # broadcast over heads
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * (1 / (1 + exp(-x))), op by op in x's type: the ops
    ``jax.nn.silu`` lowers to, so bf16 rounds where the reference's does
    (``F.silu`` and ``x * sigmoid(x)`` round elsewhere and differ from it
    in about a third of bf16 inputs)."""
    return x * (1 / (1 + torch.exp(-x)))


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return silu(gate) * up


def plain_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``, the projection when no ``dot_fn`` is given. e4m3 weights
    are refused by name: torch has no mixed-type matmul, and the port runs
    a quantized tree only on the linear decode step with
    ``dot_fn=models.fp8.fp8_dot``."""
    if w.dtype == E4M3:
        raise ValueError(
            "e4m3 weight without dot_fn: a quantize_dense_weights tree "
            "decodes through dense_decode_step(dot_fn=fp8_dot) only "
            "(prefill and the paged steps take the model-dtype tree)")
    return x @ w


class KVSlice(NamedTuple):
    """One layer's linear KV cache: (batch, max_seq, kv_heads, head_dim).
    Views into the model cache — writes through them update it in place."""

    k: torch.Tensor
    v: torch.Tensor


def tp_reduce(y: torch.Tensor, *, axis: str, n: int, inter_axis: str = "dcn",
              n_inter: int = 1) -> torch.Tensor:
    """The full AllReduce of a TP partial sum inside the rank runner: the
    AllReduce kernels on one axis (``ops/allreduce.all_reduce_local``,
    AUTO method), or — the TP group spanning a second, inter tier
    (``n_inter`` > 1) — the two-tier AllReduce (intra ring RS, the inter
    tier's sum, intra ring AG: ``ops/two_level.all_reduce_2d_local``)."""
    if n_inter > 1:
        from triton_distributed_tpu_torch.ops.two_level import (
            all_reduce_2d_local,
        )

        return all_reduce_2d_local(y, intra_axis=axis, inter_axis=inter_axis,
                                   n_intra=n, n_inter=n_inter)
    from triton_distributed_tpu_torch.ops.allreduce import all_reduce_local

    return all_reduce_local(y, axis=axis, num_ranks=n)
