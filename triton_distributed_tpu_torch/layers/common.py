"""Shared layer math: RMSNorm, RoPE, SwiGLU — counterpart of the JAX
package's ``layers/common.py``. Plain tensor code: on the card these are
PyTorch's own elementwise kernels, as the JAX package leaves them to XLA."""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


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


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


class KVSlice(NamedTuple):
    """One layer's linear KV cache: (batch, max_seq, kv_heads, head_dim).
    Views into the model cache — writes through them update it in place."""

    k: torch.Tensor
    v: torch.Tensor
