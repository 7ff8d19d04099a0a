"""The saturating e4m3 cast every fp8 KV-pool write goes through —
counterpart of the JAX package's ``models/fp8.py`` (``E4M3``,
``_to_e4m3``, ``saturate_cast``).

A plain float → float8_e4m3fn conversion is not guaranteed to saturate
(jnp's produces NaN past the ±448 finite range; torch's CPU cast happens
to saturate, which the port does not rely on), and one NaN in a KV page
poisons every later softmax over it. So every writer clamps to ±448 in
fp32 first, then casts: the paged append, the serving loop's prefill
scatter, ``Engine.to_paged`` and the megakernel lane's prefill load. The
CUDA kernels store with ``__nv_cvt_float_to_fp8(..., __NV_SATFINITE,
__NV_E4M3)``, the same values.

The fp8 WEIGHT lane (``quantize_dense_weights``, ``fp8_dot``,
``fp8_emulated_dot``) is not ported: nothing on the serving path calls a
``dot_fn``.
"""

from __future__ import annotations

import torch

E4M3 = torch.float8_e4m3fn
E4M3_MAX = float(torch.finfo(E4M3).max)      # 448.0


def to_e4m3(a: torch.Tensor) -> torch.Tensor:
    """Saturating e4m3 cast: clamp to ±448 in fp32, then cast (an e4m3
    input passes through)."""
    if a.dtype == E4M3:
        return a
    return torch.clamp(a.float(), -E4M3_MAX, E4M3_MAX).to(E4M3)


def saturate_cast(a: torch.Tensor, dtype) -> torch.Tensor:
    """``a.to(dtype)``, through :func:`to_e4m3` when ``dtype`` is e4m3 —
    the one cast every KV-pool write shares, so a hot value clamps the
    same way on every path."""
    if dtype == E4M3:
        return to_e4m3(a)
    return a.to(dtype)
