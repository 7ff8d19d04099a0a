"""fp8 (e4m3): the saturating cast every fp8 write goes through, and the
fp8 weight lane — counterpart of the JAX package's ``models/fp8.py``.

A plain float → float8_e4m3fn conversion is not guaranteed to saturate
(jnp's produces NaN past the ±448 finite range; torch's CPU cast happens
to saturate, which the port does not rely on), and one NaN in a KV page
poisons every later softmax over it. So every writer clamps to ±448 in
fp32 first, then casts: the paged append, the serving loop's prefill
scatter, ``Engine.to_paged`` and the megakernel lane's prefill load. The
CUDA kernels store with ``__nv_cvt_float_to_fp8(..., __NV_SATFINITE,
__NV_E4M3)``, the same values.

The fp8 WEIGHT lane: :func:`quantize_dense_weights` turns every
per-layer projection and MLP weight (the MoE expert stacks included) into
e4m3, and the linear decode step (``models/dense.dense_decode_step``)
takes ``dot_fn=fp8_dot``, which quantizes the activation through
:func:`to_e4m3` and runs the pure e4m3 x e4m3 product with fp32
accumulation — kernel B3's e4m3 lane on the card, its plain version on
the CPU — returned in the activation's type. :func:`fp8_emulated_dot` is
the same quantized math in fp32, the lane's token-parity golden (e4m3
products are exact in fp32).
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


# Parameter-tree leaves that hold decode-GEMM weights. Norms, embed,
# lm_head and the MoE router keep the model dtype.
_WEIGHT_KEYS = frozenset(
    ["wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"])


def quantize_dense_weights(params: dict) -> dict:
    """The parameter tree with every per-layer projection / MLP weight —
    the MoE expert stacks under ``moe`` too — cast to e4m3 through
    :func:`to_e4m3`. Other leaves are shared, not copied."""
    def q_layer(layer: dict) -> dict:
        return {k: (q_layer(v) if isinstance(v, dict) else
                    to_e4m3(v) if k in _WEIGHT_KEYS else v)
                for k, v in layer.items()}

    return {**params, "layers": [q_layer(la) for la in params["layers"]]}


def _flat_dot(x: torch.Tensor, w: torch.Tensor, dot) -> torch.Tensor:
    out_dt = x.dtype if x.dtype != E4M3 else torch.float32
    y = dot(x.reshape(-1, x.shape[-1]), w)
    return y.reshape(*x.shape[:-1], w.shape[-1]).to(out_dt)


def fp8_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Pure-fp8 projection: the activation quantized to e4m3, then e4m3 x
    e4m3 with fp32 accumulation (B3's e4m3 lane on a CUDA tensor),
    returned in x's type (fp32 for an e4m3 x). A weight already in e4m3
    passes through; a wider one is quantized on the fly."""
    from triton_distributed_tpu_torch.ops.gemm import pallas_matmul

    return _flat_dot(x, w, lambda a, b: pallas_matmul(
        to_e4m3(a), to_e4m3(b), out_dtype=torch.float32))


def fp8_emulated_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The same quantized math in fp32: both operands rounded to e4m3,
    upcast, an fp32 product."""
    return _flat_dot(x, w, lambda a, b: to_e4m3(a).float()
                     @ to_e4m3(b).float())
