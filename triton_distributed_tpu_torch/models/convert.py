"""Parameter conversion from the JAX package's pytree.

:func:`params_from_numpy` turns the JAX package's parameter tree (dicts
and lists whose leaves are numpy arrays — or anything ``np.asarray``
accepts, such as JAX arrays) into the port's parameter dict. Weights keep
the JAX ``(in, out)`` layout, so ``x @ w`` computes the same product on
both sides and nothing is transposed.

bf16 leaves arrive as ``ml_dtypes.bfloat16`` arrays, which
``torch.from_numpy`` rejects; they cross bit-exactly through a ``uint16``
view reinterpreted as ``torch.bfloat16``.
"""

from __future__ import annotations

import numpy as np
import torch

from triton_distributed_tpu_torch.models.config import ModelConfig
from triton_distributed_tpu_torch.runtime.device import (
    resolve_device, torch_dtype,
)


def array_to_tensor(a) -> torch.Tensor:
    """One numpy leaf → a CPU tensor with the same bits."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_numpy(tree, cfg: ModelConfig, *, device=None, dtype=None):
    """Convert a JAX parameter tree into the port's parameters on
    ``device`` (``None`` = the card). ``dtype`` casts floating leaves
    (default: the config's dtype)."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype or cfg.dtype)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        t = array_to_tensor(node)
        if t.is_floating_point():
            t = t.to(dt)
        return t.to(dev)

    return conv(tree)
