"""Device and dtype resolution — the single-device stand-in for the JAX
package's ``runtime/context.py`` at n=1 (no mesh, no ``shard_map``: every
tensor lives on one explicit ``torch.device``)."""

from __future__ import annotations

import torch

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float8_e4m3fn": torch.float8_e4m3fn,     # KV pools only
}


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. A CUDA device without CUDA raises — the
    port never drops to the CPU on its own; pass ``device="cpu"`` to ask
    for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is "
            "False — pass device='cpu' to run on the CPU")
    return dev


def torch_dtype(name) -> torch.dtype:
    """Map a config dtype string (``"bfloat16"``, ``"float32"``) — or an
    existing ``torch.dtype`` — to a ``torch.dtype``."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}: expected one of "
                         f"{sorted(_DTYPES)}") from None
