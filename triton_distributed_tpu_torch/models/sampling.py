"""Token sampling — counterpart of the JAX package's
``models/sampling.py`` (greedy only in this slice)."""

from __future__ import annotations

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """(B, vocab) → (B,) int32 argmax. Ties go to the first maximum, as
    ``jnp.argmax`` does (``torch.argmax`` documents the same rule;
    ``chip_smoke.py`` checks it on the card)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)
