"""Token sampling and speculative acceptance — counterpart of the JAX
package's ``models/sampling.py``: greedy, temperature / top-k
:func:`sample` on an explicit ``torch.Generator`` (its draws differ from
``jax.random``'s; the distribution is the same), and
``accept_longest_prefix``."""

from __future__ import annotations

import numpy as np
import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """(B, vocab) → (B,) int32 argmax. Ties go to the first maximum, as
    ``jnp.argmax`` does (``torch.argmax`` documents the same rule;
    ``chip_smoke.py`` checks it on the card)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def accept_longest_prefix(draft, verified) -> np.ndarray:
    """Greedy speculative acceptance, the one rule both decode lanes
    share. ``draft``: the k proposed tokens (k >= 0); ``verified``: the
    verifier's greedy token at each of the k+1 candidate positions.
    With m the longest prefix where ``draft[j] == verified[j]``, the
    accepted new tokens are ``verified[:m+1]`` — the m confirmed drafts
    plus the token the verify step computed after them. Host-side, int32
    in and out; k = 0 is one-token decode."""
    d = np.asarray(draft, dtype=np.int32).ravel()
    v = np.asarray(verified, dtype=np.int32).ravel()
    if v.size != d.size + 1:
        raise ValueError(
            f"verified has {v.size} entries for {d.size} draft tokens — "
            "the verify step scores k+1 positions (last accepted token "
            "plus each draft)")
    m = 0
    while m < d.size and d[m] == v[m]:
        m += 1
    return v[:m + 1].astype(np.int32, copy=False)


def sample(logits: torch.Tensor, generator: torch.Generator | None = None,
           temperature: float = 1.0, top_k: int | None = None
           ) -> torch.Tensor:
    """Temperature / top-k sampling. (B, vocab) → (B,) int32. Greedy at
    ``temperature <= 0``; otherwise a categorical draw from
    softmax(logits / temperature) over the ``top_k`` largest logits (all
    when None), by the Gumbel-max trick as ``jax.random.categorical``,
    with uniforms from ``generator`` (on the logits' device)."""
    if temperature <= 0.0:
        return greedy(logits)
    logits = logits.float() / temperature
    if top_k is not None and top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, float("-inf"), logits)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp(min=torch.finfo(u.dtype).tiny)))
    return torch.argmax(logits + gumbel, dim=-1).to(torch.int32)
