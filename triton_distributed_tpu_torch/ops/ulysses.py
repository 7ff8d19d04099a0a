"""Ulysses sequence parallelism — head-exchange AllToAll attention;
counterpart of the JAX package's ``ops/ulysses.py``.

Activations arrive sequence-sharded (B, S/n, H, d). An AllToAll exchanges
the head and sequence axes so every rank holds ALL positions for H/n
heads; K1 (``shard_attention``, normalized) runs over the full sequence
per head shard; a second AllToAll restores sequence sharding:

    (B, S/n, H, d) ── a2a(H→, ←S) ──> (B, S, H/n, d)
                  ── attention (full S, causal ok) ──
    (B, S, H/n, d) ── a2a(S→, ←H) ──> (B, S/n, H, d)

The exchanges are ``runtime/context.group_all_to_all`` over the head (or
sequence) axis moved to the front, the reference's ``jax.lax.all_to_all``.
Requires Hq % n == 0 and Hkv % n == 0. ``tiles`` is the reference's VMEM
cap of the flash kernel's tiles, accepted for call-site parity and unused
on this card.
"""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.ops.flash_attention import shard_attention
from triton_distributed_tpu_torch.ops.sp_ag_attention import (
    run_sequence_sharded,
)
from triton_distributed_tpu_torch.runtime.context import (
    DistContext, group_all_to_all,
)


def _heads_to_seq(x: torch.Tensor, n: int, axis: str) -> torch.Tensor:
    """(B, S/n, H, d) → (B, S, H/n, d): head chunk p to rank p, the
    received sequence shards in rank order."""
    b, s, h, d = x.shape
    got = group_all_to_all(x.permute(2, 0, 1, 3).contiguous(), axis=axis,
                           num_ranks=n)                  # (n·H/n, B, S/n, d)
    return got.reshape(n, h // n, b, s, d).permute(2, 0, 3, 1, 4).reshape(
        b, n * s, h // n, d)


def _seq_to_heads(x: torch.Tensor, n: int, axis: str) -> torch.Tensor:
    """(B, S, H/n, d) → (B, S/n, H, d): sequence chunk p to rank p, the
    received head shards in rank order."""
    b, s, h, d = x.shape
    got = group_all_to_all(
        x.reshape(b, n, s // n, h, d).permute(1, 0, 2, 3, 4).contiguous(),
        axis=axis, num_ranks=n)                          # (n, B, S/n, H/n, d)
    return got.permute(1, 2, 0, 3, 4).reshape(b, s // n, n * h, d)


def ulysses_attention_local(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, axis: str = "sp",
                            num_ranks: int | None = None, causal: bool = True,
                            tiles: tuple[int, int] | None = None
                            ) -> torch.Tensor:
    """Rank-local Ulysses attention inside ``DistContext.run``. q: (B,
    S/n, Hq, d); k/v: (B, S/n, Hkv, d), sequence-sharded. Returns (B, S/n,
    Hq, d)."""
    if num_ranks is None:
        raise ValueError("num_ranks required inside the rank runner")
    n = num_ranks
    if n == 1:
        return shard_attention(q, k, v, causal=causal)
    hq, hkv = q.shape[2], k.shape[2]
    if hq % n or hkv % n:
        raise ValueError(f"heads ({hq}, {hkv}) not divisible by axis size {n}")
    qg, kg, vg = (_heads_to_seq(t, n, axis) for t in (q, k, v))
    out = shard_attention(qg, kg, vg, causal=causal)
    return _seq_to_heads(out, n, axis)


def ulysses_attention(q, k, v, ctx: DistContext | None = None,
                      axis: str = "tp", causal: bool = True) -> list:
    """Host-level Ulysses attention: q/k/v (B, S, h*, d) sharded on dim 1
    (or lists of the n shards). Returns the n ranks' (B, S/n, hq, d)
    output shards."""
    return run_sequence_sharded(ulysses_attention_local, q, k, v, ctx, axis,
                                causal)
