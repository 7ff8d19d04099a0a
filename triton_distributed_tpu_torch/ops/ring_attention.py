"""Ring attention — sequence-parallel causal prefill over the ring;
counterpart of the JAX package's ``ops/ring_attention.py``.

KV shards rotate one rank right per hop while every rank accumulates K1's
partials (``shard_attention_partial``) with the online log-sum-exp merge
(``ops/flash_attention._merge``). Causality is positional (rank r owns
positions [r·S/n, (r+1)·S/n)), handed to K1 as (q_offset, k_offset), so a
shard wholly behind the diagonal is computed in full and one wholly past
it comes back dead (l = 0) for the merge. The rotation is
``runtime/context.group_ppermute``, as the reference's is XLA's
``ppermute`` (not kernel B7): exactly n - 1 rotations, the diagonal hop
first and the last arriving shard consumed after the loop, in the
reference's order of partials and merges.

``tiles`` is the reference's VMEM cap of the flash kernel's tiles; K1
picks its own tiles on this card, so it is accepted for call-site parity
and unused.
"""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.ops.flash_attention import (
    _merge, shard_attention_partial,
)
from triton_distributed_tpu_torch.ops.sp_ag_attention import (
    _normalize, run_sequence_sharded,
)
from triton_distributed_tpu_torch.runtime.context import (
    DistContext, axis_index, group_ppermute,
)


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, axis: str = "sp", num_ranks: int | None = None,
                         causal: bool = True, tiles: tuple | None = None
                         ) -> torch.Tensor:
    """Rank-local ring attention inside ``DistContext.run``. q/k/v: (B,
    S/n, h*, d), this rank's sequence shard. Returns (B, S/n, hq, d): the
    local queries attended over the FULL sequence."""
    if num_ranks is None:
        raise ValueError("num_ranks required inside the rank runner")
    n = num_ranks
    me = axis_index(axis) if n > 1 else 0
    sq, sk = q.shape[1], k.shape[1]
    q_off = me * sq

    def partial_for(kc, vc, src):
        return shard_attention_partial(q, kc, vc, q_offset=q_off,
                                       k_offset=src * sk, causal=causal)

    if n == 1:
        return _normalize(partial_for(k, v, me), q.dtype)
    perm = [(i, (i + 1) % n) for i in range(n)]      # shift right

    def rotate(x):
        return group_ppermute(x, perm, axis=axis, num_ranks=n)

    kc, vc = rotate(k), rotate(v)
    state = partial_for(k, v, me)
    for i in range(1, n - 1):
        kc_next, vc_next = rotate(kc), rotate(vc)
        state = _merge(state, partial_for(kc, vc, (me - i + n) % n))
        kc, vc = kc_next, vc_next
    state = _merge(state, partial_for(kc, vc, (me + 1) % n))
    return _normalize(state, q.dtype)


def ring_attention(q, k, v, ctx: DistContext | None = None,
                   axis: str = "tp", causal: bool = True) -> list:
    """Host-level ring attention: q/k/v (B, S, h*, d) sharded on dim 1
    (or lists of the n shards). Returns the n ranks' (B, S/n, hq, d)
    output shards."""
    return run_sequence_sharded(ring_attention_local, q, k, v, ctx, axis,
                                causal)
