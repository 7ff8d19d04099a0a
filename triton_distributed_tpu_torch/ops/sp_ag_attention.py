"""SP AllGather-attention — KV-gather prefill; counterpart of the JAX
package's ``ops/sp_ag_attention.py``.

Each rank holds a sequence shard of q, k and v (rank r owns positions
[r·S/n, (r+1)·S/n)). The producer gathers the KV shards through B4
(``all_gather_local``: AUTO picks the ring or the full-mesh push); the
consumer runs K1's partials (``shard_attention_partial``) over each
gathered chunk at its positional offsets and merges them with the online
log-sum-exp of ``ops/flash_attention._merge`` — the diagonal chunk first,
then every chunk in rank order with the diagonal's weight masked to 0, in
the reference's order, so the fp32 merge matches it.

``tiles`` is the reference's VMEM cap of the flash kernel's tiles; K1
picks its own tiles on this card, so it is accepted for call-site parity
and unused.
"""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.ops._comm import rank_shards
from triton_distributed_tpu_torch.ops.allgather import (
    AllGatherMethod, all_gather_local,
)
from triton_distributed_tpu_torch.ops.flash_attention import (
    _merge, shard_attention_partial,
)
from triton_distributed_tpu_torch.runtime.context import (
    DistContext, axis_index, get_context,
)


def _normalize(state, dtype) -> torch.Tensor:
    acc, _, l = state
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(dtype)


def sp_ag_attention_local(q: torch.Tensor, k_shard: torch.Tensor,
                          v_shard: torch.Tensor, *, axis: str = "sp",
                          num_ranks: int | None = None, causal: bool = True,
                          method: AllGatherMethod | str = AllGatherMethod.AUTO,
                          tiles: tuple[int, int] | None = None
                          ) -> torch.Tensor:
    """Rank-local SP AG attention inside ``DistContext.run``.
    q/k_shard/v_shard: (B, S/n, h*, d) sequence shards. Returns (B, S/n,
    hq, d): the local queries attended over the full (causal) sequence."""
    if num_ranks is None:
        raise ValueError("num_ranks required inside the rank runner")
    n = num_ranks
    b, sq, hq, d = q.shape
    sk, hkv = k_shard.shape[1], k_shard.shape[2]
    if n == 1:
        return _normalize(shard_attention_partial(q, k_shard, v_shard,
                                                  causal=causal), q.dtype)
    me = axis_index(axis)
    flat = torch.cat([k_shard.reshape(b * sk, hkv * d),
                      v_shard.reshape(b * sk, hkv * d)], dim=1)
    gathered = all_gather_local(flat, axis=axis, num_ranks=n, method=method)
    gathered = gathered.reshape(n, b, sk, 2, hkv, d)
    q_off = me * sq
    state = shard_attention_partial(q, k_shard, v_shard, q_offset=q_off,
                                    k_offset=me * sk, causal=causal)
    for r in range(n):
        acc, m, l = shard_attention_partial(
            q, gathered[r, :, :, 0].contiguous(),
            gathered[r, :, :, 1].contiguous(), q_offset=q_off,
            k_offset=r * sk, causal=causal)
        # r == me is the diagonal chunk, already accumulated above.
        keep = float(r != me)
        state = _merge(state, (acc * keep, m, l * keep))
    return _normalize(state, q.dtype)


def run_sequence_sharded(local_fn, q, k, v, ctx: DistContext | None,
                         axis: str, causal: bool) -> list:
    """A host-level SP attention call: q/k/v (B, S, h*, d) cut into the n
    ranks' sequence shards on dim 1 (or lists of the n shards), then
    ``local_fn`` on every rank. Returns the n ranks' (B, S/n, hq, d)
    output shards."""
    ctx = ctx or get_context()
    qs, ks, vs = (rank_shards(ctx, axis, t, dim=1) for t in (q, k, v))
    n = len(qs)

    def body(r):
        dev = ctx.devices[r]
        return local_fn(qs[r].to(dev).contiguous(),
                        ks[r].to(dev).contiguous(),
                        vs[r].to(dev).contiguous(), axis=axis, num_ranks=n,
                        causal=causal)

    outs = ctx.run(body)
    ctx.raise_on_comm_error()
    return outs


def sp_ag_attention(q, k, v, ctx: DistContext | None = None,
                    axis: str = "tp", causal: bool = True) -> list:
    """Host-level SP AG attention: q/k/v (B, S, h*, d) sharded on dim 1
    (or lists of the n shards). Returns the n ranks' (B, S/n, hq, d)
    output shards."""
    return run_sequence_sharded(sp_ag_attention_local, q, k, v, ctx, axis,
                                causal)
