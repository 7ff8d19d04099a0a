"""Distributed flash-decode — split-KV GQA decode with an inter-rank
combine; counterpart of the JAX package's ``ops/flash_decode.py``.

The SP/CP decode path: the KV cache is sharded over the ranks along the
sequence; every rank attends its shard, and the partials merge with
log-sum-exp rescaling. The partial over a shard is kernel K2
(``ops/paged_attention.py``, ``normalize=False``) over an identity-paged
view of the linear shard — chunk j of sequence i is pool page i·nch + j,
a reshape and no copy —, always: the reference's dense fallback for
``d % 128`` or ``s < 16`` was a VMEM limit of the TPU, with no reason on
this card. The chunk ("page") is the reference's ``pick_tile(s, 512, 8)``,
so the page table has the reference's shape.

The per-rank (acc, m, l) partials, packed as one fp32 (B·hq, d + 2)
payload, ride one of three exchanges: the barrier-free parity AllGather
(``ag_state``, kernel ``ag_parity``), B4's full-mesh push
(``method="pallas"``), or a plain gather through the rank group
(``method="xla"``, the reference's ``jax.lax.all_gather``); then they
combine in fp32.

A dead shard (kv_len = 0) reports acc = 0, m = 0, l = 0: K2's own dead
row is m = -1e30, l = 0, and the reference's contract is m = 0
(``flash_decode.py:75``).
"""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.ops._comm import rank_shards
from triton_distributed_tpu_torch.ops.allgather import (
    AllGatherMethod, all_gather_local, all_gather_stream,
)
from triton_distributed_tpu_torch.ops.paged_attention import (
    PagedKVCache, paged_decode_attention,
)
from triton_distributed_tpu_torch.ops.tiling import pick_tile
from triton_distributed_tpu_torch.runtime.context import (
    DistContext, get_context, group_all_gather,
)


def _splitkv_chunk(s: int) -> int:
    """The split-KV chunk: the reference's ``pick_tile(s, 512, 8)``."""
    return pick_tile(s, 512, 8)


def _lens(kv_len, b: int, device) -> torch.Tensor:
    """(B,) int32 valid rows from a host int or a scalar tensor (no host
    sync for a tensor)."""
    if isinstance(kv_len, torch.Tensor):
        return kv_len.to(device=device, dtype=torch.int32).reshape(
            1).expand(b).contiguous()
    return torch.full((b,), int(kv_len), dtype=torch.int32, device=device)


def _partial_decode_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_len):
    """Partial GQA attention over one KV shard — K2 with
    ``normalize=False`` over the identity-paged view of the shard.

    q: (B, hq, d); k/v: (B, S_shard, hkv, d); kv_len: valid rows (a host
    int or a scalar tensor). Returns acc (B, hq, d) fp32 (unnormalized,
    max-subtracted), m (B, hq) and l (B, hq); a dead shard gives m = 0 and
    l = 0."""
    b, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    chunk = _splitkv_chunk(s)
    nch = s // chunk

    def pool_view(x):
        return x.reshape(b * nch, chunk, hkv, d)

    table = torch.arange(b * nch, dtype=torch.int32,
                         device=q.device).reshape(b, nch)
    cache = PagedKVCache(pool_view(k), pool_view(v), table,
                         _lens(kv_len, b, q.device))
    acc, m, l = paged_decode_attention(q, cache, normalize=False)
    return acc, torch.where(l > 0, m, torch.zeros_like(m)), l


def combine_partials(accs, ms, ls) -> torch.Tensor:
    """Merge split-KV partials over dim 0 (the reference's combine): an
    online log-sum-exp across splits, a dead split (l = 0) weighing
    nothing. accs: (n, B, hq, d); ms/ls: (n, B, hq). Returns (B, hq, d)
    fp32."""
    m_all = torch.amax(torch.where(ls > 0, ms, float("-inf")), dim=0)
    m_all = torch.where(torch.isfinite(m_all), m_all,
                        torch.zeros_like(m_all))
    scale = torch.exp(ms - m_all[None]) * (ls > 0)
    l_tot = torch.sum(ls * scale, dim=0)
    acc = torch.sum(accs * scale[..., None], dim=0)
    return acc / torch.clamp(l_tot, min=1e-30)[..., None]


def flash_decode_local(q: torch.Tensor, k_shard: torch.Tensor,
                       v_shard: torch.Tensor, kv_len, *, axis: str = "tp",
                       num_ranks: int | None = None, method: str = "pallas",
                       ag_state=None):
    """Rank-local distributed flash-decode inside ``DistContext.run``.

    q: (B, hq, d), every rank's the same; k_shard/v_shard: (B, S/n, hkv,
    d), this rank's sequence shard; kv_len: valid rows in THIS shard (a
    host int or a scalar tensor; may differ per rank). Returns (B, hq, d)
    combined attention in ``q.dtype``, the same on every rank.

    ``ag_state``: (ws, call_index) from ``ops/allgather.
    ag_stream_workspace`` (shape (2, n·B·hq, d + 2), fp32) — the parity
    AllGather for the partials (the decode loop's exchange). When given,
    returns (out, ag_state')."""
    if num_ranks is None:
        raise ValueError("num_ranks required inside the rank runner")
    if ag_state is not None and method != "pallas":
        raise ValueError(
            f"method={method!r} with ag_state: the stream AG would shadow "
            "the requested path — a golden comparison would compare the "
            "stream against itself. Pass one or the other.")
    n = num_ranks
    b, hq, d = q.shape
    acc, m, l = _partial_decode_attn(q, k_shard, v_shard, kv_len)
    if n == 1:
        out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
        return (out, ag_state) if ag_state is not None else out

    payload = torch.cat([acc.reshape(b * hq, d), m.reshape(b * hq, 1),
                         l.reshape(b * hq, 1)], dim=1)
    if ag_state is not None:
        ws, idx = ag_state
        gathered, ws, idx = all_gather_stream(payload, ws, idx, axis=axis,
                                              num_ranks=n)
        ag_state = (ws, idx)
    elif method == "pallas":
        gathered = all_gather_local(payload, axis=axis, num_ranks=n,
                                    method=AllGatherMethod.FULL_MESH_PUSH)
    elif method == "xla":
        gathered = group_all_gather(payload, axis=axis, num_ranks=n)
    else:
        raise ValueError(f"unknown method {method!r}")
    gathered = gathered.reshape(n, b * hq, d + 2)
    accs = gathered[..., :d].reshape(n, b, hq, d)
    ms = gathered[..., d].reshape(n, b, hq)
    ls = gathered[..., d + 1].reshape(n, b, hq)
    out = combine_partials(accs, ms, ls).to(q.dtype)
    return (out, ag_state) if ag_state is not None else out


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_lens, ctx: DistContext | None = None, axis: str = "tp",
                 method: str = "pallas") -> list:
    """Host-level distributed flash-decode.

    q: (B, hq, d); k/v: (B, n·S_shard, hkv, d), sharded over the ranks on
    dim 1 (or lists of the n shards); kv_lens: the n shards' valid rows.
    Returns the n ranks' (B, hq, d) outputs (all equal), rank r's on
    ``ctx.devices[r]``."""
    ctx = ctx or get_context()
    ks, vs = (rank_shards(ctx, axis, t, dim=1) for t in (k, v))
    lens = [int(x) for x in kv_lens]
    n = len(ks)
    if len(lens) != n:
        raise ValueError(f"{len(lens)} lengths for {n} ranks")

    def body(r):
        dev = ctx.devices[r]
        return flash_decode_local(
            q.to(dev), ks[r].to(dev).contiguous(), vs[r].to(dev).contiguous(),
            lens[r], axis=axis, num_ranks=n, method=method)

    outs = ctx.run(body)
    ctx.raise_on_comm_error()
    return outs
