"""KV caches and the host page allocator — counterpart of the JAX
package's ``models/kv_cache.py`` (the parts the synchronous serving loop
uses).

The caches are tuples of tensors updated IN PLACE by the layers (JAX's
version is an immutable pytree threaded through donated jits). The page
allocator is the port's own copy of the host-side free list, without the
refcount / share / copy-on-write / reclaim hooks, which come with the
prefix-cache slice.

On a TP group (``num_ranks`` > 1) each rank holds its shard of the KV
heads — ``num_kv_heads / n`` a rank, per :func:`kv_cache_specs` /
:func:`paged_cache_specs` — while the page table and lengths are
replicated and one :class:`PageAllocator` serves every rank.
"""

from __future__ import annotations

import bisect
from typing import NamedTuple

import torch

from triton_distributed_tpu_torch.layers.common import KVSlice
from triton_distributed_tpu_torch.models.config import ModelConfig
from triton_distributed_tpu_torch.ops.paged_attention import PagedKVCache
from triton_distributed_tpu_torch.runtime.context import P
from triton_distributed_tpu_torch.runtime.device import (
    resolve_device, torch_dtype,
)


class KVCache(NamedTuple):
    """k/v: (num_layers, batch, max_seq, num_kv_heads, head_dim);
    ``offset``: tokens filled so far (a host int)."""

    k: torch.Tensor
    v: torch.Tensor
    offset: int

    @property
    def max_seq(self) -> int:
        return self.k.shape[2]

    def layer(self, i: int) -> KVSlice:
        """Views of layer ``i`` — writes through them land in this cache."""
        return KVSlice(k=self.k[i], v=self.v[i])


def _local_kv_heads(cfg: ModelConfig, num_ranks: int) -> int:
    if num_ranks < 1 or cfg.num_kv_heads % num_ranks:
        raise ValueError(f"num_kv_heads {cfg.num_kv_heads} not divisible by "
                         f"TP degree {num_ranks} — argument num_ranks")
    return cfg.num_kv_heads // num_ranks


def kv_cache_specs(axis: str = "tp") -> KVCache:
    """Partition specs of a linear cache: KV heads sharded."""
    return KVCache(k=P(None, None, None, axis, None),
                   v=P(None, None, None, axis, None), offset=P())


def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
                  device=None, *, num_ranks: int = 1) -> KVCache:
    """A zeroed linear cache on ``device`` (None: the card); at
    ``num_ranks`` > 1 one rank's shard (``num_kv_heads / n`` heads)."""
    device = resolve_device(device)
    shape = (cfg.num_layers, batch, max_seq,
             _local_kv_heads(cfg, num_ranks), cfg.head_dim)
    dt = torch_dtype(dtype or cfg.dtype)
    return KVCache(k=torch.zeros(shape, dtype=dt, device=device),
                   v=torch.zeros(shape, dtype=dt, device=device), offset=0)


class PagedModelCache(NamedTuple):
    """Per-layer paged pools + ONE page table / length vector shared by
    all layers. k_pools/v_pools: (L, num_pages, page, hkv, d);
    page_table: (B, max_pages) int32; kv_lens: (B,) int32."""

    k_pools: torch.Tensor
    v_pools: torch.Tensor
    page_table: torch.Tensor
    kv_lens: torch.Tensor

    def layer(self, i: int) -> PagedKVCache:
        """Layer ``i``'s pools as views — appends land in this cache."""
        return PagedKVCache(self.k_pools[i], self.v_pools[i],
                            self.page_table, self.kv_lens)

    @property
    def capacity(self) -> int:
        """Max positions one sequence's page allotment can hold."""
        return self.page_table.shape[1] * self.k_pools.shape[2]

    @property
    def saturated(self) -> torch.Tensor:
        """(B,) bool — sequences at capacity, whose decode steps drop the
        newest KV write."""
        return self.kv_lens >= self.capacity


class PagePoolConfigError(ValueError):
    """A paged-pool sizing parameter is invalid — raised up front,
    naming the offending field."""


class PageBudgetError(ValueError):
    """A sequence asked for more pages than its ``max_pages`` table row
    holds — the per-sequence budget, distinct from pool exhaustion (which
    :meth:`PageAllocator.alloc_pages` reports by returning None)."""


def _check_paged_pool_config(*, page_size: int, max_pages: int,
                             num_pages: int, batch: int) -> None:
    if page_size < 1:
        raise PagePoolConfigError(
            f"page_size = {page_size} invalid: a page must hold at least "
            "one position — field page_size")
    if max_pages < 1:
        raise PagePoolConfigError(
            f"max_pages = {max_pages} invalid: each sequence's page-table "
            "row needs at least one slot — field max_pages")
    if num_pages < 1:
        raise PagePoolConfigError(
            f"num_pages = {num_pages} invalid: the shared pool needs at "
            "least one page — field num_pages")
    if batch < 1:
        raise PagePoolConfigError(
            f"batch = {batch} invalid: the page table needs at least one "
            "sequence row — field batch")


def identity_page_table(batch: int, max_pages: int, num_pages: int,
                        device=None) -> torch.Tensor:
    """Sequence b owns pages ``[b*max_pages, (b+1)*max_pages) % num_pages``
    — the layout of the non-serving paths (on ``device``; None: the
    card)."""
    ids = torch.arange(batch * max_pages, dtype=torch.int32,
                       device=resolve_device(device))
    return ids.reshape(batch, max_pages) % num_pages


def paged_cache_specs(axis: str = "tp") -> PagedModelCache:
    """Partition specs of a paged cache: the pools sharded by KV head,
    the page table and lengths replicated."""
    return PagedModelCache(k_pools=P(None, None, None, axis, None),
                           v_pools=P(None, None, None, axis, None),
                           page_table=P(), kv_lens=P())


def init_paged_model_cache(cfg: ModelConfig, batch: int, *, page_size: int,
                           max_pages: int, num_pages: int | None = None,
                           dtype=None, kv_dtype=None, device=None,
                           num_ranks: int = 1) -> PagedModelCache:
    """Zeroed pools + identity page tables on ``device`` (None: the
    card), sizing validated up front. ``kv_dtype`` overrides the pools'
    storage type (``float8_e4m3fn``: half the bf16 page bytes); writers
    cast through ``models/fp8.saturate_cast``. At ``num_ranks`` > 1 the
    pools are one rank's shard (``num_kv_heads / n`` heads)."""
    device = resolve_device(device)
    num_pages = num_pages or batch * max_pages
    _check_paged_pool_config(page_size=page_size, max_pages=max_pages,
                             num_pages=num_pages, batch=batch)
    dt = torch_dtype(kv_dtype or dtype or cfg.dtype)
    shape = (cfg.num_layers, num_pages, page_size,
             _local_kv_heads(cfg, num_ranks), cfg.head_dim)
    return PagedModelCache(
        torch.zeros(shape, dtype=dt, device=device),
        torch.zeros(shape, dtype=dt, device=device),
        identity_page_table(batch, max_pages, num_pages, device),
        torch.zeros((batch,), dtype=torch.int32, device=device))


def kv_page_bytes(cfg: ModelConfig, *, page_size: int, kv_dtype=None) -> int:
    """Device bytes one pool page costs across all layers (k + v) — the
    unit of the serving tier's fixed-budget pool sizing."""
    item = torch.empty((), dtype=torch_dtype(kv_dtype or cfg.dtype)
                       ).element_size()
    return (2 * cfg.num_layers * page_size * cfg.num_kv_heads
            * cfg.head_dim * item)


def kv_pool_pages_for_budget(cfg: ModelConfig, *, page_size: int,
                             hbm_bytes: int, kv_dtype=None) -> int:
    """Pages a fixed device-memory budget buys (``hbm_bytes //
    kv_page_bytes``): e4m3 pages cost half the bf16 bytes, so the same
    budget holds twice the pages. Raises :class:`PagePoolConfigError`
    when the budget buys no page."""
    per_page = kv_page_bytes(cfg, page_size=page_size, kv_dtype=kv_dtype)
    pages = int(hbm_bytes) // per_page
    if pages < 1:
        raise PagePoolConfigError(
            f"kv_hbm_budget = {hbm_bytes} bytes buys zero pages (one "
            f"page costs {per_page} bytes across {cfg.num_layers} "
            "layers) — field kv_hbm_budget")
    return pages


class PageAllocator:
    """Host-side free-list allocator over a paged pool.

    Pages are ints in ``[0, num_pages)`` minus ``reserved``; ownership is
    tracked per ``owner`` key (a request id). :meth:`alloc_pages` raises
    :class:`PageBudgetError` when an owner would exceed ``max_pages`` and
    returns ``None`` when the pool is out of free pages — the scheduler's
    cue to preempt. The lowest free id goes first, so serving runs replay
    identically."""

    def __init__(self, num_pages: int, max_pages: int, *,
                 reserved: tuple[int, ...] = ()):
        _check_paged_pool_config(page_size=1, max_pages=max_pages,
                                 num_pages=num_pages, batch=1)
        self.num_pages = num_pages
        self.max_pages = max_pages
        self._reserved = tuple(sorted(set(reserved)))
        self._free = sorted(set(range(num_pages)) - set(reserved),
                            reverse=True)   # pop() yields the lowest id
        self._owned: dict = {}

    @property
    def reserved(self) -> tuple[int, ...]:
        return self._reserved

    @property
    def usable_pages(self) -> int:
        """Pages a sequence can ever own: the pool minus the reserved set."""
        return self.num_pages - len(self._reserved)

    @property
    def free_count(self) -> int:
        return len(self._free)

    def pages(self, owner) -> list[int]:
        """Pages owned, in allocation order — page i holds positions
        ``[i*page_size, (i+1)*page_size)`` of the owner's sequence."""
        return list(self._owned.get(owner, ()))

    def _release(self, pages) -> None:
        for p in pages:
            bisect.insort(self._free, p, key=lambda x: -x)

    def alloc_pages(self, owner, n: int = 1) -> list[int] | None:
        held = self._owned.setdefault(owner, [])
        if len(held) + n > self.max_pages:
            raise PageBudgetError(
                f"sequence {owner!r} would hold {len(held) + n} pages, "
                f"over its max_pages budget of {self.max_pages} — the "
                "admission check (prompt + max_new_tokens vs capacity) "
                "should have rejected this request")
        if len(self._free) < n:
            return None          # pool exhausted: preempt or backpressure
        got = [self._free.pop() for _ in range(n)]
        held.extend(got)
        return got

    def free_pages(self, owner) -> int:
        """Release every page the owner holds; returns the count (0 for an
        unknown owner — releasing twice is a no-op)."""
        held = self._owned.pop(owner, [])
        self._release(held)
        return len(held)

    def free_tail(self, owner, keep: int) -> int:
        """Release the owner's pages beyond the first ``keep``; returns
        the count released."""
        if keep < 0:
            raise ValueError(f"keep = {keep} invalid: a rollback keeps a "
                             "non-negative page count — argument keep")
        held = self._owned.get(owner)
        if not held or len(held) <= keep:
            return 0
        tail = held[keep:]
        del held[keep:]
        self._release(tail)
        return len(tail)
