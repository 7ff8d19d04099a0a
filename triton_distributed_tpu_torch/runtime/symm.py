"""Symmetric buffers — counterpart of the JAX package's
``runtime/symm.py`` (the reference's NVSHMEM symmetric heap).

A symmetric buffer is one tensor per rank, all of one shape and type,
rank r's on ``ctx.devices[r]``. On the card each rank also holds:

- a device table of the n base pointers (int64, on its own device), so a
  kernel stores to rank j's copy through ``table[j]`` — a peer's memory on
  another card (peer access enabled) or a sibling buffer on the same card
  (virtual ranks): the kernel code is the same, only the table differs;
- a signal pad of 64-bit epoch flags (zeroed once, never reset): a writer
  stores the call's epoch into a peer's flag, a waiter spins until its
  flag reaches the epoch. The flags only grow, so a persistent buffer
  needs no clearing between calls; the host keeps the epoch per rank
  (:meth:`SymmBuffer.next_epoch`), and every rank runs the same sequence
  of collectives, so the epochs agree.

Buffers are persistent: :func:`symm_zeros` caches them on the context by
(shape, dtype, tag), allocated once and never freed while the context
lives — the property the collectives' barriers and the parity stream's
barrier-free protocol rest on.

On a multi-axis group a collective over one axis allocates on the
calling rank's fiber (``runtime/context.Fiber``): the buffer's ranks,
tables and epochs are the fiber's, in fiber order, and its cache key
carries the fiber, so two fibers never share a flag.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from triton_distributed_tpu_torch.runtime.context import (
    DistContext, current_rank,
)

# 64-bit flags a rank's signal pad holds (csrc/dist.cuh kSignalWords): the
# fused GEMM kernels' barrier (128 blocks x 8 ranks) and data flags (up to
# 8 ranks x 4 sub-blocks x 128 blocks), or the push protocol's address,
# ready and data words (ops/_comm.PushLayout: 8 + 8 + 8 x 128; the torus
# AR's TorusARLayout 8 + 8 + 3 x 8 x 128).
SIGNAL_WORDS = 8192


@dataclasses.dataclass
class SymmBuffer:
    """One symmetric allocation. ``tensors[r]``: rank r's copy;
    ``table[r]``: the base pointers as rank r's device sees them;
    ``signal[r]``: rank r's flags; ``signal_table[r]``: every rank's
    signal pad base, on rank r's device. Table and signal are None on the
    CPU, where the plain versions rendezvous through the host."""

    ctx: DistContext
    tensors: list
    table: list | None
    signal: list | None
    signal_table: list | None
    epochs: list
    ready: list = dataclasses.field(default_factory=list)
    _waited: set = dataclasses.field(default_factory=set)

    def await_ready(self, rank: int) -> None:
        """Make rank ``rank``'s current stream wait, once, until every
        device's part of the buffer (zeros, tables) has landed: the
        allocation ran on whichever rank's streams asked first, and its
        peers' kernels store into every part."""
        if rank in self._waited or not self.ready:
            return
        stream = torch.cuda.current_stream(self.ctx.devices[rank])
        for ev in self.ready:
            stream.wait_event(ev)
        self._waited.add(rank)

    def call_index(self) -> int:
        """The index of the next call of a parity stream over this buffer
        for the caller: inside a rank thread of the buffer's context its
        rank's, elsewhere rank 0's (before a run every rank's is the
        same). A rank thread must not read rank 0's: rank 0 may already
        have made its call of the step."""
        try:
            ctx, rank = current_rank()
        except RuntimeError:
            return self.epochs[0]
        i = self.ctx.rank_in(ctx, rank)
        return self.epochs[0 if i is None else i]

    def next_epoch(self, rank: int) -> int:
        """The epoch of rank ``rank``'s next call on this buffer (1, 2,
        ...). The same call on every rank gets the same epoch."""
        self.epochs[rank] += 1
        return self.epochs[rank]


def _pointer_tables(ctx: DistContext, tensors) -> list:
    # From pinned memory, without a host sync: the allocating rank thread
    # must never block on the device while it holds the allocation lock
    # (a peer may be queued behind it, and its kernels wait for that peer).
    host = torch.tensor([t.data_ptr() for t in tensors],
                        dtype=torch.int64).pin_memory()
    return [host.to(d, non_blocking=True) for d in ctx.devices]


def _allocate(ctx: DistContext, shape, dtype, fill) -> SymmBuffer:
    tensors = [torch.full(tuple(shape), fill, dtype=dtype, device=d)
               for d in ctx.devices]
    n = ctx.num_ranks
    if not ctx.is_cuda:
        return SymmBuffer(ctx, tensors, None, None, None, [0] * n)
    signal = [torch.zeros(SIGNAL_WORDS, dtype=torch.int64, device=d)
              for d in ctx.devices]
    buf = SymmBuffer(ctx, tensors, _pointer_tables(ctx, tensors), signal,
                     _pointer_tables(ctx, signal), [0] * n)
    # Enqueued on the asking thread's streams: each rank's first launch
    # waits for these events (SymmBuffer.await_ready), on the device.
    for d in dict.fromkeys(ctx.devices):
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(d))
        buf.ready.append(ev)
    return buf


def symm_zeros(ctx: DistContext, shape: Sequence[int],
               dtype=torch.float32, *, tag: str = "") -> SymmBuffer:
    """The zeroed symmetric buffer of per-rank shape ``shape`` for
    (shape, dtype, tag), allocated at first use and cached on ``ctx``."""
    key = ("symm", tuple(shape), dtype, tag, 0)
    return ctx.symm_cache(key, lambda: _allocate(ctx, shape, dtype, 0))


def symm_full(ctx: DistContext, shape: Sequence[int], fill_value,
              dtype=torch.float32, *, tag: str = "") -> SymmBuffer:
    """As :func:`symm_zeros`, every element ``fill_value``."""
    key = ("symm", tuple(shape), dtype, tag, fill_value)
    return ctx.symm_cache(key,
                          lambda: _allocate(ctx, shape, dtype, fill_value))


def symm_pad(ctx: DistContext, *, tag: str) -> SymmBuffer:
    """A signal pad a rank and no payload (each rank's tensor is empty):
    the push protocol's (B4's full-mesh push, B7), whose senders write the
    receivers' own outputs. Cached on ``ctx`` by ``tag``; its epochs are
    the calls'."""
    key = ("pad", tag)
    return ctx.symm_cache(key, lambda: _allocate(ctx, (0,), torch.int64, 0))
