"""KV migration — paged blocks streamed from a prefill slice to a decode
slice; counterpart of the JAX package's ``disagg/migrate.py``, with its
kernel B13 (``_pack_kernel``, ``_scatter_kernel``) as the hand-written
CUDA kernels ``migrate_pack`` and ``migrate_scatter`` of
``csrc/migrate.cu``.

Two forms share the protocol:

* :class:`MigrationStream` — the host-driven transport: per-block (k, v)
  arrays packed on the prefill side cross through ``put`` and land in the
  decode pool through the caller's ``scatter`` at the DECODE allocator's
  page ids (the page-table rewrite). Double-buffered: block b+1 is sent
  before block b lands. Per-block checksums (fp32 sums, taken on the
  sending side) are verified after landing
  (:class:`MigrationIntegrityError`), the block count is audited at the
  end (:class:`MigrationError` on a lost block), and a stream past its
  deadline raises :class:`MigrationTimeoutError` — all named, and
  ``transient``.
* :func:`kv_migrate_local` — the single-program form over a 2-axis
  (inter, intra) group: the source slice packs its pool pages into a
  contiguous send buffer (``migrate_pack``), each block crosses the inter
  axis through the group's ``group_ppermute`` (where the reference calls
  ``jax.lax.ppermute``), and the destination slice writes each arrival
  into its pool at the rewritten page ids (``migrate_scatter``). Each
  intra rank exchanges with the same intra rank of the peer slice, so
  the pools' KV-head shards line up on both roles.

On a CUDA tensor the pack and the scatter launch their kernels (counted
in ``MIGRATE_PACK_KERNEL`` / ``MIGRATE_SCATTER_KERNEL``); on a CPU tensor
they run the plain versions. Env knobs: ``TDTPU_MIGRATE_TIMEOUT_MS``
(default 300 s, 0 disables), ``TDTPU_MIGRATE_VERIFY`` (=0 skips the
checksums).
"""

from __future__ import annotations

import ctypes
import os
import time
from typing import Callable, Sequence

import torch

from triton_distributed_tpu_torch.runtime.build import (
    CudaKernel, current_stream, ptr,
)
from triton_distributed_tpu_torch.runtime.context import (
    axis_index, group_ppermute,
)

MIGRATE_PACK_KERNEL = CudaKernel(
    "migrate.cu", "tdt_migrate_pack",
    [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                             ctypes.c_void_p])
MIGRATE_SCATTER_KERNEL = CudaKernel(
    "migrate.cu", "tdt_migrate_scatter",
    [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                             ctypes.c_void_p])
MIGRATE_KERNELS = (MIGRATE_PACK_KERNEL, MIGRATE_SCATTER_KERNEL)


class MigrationError(RuntimeError):
    """A KV-migration stream failed in a named way (lost block, integrity
    mismatch, deadline) — ``transient`` by design, so a serving tier can
    fall back to monolithic serving instead of dying mid-request."""

    transient = True


class MigrationIntegrityError(MigrationError):
    """A migrated block's checksum after landing does not match the one
    taken on the sending side: the pages must not join the decode
    batch."""


class MigrationTimeoutError(MigrationError):
    """The stream passed its deadline with blocks still in flight — a
    hang turned into a named error."""


def migrate_timeout_s() -> float:
    """The stream deadline in seconds (``TDTPU_MIGRATE_TIMEOUT_MS``,
    default 300 s; 0 disables)."""
    try:
        ms = float(os.environ.get("TDTPU_MIGRATE_TIMEOUT_MS", "") or 300_000)
    except ValueError:
        ms = 300_000.0
    return ms / 1e3


def migrate_verify() -> bool:
    return os.environ.get("TDTPU_MIGRATE_VERIFY", "1") != "0"


def _blocks(n_pages: int, block_pages: int) -> list[tuple[int, int]]:
    """(start, count) page ranges a block. The default caller passes
    ``block_pages = ceil(n_pages / 2)``: two blocks, the double buffer."""
    return [(s, min(block_pages, n_pages - s))
            for s in range(0, n_pages, block_pages)]


def _checksum(k: torch.Tensor, v: torch.Tensor) -> float:
    # An fp32 sum of both halves: the transport moves bytes, not math, so
    # any flipped payload shows up as a different sum after landing.
    return float(k.float().sum() + v.float().sum())


class MigrationStream:
    """One request's paged KV blocks in flight, prefill pool → decode
    pool (the host-driven transport between the two roles).

    Args:
      blocks_kv: per-block ``(k, v)`` tensors already packed on the
        prefill side.
      dst_pages: the decode pool's page ids per block (the DECODE
        allocator's, in block order) — the page-table rewrite.
      put: ``put((k, v)) -> (k, v)`` moving a pair to the decode side.
      chaos_hook: fault injection, called per landed block as
        ``hook(block_idx, (k, v)) -> (k, v) | None``: ``None`` is a
        dropped block, a changed pair a corrupted one, a sleeping hook a
        delay.
    """

    def __init__(self, req_id: str, blocks_kv: Sequence[tuple],
                 dst_pages: Sequence[Sequence[int]], put: Callable,
                 *, verify: bool | None = None,
                 timeout_s: float | None = None,
                 clock=time.perf_counter,
                 chaos_hook: Callable | None = None):
        if len(blocks_kv) != len(dst_pages):
            raise ValueError(
                f"migration stream for {req_id}: {len(blocks_kv)} blocks "
                f"but {len(dst_pages)} destination page groups")
        self.req_id = req_id
        self.n_blocks = len(blocks_kv)
        self.dst_pages = [list(p) for p in dst_pages]
        self.verify = migrate_verify() if verify is None else verify
        self.timeout_s = (migrate_timeout_s() if timeout_s is None
                          else timeout_s)
        self.clock = clock
        self.t_start = clock()
        self.bytes_moved = 0
        self.pages_moved = 0
        self._put = put
        self._chaos = chaos_hook
        self._pending = list(enumerate(blocks_kv))   # not yet sent
        self._in_flight: list = []                   # sent, not landed
        self._landed = 0
        self._checksums: dict[int, float] = {}
        if self.verify:
            for i, (k, v) in enumerate(blocks_kv):
                self._checksums[i] = _checksum(k, v)

    @property
    def done(self) -> bool:
        return not self._pending and not self._in_flight

    def _check_deadline(self) -> None:
        if self.timeout_s and self.clock() - self.t_start > self.timeout_s:
            raise MigrationTimeoutError(
                f"migration of {self.req_id} exceeded its deadline "
                f"({self.timeout_s:g} s) with "
                f"{len(self._pending) + len(self._in_flight)} of "
                f"{self.n_blocks} blocks unlanded — a wedged stream "
                "must become a named error, never a hang "
                "(TDTPU_MIGRATE_TIMEOUT_MS)")

    def advance(self, scatter: Callable) -> bool:
        """One double-buffer rotation: send the next block, then land the
        OLDEST block in flight through ``scatter(block_idx, (k, v),
        dst_pages)`` — so one block is always crossing while the previous
        one lands. Returns ``done``. Raises the named
        :class:`MigrationError` family on loss, corruption or deadline."""
        self._check_deadline()
        if self._pending:
            idx, kv = self._pending.pop(0)
            self._in_flight.append((idx, self._put(kv)))
        # Land a block once the pipeline is primed (or draining).
        if self._in_flight and (len(self._in_flight) >= 2
                                or not self._pending):
            idx, kv = self._in_flight.pop(0)
            if self._chaos is not None:
                kv = self._chaos(idx, kv)
                self._check_deadline()     # a delaying hook can expire it
            if kv is None:
                raise MigrationError(
                    f"migration of {self.req_id}: block {idx} lost in "
                    f"transit ({self._landed} of {self.n_blocks} landed) "
                    "— stream incomplete, pages must not join the "
                    "decode batch")
            k, v = kv
            if self.verify:
                got = _checksum(k, v)
                want = self._checksums[idx]
                if got != want:
                    raise MigrationIntegrityError(
                        f"migration of {self.req_id}: block {idx} "
                        f"checksum mismatch after the hop (sent {want!r}, "
                        f"landed {got!r}) — corrupt payload detected "
                        "before entering the decode pool")
            scatter(idx, (k, v), self.dst_pages[idx])
            self._landed += 1
            self.pages_moved += len(self.dst_pages[idx])
            self.bytes_moved += int(k.numel() * k.element_size()
                                    + v.numel() * v.element_size())
        if self.done and self._landed != self.n_blocks:
            raise MigrationError(
                f"migration of {self.req_id}: only {self._landed} of "
                f"{self.n_blocks} blocks landed — stream incomplete")
        return self.done

    def finish_metrics(self) -> None:
        """Refused by name: the migration lane's counters live in
        ``obs/metrics``, which the port does not have yet."""
        raise NotImplementedError(
            "MigrationStream.finish_metrics publishes into obs/metrics, "
            "which is not ported — read bytes_moved / pages_moved instead")


# ---------------------------------------------------------------------------
# Kernel B13 and its plain versions.
# ---------------------------------------------------------------------------

def _pages_view(t: torch.Tensor, page_rows: int) -> torch.Tensor:
    """A (rows, C) tensor's bytes as (pages, page_rows · C · itemsize):
    the plain versions are byte copies, in any type."""
    return t.contiguous().view(torch.uint8).reshape(t.shape[0] // page_rows,
                                                    -1)


def pack_plain(pool: torch.Tensor, pages: Sequence[int],
               page_rows: int) -> torch.Tensor:
    """Plain version of ``migrate_pack``: pool pages ``pages`` (of
    ``page_rows`` rows each) stacked in list order."""
    idx = torch.tensor(list(pages), dtype=torch.long, device=pool.device)
    out = _pages_view(pool, page_rows).index_select(0, idx)
    return out.view(pool.dtype).reshape(len(pages) * page_rows,
                                        pool.shape[1])


def scatter_plain(pool: torch.Tensor, buf: torch.Tensor,
                  pages: Sequence[int], page_rows: int) -> torch.Tensor:
    """Plain version of ``migrate_scatter``: a copy of ``pool`` with the
    buffer's page i at pool page ``pages[i]``."""
    out = pool.clone()
    idx = torch.tensor(list(pages), dtype=torch.long, device=pool.device)
    _pages_view(out, page_rows).index_copy_(0, idx,
                                            _pages_view(buf, page_rows))
    return out


def _page_ids(pages: Sequence[int], device) -> torch.Tensor:
    # From pinned memory, without a host sync (the caller may be a rank
    # thread whose peers wait on its stream).
    host = torch.tensor(list(pages), dtype=torch.int32).pin_memory()
    return host.to(device, non_blocking=True)


def _check_pool(pool: torch.Tensor, page_rows: int, what: str) -> int:
    """The pool's page bytes; the kernels copy whole 16-byte vectors."""
    if pool.dim() != 2 or not pool.is_contiguous():
        raise ValueError(f"{what}: the pool must be a contiguous 2-D "
                         f"(P·page_rows, C) tensor, got {tuple(pool.shape)}")
    page_bytes = page_rows * pool.shape[1] * pool.element_size()
    if page_bytes % 16 or pool.data_ptr() % 16:
        raise ValueError(f"{what}: a page of {page_bytes} bytes is not "
                         "whole 16-byte vectors")
    return page_bytes


def _check_pages(pool: torch.Tensor, pages: Sequence[int], page_rows: int,
                 name: str, *, distinct: bool = False) -> None:
    """Every id inside the pool's pages, and with ``distinct`` no id
    twice: the kernels skip an id out of range (its rows left unwritten)
    and race on a repeated destination, so the wrappers refuse both on
    the host list."""
    cap = pool.shape[0] // page_rows
    bad = [p for p in pages if not 0 <= p < cap]
    if bad:
        raise ValueError(f"{name} {bad} outside the pool's {cap} pages")
    if distinct and len(set(pages)) != len(pages):
        raise ValueError(f"duplicate destination page in {tuple(pages)}")


def pack_pages(pool: torch.Tensor, pages: Sequence[int],
               page_rows: int) -> torch.Tensor:
    """Gather ``pages`` of the flattened pool (P·page_rows, C) into a
    contiguous (len(pages)·page_rows, C) send buffer: ``migrate_pack`` on
    a CUDA tensor, :func:`pack_plain` on a CPU one. An id out of range
    raises ``ValueError``."""
    _check_pages(pool, pages, page_rows, "pages")
    if pool.device.type == "cpu":
        MIGRATE_PACK_KERNEL.count_plain()
        return pack_plain(pool, pages, page_rows)
    if pool.device.type != "cuda":
        raise ValueError(f"migrate pack: no kernel for device {pool.device}")
    page_bytes = _check_pool(pool, page_rows, "migrate pack")
    out = torch.empty((len(pages) * page_rows, pool.shape[1]),
                      dtype=pool.dtype, device=pool.device)
    ids = _page_ids(pages, pool.device)
    with torch.cuda.device(pool.device):
        MIGRATE_PACK_KERNEL.launch(ptr(pool), ptr(ids), ptr(out), page_bytes,
                                   len(pages), pool.shape[0] // page_rows,
                                   current_stream(pool.device))
    return out


def scatter_pages(pool: torch.Tensor, buf: torch.Tensor,
                  pages: Sequence[int], page_rows: int) -> torch.Tensor:
    """A new pool: ``pool`` copied through, the buffer's page i written
    at page ``pages[i]``. ``migrate_scatter`` on a CUDA tensor,
    :func:`scatter_plain` on a CPU one; ``pool`` is not changed. An id out
    of range or given twice raises ``ValueError``."""
    _check_pages(pool, pages, page_rows, "pages", distinct=True)
    if pool.device.type == "cpu":
        MIGRATE_SCATTER_KERNEL.count_plain()
        return scatter_plain(pool, buf, pages, page_rows)
    if pool.device.type != "cuda":
        raise ValueError(f"migrate scatter: no kernel for device "
                         f"{pool.device}")
    page_bytes = _check_pool(pool, page_rows, "migrate scatter")
    if (buf.device != pool.device or buf.dtype != pool.dtype
            or tuple(buf.shape) != (len(pages) * page_rows, pool.shape[1])):
        raise ValueError(f"migrate scatter: buffer {tuple(buf.shape)} "
                         f"{buf.dtype} on {buf.device} does not hold "
                         f"{len(pages)} pages of the pool's")
    buf = buf.contiguous()
    out = torch.empty_like(pool)
    ids = _page_ids(pages, pool.device)
    with torch.cuda.device(pool.device):
        MIGRATE_SCATTER_KERNEL.launch(
            ptr(pool), ptr(buf), ptr(ids), ptr(out), page_bytes, len(pages),
            pool.shape[0] // page_rows, current_stream(pool.device))
    return out


# ---------------------------------------------------------------------------
# The single-program form.
# ---------------------------------------------------------------------------

def kv_migrate_local(pool_src: torch.Tensor, pool_dst: torch.Tensor,
                     src_pages: Sequence[int], dst_pages: Sequence[int],
                     *, inter_axis: str = "dcn",
                     n_inter: int | None = None,
                     src_slice: int = 0, dst_slice: int = 1,
                     block_pages: int | None = None,
                     page_rows: int | None = None) -> torch.Tensor:
    """Rank-local KV-page migration inside ``DistContext.run`` over a
    2-axis (inter, intra) group: the ``src_slice`` packs ``src_pages`` of
    its pool, the blocks cross ``inter_axis``, and the ``dst_slice``
    writes each arrival into its pool at ``dst_pages`` — the page-table
    rewrite. Each intra rank exchanges with the same intra rank of the
    peer slice.

    pool_src / pool_dst: (P·page_rows, C) flattened page pools (the two
    may hold different page counts); ``page_rows`` (required): the rows
    of one page. Returns the destination slice's new pool (the unchanged
    rows kept, ``pool_dst`` itself not changed); every other slice gets
    its ``pool_dst`` back. Blocks of ``block_pages`` (default: half the
    pages, two blocks) rotate double-buffered: block b+1 is packed and
    sent before block b lands. Every rank calls it with the same
    arguments (the exchange is a meeting of the group)."""
    if n_inter is None:
        raise ValueError("n_inter required inside the rank runner")
    if page_rows is None:
        raise ValueError("page_rows required (rows per page in the "
                         "flattened 2-D pool)")
    src_pages = tuple(int(p) for p in src_pages)
    dst_pages = tuple(int(p) for p in dst_pages)
    if len(src_pages) != len(dst_pages):
        raise ValueError(
            f"src_pages ({len(src_pages)}) and dst_pages "
            f"({len(dst_pages)}) must pair one-to-one")
    if not src_pages:
        return pool_dst
    n_pages = len(src_pages)
    _check_pages(pool_src, src_pages, page_rows, "src_pages")
    _check_pages(pool_dst, dst_pages, page_rows, "dst_pages", distinct=True)
    bp = block_pages if block_pages is not None else -(-n_pages // 2)
    if bp < 1:
        raise ValueError(f"block_pages = {bp} invalid: a block moves at "
                         "least one page")
    if pool_src.shape[1] != pool_dst.shape[1] or (
            pool_src.dtype != pool_dst.dtype):
        raise ValueError(f"pools differ in row shape or type: "
                         f"{tuple(pool_src.shape)} {pool_src.dtype} vs "
                         f"{tuple(pool_dst.shape)} {pool_dst.dtype}")
    cols = pool_src.shape[1]
    me_inter = axis_index(inter_axis)
    perm = ((src_slice, dst_slice),)
    # Each rank does the work whose result it keeps: the source slice
    # packs, the destination slice writes its pool; every rank meets at
    # each block's exchange.
    out = pool_dst
    landed_prev = None
    for s, c in _blocks(n_pages, bp):
        if me_inter == src_slice:
            payload = pack_pages(pool_src, src_pages[s:s + c], page_rows)
        else:
            payload = torch.empty((c * page_rows, cols), dtype=pool_src.dtype,
                                  device=pool_src.device)
        sent = group_ppermute(payload, perm, axis=inter_axis,
                              num_ranks=n_inter)
        if landed_prev is not None and me_inter == dst_slice:
            (ps, pc), buf = landed_prev
            out = scatter_pages(out, buf, dst_pages[ps:ps + pc], page_rows)
        landed_prev = ((s, c), sent)
    if me_inter == dst_slice:
        (ps, pc), buf = landed_prev
        out = scatter_pages(out, buf, dst_pages[ps:ps + pc], page_rows)
    return out
