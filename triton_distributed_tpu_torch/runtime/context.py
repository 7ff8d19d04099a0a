"""The rank group of a tensor-parallel run — counterpart of the JAX
package's ``runtime/context.py`` (and of the named ``CommTimeoutError``
of its ``resilience/deadline.py``).

The JAX package is one process that drives a mesh: ``shard_map`` runs the
per-device function on every device, and Pallas kernels reach peers by
remote DMA. The port keeps that single-controller shape:

- :class:`DistContext` holds n ranks; rank r has a ``torch.device``, its
  own CUDA stream and its index.
- :meth:`DistContext.run` is the ``shard_map`` counterpart: it runs the
  per-rank function once per rank, each in its own host thread of a
  persistent pool. The thread sets its device and stream, and
  :func:`current_rank` tells the collectives which rank they serve. The
  threads take turns — one runs at a time, in rank order, until it
  reaches a meeting (:meth:`DistContext.meet`) — so they never contend
  for the GIL, and a meeting is where the turn passes. An exception in
  one rank aborts the others' turns, and the context is then spent:
  every later :meth:`run` raises.
- On the CPU the ranks are threads over CPU tensors, and the collectives'
  plain versions rendezvous through the symmetric buffers' slots
  (:meth:`DistContext.barrier`). On the card a rank's collective launches
  its hand-written kernel on the rank's stream; the kernel pushes to peers
  through a device table of peer pointers and waits on the peers' flags in
  device memory (``csrc/dist.cuh``).
- n virtual ranks on ONE card (``devices=["cuda:0"] * n``) are separate
  buffers and separate streams on one device, running the kernel code that
  would run across cards; only the pointer table differs. On a host with n
  cards rank r lives on ``cuda:r``, with peer access enabled.

The group has named axes, as the reference's mesh: one (``tp_axis``) by
default, or ``mesh_shape`` / ``axis_names`` — ``(2, 4), ("dcn", "tp")``
is two slices of a 4-rank TP group (the reference's DCN x ICI tiers; on
H100s, the network between hosts x NVLink). Ranks are row-major over the
axes (global rank g = a·n1 + b). A collective over one axis acts on the
calling rank's *fiber* — the ranks that differ only along that axis
(:class:`Fiber`, from :meth:`DistContext.fiber`) —, addressed by its rank
there, with symmetric buffers of its own; every rank of the group still
meets at every collective call, so the SPMD order is the group's. On a
one-axis group the fiber is the group itself.

No wait is without a deadline: a host rendezvous that sees no peer for
``wait_timeout_ms`` raises :class:`CommTimeoutError`; a kernel's spin on a
peer flag that passes the deadline writes the rank's error word and
returns, and :meth:`DistContext.raise_on_comm_error` — called where the
caller already synchronises, at step end — raises the same error.

XLA-level collectives of the JAX package (the logits' ``all_gather``,
``psum`` in the ``xla_rep`` mode, ``all_gather`` and ``psum_scatter`` in
the row-sharded ``xla`` mode, the MoE ring's ``ppermute``, the AllToAll
splits' ``all_to_all``) are plain tensor copies through the group here
(:func:`group_all_gather`, :func:`group_psum`, :func:`group_psum_scatter`,
:func:`group_ppermute`, :func:`group_all_to_all`), just as plain matmuls
stay ``torch.matmul``.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import threading
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

DEFAULT_TIMEOUT_MS = 300_000.0
TIMEOUT_ENV = "TDTPU_WAIT_TIMEOUT_MS"

_TLS = threading.local()
_GLOBAL_CONTEXT: "DistContext | None" = None


class CommTimeoutError(RuntimeError):
    """A wait on a peer passed its deadline — the named replacement for
    an endless spin. Carries what a postmortem needs: the flag or
    rendezvous (``sem``), the waiting rank, the value it waited for and
    the value it saw."""

    def __init__(self, *, sem: Any, rank: int, expected: int,
                 observed: int, waited_s: float, timeout_s: float):
        self.sem = sem
        self.rank = int(rank)
        self.expected = int(expected)
        self.observed = int(observed)
        self.waited_s = float(waited_s)
        self.timeout_s = float(timeout_s)
        super().__init__(
            f"wait deadline expired: sem={sem!r} rank={rank} expected "
            f"{expected}, observed {observed} after {waited_s:.1f}s (budget "
            f"{timeout_s:.1f}s, {TIMEOUT_ENV}) — a peer never signalled")


class P(tuple):
    """A partition spec, as the JAX package's ``PartitionSpec``: entry d
    names the axis dim d is sharded over, or None; ``P()`` is
    replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


class RankGroupError(RuntimeError):
    """The rank group is spent: an earlier run failed on some rank, so
    the peers' flags and epochs no longer agree. Build a new context."""


class _Turns:
    """The rank threads of one run take turns: exactly one runs at a
    time, in rank order. A rank gives the turn up at a meeting — to the
    next rank, or, when it is the last to arrive, it first runs the
    meeting's actions (each rank's collective launch) in rank order and
    gives the turn to rank 0. So every rank's part between two meetings
    runs whole, the threads never contend for the GIL (four busy threads
    handing it over at every torch call cost ~3x their serial time), and
    every kernel of a meeting is launched before any rank goes on: a rank
    that later blocks on the device (``cudaMalloc``, a page-locked
    allocation, a NULL-stream command) waits only for work that can
    finish. Waiting for a turn has the group's deadline."""

    def __init__(self, n: int, timeout_s: float):
        self.n = n
        self.timeout_s = timeout_s
        self.events = [threading.Event() for _ in range(n)]
        self.arrived = 0
        self.actions: list = []
        self.broken = False

    def start(self) -> None:
        for e in self.events:
            e.clear()
        self.arrived, self.actions, self.broken = 0, [], False
        self.events[0].set()

    def wait(self, rank: int, what: str) -> None:
        t0 = time.perf_counter()
        got = self.events[rank].wait(self.timeout_s)
        if self.broken:
            raise threading.BrokenBarrierError(
                f"rank {rank}: a peer failed while it waited at {what!r}")
        if not got:
            self.broken = True
            for e in self.events:
                e.set()
            raise CommTimeoutError(
                sem=what, rank=rank, expected=self.n, observed=self.arrived,
                waited_s=time.perf_counter() - t0, timeout_s=self.timeout_s)
        self.events[rank].clear()

    def meet(self, rank: int, what: str, action=None) -> None:
        if action is not None:
            self.actions.append((rank, action))
        self.arrived += 1
        if self.arrived == self.n:
            self.arrived = 0
            actions, self.actions = sorted(self.actions,
                                           key=lambda a: a[0]), []
            for _, act in actions:
                act()
            nxt = 0
        else:
            nxt = rank + 1
        if nxt != rank:
            self.events[nxt].set()
            self.wait(rank, what)

    def finish(self, rank: int) -> None:
        if rank + 1 < self.n:
            self.events[rank + 1].set()

    def abort(self) -> None:
        self.broken = True
        for e in self.events:
            e.set()


def resolve_timeout_ms(ctx_ms: float | None) -> float:
    """The wait budget in ms: ``TDTPU_WAIT_TIMEOUT_MS`` if set, else the
    context's ``wait_timeout_ms``, else 300 s. Must be positive: the port
    has no unbounded wait."""
    env = os.environ.get(TIMEOUT_ENV)
    ms = float(env) if env not in (None, "") else (
        DEFAULT_TIMEOUT_MS if ctx_ms is None else float(ctx_ms))
    if ms <= 0:
        raise ValueError(f"wait timeout {ms} ms invalid: every wait on a "
                         "peer has a positive deadline")
    return ms


def _resolve_devices(n: int | None, devices) -> list[torch.device]:
    if devices is None:
        if n is None:
            raise ValueError("initialize_distributed: give n (that many "
                             "cards) or devices — argument n")
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise RuntimeError(
                f"initialize_distributed({n}) asks for {n} cards, "
                f"{have} visible — pass devices= to place ranks explicitly "
                "(devices=['cuda:0'] * n for n virtual ranks on one card, "
                "['cpu'] * n for CPU rank threads)")
        return [torch.device("cuda", i) for i in range(n)]
    devs = [torch.device(d) for d in devices]
    if n is not None and n != len(devs):
        raise ValueError(f"n = {n} but {len(devs)} devices given — "
                         "argument n")
    if not devs:
        raise ValueError("initialize_distributed: no devices — argument "
                         "devices")
    types = {d.type for d in devs}
    if len(types) != 1 or types - {"cpu", "cuda"}:
        raise ValueError(f"devices {devs}: all ranks on CPUs or all on "
                         "cards — argument devices")
    if "cuda" in types:
        if not torch.cuda.is_available():
            raise RuntimeError(f"devices {devs} requested but "
                               "torch.cuda.is_available() is False")
        devs = [torch.device("cuda", d.index if d.index is not None
                             else torch.cuda.current_device())
                for d in devs]
    return devs


class DistContext:
    """n ranks: ``devices[r]`` is rank r's device, laid out row-major over
    the named axes (``axis_names``, ``mesh_shape``; one axis, ``tp_axis``,
    by default). Build it with :func:`initialize_distributed`."""

    def __init__(self, devices: Sequence[torch.device], *,
                 tp_axis: str = "tp", mesh_shape: Sequence[int] | None = None,
                 axis_names: Sequence[str] | None = None,
                 wait_timeout_ms: float | None = None):
        self.devices = list(devices)
        names = tuple(axis_names) if axis_names is not None else (tp_axis,)
        shape = (tuple(int(s) for s in mesh_shape) if mesh_shape is not None
                 else (len(self.devices),) if len(names) == 1 else None)
        if shape is None or len(shape) != len(names):
            raise ValueError(f"mesh_shape {mesh_shape} and axis_names "
                             f"{names} must have equal length — arguments "
                             "mesh_shape / axis_names")
        if len(set(names)) != len(names):
            raise ValueError(f"axis_names {names} repeat a name")
        if int(np.prod(shape)) != len(self.devices):
            raise ValueError(f"mesh_shape {shape} does not cover "
                             f"{len(self.devices)} ranks")
        self.axis_names = names
        self.mesh_shape = shape
        # The reference's tp_axis is the mesh's first name.
        self.tp_axis = names[0]
        self._coords = [tuple(int(c) for c in np.unravel_index(r, shape))
                        for r in range(len(self.devices))]
        self._fibers: dict = {}
        self.wait_timeout_ms = wait_timeout_ms
        self.timeout_s = resolve_timeout_ms(wait_timeout_ms) / 1e3
        n = len(self.devices)
        self.is_cuda = self.devices[0].type == "cuda"
        # Every rank on one card: n virtual ranks (separate buffers and
        # streams on one device).
        self.virtual = (self.is_cuda and n > 1
                        and len(set(self.devices)) == 1)
        self._pool: cf.ThreadPoolExecutor | None = None
        self._turns = _Turns(n, self.timeout_s)
        self._mail: list = [None] * n
        self._streams: list | None = None
        self._errors: list | None = None
        self._symm: dict = {}
        self._symm_lock = threading.Lock()
        self.failed: BaseException | None = None
        if self.is_cuda and not self.virtual and n > 1:
            _enable_peer_access(self.devices)

    # -- the mesh vocabulary of the reference --------------------------------
    @property
    def num_ranks(self) -> int:
        """Every rank of the group (on a one-axis group, the TP degree;
        on a 2-axis group the product of the axes — ``axis_size`` gives
        one axis's)."""
        return len(self.devices)

    def _axes(self, axis) -> tuple[int, ...]:
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        dims = []
        for a in names:
            if a not in self.axis_names:
                raise ValueError(f"axis {a!r} unknown: the rank group has the "
                                 f"axes {self.axis_names}")
            dims.append(self.axis_names.index(a))
        if len(set(dims)) != len(dims):
            raise ValueError(f"axis {axis!r} names an axis twice")
        return tuple(dims)

    def axis_size(self, axis) -> int:
        """The size of one axis, or for a tuple of names the product."""
        return int(np.prod([self.mesh_shape[d] for d in self._axes(axis)]))

    def coords(self, rank: int) -> tuple[int, ...]:
        """Rank ``rank``'s index along each axis: ranks are row-major over
        ``axis_names`` (global rank g = a·n1 + b on a 2-axis group, as
        ``P((ax0, ax1))`` orders them)."""
        return self._coords[rank]

    def axis_index(self, rank: int, axis) -> int:
        """Rank ``rank``'s index along ``axis``; for a tuple, its joint
        index row-major over the tuple's axes in the order given."""
        c = self.coords(rank)
        idx = 0
        for d in self._axes(axis):
            idx = idx * self.mesh_shape[d] + c[d]
        return idx

    def fiber_members(self, rank: int, axis) -> tuple[int, ...]:
        """The ranks that share every coordinate of ``rank`` off
        ``axis`` (its fiber along ``axis``), in the order of their index
        along it. The whole group for ``axis`` covering every axis."""
        dims = self._axes(axis)
        off = [d for d in range(len(self.mesh_shape)) if d not in dims]
        c = self._coords[rank]
        same = [g for g, cg in enumerate(self._coords)
                if all(cg[d] == c[d] for d in off)]
        return tuple(sorted(same, key=lambda g: self.axis_index(g, axis)))

    def fiber(self, rank: int, axis) -> "tuple[DistContext | Fiber, int]":
        """(the rank group of ``rank``'s fiber along ``axis``, its rank
        there): this context itself when the fiber is the whole group in
        rank order (every one-axis call), else a :class:`Fiber` view,
        one per fiber. Both are kept on the context: every collective
        call asks."""
        key = (rank, axis if isinstance(axis, str) else tuple(axis))
        hit = self._fibers.get(key)
        if hit is None:
            members = self.fiber_members(rank, axis)
            if members == tuple(range(self.num_ranks)):
                hit = (self, rank)
            else:
                fib = next((f for f, _ in self._fibers.values()
                            if isinstance(f, Fiber)
                            and f.members == members), None)
                hit = (fib or Fiber(self, members), members.index(rank))
            self._fibers[key] = hit
        return hit

    def ranks_on(self, device) -> int:
        """How many ranks of the group live on ``device`` (n virtual
        ranks on one card, else 1)."""
        return sum(1 for d in self.devices if d == device)

    def rank_in(self, ctx: "DistContext", rank: int) -> int | None:
        """The index of (``ctx``, ``rank``) — a rank thread's group and
        rank — in this group, or None when it is not a member."""
        return rank if ctx is self else None

    # -- per-rank CUDA state -------------------------------------------------
    def stream(self, rank: int):
        """Rank ``rank``'s CUDA stream (made by :meth:`run`)."""
        return self._streams[rank]

    def error_word(self, rank: int) -> torch.Tensor:
        """Rank ``rank``'s int64 error word on its device: 0, or the
        (flag index, expected, observed, 1) a timed-out kernel wrote.
        Made by :meth:`run`, before the rank threads start."""
        return self._errors[rank]

    def raise_on_comm_error(self) -> None:
        """Read every rank's error word (a device sync) and raise
        :class:`CommTimeoutError` for the first rank whose kernel timed
        out. Called where the caller synchronises anyway: at step end."""
        if not self.is_cuda or self._errors is None:
            return
        words = [e.cpu() for e in self._errors]
        for r, w in enumerate(words):
            if int(w[3]) != 0:
                self.failed = self.failed or RankGroupError(
                    f"rank {r}: a collective kernel timed out")
                raise CommTimeoutError(
                    sem=f"flag[{int(w[0])}]", rank=r, expected=int(w[1]),
                    observed=int(w[2]), waited_s=self.timeout_s,
                    timeout_s=self.timeout_s)

    # -- the shard_map counterpart -------------------------------------------
    def run(self, fn: Callable[[int], Any]) -> list:
        """Run ``fn(rank)`` once per rank, each in its own thread with its
        device and stream current, the threads taking turns (see
        :class:`_Turns`); returns the n results in rank order.

        On the card each rank's stream first waits for the caller's
        current stream, and the caller's stream waits for every rank's
        stream before :meth:`run` returns, so tensors cross in both
        directions without a host sync. The first rank to raise aborts
        the others' turns; its exception is re-raised here and the
        context is spent."""
        if self.failed is not None:
            raise RankGroupError(
                f"rank group spent by an earlier failure ({self.failed!r})"
                " — build a new DistContext")
        n = self.num_ranks
        if self._pool is None:
            self._pool = cf.ThreadPoolExecutor(
                max_workers=n, thread_name_prefix="tdt-rank")
        if self.is_cuda and self._streams is None:
            self._streams = _rank_streams(self.devices)
            self._errors = [torch.zeros(4, dtype=torch.int64, device=d)
                            for d in self.devices]
            for d in set(self.devices):
                torch.cuda.synchronize(d)
        callers = ([torch.cuda.current_stream(d) for d in self.devices]
                   if self.is_cuda else [None] * n)
        self._turns.start()
        futs = [self._pool.submit(self._rank_main, r, fn, callers[r])
                for r in range(n)]
        pending = set(futs)
        first = None
        while pending:
            done, pending = cf.wait(pending,
                                    return_when=cf.FIRST_EXCEPTION)
            for f in done:
                exc = f.exception()
                if exc is not None and first is None:
                    first = exc
                    self._turns.abort()
        if self.is_cuda:
            for caller, s in zip(callers, self._streams):
                caller.wait_stream(s)
        if first is not None:
            errs = [f.exception() for f in futs]
            root = next((e for e in errs if e is not None and not isinstance(
                e, threading.BrokenBarrierError)), first)
            self.failed = root
            raise root
        return [f.result() for f in futs]

    def _rank_main(self, rank: int, fn, caller_stream):
        prev = getattr(_TLS, "rank", None)
        _TLS.rank = (self, rank)
        try:
            self._turns.wait(rank, "run")
            if not self.is_cuda:
                out = fn(rank)
            else:
                torch.cuda.set_device(self.devices[rank])
                s = self.stream(rank)
                s.wait_stream(caller_stream)
                with torch.cuda.stream(s):
                    out = fn(rank)
            self._turns.finish(rank)
            return out
        except BaseException:
            self._turns.abort()
            raise
        finally:
            _TLS.rank = prev

    # -- host meetings (collective launches, plain versions, XLA-level
    # -- collectives) --------------------------------------------------------
    def meet(self, rank: int, what: str, action: Callable[[], Any] | None
             = None) -> None:
        """Every rank of the run arrives here before any goes on; the last
        to arrive first runs each rank's ``action`` (a collective kernel's
        launch), in rank order. Past the deadline a wait for the turn
        raises :class:`CommTimeoutError` naming the meeting."""
        self._turns.meet(rank, what, action)

    def barrier(self, rank: int, what: str = "barrier") -> None:
        """A meeting without an action."""
        self._turns.meet(rank, what)

    def exchange(self, rank: int, value, what: str = "exchange") -> list:
        """Every rank's ``value``, in rank order (an all-gather of host
        objects). Tensors produced on a rank's stream come with that
        stream's event, so a peer reading them waits on the device, not
        on the host."""
        if self.is_cuda and isinstance(value, torch.Tensor):
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(value.device))
            value = (value, ev)
        self._mail[rank] = value
        self.barrier(rank, what)
        vals = list(self._mail)
        self.barrier(rank, what)
        if self.is_cuda and vals and isinstance(vals[0], tuple):
            me = torch.cuda.current_stream(self.devices[rank])
            out = []
            for j, (t, ev) in enumerate(vals):
                if j != rank:
                    me.wait_event(ev)
                    # The stream this thread reads the peer's tensor on:
                    # its own, or — across cards — the current stream of
                    # the peer's card, where torch runs the copy. Its block
                    # is not reused before that read.
                    t.record_stream(torch.cuda.current_stream(t.device))
                out.append(t)
            vals = out
        return vals

    def symm_cache(self, key, make: Callable[[], Any]):
        """The context's cache of symmetric allocations, by key: ``make``
        runs once per key, under a lock, whichever rank asks first. A hit
        takes no lock, and ``make`` must not block on the device: a rank
        waiting here may be one its holder's kernels wait for."""
        hit = self._symm.get(key)
        if hit is not None:
            return hit
        with self._symm_lock:
            if key not in self._symm:
                self._symm[key] = make()
            return self._symm[key]

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None


class Fiber:
    """One fiber of a :class:`DistContext` along an axis — the ranks that
    differ only in their index along it (a TP group of one ``dcn`` slice
    on a (dcn, tp) group) — addressed by their rank in the fiber, as the
    reference's kernels address ``dl.rank(axis)``. It is what a
    collective over one axis of a multi-axis group sees: its devices,
    its size, and its own symmetric buffers (cached on the group under
    the fiber's key, so two fibers never share flags), each buffer's
    pointer table in fiber order. Meetings, exchanges and error words are
    the group's: every rank of the group meets at every collective call
    (the SPMD order is the group's), whichever fiber it serves."""

    def __init__(self, group: DistContext, members: Sequence[int]):
        self.group = group
        self.members = tuple(members)
        self.devices = [group.devices[g] for g in self.members]
        self.is_cuda = group.is_cuda
        self.virtual = group.virtual
        self.timeout_s = group.timeout_s

    @property
    def num_ranks(self) -> int:
        return len(self.members)

    def axis_size(self, axis) -> int:
        return self.group.axis_size(axis)

    def ranks_on(self, device) -> int:
        return self.group.ranks_on(device)

    def rank_in(self, ctx: DistContext, rank: int) -> int | None:
        if ctx is not self.group or rank not in self.members:
            return None
        return self.members.index(rank)

    def stream(self, i: int):
        return self.group.stream(self.members[i])

    def error_word(self, i: int) -> torch.Tensor:
        return self.group.error_word(self.members[i])

    def raise_on_comm_error(self) -> None:
        self.group.raise_on_comm_error()

    def meet(self, i: int, what: str, action: Callable[[], Any] | None
             = None) -> None:
        self.group.meet(self.members[i], what, action)

    def barrier(self, i: int, what: str = "barrier") -> None:
        self.group.barrier(self.members[i], what)

    def exchange(self, i: int, value, what: str = "exchange") -> list:
        vals = self.group.exchange(self.members[i], value, what)
        return [vals[g] for g in self.members]

    def symm_cache(self, key, make: Callable[[], Any]):
        return self.group.symm_cache(("fiber", self.members) + tuple(key),
                                     make)


def _rank_streams(devices: list[torch.device]) -> list:
    """One non-blocking stream a rank, made one after another so each
    takes its own hardware queue. Virtual ranks on one card need as many
    queues as ranks plus the caller's (``CUDA_DEVICE_MAX_CONNECTIONS``,
    default 8, read when CUDA starts): two ranks on one queue could
    deadlock — a rank's kernel queued behind a peer's kernel that waits
    for it."""
    import ctypes

    from triton_distributed_tpu_torch.ops._comm import STREAMS

    per_device: dict = {}
    for d in devices:
        per_device[d] = per_device.get(d, 0) + 1
    need = max(per_device.values()) + 1
    have = int(os.environ.get("CUDA_DEVICE_MAX_CONNECTIONS") or 8)
    if have < need:
        raise RuntimeError(
            f"{need - 1} ranks share one card but CUDA_DEVICE_MAX_"
            f"CONNECTIONS is {have}: set it to at least {need} before CUDA "
            "starts (the ranks' streams need hardware queues of their own)")
    lib = STREAMS.library()
    streams = []
    for d in devices:
        raw = ctypes.c_void_p()
        err = lib.tdt_stream_create(d.index, ctypes.byref(raw))
        if err != 0:
            raise RuntimeError(f"cudaStreamCreate on {d}: "
                               f"{lib.tdt_error_string(err).decode()}")
        streams.append(torch.cuda.ExternalStream(raw.value, device=d))
    return streams


def _enable_peer_access(devices: list[torch.device]) -> None:
    """Let every card map every other's memory (the kernels store through
    peer pointers). Raises when a pair cannot reach each other: the
    ring (``topology.ring_order``) needs every hop direct."""
    from triton_distributed_tpu_torch.ops._comm import PEER_ACCESS
    from triton_distributed_tpu_torch.runtime.topology import (
        detect_topology, ring_order,
    )

    ring_order(detect_topology(devices))
    idx = sorted({d.index for d in devices})

    lib = PEER_ACCESS.library()
    for a in idx:
        for b in idx:
            if a != b:
                err = lib.tdt_enable_peer_access(a, b)
                if err != 0:
                    raise RuntimeError(
                        f"cudaDeviceEnablePeerAccess({a} -> {b}): "
                        f"{lib.tdt_error_string(err).decode()}")


def initialize_distributed(n: int | None = None, devices=None, *,
                           mesh_shape: Sequence[int] | None = None,
                           axis_names: Sequence[str] | None = None,
                           tp_axis: str = "tp",
                           wait_timeout_ms: float | None = None
                           ) -> DistContext:
    """Build the global rank group (reference ``initialize_distributed``).

    ``devices=None`` means ``n`` cards, ``cuda:0`` .. ``cuda:n-1``, and
    raises if fewer are visible. Anything else is asked for explicitly:
    ``devices=["cuda:0"] * n`` for n virtual ranks on one card,
    ``devices=["cpu"] * n`` for CPU rank threads. Nothing drops to fewer
    ranks, to the CPU or to a plain version on its own.

    ``mesh_shape`` / ``axis_names`` (the reference's) lay the ranks out
    over named axes, row-major: ``mesh_shape=(2, 4), axis_names=("dcn",
    "tp")`` is two slices of a 4-rank TP group, global rank g = a·4 + b
    (``n`` defaults to the product). ``tp_axis`` names the one axis of a
    one-axis group; with ``axis_names`` the first name is the tp axis,
    as in the reference."""
    if n is None and devices is None and mesh_shape is not None:
        n = int(np.prod(mesh_shape))
    ctx = DistContext(_resolve_devices(n, devices), tp_axis=tp_axis,
                      mesh_shape=mesh_shape, axis_names=axis_names,
                      wait_timeout_ms=wait_timeout_ms)
    set_context(ctx)
    return ctx


def set_context(ctx: DistContext) -> None:
    global _GLOBAL_CONTEXT
    _GLOBAL_CONTEXT = ctx


def get_context() -> DistContext:
    if _GLOBAL_CONTEXT is None:
        raise RuntimeError("No distributed context: call "
                           "initialize_distributed() first")
    return _GLOBAL_CONTEXT


def group_context(ctx: DistContext | None = None) -> DistContext:
    """``ctx`` if given, else the calling rank thread's group, else the
    global one — where a per-rank state (a parity workspace) is made."""
    if ctx is not None:
        return ctx
    cur = getattr(_TLS, "rank", None)
    return cur[0] if cur is not None else get_context()


def current_rank() -> tuple[DistContext, int]:
    """(context, rank) of the calling rank thread — what a collective
    called inside :meth:`DistContext.run` serves. Raises outside one."""
    cur = getattr(_TLS, "rank", None)
    if cur is None:
        raise RuntimeError("collective called outside a rank thread: run "
                           "the per-rank function through DistContext.run "
                           "(the shard_map counterpart)")
    return cur


def axis_index(axis) -> int:
    """The calling rank thread's index along ``axis`` (the reference's
    ``jax.lax.axis_index``); for a tuple, its joint index over the
    tuple's axes, row-major."""
    ctx, rank = current_rank()
    return ctx.axis_index(rank, axis)


def _fiber_of(axis, num_ranks: int | None, what: str):
    """(fiber group, this rank's index in it, its size) of the calling
    rank along ``axis``, ``num_ranks`` checked against the size."""
    ctx, rank = current_rank()
    fib, i = ctx.fiber(rank, axis)
    n = fib.num_ranks
    if num_ranks is not None and num_ranks != n:
        raise ValueError(f"{what}: num_ranks = {num_ranks} but axis "
                         f"{axis!r} has {n} ranks — argument num_ranks")
    return fib, i, n


def group_all_gather(x: torch.Tensor, *, axis="tp",
                     num_ranks: int | None = None, dim: int = 0
                     ) -> torch.Tensor:
    """Plain all-gather through the rank group (the JAX package's
    ``jax.lax.all_gather(..., tiled=True)``): the ``x`` of every rank of
    this rank's fiber along ``axis`` (one name or a tuple), concatenated
    along ``dim`` in fiber order, on this rank's device. Every rank of
    the group meets at the call."""
    fib, i, _ = _fiber_of(axis, num_ranks, "all_gather")
    parts = fib.exchange(i, x, "all_gather")
    return torch.cat([p.to(x.device) for p in parts], dim=dim)


def group_psum(x: torch.Tensor, *, axis="tp",
               num_ranks: int | None = None) -> torch.Tensor:
    """Plain sum through the rank group (the JAX package's ``psum``): the
    fiber's ``x`` added in fiber order in ``x``'s type — every rank adds
    the same operands in the same order, so the replicas stay
    bit-identical."""
    fib, i, _ = _fiber_of(axis, num_ranks, "psum")
    parts = fib.exchange(i, x, "psum")
    acc = parts[0].to(x.device)
    for p in parts[1:]:
        acc = acc + p.to(x.device)
    return acc


def group_ppermute(x: torch.Tensor, perm, *, axis="tp",
                   num_ranks: int | None = None) -> torch.Tensor:
    """Plain permutation through the rank group (the JAX package's
    ``jax.lax.ppermute``): ``perm`` lists (source, destination) pairs of
    indices along ``axis``; this rank gets the ``x`` of the source that
    names it, or zeros when none does. Every rank calls it with the same
    ``perm``."""
    fib, i, _ = _fiber_of(axis, num_ranks, "ppermute")
    parts = fib.exchange(i, x, "ppermute")
    src = [s for s, d in perm if d == i]
    if len(src) > 1:
        raise ValueError(f"ppermute: index {i} is the destination of "
                         f"{src} — argument perm")
    return parts[src[0]].to(x.device) if src else torch.zeros_like(x)


def group_all_to_all(x: torch.Tensor, *, axis="tp",
                     num_ranks: int | None = None) -> torch.Tensor:
    """Plain all-to-all through the rank group (the JAX package's
    ``jax.lax.all_to_all(x, axis, split_axis=0, concat_axis=0,
    tiled=True)``): ``x``'s rows cut into n equal chunks, chunk p sent to
    fiber rank p; this rank's result is the chunks it received, in fiber
    order."""
    fib, i, n = _fiber_of(axis, num_ranks, "all_to_all")
    if x.shape[0] % n:
        raise ValueError(f"all_to_all: rows {x.shape[0]} not divisible by "
                         f"num_ranks {n}")
    rows = x.shape[0] // n
    parts = fib.exchange(i, x, "all_to_all")
    return torch.cat([p[i * rows:(i + 1) * rows].to(x.device)
                      for p in parts], dim=0)


def group_psum_scatter(x: torch.Tensor, *, axis="tp",
                       num_ranks: int | None = None) -> torch.Tensor:
    """Plain reduce-scatter through the rank group (the JAX package's
    ``jax.lax.psum_scatter(..., scatter_dimension=0, tiled=True)``): the
    fiber's ``x`` summed as :func:`group_psum` sums them, and this rank's
    1/n of the rows."""
    fib, i, n = _fiber_of(axis, num_ranks, "psum_scatter")
    if x.shape[0] % n:
        raise ValueError(f"psum_scatter: rows {x.shape[0]} not divisible by "
                         f"num_ranks {n}")
    rows = x.shape[0] // n
    return group_psum(x, axis=axis, num_ranks=n)[i * rows:(i + 1) * rows]
