"""Iteration-level request scheduler over the paged KV pool —
counterpart of the JAX package's ``serving/scheduler.py``, pure host
logic: admission against the free-page budget, one prefill head at a
time, page growth with preemption of the lowest-priority, youngest
sequence, and completion. The prefix-cache matching, SLO-driven
admission width and lifecycle observers come with later slices.

The loop (``serving/loop.py``) calls, per iteration:
``schedule_admissions`` → ``prefill_head`` (one chunk slice) →
``ensure_decode_pages`` → decode the ready batch.
"""

from __future__ import annotations

import enum

from triton_distributed_tpu_torch.models.kv_cache import PageAllocator
from triton_distributed_tpu_torch.serving.request import Request, RequestState


class AdmitResult(enum.Enum):
    ADMITTED = "admitted"
    QUEUE_FULL = "queue_full"


class SchedulerConfigError(ValueError):
    """A scheduler sizing parameter is invalid — named, up front."""


class RequestTooLargeError(ValueError):
    """The request can never fit its sequence's page budget — rejected
    at admission, not discovered mid-decode."""


class Scheduler:
    """Host-side continuous-batching scheduler state machine."""

    def __init__(self, *, num_slots: int, allocator: PageAllocator,
                 page_size: int, capacity_tokens: int,
                 max_waiting: int = 64):
        if num_slots < 1:
            raise SchedulerConfigError(
                f"num_slots = {num_slots} invalid: the decode batch needs "
                "at least one slot — argument num_slots (ServingEngine "
                "max_batch)")
        if max_waiting < 1:
            raise SchedulerConfigError(
                f"max_waiting = {max_waiting} invalid: the waiting queue "
                "needs at least one entry — argument max_waiting")
        if capacity_tokens < 1:
            raise SchedulerConfigError(
                f"capacity_tokens = {capacity_tokens} invalid — derived "
                "from max_pages * page_size and the prefill buffer")
        self.num_slots = num_slots
        self.allocator = allocator
        self.page_size = page_size
        self.capacity_tokens = capacity_tokens
        self.max_waiting = max_waiting
        self.waiting: list[Request] = []
        self.active: list[Request] = []  # PREFILLING + RUNNING, admit order
        self._free_slots = set(range(num_slots))
        self._seq = 0

    @property
    def active_count(self) -> int:
        return len(self.active)

    def running(self) -> list[Request]:
        return [r for r in self.active if r.state is RequestState.RUNNING]

    def has_work(self) -> bool:
        return bool(self.waiting or self.active)

    # -- admission -----------------------------------------------------------
    def admit(self, req: Request, now: float) -> AdmitResult:
        """Queue a new request, or refuse it (backpressure). Raises
        :class:`RequestTooLargeError` for a request this pool geometry can
        never serve."""
        if req.final_kv_len > self.capacity_tokens:
            raise RequestTooLargeError(
                f"request {req.req_id}: prompt {len(req.prompt)} + "
                f"max_new_tokens {req.max_new_tokens} needs "
                f"{req.final_kv_len} KV positions, over the per-sequence "
                f"capacity {self.capacity_tokens} (max_pages * page_size, "
                "bounded by the prefill buffer)")
        if req.page_budget(self.page_size) > self.allocator.usable_pages:
            raise RequestTooLargeError(
                f"request {req.req_id} needs "
                f"{req.page_budget(self.page_size)} pages at completion "
                f"but the whole pool holds {self.allocator.usable_pages} "
                "usable — it could only ever cycle through self-preemption")
        if len(self.waiting) >= self.max_waiting:
            return AdmitResult.QUEUE_FULL
        if self.allocator.free_count == 0:
            return AdmitResult.QUEUE_FULL    # pool exhausted: shed at the door
        if req.arrival_seq < 0:
            req.arrival_seq = self._seq
            self._seq += 1
            req.t_arrival = now
        self.waiting.append(req)
        return AdmitResult.ADMITTED

    def _pick_waiting(self) -> Request | None:
        if not self.waiting:
            return None
        # Highest priority first; FIFO (original admission order) within.
        return min(self.waiting, key=lambda r: (-r.priority, r.arrival_seq))

    def schedule_admissions(self) -> list[Request]:
        """WAITING/PREEMPTED → PREFILLING while a slot is free and the
        pool can reserve the full prefill scatter (ceil(len(text)/page)
        pages)."""
        admitted: list[Request] = []
        while self.waiting and self._free_slots:
            req = self._pick_waiting()
            n_pages = max(1, -(-len(req.text) // self.page_size))
            if self.allocator.alloc_pages(req.req_id, n_pages) is None:
                break                # pool short: stays queued
            self.waiting.remove(req)
            req.slot = min(self._free_slots)
            self._free_slots.discard(req.slot)
            req.prefill_pos = 0
            req.kv_len = 0
            req.advance(RequestState.PREFILLING)
            self.active.append(req)
            admitted.append(req)
        return admitted

    def prefill_head(self) -> Request | None:
        """The one request whose prefill advances this iteration (oldest
        admitted first, so the shared prefill buffer holds one prompt)."""
        for r in self.active:
            if r.state is RequestState.PREFILLING:
                return r
        return None

    # -- preemption / page growth -------------------------------------------
    def _preempt(self, req: Request) -> None:
        self.allocator.free_pages(req.req_id)
        if req.slot is not None:
            self._free_slots.add(req.slot)
        req.slot = None
        req.kv_len = 0
        req.prefill_pos = 0
        req.preemptions += 1
        req.advance(RequestState.PREEMPTED)
        self.active.remove(req)
        self.waiting.append(req)

    def _victim(self) -> Request | None:
        """Lowest priority, then youngest (latest admission)."""
        if not self.active:
            return None
        return min(self.active, key=lambda r: (r.priority, -r.arrival_seq))

    def ensure_decode_pages(self, extra: dict | None = None
                            ) -> tuple[list[Request], list[Request]]:
        """Grow each running sequence's pages to cover its next KV write,
        preempting under page pressure. Returns (ready-to-decode requests
        in slot order, preempted victims). ``extra`` maps req_id → tokens
        this step appends (default 1): the spec lane reserves its whole
        candidate window and releases the unused tail after acceptance
        (``PageAllocator.free_tail``)."""
        preempted: list[Request] = []
        ready: list[Request] = []
        for req in sorted(self.running(), key=lambda r: r.slot):
            if req.state is not RequestState.RUNNING:
                continue             # preempted by an earlier slot's growth
            ok = True
            need = 1 if extra is None else max(1, extra.get(req.req_id, 1))
            while len(self.allocator.pages(req.req_id)) \
                    < req.pages_needed(self.page_size, extra=need):
                if self.allocator.alloc_pages(req.req_id, 1) is not None:
                    continue
                victim = self._victim()
                if victim is None or victim is req:
                    # Nothing lower-priority to evict: this sequence
                    # yields its own pages and resumes later.
                    self._preempt(req)
                    preempted.append(req)
                    ok = False
                    break
                self._preempt(victim)
                preempted.append(victim)
                if victim in ready:
                    ready.remove(victim)
            if ok:
                ready.append(req)
        return ready, preempted

    # -- completion ----------------------------------------------------------
    def finish(self, req: Request, now: float) -> None:
        self.allocator.free_pages(req.req_id)
        if req.slot is not None:
            self._free_slots.add(req.slot)
        req.slot = None
        req.t_finish = now
        req.advance(RequestState.FINISHED)
        if req in self.active:
            self.active.remove(req)
