"""Request lifecycle for the continuous-batching serving tier —
counterpart of the JAX package's ``serving/request.py``::

    WAITING ──▶ PREFILLING ──▶ RUNNING ──▶ FINISHED
                    ▲              │
                    └─ PREEMPTED ◀─┘   (pages freed; recompute-on-resume)

Transitions are validated (:meth:`Request.advance` raises on an illegal
edge); the loop stamps arrival / first-token / finish times with the clock
it owns. ``tokens`` holds every generated token (the first from the
prefill logits); ``text`` is ``prompt + tokens`` — what a (re)compute
prefills, so a preempted request resumes by prefilling ``text`` and its
final slice yields the NEXT token. The disaggregated tier's MIGRATING
state and the prefix / KV-tier bookkeeping come with their slices.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools


class RequestState(enum.Enum):
    WAITING = "waiting"
    PREFILLING = "prefilling"
    RUNNING = "running"
    PREEMPTED = "preempted"
    FINISHED = "finished"


_EDGES: dict[RequestState, tuple[RequestState, ...]] = {
    RequestState.WAITING: (RequestState.PREFILLING,),
    RequestState.PREFILLING: (RequestState.RUNNING, RequestState.PREEMPTED,
                              RequestState.FINISHED),
    RequestState.RUNNING: (RequestState.PREEMPTED, RequestState.FINISHED),
    RequestState.PREEMPTED: (RequestState.PREFILLING,),
    RequestState.FINISHED: (),
}

_IDS = itertools.count()


def _next_id() -> str:
    return f"req-{next(_IDS)}"


@dataclasses.dataclass
class Request:
    """One generation job. ``priority``: higher = preempted later (the
    scheduler evicts the lowest-priority, youngest sequence first)."""

    prompt: list[int]
    max_new_tokens: int
    priority: int = 0
    req_id: str = dataclasses.field(default_factory=_next_id)

    state: RequestState = RequestState.WAITING
    tokens: list[int] = dataclasses.field(default_factory=list)
    slot: int | None = None          # decode-batch row while active
    kv_len: int = 0                  # positions currently in the paged pool
    prefill_pos: int = 0             # tokens of ``text`` prefilled
    preemptions: int = 0
    arrival_seq: int = -1            # admission order stamp (scheduler)
    drafted_tokens: int = 0          # spec lane: draft candidates proposed
    accepted_draft_tokens: int = 0   # spec lane: drafts the verifier kept

    t_arrival: float | None = None
    t_first_token: float | None = None
    t_finish: float | None = None

    def __post_init__(self):
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens = {self.max_new_tokens} invalid: a "
                "request must generate at least one token — argument "
                "max_new_tokens")
        if len(self.prompt) < 1:
            raise ValueError("empty prompt: a request needs at least one "
                             "prompt token — argument prompt")

    def advance(self, new: RequestState) -> None:
        if new not in _EDGES[self.state]:
            raise ValueError(
                f"illegal request transition {self.state.name} -> "
                f"{new.name} for {self.req_id} (valid: "
                f"{[s.name for s in _EDGES[self.state]]})")
        self.state = new

    @property
    def done(self) -> bool:
        return len(self.tokens) >= self.max_new_tokens

    @property
    def text(self) -> list[int]:
        """prompt + generated so far — what a (re)compute prefills."""
        return list(self.prompt) + list(self.tokens)

    @property
    def final_kv_len(self) -> int:
        """KV positions at completion: the last generated token's KV is
        never written."""
        return len(self.prompt) + self.max_new_tokens - 1

    def page_budget(self, page_size: int) -> int:
        """Pages this request can ever hold."""
        return -(-self.final_kv_len // page_size)

    def pages_needed(self, page_size: int, extra: int = 0) -> int:
        """Pages required to hold ``kv_len + extra`` positions — the
        decode loop asks with ``extra=1`` (the next write), the spec lane
        with its whole candidate window."""
        return -(-(self.kv_len + extra) // page_size)

    @property
    def ttft_s(self) -> float | None:
        if self.t_first_token is None or self.t_arrival is None:
            return None
        return self.t_first_token - self.t_arrival
