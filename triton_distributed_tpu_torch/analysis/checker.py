"""The violation and report shapes the analysis tools share.

The port's copy of the data half of the JAX package's
``analysis/checker.py`` (its semaphore-protocol checker replays
multi-rank kernels and waits for them).
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class Violation:
    kind: str
    message: str
    rank: int | None = None
    sem: str | None = None
    site: str = ""

    def to_json(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Report:
    op: str
    axes: tuple[str, ...]
    dims: tuple[int, ...]
    violations: list[Violation]
    n_events: int
    n_kernels: int

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_json(self) -> dict[str, Any]:
        return {
            "op": self.op,
            "mesh": dict(zip(self.axes, self.dims)),
            "ok": self.ok,
            "n_events": self.n_events,
            "n_kernels": self.n_kernels,
            "violations": [v.to_json() for v in self.violations],
        }
