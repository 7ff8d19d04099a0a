"""MegaKernel scheduler — the task graph's execution order.

The port's copy of the JAX package's ``megakernel/scheduler.py``: the
smallest-index-first Kahn order of its pure-Python path. The JAX package
may order through a native C++ scheduler; that one promises the same
order, so the queues the two builders emit are identical either way.
"""

from __future__ import annotations

import heapq


class ScheduleCycleError(ValueError):
    """Task graph has a dependency cycle; ``cycle`` lists the member task ids.

    ``task_types`` (when the caller supplied them) annotates each member with
    its TaskType name so the diagnostic reads ``12:GEMM_MAT -> 10:APPEND_KV``.
    """

    def __init__(self, cycle: list[int], task_types=None):
        self.cycle = list(cycle)
        if task_types is not None:
            names = []
            for t in self.cycle:
                ty = task_types[t]
                label = getattr(ty, "name", None) or str(ty)
                names.append(f"{t}:{label}")
        else:
            names = [str(t) for t in self.cycle]
        super().__init__(
            "task graph has a dependency cycle: " + " -> ".join(names + names[:1]))


def _find_cycle(n_tasks: int, edges: list[tuple[int, int]]) -> list[int]:
    """Return the task ids of one actual cycle (graph is known cyclic)."""
    succ: list[list[int]] = [[] for _ in range(n_tasks)]
    indeg = [0] * n_tasks
    for s, d in edges:
        succ[s].append(d)
        indeg[d] += 1
    # Peel acyclic fringe; what remains all sits on/feeds cycles.
    ready = [i for i in range(n_tasks) if indeg[i] == 0]
    while ready:
        t = ready.pop()
        for d in succ[t]:
            indeg[d] -= 1
            if indeg[d] == 0:
                ready.append(d)
    remaining = {i for i in range(n_tasks) if indeg[i] > 0}
    if not remaining:
        return []
    # Walk successors inside the remainder until a node repeats.
    start = min(remaining)
    seen: dict[int, int] = {}
    path: list[int] = []
    node = start
    while node not in seen:
        seen[node] = len(path)
        path.append(node)
        node = next(d for d in succ[node] if d in remaining)
    return path[seen[node]:]


def topo_schedule(
        n_tasks: int, edges: list[tuple[int, int]],
        task_types=None) -> list[int]:
    """Dependency-respecting execution order (smallest-index-first Kahn).

    Raises :class:`ScheduleCycleError` on a dependency cycle, naming the
    member task ids (and types, when ``task_types`` is given).
    """
    succ: list[list[int]] = [[] for _ in range(n_tasks)]
    indeg = [0] * n_tasks
    for s, d in edges:
        succ[s].append(d)
        indeg[d] += 1
    ready = [i for i in range(n_tasks) if indeg[i] == 0]
    heapq.heapify(ready)
    order = []
    while ready:
        t = heapq.heappop(ready)
        order.append(t)
        for d in succ[t]:
            indeg[d] -= 1
            if indeg[d] == 0:
                heapq.heappush(ready, d)
    if len(order) != n_tasks:
        raise ScheduleCycleError(_find_cycle(n_tasks, edges), task_types)
    return order
