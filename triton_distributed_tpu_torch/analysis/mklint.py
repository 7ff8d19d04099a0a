"""mklint — static hazard verifier for megakernel task queues.

The megakernel's whole safety story is host-side: the builder's
read/write hazard sets feed the deterministic scheduler, and the paged
serving host rewrites queue WORDS (valid lengths, append targets, page
tables) between launches. None of that was checkable after the fact —
a table-rewrite race or a mis-ordered append only ever surfaced as a
token-parity diff. mklint closes the gap (the commlint move, applied to
the task-queue protocol surface):

**Compiled-artifact checks** (:func:`check_compiled`) — over the hazard
metadata the builder now exports on :class:`CompiledMegaKernel`
(``hazard_edges`` / ``task_reads`` / ``task_writes``, emission order):

* ``missing-producer`` — a tile read whose last writer is scheduled
  AFTER the reader under the emitted topo order (RAW broken);
* ``waw-hazard`` / ``war-hazard`` (``kv8-``/``w8-``/``wm-`` prefixed
  for the offset hazard spaces, e.g. the fp8 KV pool aliases) — writes
  not ordered after the previous writer / its readers;
* ``edge-order`` — an exported dependency edge the queue order ignores;
* ``schedule-cycle`` / ``schedule-divergence`` — the edge list no
  longer admits the embedded order, or the order differs from the
  canonical smallest-index Kahn schedule (cross-rank ALLREDUCE_ROW
  matches by queue POSITION, so determinism is a protocol invariant,
  checked per AR row block as ``ar-order``);
* ``prefetch-retarget`` / ``prefetch-missing`` / ``prefetch-unconsumed``
  — the three ways the single reserved warm slot per class (PREFETCH,
  PREFETCH_W8, PREFETCH_MAT) can be misused in queue order.

**Paged-step checks** (:func:`check_paged_step`) — over the host-
rewritten queue a :class:`PagedMegakernelDecoder` built for one step
(``dec.last_retarget``), plus the allocator's refcounts:

* ``append-shared-page`` — an APPEND_KV target whose refcount != 1
  (COW must have run first; the write would corrupt a sharer's KV);
* ``append-scratch`` / ``append-out-of-bounds`` / ``append-retarget``
  — an ACTIVE slot appending onto the reserved scratch page, outside
  the pool, or onto a page other than the one covering ``kv_len``;
* ``table-freed-page`` — a table DATA row a read walks (j < k_tiles)
  referencing a page with no live reference (freed/reclaimed);
* ``table-scratch-read`` / ``table-out-of-bounds`` / ``table-row-skew``
  — read coverage riding the scratch page, ids past the pool, or kT/V
  entries disagreeing on the page;
* ``kv-state-mismatch`` / ``spec-window-mismatch`` — attention fold
  words (``kv_len``/``k_tiles``/window, the spec n1/rest/col split)
  inconsistent with the slot state the rewrite claimed to encode.

The port's copy of the JAX package's ``analysis/mklint.py``, over the
port's builder (``CompiledMegaKernel.hazard_edges`` / ``task_reads`` /
``task_writes``) and ``PagedMegakernelDecoder.last_retarget``. The
refcount rules (``append-shared-page``, ``table-freed-page``) read
``ref_counts``: a ``{page: count}`` dict, or an allocator with
``ref_count``. The port's ``PageAllocator`` does not share pages, so
:func:`owned_ref_counts` gives each owned page a count of 1; the rules
see shared pages once the refcounted allocator is ported.

CLI: ``python -m triton_distributed_tpu_torch.analysis.mklint --all``
sweeps the builder matrix (:data:`COMPOSITIONS`) and exits 0 when every
composition lints clean.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from triton_distributed_tpu_torch.analysis.checker import Violation

# Violation kinds, most severe first (report ordering).
MK_KIND_ORDER = (
    "schedule-cycle",
    "missing-producer",
    "waw-hazard",
    "war-hazard",
    "kv8-waw-hazard",
    "kv8-war-hazard",
    "w8-waw-hazard",
    "w8-war-hazard",
    "wm-waw-hazard",
    "wm-war-hazard",
    "edge-order",
    "schedule-divergence",
    "ar-order",
    "prefetch-retarget",
    "prefetch-missing",
    "prefetch-unconsumed",
    "append-shared-page",
    "append-scratch",
    "append-out-of-bounds",
    "append-retarget",
    "table-freed-page",
    "table-scratch-read",
    "table-out-of-bounds",
    "table-row-skew",
    "kv-state-mismatch",
    "spec-window-mismatch",
    "no-hazard-metadata",
)


@dataclasses.dataclass
class MkReport:
    """commlint's Report shape, for one checked artifact/step."""

    op: str
    n_tasks: int
    n_edges: int
    violations: list[Violation]

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_json(self) -> dict[str, Any]:
        return {
            "op": self.op,
            "ok": self.ok,
            "n_tasks": self.n_tasks,
            "n_edges": self.n_edges,
            "violations": [v.to_json() for v in self.violations],
        }


def _rank(v: Violation) -> int:
    try:
        return MK_KIND_ORDER.index(v.kind)
    except ValueError:
        return len(MK_KIND_ORDER)


def _space(tile: int) -> str:
    from triton_distributed_tpu_torch.megakernel.builder import (
        MegaKernelBuilder as B,
    )

    if tile >= B._W8_HAZARD:
        return "w8"
    if tile >= B._WM_HAZARD:
        return "wm"
    if tile >= B._K8_HAZARD:
        return "kv8"
    return "main"


def _kind_for(space: str, base: str) -> str:
    return base if space == "main" else f"{space}-{base}"


# -- compiled-artifact checks -----------------------------------------------
def check_compiled(comp, name: str = "megakernel") -> MkReport:
    """Statically verify a CompiledMegaKernel's queue against the hazard
    metadata the builder exported on it."""
    from triton_distributed_tpu_torch.megakernel.scheduler import (
        ScheduleCycleError, topo_schedule,
    )
    from triton_distributed_tpu_torch.megakernel.tasks import TaskType

    violations: list[Violation] = []
    q = np.asarray(comp.queue)
    n_exec = int(comp.num_exec if comp.num_exec is not None else q.shape[0])
    reads, writes, rows = comp.task_reads, comp.task_writes, comp.task_rows
    edges = comp.hazard_edges
    if reads is None or writes is None or rows is None or edges is None:
        violations.append(Violation(
            kind="no-hazard-metadata",
            message="compiled artifact carries no hazard metadata "
                    "(task_reads/task_writes/task_rows/hazard_edges) — "
                    "compiled by a pre-mklint builder?"))
        return MkReport(op=name, n_tasks=n_exec, n_edges=0,
                        violations=violations)
    n = len(reads)

    def tname(tid: int) -> str:
        try:
            return TaskType(int(q[rows[tid], 0])).name
        except ValueError:
            return f"type{int(q[rows[tid], 0])}"

    def site(tid: int) -> str:
        return f"task {tid} ({tname(tid)}) @ row {rows[tid]}"

    # RAW/WAW/WAR re-derived from the exported per-task sets, emission
    # order — independent of the edge list, so a corrupted schedule shows
    # up even if the edges were corrupted consistently with it.
    last_writer: dict[int, int] = {}
    readers: dict[int, list[int]] = {}
    for tid in range(n):
        for t in reads[tid]:
            w = last_writer.get(t)
            if w is not None and rows[w] >= rows[tid]:
                violations.append(Violation(
                    kind="missing-producer",
                    message=f"tile {t & 0xFFFFFFF} ({_space(t)}) is read "
                            f"before its producer task {w} ({tname(w)}) "
                            f"executes (producer row {rows[w]} >= reader "
                            f"row {rows[tid]})",
                    site=site(tid)))
            readers.setdefault(t, []).append(tid)
        for t in writes[tid]:
            sp = _space(t)
            w = last_writer.get(t)
            if w is not None and rows[w] >= rows[tid]:
                violations.append(Violation(
                    kind=_kind_for(sp, "waw-hazard"),
                    message=f"tile {t & 0xFFFFFFF} ({sp}) is re-written "
                            f"before the previous writer task {w} "
                            f"({tname(w)}) executes",
                    site=site(tid)))
            for r in readers.get(t, []):
                if r != tid and rows[r] >= rows[tid]:
                    violations.append(Violation(
                        kind=_kind_for(sp, "war-hazard"),
                        message=f"tile {t & 0xFFFFFFF} ({sp}) is "
                                f"overwritten before reader task {r} "
                                f"({tname(r)}) consumes the previous "
                                "value",
                        site=site(tid)))
            last_writer[t] = tid
            readers[t] = []

    # Every exported dependency edge must hold under the embedded order.
    for a, b in edges:
        if rows[a] >= rows[b]:
            violations.append(Violation(
                kind="edge-order",
                message=f"dependency edge {a} -> {b} inverted in the "
                        f"queue (rows {rows[a]} >= {rows[b]})",
                site=site(b)))

    # Determinism: the embedded order must BE the canonical Kahn order —
    # cross-rank tasks match by queue position, so any divergence (a
    # scrambled task_rows, a scheduler skew) breaks the ALLREDUCE_ROW
    # positional protocol even if hazards still hold.
    try:
        canon = topo_schedule(n, list(edges))
    except ScheduleCycleError as exc:
        violations.append(Violation(kind="schedule-cycle",
                                    message=str(exc)))
    else:
        implied = sorted(range(n), key=lambda t: rows[t])
        if implied != canon:
            first = next(i for i, (a, b) in enumerate(zip(implied, canon))
                         if a != b)
            violations.append(Violation(
                kind="schedule-divergence",
                message=f"embedded order diverges from the canonical "
                        f"Kahn schedule at position {first}: task "
                        f"{implied[first]} vs {canon[first]}"))
        ar = [tid for tid in range(n)
              if int(q[rows[tid], 0]) in (int(TaskType.ALLREDUCE),
                                          int(TaskType.ALLREDUCE_ROW))]
        for i in range(1, len(ar)):
            if rows[ar[i - 1]] >= rows[ar[i]]:
                violations.append(Violation(
                    kind="ar-order",
                    message=f"cross-device tasks {ar[i - 1]} and "
                            f"{ar[i]} swapped queue positions — every "
                            "rank must dispatch them in emission order",
                    site=site(ar[i])))

    # Prefetch slots: one reserved warm slot per class, scanned in queue
    # order — produced exactly once, consumed before the next warm.
    pending: dict[str, int | None] = {"pf": None, "pf8": None, "pfm": None}
    claims = {int(TaskType.PREFETCH): "pf",
              int(TaskType.PREFETCH_W8): "pf8",
              int(TaskType.PREFETCH_MAT): "pfm"}
    for pos in range(n_exec):
        tt = int(q[pos, 0])
        slot = claims.get(tt)
        if slot is not None:
            if pending[slot] is not None:
                violations.append(Violation(
                    kind="prefetch-retarget",
                    message=f"row {pos} re-targets the {slot} warm slot "
                            f"while the warm from row {pending[slot]} is "
                            "still pending (its DMA would be clobbered "
                            "mid-flight)",
                    site=f"row {pos} ({TaskType(tt).name})"))
            pending[slot] = pos
            continue
        consume = None
        if tt == int(TaskType.GEMM_WIDE) and int(q[pos, 8]) == 1:
            consume = "pf"
        elif tt == int(TaskType.GEMM_WIDE_W8) and int(q[pos, 8]) == 1:
            consume = "pf8"
        elif tt == int(TaskType.GEMM_MAT):
            spec = comp.mat_specs[int(q[pos, 5])]
            if getattr(spec, "warm", 0):
                consume = "pfm"
        if consume is not None:
            if pending[consume] is None:
                violations.append(Violation(
                    kind="prefetch-missing",
                    message=f"row {pos} consumes the {consume} warm slot "
                            "but no prefetch is pending — it would wait "
                            "a semaphore nothing signals (or read a "
                            "stale warm)",
                    site=f"row {pos} ({TaskType(tt).name})"))
            pending[consume] = None
    for slot, pos in pending.items():
        if pos is not None:
            violations.append(Violation(
                kind="prefetch-unconsumed",
                message=f"the {slot} warm from row {pos} is never "
                        "consumed — the kernel would exit with an "
                        "outstanding DMA on the reserved slot",
                site=f"row {pos}"))

    violations.sort(key=_rank)
    return MkReport(op=name, n_tasks=n, n_edges=len(edges),
                    violations=violations)


# -- paged-step checks --------------------------------------------------------
def check_paged_step(dec, state: dict | None = None, *,
                     ref_counts=None, name: str = "paged-step") -> MkReport:
    """Verify one host-rewritten queue against the slot state it encodes
    and the allocator's page refcounts.

    ``dec``: a PagedMegakernelDecoder. ``state``: the retarget record
    (defaults to ``dec.last_retarget`` — the queue + kv_lens/tables/wins
    of the most recent step). ``ref_counts``: an allocator with
    ``ref_count`` or a plain ``{page: count}`` dict
    (:func:`owned_ref_counts`); None skips the refcount-dependent
    checks.
    """
    from triton_distributed_tpu_torch.megakernel.tasks import TILE

    violations: list[Violation] = []
    state = state if state is not None else dec.last_retarget
    if state is None:
        violations.append(Violation(
            kind="no-hazard-metadata",
            message="decoder has no retarget state to check — run a "
                    "step (or _retarget) first"))
        return MkReport(op=name, n_tasks=0, n_edges=0,
                        violations=violations)
    q = np.asarray(state["queue"])
    kv_lens, tables, wins = state["kv_lens"], state["tables"], state["wins"]
    scratch = dec.scratch
    spec = dec.spec_w > 1

    if ref_counts is None:
        rc = None
    elif hasattr(ref_counts, "ref_count"):
        rc = ref_counts.ref_count
    else:
        rc = lambda p: ref_counts.get(int(p), 0)   # noqa: E731

    n_checked = 0
    for b in range(dec.num_slots):
        kvl = int(kv_lens[b])
        win = int(wins[b]) if spec else 1
        pages = [int(p) for p in tables[b] if int(p) >= 0]
        ktiles = -(-kvl // TILE)
        active = kvl > 0 or bool(pages)
        for row, kt0, v0, trow in zip(*(a.tolist() for a in dec._attn[b])):
            n_checked += 1
            if int(q[row, 4]) != ktiles or int(q[row, 6]) != kvl:
                violations.append(Violation(
                    kind="kv-state-mismatch",
                    message=f"slot {b} attention row carries k_tiles="
                            f"{int(q[row, 4])} valid_len={int(q[row, 6])} "
                            f"but the slot state is k_tiles={ktiles} "
                            f"kv_len={kvl}",
                    site=f"slot {b} row {row}"))
            if spec and int(q[row, 5]) != win:
                violations.append(Violation(
                    kind="spec-window-mismatch",
                    message=f"slot {b} attention row folds a window of "
                            f"{int(q[row, 5])} but the slot's live "
                            f"window is {win}",
                    site=f"slot {b} row {row}"))
            ent = q[trow:trow + dec._table_rows].reshape(-1)
            for j in range(dec.max_pages):
                kt_id, v_id = int(ent[2 * j]), int(ent[2 * j + 1])
                pk, pv = kt_id - kt0, v_id - v0
                jsite = f"slot {b} table row entry {j}"
                if pk != pv:
                    violations.append(Violation(
                        kind="table-row-skew",
                        message=f"kT entry maps page {pk} but V entry "
                                f"maps page {pv} — the pair must address "
                                "the same pool page",
                        site=jsite))
                if not 0 <= pk <= scratch:
                    violations.append(Violation(
                        kind="table-out-of-bounds",
                        message=f"table entry references pool page {pk} "
                                f"outside [0, {scratch}]",
                        site=jsite))
                    continue
                if j < ktiles:
                    # A page the attention read actually walks.
                    if pk == scratch:
                        violations.append(Violation(
                            kind="table-scratch-read",
                            message=f"slot {b} reads table entry {j} "
                                    f"(k_tiles={ktiles}) but it rides "
                                    "the reserved scratch page — KV "
                                    "bytes were never mapped",
                            site=jsite))
                    elif rc is not None and rc(pk) < 1:
                        violations.append(Violation(
                            kind="table-freed-page",
                            message=f"slot {b} table entry {j} "
                                    f"references page {pk} which holds "
                                    "no live reference (freed or "
                                    "reclaimed) — use-after-free at "
                                    "the next launch",
                            site=jsite))
        # Append target(s): the page holding positions [kvl, kvl+win).
        ti, col = kvl // TILE, kvl % TILE
        want = pages[ti] if ti < len(pages) else scratch
        rows_b = list(zip(*(a.tolist() for a in dec._append[b])))
        pairs = ([(rows_b[i], rows_b[i + 1])
                  for i in range(0, len(rows_b), 2)] if spec
                 else [(r, None) for r in rows_b])
        for (row, kt0, v0), spill in pairs:
            n_checked += 1
            ap_k, ap_v = int(q[row, 1]) - kt0, int(q[row, 3]) - v0
            site_s = f"slot {b} append row {row}"
            if ap_k != ap_v:
                violations.append(Violation(
                    kind="table-row-skew",
                    message=f"append kT target page {ap_k} != V target "
                            f"page {ap_v}",
                    site=site_s))
            if not 0 <= ap_k <= scratch:
                violations.append(Violation(
                    kind="append-out-of-bounds",
                    message=f"append targets pool page {ap_k} outside "
                            f"[0, {scratch}]",
                    site=site_s))
                continue
            if not active:
                continue        # idle slots park on scratch by design
            if ap_k == scratch:
                violations.append(Violation(
                    kind="append-scratch",
                    message=f"ACTIVE slot {b} (kv_len {kvl}) appends "
                            "onto the reserved scratch page — the "
                            "token's KV would be lost",
                    site=site_s))
                continue
            if ap_k != want:
                violations.append(Violation(
                    kind="append-retarget",
                    message=f"slot {b} appends position {kvl} onto page "
                            f"{ap_k} but the table maps that position "
                            f"to page {want}",
                    site=site_s))
            if rc is not None and rc(ap_k) != 1:
                violations.append(Violation(
                    kind="append-shared-page",
                    message=f"slot {b} appends into page {ap_k} with "
                            f"refcount {rc(ap_k)} — COW must run before "
                            "a shared page is written (a sharer's KV "
                            "would be corrupted)",
                    site=site_s))
            if int(q[row, 8]) != col:
                violations.append(Violation(
                    kind="kv-state-mismatch",
                    message=f"append column {int(q[row, 8])} != kv_len "
                            f"% TILE = {col}",
                    site=site_s))
            if spill is not None:
                n1 = min(win, TILE - col)
                rest = win - n1
                row2, kt0b, v0b = spill
                if int(q[row, 4]) != n1 or int(q[row, 7]) != 0:
                    violations.append(Violation(
                        kind="spec-window-mismatch",
                        message=f"primary append row claims n={int(q[row, 4])} "
                                f"src={int(q[row, 7])} but the window "
                                f"split is n1={n1} src=0",
                        site=site_s))
                if rest > 0:
                    ap2 = int(q[row2, 1]) - kt0b
                    want2 = pages[ti + 1] if ti + 1 < len(pages) else scratch
                    if (int(q[row2, 4]) != rest or int(q[row2, 7]) != n1
                            or int(q[row2, 8]) != 0):
                        violations.append(Violation(
                            kind="spec-window-mismatch",
                            message=f"spill append row claims n="
                                    f"{int(q[row2, 4])} src={int(q[row2, 7])} "
                                    f"col={int(q[row2, 8])} but the split "
                                    f"is rest={rest} src={n1} col=0",
                            site=f"slot {b} append row {row2}"))
                    if ap2 != want2:
                        violations.append(Violation(
                            kind="append-retarget",
                            message=f"spill append targets page {ap2} "
                                    f"but position {kvl + n1} maps to "
                                    f"page {want2}",
                            site=f"slot {b} append row {row2}"))
                    elif (rc is not None and ap2 != scratch
                            and rc(ap2) != 1):
                        violations.append(Violation(
                            kind="append-shared-page",
                            message=f"spill append into page {ap2} with "
                                    f"refcount {rc(ap2)} — COW before "
                                    "append",
                            site=f"slot {b} append row {row2}"))
                elif int(q[row2, 8]) != -1:
                    violations.append(Violation(
                        kind="spec-window-mismatch",
                        message=f"window fits one tile (n1={n1}) but the "
                                "spill row is not parked (c0 != -1)",
                        site=f"slot {b} append row {row2}"))

    violations.sort(key=_rank)
    return MkReport(op=name, n_tasks=n_checked,
                    n_edges=len(dec.comp.hazard_edges or ()),
                    violations=violations)


def owned_ref_counts(alloc) -> dict[int, int]:
    """Refcounts of a ``PageAllocator`` that shares no page: 1 for each
    page an owner holds."""
    return {int(p): 1 for pages in alloc._owned.values() for p in pages}


# -- the builder-matrix sweep -------------------------------------------------
def _tiny_cfg():
    from triton_distributed_tpu_torch.models.config import ModelConfig

    return ModelConfig(hidden_size=256, intermediate_size=256, num_layers=1,
                       num_heads=2, num_kv_heads=1, head_dim=128,
                       vocab_size=512, qk_norm=True, dtype="float32")


def _build(name, **kw):
    from triton_distributed_tpu_torch.megakernel.models import (
        build_decode_step,
    )

    # The JAX builder's defaults: host-fed appends, no matrix warms.
    base = dict(hidden=256, hq_local=2, hkv_local=1, ffn_local=256,
                num_layers=1, max_seq=256, pos=100)
    force_ar = kw.pop("force_ar", False)
    base.update(kw)
    prog = build_decode_step(**base)
    return check_compiled(prog.mb.compile(force_ar=force_ar), name=name)


def _serving(name, **kw):
    """Decoder composition: compile + one real retargeted step's queue,
    both checked (the allocator's pages feed the refcount checks)."""
    import torch

    from triton_distributed_tpu_torch.megakernel.serving import (
        PagedMegakernelDecoder,
    )
    from triton_distributed_tpu_torch.megakernel.tasks import TILE
    from triton_distributed_tpu_torch.models.dense import init_dense_llm
    from triton_distributed_tpu_torch.models.kv_cache import PageAllocator

    cfg = _tiny_cfg()
    params = init_dense_llm(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    spec_w = kw.get("spec_window", 1)
    dec = PagedMegakernelDecoder(cfg, params, num_slots=2, num_pages=4,
                                 max_pages=2, device="cpu", **kw)
    alloc = PageAllocator(dec.num_pages + 1, dec.max_pages,
                          reserved=(dec.scratch,))
    pages_a = alloc.alloc_pages("a", 2)
    pages_b = alloc.alloc_pages("b", 1)
    kv_lens = [TILE + 1 if spec_w == 1 else TILE - 1, 5]
    wins = [min(spec_w, 2), 1] if spec_w > 1 else None
    tables = [pages_a, pages_b + [-1]]
    dec._retarget(kv_lens, tables, wins)
    rep = check_compiled(dec.comp, name=name)
    step = check_paged_step(dec, ref_counts=owned_ref_counts(alloc),
                            name=name)
    rep.violations.extend(step.violations)
    rep.n_tasks += step.n_tasks
    return rep


# The builder matrix the --all sweep covers: the JAX package's.
COMPOSITIONS = {
    "decode_n1_dense": lambda: _build("decode_n1_dense"),
    "decode_batch_2tile": lambda: _build("decode_batch_2tile", batch=256),
    "decode_head64": lambda: _build("decode_head64", head_dim=64),
    "decode_fp8_weights": lambda: _build("decode_fp8_weights",
                                         fp8_weights=True),
    "decode_force_ar": lambda: _build("decode_force_ar",
                                      force_ar_tasks=True, force_ar=True),
    "decode_mat_prefetch": lambda: _build("decode_mat_prefetch",
                                          mat_prefetch=True),
    "serving_paged": lambda: _serving("serving_paged"),
    "serving_fp8kv": lambda: _serving("serving_fp8kv",
                                      kv_dtype="float8_e4m3fn"),
    "serving_spec": lambda: _serving("serving_spec", spec_window=3),
}


def main(argv: list[str] | None = None) -> int:
    import argparse
    import json
    import time

    parser = argparse.ArgumentParser(
        prog="mklint",
        description="Static hazard verifier for the port's megakernel "
                    "task queues.")
    parser.add_argument("--all", action="store_true",
                        help="check every builder composition")
    parser.add_argument("--comp", action="append", default=[],
                        help="check one composition (repeatable)")
    parser.add_argument("--json", dest="json_path", default=None,
                        help="write the machine-readable report here")
    parser.add_argument("--list", action="store_true",
                        help="list compositions and exit")
    parser.add_argument("-v", "--verbose", action="store_true",
                        help="print per-violation details")
    args = parser.parse_args(argv)

    if args.list:
        for name in COMPOSITIONS:
            print(name)
        return 0

    names = (list(COMPOSITIONS) if args.all or not args.comp
             else args.comp)
    unknown = [n for n in names if n not in COMPOSITIONS]
    if unknown:
        parser.error(f"unknown compositions: {unknown}; --list shows them")

    reports = []
    failed = 0
    for name in names:
        t0 = time.time()
        try:
            rep = COMPOSITIONS[name]()
        except Exception as exc:   # a builder crash is a finding, not a pass
            failed += 1
            print(f"ERROR {name}: {type(exc).__name__}: {exc}")
            reports.append({"op": name, "ok": False,
                            "error": f"{type(exc).__name__}: {exc}"})
            continue
        dt = time.time() - t0
        reports.append(rep.to_json())
        status = "OK " if rep.ok else "FAIL"
        print(f"{status} {rep.op:24s} tasks={rep.n_tasks:4d} "
              f"edges={rep.n_edges:5d} "
              f"violations={len(rep.violations)}  [{dt:.1f}s]")
        if not rep.ok:
            failed += 1
            shown = rep.violations if args.verbose else rep.violations[:8]
            for v in shown:
                where = f" @ {v.site}" if v.site else ""
                print(f"     [{v.kind}] {v.message}{where}")
            if len(rep.violations) > len(shown):
                print(f"     ... {len(rep.violations) - len(shown)} more "
                      "(use -v)")

    if args.json_path:
        with open(args.json_path, "w") as f:
            json.dump({"ok": failed == 0, "reports": reports}, f, indent=2)
        print(f"report written to {args.json_path}")

    total = len(reports)
    print(f"mklint: {total - failed}/{total} clean")
    return 0 if failed == 0 else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
