"""Per-task megakernel timeline.

The port's copy of the JAX package's ``obs/kernel_profile.py``:

* ``CompiledMegaKernel.step(..., profile=True)`` (megakernel/builder.py)
  runs the queue with an extra int32 (num_exec, 128) profile output: when
  a task begins, the kernel stamps its execution index plus its full
  queue row into row ``t`` of the dump (on the card one block writes it;
  the plain version builds the same rows). The dump is the dispatch
  record: which task types ran, in what order, addressing which
  workspace tiles. No durations are stamped, as in the reference.
* :func:`attach_durations` attaches per-task seconds from either the
  bytes/flops cost model (``estimate_task_seconds`` on the port's
  :class:`~triton_distributed_tpu_torch.runtime.perf_model.ChipSpec` —
  rendered as ``est:`` lanes) or measured per-type costs (any
  ``{type_name: seconds}`` mapping).
* :class:`KernelProfile` renders task lanes — GEMM vs attention vs
  elementwise — as chrome-trace events, one track per task class, with an
  ``unattributed/stall`` slice appended when a measured whole-step time
  exceeds the per-task sum.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Mapping

import numpy as np

from triton_distributed_tpu_torch.megakernel.tasks import TILE, WORDS, TaskType
from triton_distributed_tpu_torch.runtime.perf_model import ChipSpec, chip_spec

# One profile row per task: [exec_index, type, out, a0, b0, k_tiles,
# a_stride, b_stride, arg, c0, d0], padded to the 128-lane row the kernel
# stamps (unused lanes hold -1).
PROF_LANES = 1 + WORDS

# Perfetto lane (track) per task class.
TASK_CLASS: dict[TaskType, str] = {
    TaskType.COPY: "elementwise",
    TaskType.ADD: "elementwise",
    TaskType.SILU_MUL: "elementwise",
    TaskType.SCALE: "elementwise",
    TaskType.RMS_NORM: "norm",
    TaskType.NORM_ROPE: "norm",
    TaskType.ATTN_DECODE: "attention",
    TaskType.ATTN_DECODE_PAGED: "attention",
    TaskType.ATTN_DECODE_GQA: "attention",
    TaskType.ALLREDUCE: "allreduce",
    TaskType.GEMM_WIDE: "gemm",
    TaskType.GEMM_WIDE_W8: "gemm",
    TaskType.GEMM_MAT: "gemm",
    TaskType.PREFETCH: "prefetch",
    TaskType.PREFETCH_W8: "prefetch",
    TaskType.APPEND_KV: "kv_append",
    TaskType.MOE_TOPK: "moe",
    TaskType.MOE_FFN: "moe",
    TaskType.GEMM: "retired",
    TaskType.ROPE: "retired",
    TaskType.ADD_NORM: "norm",
    TaskType.NORM_ROPE_QKV: "norm",
    TaskType.ALLREDUCE_ROW: "allreduce",
    TaskType.PREFETCH_MAT: "prefetch",
    TaskType.ATTN_DECODE_PAGED_F8: "attention",
    TaskType.APPEND_KV_F8: "kv_append",
}

# Fixed per-task overhead the cost model charges (queue decode and issue,
# whatever the bytes); the reference's value.
FIXED_TASK_OVERHEAD_S = 2e-6


@dataclasses.dataclass
class TaskRecord:
    """One executed task, decoded from its stamped profile row."""

    seq: int                 # execution index (the queue row)
    type: int
    type_name: str
    task_class: str
    words: dict[str, int]    # the queue row, by field name
    duration_s: float | None = None
    duration_kind: str = "none"   # "estimated" | "measured" | "none"

    def to_json(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


_FIELDS = ("out", "a0", "b0", "k_tiles", "a_stride", "b_stride", "arg",
           "c0", "d0")


def decode_records(prof: Any) -> list[TaskRecord]:
    """Decode the (n_tasks, 128) int32 profile dump into records."""
    arr = np.asarray(prof)
    if arr.ndim != 2 or arr.shape[1] < PROF_LANES:
        raise ValueError(f"profile buffer shape {arr.shape} is not a "
                         f"(n_tasks, >= {PROF_LANES}) stamp dump")
    records = []
    for row in arr:
        seq, tt = int(row[0]), int(row[1])
        try:
            name = TaskType(tt).name
            cls = TASK_CLASS.get(TaskType(tt), "other")
        except ValueError:
            name, cls = f"UNKNOWN_{tt}", "other"
        words = {f: int(v) for f, v in zip(_FIELDS, row[2:2 + len(_FIELDS)])}
        records.append(TaskRecord(seq=seq, type=tt, type_name=name,
                                  task_class=cls, words=words))
    records.sort(key=lambda r: r.seq)
    return records


def records_from_queue(queue: Any, num_exec: int | None = None
                       ) -> list[TaskRecord]:
    """Decode a COMPILED queue's executable prefix into records without
    running the kernel: the queue IS the dispatch plan (task t is row t),
    so per-task accounting at build time needs no device. Rows past
    ``num_exec`` are page-table DATA and are skipped."""
    arr = np.asarray(queue)
    if arr.ndim != 2 or arr.shape[1] < 1 + len(_FIELDS):
        raise ValueError(f"queue shape {arr.shape} is not a packed "
                         "(rows, WORDS) task queue")
    n = num_exec if num_exec is not None else arr.shape[0]
    records = []
    for seq, row in enumerate(arr[:n]):
        tt = int(row[0])
        try:
            name = TaskType(tt).name
            cls = TASK_CLASS.get(TaskType(tt), "other")
        except ValueError:
            name, cls = f"UNKNOWN_{tt}", "other"
        words = {f: int(v) for f, v in zip(_FIELDS, row[1:1 + len(_FIELDS)])}
        records.append(TaskRecord(seq=seq, type=tt, type_name=name,
                                  task_class=cls, words=words))
    return records


def estimate_task_seconds(rec: TaskRecord, itemsize: int = 2,
                          spec: ChipSpec | None = None) -> float:
    """Bytes/flops roofline estimate of one task's duration.

    Deliberately coarse — it exists so a profile dump renders a readable
    timeline where no per-type measurement exists. Lanes built from it
    are labeled ``est:``; tuning should feed measured per-type costs
    through :func:`attach_durations`. A cross-card task is charged one
    NVLink push and one delivery (``ChipSpec.link_gbps`` /
    ``link_latency_s``).
    """
    spec = spec or chip_spec()
    bw = spec.hbm_gbps * 1e9
    tile_b = TILE * TILE * itemsize
    w = rec.words
    kt = max(w["k_tiles"], 1)
    t = TaskType(rec.type) if rec.type in TaskType._value2member_map_ \
        else None
    if t in (TaskType.COPY, TaskType.SCALE):
        nbytes = 2 * kt * tile_b
    elif t in (TaskType.ADD, TaskType.SILU_MUL, TaskType.RMS_NORM):
        nbytes = 3 * kt * tile_b
    elif t in (TaskType.ATTN_DECODE, TaskType.ATTN_DECODE_PAGED):
        nbytes = (2 * kt + 3) * tile_b
    elif t is TaskType.ATTN_DECODE_PAGED_F8:
        # fp8 pool pages: the 2*kt cache tiles move ONE byte per element
        # regardless of the workspace itemsize — the halved-DMA lever.
        nbytes = 2 * kt * TILE * TILE + 3 * tile_b
    elif t is TaskType.ATTN_DECODE_GQA:
        g = max(w["arg"] >> 24, 1)
        nbytes = (2 * kt + 2 * g + 3) * tile_b
    elif t in (TaskType.GEMM_WIDE, TaskType.GEMM_WIDE_W8):
        width = max(w["arg"] & 0xFFFF, 1)
        wb = 1 if t is TaskType.GEMM_WIDE_W8 else itemsize
        nbytes = (kt * tile_b + kt * width * TILE * TILE * wb
                  + 2 * width * tile_b)
    elif t is TaskType.GEMM_MAT:
        # B bytes dominate; n is not in the row, so approximate with the
        # strip the accumulator covers per chunk (kt * 1024 cols).
        nbytes = kt * tile_b + kt * TILE * 1024 * itemsize
    elif t is TaskType.ALLREDUCE:
        return (FIXED_TASK_OVERHEAD_S + 2 * spec.link_latency_s
                + 2 * tile_b / (spec.link_gbps * 1e9))
    elif t is TaskType.ALLREDUCE_ROW:
        # Whole-row slab AR: one push + one delivery per peer for k_tiles
        # contiguous tiles.
        return (FIXED_TASK_OVERHEAD_S + 2 * spec.link_latency_s
                + 2 * kt * tile_b / (spec.link_gbps * 1e9))
    elif t is TaskType.ADD_NORM:
        # reads x1 + addend + norm weight, writes x2 + xn — five row
        # passes over k_tiles tiles.
        nbytes = 5 * kt * tile_b
    elif t is TaskType.NORM_ROPE_QKV:
        # hq (k_tiles) + hkv (b_stride) head tiles read+written, plus the
        # 4 once-per-layer table tiles.
        heads = kt + max(w["b_stride"], 0)
        nbytes = (2 * heads + 4) * tile_b
    elif t is TaskType.MOE_FFN:
        e_active = 2  # topk-ish active experts; router outcome not in row
        ft = max(w["arg"] >> 16, 1)
        nbytes = (kt * tile_b
                  + e_active * (2 * kt * ft + ft * kt) * tile_b)
    elif t in (TaskType.PREFETCH, TaskType.PREFETCH_W8,
               TaskType.PREFETCH_MAT):
        # Fire-and-forget DMA issue: the transfer itself rides under the
        # tasks scheduled before the consumer (that's the point).
        return FIXED_TASK_OVERHEAD_S / 2
    elif t is TaskType.APPEND_KV:
        nbytes = 8 * tile_b
    elif t is TaskType.APPEND_KV_F8:
        # Two fp8 cache tiles round-trip (1 B/elem) + two wdt new-rows.
        nbytes = 4 * TILE * TILE + 2 * tile_b
    else:
        nbytes = 2 * kt * tile_b
    return FIXED_TASK_OVERHEAD_S + nbytes / bw


def attach_durations(records: list[TaskRecord], *, itemsize: int = 2,
                     measured: Mapping[str, float] | None = None,
                     spec: ChipSpec | None = None) -> list[TaskRecord]:
    """Attach per-task durations in place (and return the list).

    ``measured`` maps type names (``"GEMM_MAT"``) to per-task seconds.
    Types absent from ``measured`` fall back to the cost-model
    estimate.
    """
    for r in records:
        m = measured.get(r.type_name) if measured else None
        if m is not None:
            r.duration_s, r.duration_kind = float(m), "measured"
        else:
            r.duration_s = estimate_task_seconds(r, itemsize, spec)
            r.duration_kind = "estimated"
    return records


@dataclasses.dataclass
class KernelProfile:
    """A decoded per-step task timeline for one rank."""

    records: list[TaskRecord]
    rank: int = 0
    step_index: int = 0
    measured_step_s: float | None = None
    label: str = "megakernel"

    @classmethod
    def from_dump(cls, prof, *, itemsize: int = 2,
                  measured: Mapping[str, float] | None = None,
                  rank: int = 0, step_index: int = 0,
                  measured_step_s: float | None = None,
                  label: str = "megakernel") -> "KernelProfile":
        recs = attach_durations(decode_records(prof), itemsize=itemsize,
                                measured=measured)
        return cls(records=recs, rank=rank, step_index=step_index,
                   measured_step_s=measured_step_s, label=label)

    # -- rendering ----------------------------------------------------------
    def to_chrome_events(self, *, pid: int | None = None,
                         t0_us: float = 0.0) -> list[dict]:
        """Task lanes: one pid per rank, one tid (track) per task class,
        tasks laid end-to-end in execution order (the queue order, which
        the card's grid barriers keep; cumulative duration is the modeled
        timeline). An ``unattributed/stall`` slice covers any gap between
        the per-task sum and a measured whole-step time."""
        pid = pid if pid is not None else 92_000 + self.rank
        classes = sorted({r.task_class for r in self.records})
        tid_of = {c: i + 1 for i, c in enumerate(classes)}
        events: list[dict] = [
            {"name": "process_name", "ph": "M", "pid": pid,
             "args": {"name": f"megakernel tasks (rank {self.rank}, "
                              f"step {self.step_index})"}}]
        for c, tid in tid_of.items():
            events.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": tid, "args": {"name": c}})
        t = t0_us
        for r in self.records:
            dur_us = (r.duration_s or 0.0) * 1e6
            prefix = "est:" if r.duration_kind == "estimated" else ""
            events.append({
                "name": f"{prefix}{r.type_name}", "ph": "X", "pid": pid,
                "tid": tid_of[r.task_class], "ts": t,
                "dur": max(dur_us, 0.001),
                "args": {"seq": r.seq, **r.words,
                         "duration_kind": r.duration_kind}})
            t += dur_us
        if self.measured_step_s is not None:
            gap_us = self.measured_step_s * 1e6 - (t - t0_us)
            if gap_us > 0:
                tid = len(classes) + 1
                events.append({"name": "thread_name", "ph": "M", "pid": pid,
                               "tid": tid, "args": {"name": "stall"}})
                events.append({
                    "name": "unattributed/stall", "ph": "X", "pid": pid,
                    "tid": tid, "ts": t, "dur": gap_us,
                    "args": {"note": "measured step minus per-task sum"}})
        return events

    def summary(self) -> dict[str, Any]:
        """Per-class totals."""
        by_class: dict[str, dict] = {}
        for r in self.records:
            d = by_class.setdefault(
                r.task_class, {"tasks": 0, "seconds": 0.0, "kinds": set()})
            d["tasks"] += 1
            d["seconds"] += r.duration_s or 0.0
            d["kinds"].add(r.duration_kind)
        out = {c: {"tasks": d["tasks"],
                   "seconds": round(d["seconds"], 9),
                   "duration_kind": "/".join(sorted(d["kinds"]))}
               for c, d in sorted(by_class.items())}
        total = sum(d["seconds"] for d in by_class.values())
        return {"classes": out, "n_tasks": len(self.records),
                "task_sum_s": round(total, 9),
                "measured_step_s": self.measured_step_s}

    def accounting(self, *, host_s: float | None = None,
                   host_label: str = "host embed/final-norm/logits"
                   ) -> dict[str, Any]:
        """Full-model per-task accounting: the per-class table
        plus the two lanes a whole-MODEL step carries beyond the in-kernel
        queue — the host-side embed/logits work (``host_s``: measured
        whole-step minus kernel-only step) and the ``unattributed/stall``
        slice (measured kernel step minus the per-task sum). Every in-
        kernel task must land in a named class; ``unclassified`` > 0
        means a task type is missing from TASK_CLASS — the attribution
        regression the profile test gates on."""
        s = self.summary()
        classes = dict(s["classes"])
        total = s["task_sum_s"]
        out: dict[str, Any] = {
            "classes": classes, "n_tasks": s["n_tasks"],
            "task_sum_s": total,
            "measured_step_s": self.measured_step_s,
            "unclassified": sum(d["tasks"] for c, d in classes.items()
                                if c == "other"),
        }
        if self.measured_step_s is not None:
            gap = self.measured_step_s - total
            out["unattributed_stall_s"] = round(max(gap, 0.0), 9)
            out["stall_fraction"] = round(
                max(gap, 0.0) / self.measured_step_s, 6)
        if host_s is not None:
            out["host_s"] = round(host_s, 9)
            out["host_label"] = host_label
        denom = (self.measured_step_s or total) + (host_s or 0.0)
        if denom > 0:
            for c, d in classes.items():
                d["share"] = round(d["seconds"] / denom, 4)
        return out

    # -- persistence --------------------------------------------------------
    def save(self, run_dir: str) -> str:
        """Write ``<label>.r<rank>.s<step>.kernel_profile.json`` (records +
        summary) into ``run_dir``."""
        os.makedirs(run_dir, exist_ok=True)
        path = os.path.join(
            run_dir, f"{self.label}.r{self.rank}.s{self.step_index}"
                     ".kernel_profile.json")
        with open(path, "w") as f:
            json.dump({"rank": self.rank, "step_index": self.step_index,
                       "label": self.label,
                       "measured_step_s": self.measured_step_s,
                       "records": [r.to_json() for r in self.records],
                       "summary": self.summary()}, f, indent=2)
        return path


def load_profile(path: str) -> KernelProfile:
    with open(path) as f:
        data = json.load(f)
    records = [TaskRecord(**{**r, "words": dict(r["words"])})
               for r in data["records"]]
    return KernelProfile(records=records, rank=data.get("rank", 0),
                         step_index=data.get("step_index", 0),
                         measured_step_s=data.get("measured_step_s"),
                         label=data.get("label", "megakernel"))
