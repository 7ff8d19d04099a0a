"""The persistent megakernel — one launch runs the whole task queue.

Counterpart of the JAX package's ``megakernel/kernel.py``. The TPU kernel
there (``_mega_kernel``: the Pallas grid IS the queue loop, one task per
grid step, a ``lax.switch`` over ~26 handlers) becomes the hand-written
CUDA interpreter ``csrc/megakernel.cu``: one cooperative launch whose
blocks all walk the queue, each task's work spread over the blocks, grid
barriers where the builder's hazard edges need them (see that file's
header). It handles :data:`PORTED_TYPES`: the task types of the paged
serving program — with e4m3 pools (types 24/25 over the kv8 workspace)
and the speculative window (the causal fold of types 9/24, the windowed
append of 14/25) — and of the linear decode programs in both weight
layouts (GQA / single-head attention over a linear cache, GEMM_WIDE and
GEMM_WIDE_W8 over weight tiles with their PREFETCH / PREFETCH_W8 warms,
per-head NORM_ROPE, ADD_NORM and the row-wise elementwise types), and the
Qwen3-MoE FFN's MOE_TOPK and MOE_FFN, on 1 to TILE live rows a block,
and the cross-rank ALLREDUCE / ALLREDUCE_ROW of a program compiled for a
TP group (the TPU kernel's ``t_allreduce`` / ``t_allreduce_row``; the
CUDA kernel's ``t_allreduce`` runs both): each rank pushes its
slab into its slot of every rank's AR slot buffer (a symmetric buffer of
the rank group, :func:`ar_slots`), waits for one delivery from each
rank, sums the slots in rank order in fp32 and rounds once. On the card
each block pushes, signals, waits and sums its own vectors (a flag a
block, parity and source), and the two parity slot sets alternate by the
row's epoch: the grid barrier the queue holds between two AllReduce rows
(:func:`check_ar_barriers`) and stream order between launches order the
slots' reuse, so the task has no grid or exit barrier of its own. Every
rank sums in the same order, so every rank's row is bit-identical. At one
rank the AllReduce tasks do nothing, unless the program was compiled with
``force_ar``: then the protocol runs against the rank itself.
``profile=True`` adds the per-task dispatch dump of the TPU kernel's
``_stamp_profile``.

:func:`run_queue_plain` is the same interpreter in plain PyTorch: it walks
the queue rows in order with one handler per type on full 128-row tiles,
rounding where the TPU kernel stores; its AllReduce meets the other
rank threads through the group's CPU rendezvous, as the collectives'
plain versions do. CPU tensors take it; on the card ``chip_smoke.py``
holds the CUDA kernel against it.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from triton_distributed_tpu_torch.megakernel.tasks import (
    MAT_COLS, TILE, WORDS, TaskType,
)
from triton_distributed_tpu_torch.models.fp8 import E4M3, to_e4m3
from triton_distributed_tpu_torch.ops._comm import _launch_at_meeting
from triton_distributed_tpu_torch.runtime.build import (
    CudaKernel, current_stream, ptr,
)
from triton_distributed_tpu_torch.runtime.context import (
    DistContext, current_rank,
)
from triton_distributed_tpu_torch.runtime.symm import (
    SIGNAL_WORDS, SymmBuffer, symm_zeros,
)

PORTED_TYPES = frozenset({
    TaskType.COPY, TaskType.ADD, TaskType.SILU_MUL, TaskType.SCALE,
    TaskType.RMS_NORM, TaskType.ATTN_DECODE, TaskType.ATTN_DECODE_PAGED,
    TaskType.ATTN_DECODE_GQA, TaskType.GEMM_WIDE, TaskType.NORM_ROPE,
    TaskType.APPEND_KV, TaskType.GEMM_WIDE_W8, TaskType.GEMM_MAT,
    TaskType.ADD_NORM, TaskType.NORM_ROPE_QKV, TaskType.PREFETCH_MAT,
    TaskType.ATTN_DECODE_PAGED_F8, TaskType.APPEND_KV_F8,
    TaskType.MOE_TOPK, TaskType.MOE_FFN,
    TaskType.PREFETCH, TaskType.PREFETCH_W8,
    TaskType.ALLREDUCE, TaskType.ALLREDUCE_ROW,
})
_ATTN = (int(TaskType.ATTN_DECODE_PAGED), int(TaskType.ATTN_DECODE_PAGED_F8))
_ATTN_LINEAR = (int(TaskType.ATTN_DECODE), int(TaskType.ATTN_DECODE_GQA))
_APPEND = (int(TaskType.APPEND_KV), int(TaskType.APPEND_KV_F8))
_KV8 = (int(TaskType.ATTN_DECODE_PAGED_F8), int(TaskType.APPEND_KV_F8))
# The paged serving program's types: a queue of these alone launches the
# kernel's lean instantiation, any other ported type a full one (the MoE
# types their own).
_PAGED_PROGRAM = tuple(int(t) for t in (
    TaskType.RMS_NORM, TaskType.ATTN_DECODE_PAGED, TaskType.APPEND_KV,
    TaskType.GEMM_MAT, TaskType.NORM_ROPE_QKV, TaskType.PREFETCH_MAT,
    TaskType.ATTN_DECODE_PAGED_F8, TaskType.APPEND_KV_F8))
_MOE = (int(TaskType.MOE_TOPK), int(TaskType.MOE_FFN))
_WARMS = (int(TaskType.PREFETCH), int(TaskType.PREFETCH_W8),
          int(TaskType.PREFETCH_MAT))
_AR = (int(TaskType.ALLREDUCE), int(TaskType.ALLREDUCE_ROW))
_EW = {int(TaskType.COPY): lambda a, b, f: a,
       int(TaskType.ADD): lambda a, b, f: a + b,
       int(TaskType.SILU_MUL): lambda a, b, f: torch.nn.functional.silu(a) * b,
       int(TaskType.SCALE): lambda a, b, f: a * f}
MAX_LIVE_ROWS = TILE     # rows per 128-row block the CUDA kernel computes
PROF_LANES = TILE        # int32 lanes of one profile-dump row
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_NEG = -1e30

MEGA_KERNEL = CudaKernel(
    "megakernel.cu", "megakernel_run",
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
    + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    + [ctypes.c_ulonglong, ctypes.c_longlong] + [ctypes.c_int] * 5
    + [ctypes.c_void_p])


class MegakernelUnsupportedError(ValueError):
    """The program, queue or configuration needs a part of the megakernel
    the port has not ported yet (the multi-rank task types, a page
    shape). Raised by name: the port has no backend ladder, and a silent
    demotion would hide the kernel."""


def _type_name(t: int) -> str:
    try:
        return TaskType(int(t)).name
    except ValueError:
        return str(int(t))


def check_queue(queue: np.ndarray, num_exec: int,
                used_types=None) -> None:
    """Refuse a program or queue the interpreters cannot run: a task type
    outside :data:`PORTED_TYPES` (a retired slot, or no type at all), or
    rows past a 128-row block — an
    attention row's speculative window (word 5), a windowed append
    reading source rows ``[word 7, word 7 + word 4)``, or a MOE_TOPK
    batch (word 9) above TILE. Both interpreters refuse alike, so a CPU
    run never accepts what the card would not."""
    if used_types is not None:
        bad = sorted(int(t) for t in used_types if t not in PORTED_TYPES)
        if bad:
            raise MegakernelUnsupportedError(
                "megakernel program uses task types the port has not "
                f"ported: {[_type_name(t) for t in bad]} (ported: "
                f"{sorted(t.name for t in PORTED_TYPES)})")
    rows = queue[:num_exec]
    types = rows[:, 0]
    bad_rows = ~np.isin(types, [int(t) for t in PORTED_TYPES])
    if bad_rows.any():
        raise MegakernelUnsupportedError(
            f"queue row {int(np.flatnonzero(bad_rows)[0])} has task type "
            f"{_type_name(types[bad_rows][0])}, which the port has not "
            "ported")
    attn = rows[np.isin(types, _ATTN)]
    if np.any(attn[:, 5] > MAX_LIVE_ROWS):
        raise MegakernelUnsupportedError(
            f"attention row with a speculative window of "
            f"{int(attn[:, 5].max())} rows: a window rides the "
            f"{MAX_LIVE_ROWS} rows of one slot block")
    app = rows[np.isin(types, _APPEND)]
    live = app[:, 8] >= 0
    if np.any(live & (app[:, 4] > 0) & (app[:, 7] + app[:, 4] > MAX_LIVE_ROWS)):
        raise MegakernelUnsupportedError(
            "windowed append reading source rows past the "
            f"{MAX_LIVE_ROWS} rows of a slot block")
    topk = rows[types == int(TaskType.MOE_TOPK)]
    if np.any(topk[:, 9] > MAX_LIVE_ROWS):
        raise MegakernelUnsupportedError(
            f"MOE_TOPK over a batch of {int(topk[:, 9].max())} rows: one "
            f"(B, E) logits tile holds at most {MAX_LIVE_ROWS}")


@dataclasses.dataclass
class ArGroup:
    """The rank group a launch's AllReduce tasks run in, as rank ``rank``
    sees it: its AR slot buffer and the AllReduce rows of the queue (each
    launch takes that many epochs of the slot buffer's flags)."""

    ctx: DistContext
    rank: int
    n: int
    slots: SymmBuffer
    sites: int

    def next_epochs(self) -> int:
        """The first epoch of this rank's next launch: AllReduce row k of
        the queue uses it + k, so the flags only grow, and the card's slot
        set ``epoch & 1`` alternates from row to row, across launches
        too."""
        base = self.slots.epochs[self.rank] + 1
        self.slots.epochs[self.rank] += self.sites
        return base


def ar_slots(ctx: DistContext, num_ranks: int, max_ar: int, dtype,
             tag: str = "") -> SymmBuffer:
    """The AllReduce slots of a rank group: per rank ``(max(n, 1),
    max_ar, TILE, TILE)`` in the workspace type (the reference's
    ``kernel.py:1589-1591``), slot r holding rank r's slab, with the
    buffer's signal pad; on the card two such sets, ``(2, max(n, 1),
    max_ar, TILE, TILE)`` (AllReduce row k of a launch uses set ``epoch &
    1``; the plain version's meetings order one set). One per (shape,
    type, ``tag``), made at first use and cached on the context
    (``runtime/symm.symm_zeros``)."""
    shape = (max(num_ranks, 1), max_ar, TILE, TILE)
    return symm_zeros(ctx, (2, *shape) if ctx.is_cuda else shape, dtype,
                      tag="megakernel-ar" + (f"-{tag}" if tag else ""))


def ar_flag_stride(sms: int, ranks_on_card: int) -> int:
    """The AllReduce's flag words a (parity, source): the largest grid any
    body takes on a card of ``sms`` SMs with ``ranks_on_card`` ranks of a
    group on it (two blocks an SM on 1/r of the SMs: ``csrc/megakernel.cu``
    launch), so a word's meaning stays the same across launches of
    different bodies."""
    return 2 * (sms // max(ranks_on_card, 1))


def ar_flag_words(num_ranks: int, stride: int) -> int:
    """The AllReduce's flag words in its slot buffer's pad: one a parity,
    source and block, ``2 * n * stride`` from word 0. Raises past
    ``SIGNAL_WORDS`` (the C entry refuses it too)."""
    words = 2 * max(num_ranks, 1) * stride
    if words > SIGNAL_WORDS:
        raise ValueError(
            f"megakernel: the AllReduce's {words} flag words (2 parities x "
            f"{num_ranks} ranks x {stride}) do not fit the signal pad's "
            f"{SIGNAL_WORDS}")
    return words


def ar_scope(ranks_on_card: int, num_ranks: int) -> int:
    """The AllReduce flags' memory scope: 0 (the GPU's) when every rank of
    the group is on this card, 1 (the system's) otherwise."""
    return 0 if ranks_on_card == num_ranks else 1


def check_ar_barriers(q: np.ndarray, num_exec: int, sync_before) -> None:
    """Refuse a queue in which two AllReduce rows share a barrier interval:
    the CUDA task has no barrier of its own, and its two parity slot sets
    are safe only with a grid barrier between any two of a launch's
    AllReduce rows (``csrc/megakernel.cu`` t_allreduce; the builder's
    ``barrier_rows`` puts one there)."""
    rows = np.flatnonzero(np.isin(q[:num_exec, 0], _AR))
    sync = np.asarray(sync_before[:num_exec])
    for a, b in zip(rows, rows[1:]):
        if not sync[a + 1:b + 1].any():
            raise ValueError(
                f"megakernel: AllReduce rows {int(a)} and {int(b)} share a "
                "barrier interval — their slot sets need a grid barrier "
                "between them (builder.barrier_rows)")


def ar_group(q: np.ndarray, num_exec: int, ws: torch.Tensor, *,
             num_ranks: int, axis: str, max_ar: int, force_ar: bool,
             ar_tag: str = "") -> ArGroup | None:
    """The group a queue's AllReduce tasks need, or None where they do
    nothing (no such task, or one rank without ``force_ar``). Raises
    outside the group's rank runner, on a group of another size, and on
    a row wider than the slots."""
    rows = q[:num_exec]
    is_ar = np.isin(rows[:, 0], _AR)
    if not is_ar.any() or (num_ranks == 1 and not force_ar):
        return None
    widths = np.where(rows[is_ar, 0] == int(TaskType.ALLREDUCE_ROW),
                      rows[is_ar, 4], 1)
    if widths.min() < 1 or widths.max() > max_ar:
        raise ValueError(f"megakernel: an AllReduce row of {int(widths.max())}"
                         f" tiles, past the program's max_ar {max_ar}")
    try:
        ctx, rank = current_rank()
    except RuntimeError as exc:
        raise ValueError(
            f"megakernel: a program compiled for num_ranks = {num_ranks}"
            f"{' with force_ar' if force_ar else ''} runs its AllReduce "
            "tasks inside the rank group's runner (DistContext.run), one "
            "workspace a rank") from exc
    n = ctx.axis_size(axis)
    if n != num_ranks:
        raise ValueError(f"megakernel: program compiled for num_ranks = "
                         f"{num_ranks}, the rank group has {n}")
    if ws.device != ctx.devices[rank]:
        raise ValueError(f"megakernel: rank {rank}'s workspace on "
                         f"{ws.device}, its device is {ctx.devices[rank]}")
    return ArGroup(ctx, rank, n, ar_slots(ctx, n, max_ar, ws.dtype, ar_tag),
                   int(is_ar.sum()))


def gemm_chunk_rows(k: int) -> int:
    """Contraction rows per GEMM_MAT item of the CUDA kernel (its
    ``gemm_kch``): the partial-sum scratch holds one slab per chunk."""
    return 256 if k % 256 == 0 else 128


def run_queue(queue, ws: torch.Tensor, wsm: torch.Tensor | None, *,
              num_exec: int, mat_specs: tuple, used_types=None,
              head_dim: int = TILE, sync_before=None,
              live_rows: int = TILE,
              ws8: torch.Tensor | None = None,
              wkv8: torch.Tensor | None = None,
              profile: bool = False, num_ranks: int = 1,
              axis: str = "tp", max_ar: int = 1, force_ar: bool = False,
              ar_tag: str = ""):
    """Execute the packed task queue over the workspace, in place; returns
    ``ws``. The CUDA interpreter on a CUDA workspace (one launch; rows
    ``[0, live_rows)`` of every 128-row block), the plain version on a CPU
    one (every row). ``sync_before``: the builder's per-row barrier flags
    (``builder.barrier_rows``), needed on the card. ``ws8``: the e4m3
    weight workspace of a program with GEMM_WIDE_W8 / PREFETCH_W8 tasks
    (read-only); ``wkv8``: the e4m3 KV-pool workspace of a program with
    types 24/25 (updated in place). ``profile``: also return the int32
    (num_exec, 128) dispatch dump — row t is ``[t, *queue row t]``, the
    other lanes -1 — as ``(ws, dump)``. ``num_ranks`` / ``axis`` /
    ``max_ar`` / ``force_ar``: the program's AllReduce geometry
    (``compile``); with AllReduce tasks to run, the call is one rank's,
    inside the group's runner, and ``ar_tag`` names its slot buffer
    (:func:`ar_slots`)."""
    q = np.ascontiguousarray(queue, np.int32)
    check_queue(q, num_exec, used_types)
    group = ar_group(q, num_exec, ws, num_ranks=num_ranks, axis=axis,
                     max_ar=max_ar, force_ar=force_ar, ar_tag=ar_tag)
    if ws.device.type == "cuda":
        return _run_queue_cuda(q, ws, wsm, num_exec=num_exec,
                               mat_specs=mat_specs, head_dim=head_dim,
                               sync_before=sync_before, live_rows=live_rows,
                               ws8=ws8, wkv8=wkv8, profile=profile,
                               group=group)
    if ws.device.type == "cpu":
        return run_queue_plain(q, ws, wsm, num_exec=num_exec,
                               mat_specs=mat_specs, head_dim=head_dim,
                               ws8=ws8, wkv8=wkv8, profile=profile,
                               group=group)
    raise ValueError(f"megakernel: no kernel for device {ws.device}")


def profile_dump(queue: np.ndarray, num_exec: int) -> np.ndarray:
    """The dump a profiled run of ``queue`` stamps, built on the host:
    row t = [t, *queue row t], the other lanes -1 (the plain version's
    stamp, and the card's yardstick)."""
    dump = np.full((num_exec, PROF_LANES), -1, np.int32)
    dump[:, 0] = np.arange(num_exec)
    dump[:, 1:1 + WORDS] = np.asarray(queue, np.int32)[:num_exec]
    return dump


# ---------------------------------------------------------------------------
# CUDA launch.
# ---------------------------------------------------------------------------

def _specs_array(mat_specs) -> np.ndarray:
    rows = [(sp.kt, sp.ns, sp.nt_out, sp.epi) for sp in mat_specs]
    return np.asarray(rows or [(0, 0, 0, 0)], np.int32).reshape(-1, 4)


def _scratch_floats(q: np.ndarray, num_exec: int, mat_specs,
                    live_rows: int) -> int:
    """The fp32 scratch one launch shares between GEMM_MAT's partial sums
    (a slab per contraction chunk) and MOE_FFN's expert activations (E x
    live rows x ffn)."""
    n = 1
    for sp in mat_specs:
        k = sp.kt * TILE
        n = max(n, (k // gemm_chunk_rows(k)) * live_rows * sp.ns * MAT_COLS)
    ffn = q[:num_exec][q[:num_exec, 0] == int(TaskType.MOE_FFN), 7]
    for arg in ffn.tolist():
        n = max(n, (arg & 0xFFFF) * live_rows * (arg >> 16) * TILE)
    return n


def _check_e4m3_ws(q: np.ndarray, num_exec: int, ws, w8, name: str,
                   types: tuple, what: str) -> None:
    """An e4m3 side workspace (``ws8`` weights or ``wkv8`` pools): present
    when the queue has the task ``types`` that read it, and shaped like
    the main one."""
    if w8 is None:
        if np.isin(q[:num_exec, 0], types).any():
            raise ValueError(f"megakernel: the queue has {what} but no "
                             f"{name} workspace was passed")
        return
    if w8.dtype != E4M3 or w8.device != ws.device \
            or not w8.is_contiguous() or w8.dim() != 3 \
            or tuple(w8.shape[1:]) != (TILE, TILE):
        raise ValueError(f"megakernel: {name} {tuple(w8.shape)} {w8.dtype} "
                         f"must be a contiguous (tiles, {TILE}, {TILE}) "
                         "float8_e4m3fn tensor on the workspace's device")


def _check_side_workspaces(q, num_exec, ws, ws8, wkv8) -> None:
    _check_e4m3_ws(q, num_exec, ws, ws8, "ws8",
                   (int(TaskType.GEMM_WIDE_W8), int(TaskType.PREFETCH_W8)),
                   "e4m3-weight tasks (types 15/16)")
    _check_e4m3_ws(q, num_exec, ws, wkv8, "wkv8", _KV8,
                   "e4m3-pool tasks (types 24/25)")


def cuda_launcher(q: np.ndarray, ws, wsm, *, num_exec, mat_specs,
                  head_dim, sync_before, live_rows, ws8=None, wkv8=None,
                  profile: bool = False, group: ArGroup | None = None):
    """Check the operands, upload the queue (with the barrier flags and
    the GEMM_MAT spec table) and the partial-sum scratch, and return a
    zero-argument function that launches the kernel on them — so a timing
    loop can launch without re-uploading. ``profile``: the launches also
    stamp the dispatch dump into ``launch.prof`` (int32 (num_exec, 128),
    -1 where nothing is stamped). ``group``: the AllReduce tasks' rank
    group (:func:`ar_group`); each launch then takes fresh epochs and goes
    out at the group's meeting, where the last rank to arrive launches
    every rank's kernel back to back on the ranks' streams, so the
    cooperative launches of the ranks run at once."""
    if ws.dtype not in _DTYPE_CODE:
        raise ValueError(f"megakernel: workspace dtype {ws.dtype} "
                         "unsupported (float32 or bfloat16)")
    if not ws.is_contiguous() or ws.dim() != 3 \
            or tuple(ws.shape[1:]) != (TILE, TILE):
        raise ValueError(f"megakernel: ws {tuple(ws.shape)} must be a "
                         f"contiguous (tiles, {TILE}, {TILE}) tensor")
    if wsm is None:
        wsm = torch.zeros((1, MAT_COLS), dtype=ws.dtype, device=ws.device)
    if wsm.device != ws.device or wsm.dtype != ws.dtype \
            or not wsm.is_contiguous():
        raise ValueError("megakernel: wsm must be a contiguous tensor of "
                         "the workspace's device and dtype")
    if not 1 <= live_rows <= MAX_LIVE_ROWS:
        raise ValueError(f"megakernel: live_rows {live_rows} outside [1, "
                         f"{MAX_LIVE_ROWS}] — the CUDA kernel computes at "
                         "most that many rows per block")
    if head_dim not in (TILE // 2, TILE):
        raise ValueError(f"megakernel: head_dim {head_dim} unsupported")
    if sync_before is None or len(sync_before) < num_exec:
        raise ValueError("megakernel: the CUDA kernel needs the program's "
                         "per-row barrier flags (compile() records them)")
    _check_side_workspaces(q, num_exec, ws, ws8, wkv8)
    rows = q[:num_exec]
    batch = rows[rows[:, 0] == int(TaskType.MOE_TOPK), 9]
    if np.any(batch > live_rows):
        raise MegakernelUnsupportedError(
            f"MOE_TOPK routes {int(batch.max())} rows but the launch "
            f"computes {live_rows}: rows past the live ones would elect "
            "experts the kernel never runs — live_rows >= the MoE batch")
    n_q = q.size
    host = np.concatenate([q.reshape(-1),
                           np.asarray(sync_before[:num_exec], np.int32),
                           _specs_array(mat_specs).reshape(-1)])
    dev = torch.from_numpy(host).to(ws.device)
    partial = torch.empty(
        (_scratch_floats(q, num_exec, mat_specs, live_rows),),
        dtype=torch.float32, device=ws.device)
    prof = (torch.full((num_exec, PROF_LANES), -1, dtype=torch.int32,
                       device=ws.device) if profile else None)
    base = dev.data_ptr()
    body = _kernel_body(q, num_exec, profile)
    args = (ctypes.c_void_p(base), ctypes.c_void_p(base + 4 * n_q),
            ctypes.c_void_p(base + 4 * (n_q + num_exec)),
            ptr(ws), ptr(wsm), ptr(ws8), ptr(wkv8), ptr(partial), ptr(prof),
            int(num_exec), int(live_rows), int(head_dim),
            _DTYPE_CODE[ws.dtype], body)

    variants = tuple(name for name, on in (
        ("full", body > 0),
        ("moe", body == 2),
        ("kv8", wkv8 is not None),
        ("window", bool((rows[np.isin(rows[:, 0], _ATTN), 5] > 0).any())),
        ("rows", live_rows > 4),
        ("profile", profile),
        ("allreduce", group is not None))
        if on)
    stream = current_stream(ws.device)

    if group is None:
        def launch():
            MEGA_KERNEL.launch(*args, None, None, None, 0, 1, 0, 0, 0, 1, 1,
                               0, 1, stream, variants=variants)
    else:
        check_ar_barriers(q, num_exec, sync_before)
        ctx, rank, slots = group.ctx, group.rank, group.slots
        on_card = sum(1 for d in ctx.devices if d == ws.device)
        stride = ar_flag_stride(torch.cuda.get_device_properties(
            ws.device).multi_processor_count, on_card)
        ar_flag_words(group.n, stride)
        ar = (ptr(slots.table[rank]), ptr(slots.signal_table[rank]),
              ptr(ctx.error_word(rank)), rank, group.n)

        def launch():
            # The epochs are taken in the meeting's action: a rank whose
            # peer fails before the meeting keeps its counter where its
            # peers' are.
            _launch_at_meeting(
                MEGA_KERNEL, slots, rank, ws.device, "megakernel.launch",
                lambda: args + ar + (
                    group.next_epochs(), int(ctx.timeout_s * 1e9), 1,
                    slots.tensors[rank].shape[-3], on_card,
                    ar_scope(on_card, group.n), stride, stream),
                variants=variants)

    launch.buffers = (dev, partial, wsm, ws8, wkv8)   # alive with the pointers
    launch.prof = prof
    return launch


def _full_kernel(q: np.ndarray, num_exec: int) -> bool:
    """Whether the queue needs one of the kernel's full instantiations: a
    task type beyond the paged serving program's (as the TPU kernel
    compiles only the branches a program uses, the CUDA kernel has a lean
    body for that program and full ones for every ported type)."""
    return bool((~np.isin(q[:num_exec, 0], _PAGED_PROGRAM)).any())


def _kernel_body(q: np.ndarray, num_exec: int,
                 profile: bool = False) -> int:
    """The instantiation the queue launches: 0 the lean body, 1 the full
    body of the non-MoE types, 2 the full body with MOE_TOPK / MOE_FFN
    (their 4-row loops would take the register file from the linear
    programs' GEMMs if the two shared a body). Only the full bodies have
    profiled instantiations, so a profiled paged program runs body 1."""
    if np.isin(q[:num_exec, 0], _MOE).any():
        return 2
    return 1 if profile or _full_kernel(q, num_exec) else 0


def grid_blocks(dtype: torch.dtype, full: bool = False,
                moe: bool = False, ranks_on_card: int = 1) -> int:
    """Blocks of the cooperative grid the kernel launches on the current
    card for this workspace dtype and instantiation, with
    ``ranks_on_card`` ranks of a group on the card (0 before the first
    such launch)."""
    MEGA_KERNEL._load()
    fn = MEGA_KERNEL._lib.megakernel_grid
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
    return int(fn(_DTYPE_CODE[dtype], 2 if moe else int(full),
                  int(ranks_on_card)))


def _run_queue_cuda(q: np.ndarray, ws, wsm, **kw):
    """One launch (at the group's meeting when ``kw["group"]`` is set)."""
    launch = cuda_launcher(q, ws, wsm, **kw)
    launch()
    return (ws, launch.prof) if kw.get("profile") else ws


# ---------------------------------------------------------------------------
# Plain version: the same queue walk in PyTorch.
# ---------------------------------------------------------------------------

def _fixed(word: int, unit: float) -> torch.Tensor:
    """A fixed-point queue word as the TPU kernel decodes it: the int
    cast to fp32, times the fp32 unit."""
    return (torch.tensor(float(word), dtype=torch.float32)
            * torch.tensor(unit, dtype=torch.float32))


def _row(ws, base: int, nt: int) -> torch.Tensor:
    """Tiles [base, base+nt) as one fp32 (TILE, nt*TILE) row block."""
    return ws[base:base + nt].permute(1, 0, 2).reshape(TILE, nt * TILE).float()


def _put_row(ws, base: int, x: torch.Tensor) -> None:
    nt = x.shape[1] // TILE
    ws[base:base + nt] = x.reshape(TILE, nt, TILE).permute(1, 0, 2).to(ws.dtype)


def _rms(x: torch.Tensor, w: torch.Tensor, cols: int, eps) -> torch.Tensor:
    ss = torch.sum(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(ss / float(cols) + eps.to(x.device)) * w


def _p_rms_norm(ws, w):
    out, a0, b0, kt, arg = w[1], w[2], w[3], w[4], w[7]
    x = _row(ws, a0, kt)
    _put_row(ws, out, _rms(x, _row(ws, b0, kt), kt * TILE, _fixed(arg, 1e-9)))


def _p_norm_rope_qkv(ws, w, head_dim):
    a0, qn, hq, kn, hkv, arg, c0, d0 = (w[2], w[3], w[4], w[5], w[6], w[7],
                                        w[8], w[9])
    heads = ws[a0:a0 + hq + hkv].float()                  # (h, TILE, TILE)
    gain = torch.stack([ws[qn].float()] * hq + [ws[kn].float()] * hkv)
    xn = _rms(heads, gain, head_dim, _fixed(arg, 1e-9))
    half = head_dim // 2
    rot = torch.cat([-xn[..., half:head_dim], xn[..., :half],
                     xn[..., head_dim:]], dim=-1)
    y = xn * ws[c0].float() + rot * ws[d0].float()
    ws[a0:a0 + hq + hkv] = y.to(ws.dtype)


def _p_attn_paged(ws, flat, w, pool):
    """ATTN_DECODE_PAGED (``pool`` is ``ws``) or _F8 (``pool`` is the kv8
    workspace): the page walk, then the current tokens' fold — each row
    its own k/v (word 5 = 0), or the causal window of the block's fresh
    rows j <= i, j < win (word 5 = win)."""
    b0, kt = w[3], w[4]
    ent = flat[b0 * WORDS:b0 * WORDS + 2 * kt].astype(np.int64)
    ent = torch.from_numpy(ent.reshape(kt, 2)).to(ws.device)
    _attn_head(ws, pool, ent[:, 0], ent[:, 1], out=w[1], a0=w[2], win=w[5],
               valid=w[6], scale=_fixed(w[7], 1e-6), c0=w[8], d0=w[9])


def _p_attn_linear(ws, w, pool):
    """ATTN_DECODE (one head) or ATTN_DECODE_GQA (``arg >> 24`` q heads at
    tiles a0.., outputs at out..; scale in the low 24 bits) over a linear
    cache: kT tiles b0.., V tiles from word 5, each row folding its own
    current k/v. ``pool`` holds the cache tiles (``ws`` itself; a replay
    may pass the workspace the step started from)."""
    out, a0, b0, kt, v0, valid, arg, c0, d0 = (w[1], w[2], w[3], w[4], w[5],
                                               w[6], w[7], w[8], w[9])
    g = 1
    if w[0] == TaskType.ATTN_DECODE_GQA:
        g, arg = arg >> 24, arg & 0xFFFFFF
    ids = torch.arange(kt, device=ws.device)
    for h in range(g):
        _attn_head(ws, pool, b0 + ids, v0 + ids, out=out + h, a0=a0 + h,
                   win=0, valid=valid, scale=_fixed(arg, 1e-6), c0=c0, d0=d0)


def _attn_head(ws, pool, k_ids, v_ids, *, out, a0, win, valid, scale, c0,
               d0):
    """One q-head tile against the cache tiles ``k_ids`` / ``v_ids`` of
    ``pool``, masked to ``valid``, then the current tokens' fold, then
    / max(l, 1e-30); stored rounded to the workspace type."""
    kt = len(k_ids)
    kv8 = pool.dtype == E4M3
    scale = scale.to(ws.device)
    q = ws[a0].float()                                     # (rows, d)
    rows = q.shape[0]
    if kt > 0:
        keys = pool[k_ids].float().permute(1, 0, 2).reshape(TILE, kt * TILE)
        vals = pool[v_ids].float().reshape(kt * TILE, TILE)
        s = (q @ keys) * scale
        col = torch.arange(kt * TILE, device=ws.device)
        s = torch.where(col[None, :] < valid, s, _NEG)
        m = torch.amax(s, dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = torch.sum(p, dim=-1, keepdim=True)
        # The PV product takes p rounded to the type V is read in — the
        # workspace type, or fp32 for widened e4m3 pages; l sums it
        # unrounded (the TPU kernel's p.astype(vv.dtype)).
        acc = (p if kv8 else p.to(ws.dtype).float()) @ vals
    else:
        m = torch.full((rows, 1), _NEG, device=ws.device)
        l = torch.zeros((rows, 1), device=ws.device)
        acc = torch.zeros((rows, TILE), device=ws.device)

    def cur_kv(tile):
        # The current tokens' k/v from the main workspace; over e4m3
        # pools they round-trip through the saturating cast, so the fold
        # reads what the append stores (the eager lane appends, then
        # attends the stored value).
        x = ws[tile].float()
        return to_e4m3(x).float() if kv8 else x

    if c0 >= 0 and win == 0:
        s_cur = torch.sum(q * cur_kv(c0), dim=-1, keepdim=True) * scale
        m_new = torch.maximum(m, s_cur)
        p_cur = torch.exp(s_cur - m_new)
        corr = torch.exp(m - m_new)
        acc = acc * corr + p_cur * cur_kv(d0)
        l = l * corr + p_cur
    elif c0 >= 0:
        s_w = (q @ cur_kv(c0).T) * scale
        io = torch.arange(TILE, device=ws.device)
        causal = (io[None, :] <= io[:, None]) & (io[None, :] < win)
        s_w = torch.where(causal, s_w, _NEG)
        m_new = torch.maximum(m, torch.amax(s_w, dim=-1, keepdim=True))
        p_w = torch.exp(s_w - m_new)
        corr = torch.exp(m - m_new)
        acc = acc * corr + p_w @ cur_kv(d0)
        l = l * corr + torch.sum(p_w, dim=-1, keepdim=True)
    ws[out] = (acc / torch.clamp(l, min=1e-30)).to(ws.dtype)


def _p_append_kv(ws, w, pool):
    """APPEND_KV (``pool`` is ``ws``) or _F8 (the kv8 workspace, through
    the saturating cast): k_new row 0 → column c0 of the kT tile, v_new
    row 0 → row c0 of the V tile; the window form (word 4 = n > 0) moves
    rows s..s+n-1 (word 7 = s) to columns/rows c0..c0+n-1. c0 < 0
    skips."""
    out, a0, b0, cnt, src, c0, d0 = (w[1], w[2], w[3], w[4], w[7], w[8],
                                     w[9])
    if c0 < 0:
        return
    if cnt == 0:
        src, cnt = 0, 1
    n = min(cnt, TILE - c0)

    def store(x):
        return to_e4m3(x) if pool.dtype == E4M3 else x.to(pool.dtype)

    pool[out][:, c0:c0 + n] = store(ws[a0][src:src + n].float().T)
    pool[b0][c0:c0 + n, :] = store(ws[d0][src:src + n].float())


def _p_gemm_mat(ws, wsm, w, mat_specs):
    out, a0, b0, kt, si, nb, arg, c0, d0 = (w[1], w[2], w[3], w[4], w[5],
                                            w[6], w[7], w[8], w[9])
    sp = mat_specs[si]
    epi = arg & 0xFF
    k = kt * TILE
    a = _row(ws, a0, kt)                                   # (TILE, K)
    wts = wsm[b0:b0 + sp.ns * k].reshape(sp.ns, k, MAT_COLS).float()
    acc = torch.matmul(a, wts)                             # (ns, TILE, 1024)
    if epi == 1:
        half = MAT_COLS // 2
        act = torch.nn.functional.silu(acc[..., :half]) * acc[..., half:]
        y = act.permute(1, 0, 2).reshape(TILE, sp.ns * half)
    else:
        y = acc.permute(1, 0, 2).reshape(TILE, sp.ns * MAT_COLS)
    y = y[:, :sp.nt_out * TILE]
    if epi in (2, 3):
        y = y + _row(ws, c0, sp.nt_out)
    _put_row(ws, out, y)
    if epi == 3:
        x2 = _row(ws, out, sp.nt_out)                      # the stored row
        _put_row(ws, d0, _rms(x2, _row(ws, nb, sp.nt_out),
                              sp.nt_out * TILE, _fixed(arg >> 8, 1e-9)))


def _p_ew(ws, w):
    """COPY / ADD / SILU_MUL / SCALE over a row of k_tiles tiles: fp32
    inside, stored in the workspace type. SCALE's factor is word 7 in
    fixed point 1e-6."""
    out, a0, b0, kt, arg = w[1], w[2], w[3], w[4], w[7]
    a = _row(ws, a0, kt)
    b = _row(ws, b0, kt)
    _put_row(ws, out, _EW[w[0]](a, b, _fixed(arg, 1e-6).to(ws.device)))


def _p_norm_rope(ws, w, head_dim):
    """NORM_ROPE: out <- rope(rms_norm(a) * w) on one head tile (the norm
    over the head's ``head_dim`` columns, the rotation inside them)."""
    out, a0, b0, arg, c0, d0 = w[1], w[2], w[3], w[7], w[8], w[9]
    xn = _rms(ws[a0].float(), ws[b0].float(), head_dim, _fixed(arg, 1e-9))
    half = head_dim // 2
    rot = torch.cat([-xn[..., half:head_dim], xn[..., :half],
                     xn[..., head_dim:]], dim=-1)
    ws[out] = (xn * ws[c0].float() + rot * ws[d0].float()).to(ws.dtype)


def _p_add_norm(ws, w):
    """ADD_NORM: x2 = a + b stored, then rms_norm of the STORED (rounded)
    x2 times the weight row (tiles from word 6) into the row at word 9 —
    bit-equal to the ADD + RMS_NORM task pair."""
    out, a0, b0, kt, nw, arg, d0 = w[1], w[2], w[3], w[4], w[6], w[7], w[9]
    _put_row(ws, out, _row(ws, a0, kt) + _row(ws, b0, kt))
    x2 = _row(ws, out, kt)
    _put_row(ws, d0, _rms(x2, _row(ws, nw, kt), kt * TILE,
                          _fixed(arg, 1e-9)))


def _p_gemm_wide(ws, b_ws, w):
    """GEMM_WIDE (``b_ws`` is ``ws``) or GEMM_WIDE_W8 (the e4m3 weight
    workspace): ``width`` = word 7 output column tiles from ``out``; A =
    the row of k_tiles tiles at a0; B tile (j, c) at ``b0 + j * b_stride +
    c``, widened to fp32 (exact from e4m3 or bf16); fp32 sums, one
    rounding at the store."""
    out, a0, b0, kt, b_stride, width = w[1], w[2], w[3], w[4], w[6], w[7]
    a = _row(ws, a0, kt)                                   # (TILE, K)
    idx = (b0 + torch.arange(kt, device=ws.device)[:, None] * b_stride
           + torch.arange(width, device=ws.device)[None, :])
    b = b_ws[idx.reshape(-1)].float().reshape(kt, width, TILE, TILE)
    b = b.permute(0, 2, 1, 3).reshape(kt * TILE, width * TILE)
    _put_row(ws, out, a @ b)


def _p_moe_topk(ws, w):
    """MOE_TOPK: the logits tile (a0) masked to columns < E (word 6) and
    rows < batch (word 9), ``arg`` experts per row by iterative argmax
    (ties to the leftmost column), weights exp(l - row max) over the
    selected normalised by max(sum, 1e-30); stored transposed, (E, B),
    zeros for the rest."""
    out, a0, num_e, k, batch = w[1], w[2], w[6], w[7], w[9]
    io = torch.arange(TILE, device=ws.device)
    lg = ws[a0].float()
    lg = torch.where((io[None, :] < num_e) & (io[:, None] < batch), lg, _NEG)
    m0 = torch.amax(lg, dim=1, keepdim=True)
    work, sel = lg.clone(), torch.zeros_like(lg, dtype=torch.bool)
    for _ in range(k):
        m = torch.amax(work, dim=1, keepdim=True)
        is_m = (work == m) & (work > _NEG * 0.5)
        idx = torch.amin(torch.where(is_m, io[None, :], TILE), dim=1,
                         keepdim=True)
        pick = io[None, :] == idx
        work = torch.where(pick, _NEG, work)
        sel |= pick
    wgt = torch.where(sel, torch.exp(lg - m0), 0.0)
    z = torch.sum(wgt, dim=1, keepdim=True)
    ws[out] = (wgt / torch.clamp(z, min=1e-30)).T.to(ws.dtype)


def _expert(ws, base: int, e: int, rt: int, ct: int) -> torch.Tensor:
    """Expert ``e``'s (rt·TILE, ct·TILE) matrix of a stacked weight whose
    tiles start at ``base`` (row tile e·rt + i, column tile j)."""
    t = ws[base + e * rt * ct:base + (e + 1) * rt * ct].float()
    return t.reshape(rt, ct, TILE, TILE).permute(0, 2, 1, 3).reshape(
        rt * TILE, ct * TILE)


def _p_moe_ffn(ws, w):
    """MOE_FFN: for each expert e < E whose row of the (E, B) weight tile
    (b0) sums above zero — the rest skipped before their weights are
    read —, act = silu(xn @ Wg_e) * (xn @ Wu_e) * w_e (per token), rounded
    to the workspace type, then act @ Wd_e, summed over the experts in
    fp32 and stored once at ``out``. Word layout: tasks.py MOE_FFN."""
    out, a0, b0, ht, wg, wu, arg, wd = (w[1], w[2], w[3], w[4], w[5], w[6],
                                        w[7], w[8])
    num_e, ft = arg & 0xFFFF, arg >> 16
    x = _row(ws, a0, ht)                                   # (TILE, hidden)
    wt = ws[b0].float()                                    # (E, B)
    acc = torch.zeros_like(x)
    for e in range(num_e):
        w_tok = wt[e]
        if not bool(torch.sum(w_tok) > 0):
            continue
        g = x @ _expert(ws, wg, e, ht, ft)
        u = x @ _expert(ws, wu, e, ht, ft)
        act = torch.nn.functional.silu(g) * u * w_tok[:, None]
        acc += act.to(ws.dtype).float() @ _expert(ws, wd, e, ft, ht)
    _put_row(ws, out, acc)


def _p_allreduce(ws, w, group: ArGroup | None):
    """ALLREDUCE (one tile, slot slab 0) / ALLREDUCE_ROW (word 4 tiles
    from ``out``): push the slab into slot ``rank`` of every rank's slot
    buffer, meet (the deliveries), sum this rank's slots 0..n-1 in fp32
    in rank order, round once and store at ``out``; then meet again (the
    exit barrier, n > 1) before any rank reuses the slots. On CUDA tensors
    (the card's yardstick run) the slot buffer has the kernel's two sets:
    the meetings order one, set 0. No group: one rank without
    ``force_ar``, nothing to do."""
    if group is None:
        return
    nt = w[4] if w[0] == TaskType.ALLREDUCE_ROW else 1
    out, me = w[1], group.rank
    sets = [t[0] if t.dim() == 5 else t for t in group.slots.tensors]

    def meet(what):
        # On CUDA tensors (the card's yardstick run) each rank's copies
        # run on its own stream: finish them before the peers read.
        if ws.is_cuda:
            torch.cuda.current_stream(ws.device).synchronize()
        group.ctx.barrier(me, what)

    for t in sets:
        t[me, :nt] = ws[out:out + nt]
    meet("megakernel.allreduce")
    mine = sets[me]
    acc = torch.zeros((nt, TILE, TILE), dtype=torch.float32,
                      device=ws.device)
    for r in range(group.n):
        acc = acc + mine[r, :nt].float()
    ws[out:out + nt] = acc.to(ws.dtype)
    if group.n > 1:
        meet("megakernel.allreduce.exit")


def run_queue_plain(queue, ws: torch.Tensor, wsm: torch.Tensor | None, *,
                    num_exec: int, mat_specs: tuple,
                    head_dim: int = TILE,
                    ws8: torch.Tensor | None = None,
                    wkv8: torch.Tensor | None = None,
                    profile: bool = False,
                    group: ArGroup | None = None):
    """The megakernel's function in plain PyTorch: the queue rows in
    order, one handler per type, every row of every tile, fp32 compute
    and stores in the workspace dtype (e4m3 through the saturating cast
    in ``wkv8``). Updates ``ws`` (and ``wkv8``) in place and returns
    ``ws``, or ``(ws, dump)`` with ``profile`` (:func:`profile_dump`, on
    the workspace's device). ``group``: the AllReduce tasks' rank group
    (:func:`ar_group`; None where they do nothing)."""
    MEGA_KERNEL.count_plain()
    q = np.ascontiguousarray(queue, np.int32)
    check_queue(q, num_exec)
    _check_side_workspaces(q, num_exec, ws, ws8, wkv8)
    flat = q.reshape(-1)
    for row in q[:num_exec].tolist():
        t = row[0]
        if t == TaskType.RMS_NORM:
            _p_rms_norm(ws, row)
        elif t in _EW:
            _p_ew(ws, row)
        elif t == TaskType.GEMM_WIDE:
            _p_gemm_wide(ws, ws, row)
        elif t == TaskType.GEMM_WIDE_W8:
            _p_gemm_wide(ws, ws8, row)
        elif t == TaskType.NORM_ROPE:
            _p_norm_rope(ws, row, head_dim)
        elif t == TaskType.ADD_NORM:
            _p_add_norm(ws, row)
        elif t in _ATTN_LINEAR:
            _p_attn_linear(ws, row, ws)
        elif t == TaskType.NORM_ROPE_QKV:
            _p_norm_rope_qkv(ws, row, head_dim)
        elif t == TaskType.ATTN_DECODE_PAGED:
            _p_attn_paged(ws, flat, row, ws)
        elif t == TaskType.ATTN_DECODE_PAGED_F8:
            _p_attn_paged(ws, flat, row, wkv8)
        elif t == TaskType.APPEND_KV:
            _p_append_kv(ws, row, ws)
        elif t == TaskType.APPEND_KV_F8:
            _p_append_kv(ws, row, wkv8)
        elif t == TaskType.GEMM_MAT:
            _p_gemm_mat(ws, wsm, row, mat_specs)
        elif t in _WARMS:
            pass    # a DMA warm on the TPU, an L2 warm here: no value
        elif t == TaskType.MOE_TOPK:
            _p_moe_topk(ws, row)
        elif t == TaskType.MOE_FFN:
            _p_moe_ffn(ws, row)
        elif t in _AR:
            _p_allreduce(ws, row, group)
        else:
            raise MegakernelUnsupportedError(
                f"task type {_type_name(t)} is not ported")
    if profile:
        return ws, torch.from_numpy(profile_dump(q, num_exec)).to(ws.device)
    return ws
