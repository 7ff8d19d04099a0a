"""MegaKernel model builder — record ops as tasks, compile once, replay.

The port's counterpart of the JAX package's ``megakernel/builder.py``,
with the ops the decode programs emit: the paged serving program's
(``rms_norm``, ``gemm_mat``, ``prefetch_mat``, ``norm_rope_qkv``,
``attn_decode_paged``, ``append_kv``, each pool op also over e4m3 pools)
and the linear programs' (``attn_decode_gqa``, ``attn_decode``, the
linear ``append_kv``, and for the tile weight layout ``gemm`` — GEMM_WIDE,
or GEMM_WIDE_W8 over e4m3 weight tiles —, ``norm_rope``, ``add_norm``,
``copy`` / ``add`` / ``silu_mul`` / ``scale``) and the Qwen3-MoE FFN's
``moe_topk`` / ``moe_ffn``, and the single-tile weight warm ``prefetch``
(PREFETCH / PREFETCH_W8) that ``gemm(prefetch_first=True)`` consumes,
with the JAX builder's one-outstanding-warm rules, and the cross-rank
``all_reduce`` (one ALLREDUCE_ROW task per row of tiles) that a program
compiled for a TP group (``compile(num_ranks=)``) or for the one-rank
loopback (``compile(force_ar=True)``) runs in the kernel. Tensor
allocation, hazard bookkeeping, the schedule and the packed queue follow
the JAX builder step for step, so both emit the same queue word for word
(the CPU tests hold them equal).

:class:`CompiledMegaKernel` carries the queue and the workspace geometry;
its workspaces are torch tensors updated IN PLACE (the JAX package
threads donated arrays through jits instead): the main workspace, the
matrix weight workspace, the e4m3 weight-tile workspace
(``tensor(fp8=True)`` tiles, GEMM_WIDE_W8's B operands, read-only) and,
for programs with e4m3 pools, the kv8 workspace (``tensor(kv8=True)``
tiles, read by ATTN_DECODE_PAGED_F8 and written by APPEND_KV_F8).

Reference: ``mega_triton_kernel/models/model_builder.py:83-406``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from triton_distributed_tpu_torch.megakernel.kernel import run_queue
from triton_distributed_tpu_torch.megakernel.scheduler import topo_schedule
from triton_distributed_tpu_torch.megakernel.tasks import (
    MAT_COLS, TILE, WORDS, MatHandle, MatSpec, Task, TaskType, TensorHandle,
    mat_chunk_rows,
)
from triton_distributed_tpu_torch.models.fp8 import E4M3, saturate_cast
from triton_distributed_tpu_torch.runtime.device import (
    resolve_device, torch_dtype,
)


class MegaKernelBuilder:
    """Records tensors + tasks; tracks read/write hazards for the scheduler
    (the role of the reference's TaskDependency records,
    core/task_base.py:112-218)."""

    # Hazard-id offset for e4m3 weight-workspace tiles (GEMM_WIDE_W8 B
    # operands): their tile ids live in a separate space, so dependency
    # bookkeeping must not collide them with main-workspace ids (the JAX
    # builder's values, so the exported hazard sets match).
    _W8_HAZARD = 1 << 30
    # Same for 2D matrix-workspace rows (GEMM_MAT B operands).
    _WM_HAZARD = 1 << 29
    # And for the e4m3 KV-pool tiles (the kv8 workspace, read-write):
    # appends stay ordered after the attention reads of the same tile.
    _K8_HAZARD = 1 << 28

    def __init__(self):
        # NORM_ROPE_QKV sub-tile span, set by the program assembly
        # (build_decode_step(head_dim=)); compile() inherits it.
        self.head_dim = TILE
        self._num_tiles = 0
        self._num_tiles8 = 0
        self._num_tiles_kv8 = 0
        self._num_mrows = 0
        self._max_row = 1
        self._max_gqa = 1
        self._max_gemm_width = 1
        self._max_strip = 1
        self._max_moe_h = 0
        self._max_moe_f = 0
        self._max_ar = 1
        self._mat_specs: list[MatSpec] = []
        self._tasks: list[Task] = []
        self._edges: list[tuple[int, int]] = []
        self._last_writer: dict[int, int] = {}
        self._readers_since_write: dict[int, list[int]] = {}
        self._reads: list[tuple[int, ...]] = []
        self._writes: list[tuple[int, ...]] = []
        # task id -> flat int list; packed as extra queue rows at compile
        # (page tables for ATTN_DECODE_PAGED — data rows, never dispatched).
        self._task_tables: dict[int, list[int]] = {}
        # Matrix-chunk warm hand-off (PREFETCH_MAT): the pseudo resource
        # serializing the reserved slot, and (task id, wsm base) of the
        # outstanding warm awaiting its consuming GEMM_MAT.
        self._pfm_res: TensorHandle | None = None
        self._pending_pf_mat: tuple[int, int] | None = None
        # Single-tile warm hand-off (PREFETCH / PREFETCH_W8): its pseudo
        # resource, and (weight tile, fp8) of the outstanding warm.
        self._pf_res: TensorHandle | None = None
        self._pending_pf: tuple[int, bool] | None = None

    # -- tensors ------------------------------------------------------------
    def tensor(self, rows: int, cols: int, fp8: bool = False,
               kv8: bool = False) -> TensorHandle:
        """``fp8=True``: allocate in the e4m3 WEIGHT workspace (a separate
        read-only input with its own tile-id space from 0 — GEMM B
        operands only, half the weight bytes of bf16). ``kv8=True``:
        allocate in the e4m3 KV-pool workspace (its own tile-id space
        from 0) — paged pools at half the bf16 bytes."""
        if rows % TILE or cols % TILE:
            raise ValueError(f"dims must be multiples of {TILE}, got "
                             f"({rows}, {cols})")
        if fp8 and kv8:
            raise ValueError("fp8 (weight) and kv8 (KV pool) are distinct "
                             "workspaces — pick one")
        if fp8:
            h = TensorHandle(self._num_tiles8, rows, cols, fp8=True)
            self._num_tiles8 += h.rt * h.ct
            return h
        if kv8:
            h = TensorHandle(self._num_tiles_kv8, rows, cols, kv8=True)
            self._num_tiles_kv8 += h.rt * h.ct
            return h
        h = TensorHandle(self._num_tiles, rows, cols)
        self._num_tiles += h.rt * h.ct
        return h

    @staticmethod
    def _no_fp8(*handles):
        """fp8-space handles are GEMM B operands only, and kv8 pool handles
        paged-attention/append operands only: their tile ids start at 0 in
        their own spaces, so any other op encoding them would alias
        main-workspace tiles (data and hazards)."""
        for h in handles:
            if h is not None and getattr(h, "fp8", False):
                raise ValueError(
                    "fp8 weight-workspace tensors can only be GEMM B "
                    "operands (GEMM_WIDE_W8) — other tasks address the "
                    "main workspace")
            if h is not None and getattr(h, "kv8", False):
                raise ValueError(
                    "kv8 pool-workspace tensors can only be paged KV "
                    "pools (ATTN_DECODE_PAGED_F8 / APPEND_KV_F8) — other "
                    "tasks address the main workspace")

    def tensor_mat(self, k: int, n: int, pair: bool = False) -> MatHandle:
        """A (k, n) weight matrix in the 2D MATRIX workspace (GEMM_MAT B
        operand; ``pair=True`` = interleaved gate|up layout, n per half —
        see tasks.py MatHandle)."""
        if k % TILE or n % TILE:
            raise ValueError(f"dims must be multiples of {TILE}, got "
                             f"({k}, {n})")
        mat_chunk_rows(k)   # raises early on an unchunkable K
        h = MatHandle(self._num_mrows, k, n, pair=pair)
        self._num_mrows += h.rows
        return h

    # -- dependency bookkeeping --------------------------------------------
    def _emit(self, task: Task, reads: list[int], writes: list[int]) -> int:
        tid = len(self._tasks)
        for t in reads:
            w = self._last_writer.get(t)
            if w is not None:
                self._edges.append((w, tid))          # RAW
            self._readers_since_write.setdefault(t, []).append(tid)
        for t in writes:
            w = self._last_writer.get(t)
            if w is not None:
                self._edges.append((w, tid))          # WAW
            for r in self._readers_since_write.get(t, []):
                if r != tid:
                    self._edges.append((r, tid))      # WAR
            self._last_writer[t] = tid
            self._readers_since_write[t] = []
        self._tasks.append(task)
        self._reads.append(tuple(reads))
        self._writes.append(tuple(writes))
        return tid

    # -- ops ----------------------------------------------------------------
    def copy(self, out: TensorHandle, a: TensorHandle):
        self._ew(TaskType.COPY, out, a)

    def add(self, out: TensorHandle, a: TensorHandle, b: TensorHandle):
        self._ew(TaskType.ADD, out, a, b)

    def silu_mul(self, out: TensorHandle, gate: TensorHandle,
                 up: TensorHandle):
        self._ew(TaskType.SILU_MUL, out, gate, up)

    def scale(self, out: TensorHandle, a: TensorHandle, factor: float):
        self._ew(TaskType.SCALE, out, a, arg=int(round(factor * 1e6)))

    def _ew(self, tt: TaskType, out, a, b=None, arg: int = 0):
        """One task per ROW of tiles (k_tiles = ct), so a wide elementwise
        op costs one dispatch instead of ct."""
        self._no_fp8(out, a, b)
        if (out.rt, out.ct) != (a.rt, a.ct) or (b and (b.rt, b.ct) != (a.rt, a.ct)):
            raise ValueError("elementwise shape mismatch")
        for i in range(out.rt):
            reads = [a.tile(i, j) for j in range(a.ct)]
            if b:
                reads += [b.tile(i, j) for j in range(a.ct)]
            self._emit(Task(tt, out.tile(i, 0), a0=a.tile(i, 0),
                            b0=b.tile(i, 0) if b else a.tile(i, 0),
                            k_tiles=a.ct, arg=arg),
                       reads, [out.tile(i, j) for j in range(out.ct)])
            self._max_row = max(self._max_row, a.ct)

    def prefetch(self, weight_tile: int, fp8: bool = False):
        """Start warming ``weight_tile`` into the reserved slot (the
        reference's weight-prefetch task). The next ``gemm(...,
        prefetch_first=True)`` whose first weight tile equals it consumes
        the warm. One outstanding prefetch at a time — the pseudo-resource
        hazard serializes slot reuse through the scheduler, and the
        builder rejects an unconsumed double-issue. ``fp8``: the tile
        lives in the e4m3 weight workspace (PREFETCH_W8). On the card the
        warm is an L2 prefetch of the tile; it changes no value."""
        if self._pending_pf is not None:
            raise ValueError(
                f"prefetch of tile {self._pending_pf[0]} not yet consumed — "
                "one reserved slot, one outstanding prefetch")
        if self._pf_res is None:
            self._pf_res = self.tensor(TILE, TILE)   # hazard token only
        tt = TaskType.PREFETCH_W8 if fp8 else TaskType.PREFETCH
        read_id = int(weight_tile) + (self._W8_HAZARD if fp8 else 0)
        self._emit(Task(tt, out=0, a0=int(weight_tile)),
                   [read_id], [self._pf_res.tile(0, 0)])
        self._pending_pf = (int(weight_tile), fp8)

    def gemm(self, out: TensorHandle, a: TensorHandle, b: TensorHandle,
             prefetch_first: bool = False, width: int = 16):
        """out (M,N) = a (M,K) @ b (K,N) as GEMM_WIDE strips of up to
        ``width`` output column tiles per task (GEMM_WIDE_W8 when ``b``
        lives in the e4m3 weight workspace). A task that spans B's full
        width with k % 4 == 0 carries the super-strip flag (d0 = 4): on
        the TPU a fetch shape, four k-rows per DMA; the CUDA kernel reads
        the same tiles either way, the word is kept so the queue equals
        the JAX builder's. ``prefetch_first``: the first task's first
        weight tile was warmed by a preceding :meth:`prefetch` (queue word
        c0 = 1)."""
        if isinstance(b, MatHandle):
            raise TypeError("matrix-workspace weights go through gemm_mat, "
                            "not gemm")
        if a.cols != b.rows or out.rows != a.rows or out.cols != b.cols:
            raise ValueError("gemm shape mismatch")
        if not 1 <= width <= 16:
            raise ValueError(f"gemm width {width} out of range")
        if a.fp8 or out.fp8:
            raise ValueError("fp8 space holds weights (GEMM B operands) "
                             "only — activations/outputs stay in the main "
                             "workspace")
        if prefetch_first:
            if self._pending_pf != (b.tile(0, 0), b.fp8):
                raise ValueError(
                    f"prefetch_first: pending prefetch {self._pending_pf} "
                    f"does not match this gemm's first weight tile "
                    f"{(b.tile(0, 0), b.fp8)}")
            self._pending_pf = None
        kt = a.ct
        tt = TaskType.GEMM_WIDE_W8 if b.fp8 else TaskType.GEMM_WIDE
        b_off = self._W8_HAZARD if b.fp8 else 0
        first = True
        for i in range(out.rt):
            j = 0
            while j < out.ct:
                wd = min(width, out.ct - j)
                su = 4 if (wd == b.ct and kt % 4 == 0 and kt >= 4) else 0
                reads = [a.tile(i, q) for q in range(kt)]
                reads += [b.tile(q, j + w) + b_off for q in range(kt)
                          for w in range(wd)]
                use_pf = prefetch_first and first
                if use_pf:
                    reads.append(self._pf_res.tile(0, 0))
                self._emit(
                    Task(tt, out.tile(i, j),
                         a0=a.tile(i, 0), b0=b.tile(0, j),
                         k_tiles=kt, a_stride=1, b_stride=b.ct,
                         arg=wd, c0=1 if use_pf else 0, d0=su),
                    reads, [out.tile(i, j + w) for w in range(wd)])
                self._max_gemm_width = max(self._max_gemm_width, wd)
                self._max_strip = max(self._max_strip, (su or 1) * wd)
                self._max_row = max(self._max_row, kt)
                first = False
                j += wd

    def prefetch_mat(self, w: MatHandle) -> int:
        """Start warming ``w``'s first weight chunk into the reserved
        matrix slot; the next ``gemm_mat(..., w, prefetch_first=True)``
        consumes it. One outstanding warm at a time. Returns the task id."""
        if self._pending_pf_mat is not None:
            raise ValueError(
                f"matrix prefetch of wsm base {self._pending_pf_mat[1]} "
                "not yet consumed — one reserved slot, one outstanding "
                "warm (emit the matching gemm_mat(prefetch_first=True))")
        if not isinstance(w, MatHandle):
            raise TypeError("prefetch_mat warms matrix-workspace weights "
                            "(tensor_mat handles)")
        if self._pfm_res is None:
            self._pfm_res = self.tensor(TILE, TILE)   # hazard token only
        tid = self._emit(Task(TaskType.PREFETCH_MAT, out=0, a0=w.base),
                         [self._WM_HAZARD + w.base],
                         [self._pfm_res.tile(0, 0)])
        self._pending_pf_mat = (tid, w.base)
        return tid

    def gemm_mat(self, out: TensorHandle, a: TensorHandle, w: MatHandle,
                 residual: TensorHandle | None = None,
                 norm_w: TensorHandle | None = None,
                 norm_out: TensorHandle | None = None,
                 eps: float = 1e-6, prefetch_first: bool = False):
        """out (TILE, N) = a (TILE, K) @ w — ONE GEMM_MAT task over the 2D
        matrix workspace. ``w.pair``: stores silu(gate half) * up half.
        ``residual``: ``+= residual``. ``norm_w``/``norm_out`` (needs
        ``residual``): also store ``norm_out = rms_norm(out) * norm_w``."""
        self._no_fp8(out, a, residual, norm_w, norm_out)
        if not isinstance(w, MatHandle):
            raise TypeError("gemm_mat weight must be a tensor_mat handle")
        if a.rt != 1 or out.rt != 1:
            raise ValueError("gemm_mat operates on single activation rows")
        if a.cols != w.k or out.cols != w.n:
            raise ValueError(
                f"gemm_mat shape mismatch: a ({a.rows},{a.cols}) @ w "
                f"({w.k},{w.n}{' pair' if w.pair else ''}) -> out "
                f"({out.rows},{out.cols})")
        if w.pair and residual is not None:
            raise ValueError("pair (silu) and residual epilogues are "
                             "mutually exclusive")
        if residual is not None and (residual.rt != 1
                                     or residual.cols != out.cols):
            raise ValueError(
                f"residual ({residual.rows},{residual.cols}) must match "
                f"out ({out.rows},{out.cols})")
        if (norm_w is None) != (norm_out is None):
            raise ValueError("epilogue 3 needs BOTH norm_w and norm_out")
        if norm_w is not None:
            if residual is None:
                raise ValueError("norm epilogue requires residual (it "
                                 "fuses the residual-chain add + norm)")
            if norm_out.rt != 1 or norm_out.cols != out.cols:
                raise ValueError(
                    f"norm_out ({norm_out.rows},{norm_out.cols}) must "
                    f"match out ({out.rows},{out.cols})")
            if norm_w.rt != 1 or norm_w.ct != out.ct:
                raise ValueError("norm_w must be the broadcast (TILE, N) "
                                 "norm-weight tensor matching out's width")
        if prefetch_first and (self._pending_pf_mat is None
                               or self._pending_pf_mat[1] != w.base):
            raise ValueError(
                f"prefetch_first: pending matrix warm "
                f"{self._pending_pf_mat} does not match this gemm_mat's "
                f"weight base {w.base}")
        epi = 1 if w.pair else (3 if norm_w is not None
                                else 2 if residual is not None else 0)
        spec = MatSpec(kt=a.ct, ns=w.n_strips, nt_out=out.ct,
                       kch=mat_chunk_rows(w.k), epi=epi,
                       warm=1 if prefetch_first else 0)
        try:
            si = self._mat_specs.index(spec)
        except ValueError:
            si = len(self._mat_specs)
            self._mat_specs.append(spec)
        reads = [a.tile(0, q) for q in range(a.ct)]
        reads.append(self._WM_HAZARD + w.base)
        if prefetch_first:
            # The warm task was emitted before its spec existed: patch its
            # spec-index word now, and order this task after it through
            # the reserved-slot pseudo resource.
            pf_tid, _ = self._pending_pf_mat
            self._tasks[pf_tid] = dataclasses.replace(
                self._tasks[pf_tid], a_stride=si)
            reads.append(self._pfm_res.tile(0, 0))
            self._pending_pf_mat = None
        if residual is not None:
            reads += [residual.tile(0, q) for q in range(out.ct)]
        writes = [out.tile(0, j) for j in range(out.ct)]
        arg = epi
        b_stride = d0 = 0
        if epi == 3:
            reads += [norm_w.tile(0, q) for q in range(out.ct)]
            writes += [norm_out.tile(0, j) for j in range(out.ct)]
            arg = epi | (int(round(eps * 1e9)) << 8)
            b_stride, d0 = norm_w.tile(0, 0), norm_out.tile(0, 0)
        self._emit(
            Task(TaskType.GEMM_MAT, out.tile(0, 0), a0=a.tile(0, 0),
                 b0=w.base, k_tiles=a.ct, a_stride=si, b_stride=b_stride,
                 arg=arg,
                 c0=residual.tile(0, 0) if residual is not None else 0,
                 d0=d0),
            reads, writes)
        self._max_row = max(self._max_row, a.ct, out.ct)

    def norm_rope(self, out: TensorHandle, a: TensorHandle,
                  w: TensorHandle, cos: TensorHandle, sin: TensorHandle,
                  eps: float = 1e-6):
        """Fused per-head qk-norm + RoPE over ONE (TILE, TILE) head tile
        (the norm reduces over the head's ``head_dim`` columns of it)."""
        self._no_fp8(out, a, w, cos, sin)
        for t in (out, a):
            if t.rt != 1 or t.ct != 1:
                raise ValueError("norm_rope operates on single head tiles")
        for t in (w, cos, sin):
            if t.rt != 1 or t.ct < 1:
                raise ValueError("norm weight / rope tables must be single-"
                                 "row-tile tensors")
        if cos.ct != 1 or sin.ct != 1 or w.ct != 1:
            raise ValueError("norm_rope reads one (TILE, TILE) tile of "
                             "w/cos/sin — wider tables would be silently "
                             "truncated")
        self._emit(
            Task(TaskType.NORM_ROPE, out.tile(0, 0), a0=a.tile(0, 0),
                 b0=w.tile(0, 0), arg=int(round(eps * 1e9)),
                 c0=cos.tile(0, 0), d0=sin.tile(0, 0)),
            [a.tile(0, 0), w.tile(0, 0), cos.tile(0, 0), sin.tile(0, 0)],
            [out.tile(0, 0)])

    def append_kv(self, kT: TensorHandle, v: TensorHandle, pos: int,
                  k_new: TensorHandle, v_new: TensorHandle):
        """In-kernel KV cache append at position ``pos``: k_new's row 0
        becomes column pos of the kT cache, v_new's row 0 becomes row pos
        of the v cache. a_stride/b_stride carry the cache base tiles, so
        a host retarget (``models.advance_queue_pos`` on the linear cache,
        the paged decoder's on pools) moves the row per step without
        recompiling. kv8 pools (kT and v both) emit APPEND_KV_F8, which
        stores through the saturating e4m3 cast."""
        self._no_fp8(k_new, v_new)
        if kT.kv8 != v.kv8:
            raise ValueError(
                "append_kv pools must live in ONE space: kT and v are "
                f"kv8={kT.kv8}/{v.kv8} — a mixed-dtype page pool would "
                "read one space and write the other")
        if not kT.kv8:
            self._no_fp8(kT, v)
        if not 0 <= pos < kT.ct * TILE:
            raise ValueError(f"append pos {pos} outside cache capacity")
        if kT.rt != 1 or v.ct != 1:
            raise ValueError("kT must be (d, S), v (S, d)")
        for t in (k_new, v_new):
            if t.rt != 1 or t.ct != 1:
                raise ValueError("k_new/v_new must be single head tiles")
        ti, col = pos // TILE, pos % TILE
        kt_tile, v_tile = kT.tile(0, ti), v.tile(ti, 0)
        hz = self._K8_HAZARD if kT.kv8 else 0
        tt = TaskType.APPEND_KV_F8 if kT.kv8 else TaskType.APPEND_KV
        return self._emit(
            Task(tt, kt_tile, a0=k_new.tile(0, 0),
                 b0=v_tile, a_stride=kT.tile(0, 0), b_stride=v.tile(0, 0),
                 c0=col, d0=v_new.tile(0, 0)),
            [k_new.tile(0, 0), v_new.tile(0, 0), kt_tile + hz, v_tile + hz],
            [kt_tile + hz, v_tile + hz])

    def add_norm(self, out_x2: TensorHandle, a: TensorHandle,
                 b: TensorHandle, w: TensorHandle,
                 out_xn: TensorHandle, eps: float = 1e-6):
        """Fused ``out_x2 = a + b`` and ``out_xn = rms_norm(out_x2) * w``
        in ONE task (ADD_NORM; the norm reads the STORED out_x2, so the
        pair equals the add + rms_norm tasks bit for bit). ``w`` is the
        broadcast (TILE, cols) norm-weight tensor."""
        self._no_fp8(out_x2, a, b, w, out_xn)
        for t in (out_x2, a, b, out_xn):
            if t.rt != 1 or (t.ct != a.ct):
                raise ValueError("add_norm operates on single-row-tile "
                                 "tensors of equal width")
        if w.ct != a.ct:
            raise ValueError("norm weight width must match the row")
        reads = ([a.tile(0, j) for j in range(a.ct)]
                 + [b.tile(0, j) for j in range(a.ct)]
                 + [w.tile(0, j) for j in range(a.ct)])
        writes = ([out_x2.tile(0, j) for j in range(a.ct)]
                  + [out_xn.tile(0, j) for j in range(a.ct)])
        self._emit(
            Task(TaskType.ADD_NORM, out_x2.tile(0, 0), a0=a.tile(0, 0),
                 b0=b.tile(0, 0), k_tiles=a.ct, b_stride=w.tile(0, 0),
                 arg=int(round(eps * 1e9)), d0=out_xn.tile(0, 0)),
            reads, writes)
        self._max_row = max(self._max_row, a.ct)

    def norm_rope_qkv(self, q: TensorHandle, hq: int, k: TensorHandle,
                      hkv: int, q_norm: TensorHandle, k_norm: TensorHandle,
                      cos: TensorHandle, sin: TensorHandle,
                      eps: float = 1e-6):
        """Per-head qk-norm + RoPE over ALL hq q-heads and hkv k-heads in
        ONE task. Requires the fused qkv layout — k's head tiles
        contiguous after q's."""
        self._no_fp8(q, k, q_norm, k_norm, cos, sin)
        if q.rt != 1 or k.rt != 1:
            raise ValueError("q/k must be single-row-tile activations")
        if q.ct < hq or k.ct < hkv:
            raise ValueError(f"head counts ({hq}, {hkv}) exceed tensor "
                             f"widths ({q.ct}, {k.ct})")
        if k.base != q.base + hq:
            raise ValueError(
                "norm_rope_qkv needs k's head tiles contiguous after q's "
                f"(q base {q.base} + hq {hq} != k base {k.base}) — the "
                "fused qkv_out layout")
        for t in (q_norm, k_norm, cos, sin):
            if t.rt != 1 or t.ct != 1:
                raise ValueError("norm weights / rope tables must be "
                                 "single (TILE, TILE) tiles")
        head_tiles = [q.tile(0, j) for j in range(hq)] \
            + [k.tile(0, j) for j in range(hkv)]
        reads = head_tiles + [q_norm.tile(0, 0), k_norm.tile(0, 0),
                              cos.tile(0, 0), sin.tile(0, 0)]
        self._emit(
            Task(TaskType.NORM_ROPE_QKV, q.tile(0, 0), a0=q.tile(0, 0),
                 b0=q_norm.tile(0, 0), k_tiles=hq,
                 a_stride=k_norm.tile(0, 0), b_stride=hkv,
                 arg=int(round(eps * 1e9)), c0=cos.tile(0, 0),
                 d0=sin.tile(0, 0)),
            reads, head_tiles)

    def rms_norm(self, out: TensorHandle, a: TensorHandle, w: TensorHandle,
                 eps: float = 1e-6):
        """Row-wise RMSNorm over the full width; ``w`` is the norm weight
        stored broadcast as a (TILE, cols) tensor (models.broadcast_rows);
        one task per row block."""
        self._no_fp8(out, a, w)
        if (out.rt, out.ct) != (a.rt, a.ct) or w.ct != a.ct:
            raise ValueError("rms_norm shape mismatch")
        for i in range(out.rt):
            reads = [a.tile(i, j) for j in range(a.ct)]
            reads += [w.tile(0, j) for j in range(a.ct)]
            self._emit(
                Task(TaskType.RMS_NORM, out.tile(i, 0), a0=a.tile(i, 0),
                     b0=w.tile(0, 0), k_tiles=a.ct,
                     arg=int(round(eps * 1e9))),
                reads, [out.tile(i, j) for j in range(out.ct)])
            self._max_row = max(self._max_row, a.ct)

    def attn_decode(self, out: TensorHandle, q: TensorHandle,
                    kT: TensorHandle, v: TensorHandle, valid_len: int,
                    scale: float, k_new: TensorHandle | None = None,
                    v_new: TensorHandle | None = None):
        """One-token flash-attention decode for ONE head over a linear
        cache. q/out: (TILE, TILE) — rows = padded batch, cols = head_dim
        = TILE; kT: (TILE, S) the head's cached keys transposed; v: (S,
        TILE). ``valid_len`` masks cache columns >= valid (a runtime queue
        word). ``k_new``/``v_new`` (one (TILE, TILE) tile each, row b =
        the token batch row b just projected) join the softmax as the
        current position."""
        self._no_fp8(out, q, kT, v, k_new, v_new)
        if q.rt != 1 or q.ct != 1 or out.rt != 1 or out.ct != 1:
            raise ValueError("q/out must be a single (TILE, TILE) tile")
        if kT.rt != 1 or v.ct != 1 or kT.ct != v.rt:
            raise ValueError("kT must be (TILE, S), v (S, TILE)")
        if (k_new is None) != (v_new is None):
            raise ValueError("pass both k_new and v_new or neither")
        if k_new is None and valid_len < 1:
            raise ValueError("cache-only attention needs valid_len >= 1 "
                             "(all-masked softmax)")
        if valid_len > kT.ct * TILE:
            raise ValueError(
                f"valid_len {valid_len} exceeds cache capacity "
                f"{kT.ct * TILE} — the mask would admit garbage positions")
        if k_new is not None and (k_new.rt != 1 or k_new.ct != 1
                                  or v_new.rt != 1 or v_new.ct != 1):
            raise ValueError("k_new/v_new must be single (TILE, TILE) tiles "
                             "(one head's current k/v — use a _col view)")
        # Fully-masked cache tiles contribute nothing: don't visit them.
        k_tiles = min(kT.ct, -(-valid_len // TILE))
        reads = ([q.tile(0, 0)] + [kT.tile(0, j) for j in range(k_tiles)]
                 + [v.tile(j, 0) for j in range(k_tiles)])
        c0 = d0 = -1
        if k_new is not None:
            c0, d0 = k_new.tile(0, 0), v_new.tile(0, 0)
            reads += [c0, d0]
        self._emit(
            Task(TaskType.ATTN_DECODE, out.tile(0, 0), a0=q.tile(0, 0),
                 b0=kT.tile(0, 0), k_tiles=k_tiles, a_stride=v.tile(0, 0),
                 b_stride=int(valid_len), arg=int(round(scale * 1e6)),
                 c0=c0, d0=d0),
            reads, [out.tile(0, 0)])

    def attn_decode_gqa(self, out: TensorHandle, out_j: int,
                        q: TensorHandle, q_j: int, g: int,
                        kT: TensorHandle, v: TensorHandle, valid_len: int,
                        scale: float, k_new: TensorHandle | None = None,
                        v_new: TensorHandle | None = None):
        """One-token decode for a WHOLE GQA group: the ``g`` q-heads at
        column tiles ``q_j..q_j+g-1`` of ``q`` (outputs at
        ``out_j..out_j+g-1`` of ``out``) attend the shared kv head's
        kT/v. The task lists every visited cache tile in its reads, so
        the same layer's append of that head waits for it."""
        self._no_fp8(out, q, kT, v, k_new, v_new)
        if not 1 <= g <= 127:
            raise ValueError(f"group size {g} out of range")
        if q_j + g > q.ct or out_j + g > out.ct:
            raise ValueError(
                f"group [{q_j}, {q_j + g}) exceeds q.ct={q.ct} or "
                f"out.ct={out.ct} — the tiles would alias the next tensor")
        if q.rt != 1 or out.rt != 1:
            raise ValueError("q/out must be single-row-tile activations")
        if not 0 < scale < 16:
            raise ValueError(f"scale {scale} out of the 24-bit arg field")
        if kT.rt != 1 or v.ct != 1 or kT.ct != v.rt:
            raise ValueError("kT must be (TILE, S), v (S, TILE)")
        if (k_new is None) != (v_new is None):
            raise ValueError("pass both k_new and v_new or neither")
        if k_new is None and valid_len < 1:
            raise ValueError("cache-only attention needs valid_len >= 1")
        if valid_len > kT.ct * TILE:
            raise ValueError(f"valid_len {valid_len} exceeds cache "
                             f"capacity {kT.ct * TILE}")
        k_tiles = min(kT.ct, -(-valid_len // TILE))
        q_tiles = [q.tile(0, q_j + h) for h in range(g)]
        out_tiles = [out.tile(0, out_j + h) for h in range(g)]
        reads = (q_tiles + [kT.tile(0, j) for j in range(k_tiles)]
                 + [v.tile(j, 0) for j in range(k_tiles)])
        c0 = d0 = -1
        if k_new is not None:
            if (k_new.rt != 1 or k_new.ct != 1 or v_new.rt != 1
                    or v_new.ct != 1):
                raise ValueError("k_new/v_new must be single (TILE, TILE) "
                                 "tiles (one kv head's current k/v)")
            c0, d0 = k_new.tile(0, 0), v_new.tile(0, 0)
            reads += [c0, d0]
        self._max_gqa = max(self._max_gqa, g)
        self._emit(
            Task(TaskType.ATTN_DECODE_GQA, out_tiles[0], a0=q_tiles[0],
                 b0=kT.tile(0, 0), k_tiles=k_tiles, a_stride=v.tile(0, 0),
                 b_stride=int(valid_len),
                 arg=int(round(scale * 1e6)) | (g << 24), c0=c0, d0=d0),
            reads, out_tiles)

    def attn_decode_paged(self, out: TensorHandle, q: TensorHandle,
                          pages: list[tuple[int, int]], valid_len: int,
                          scale: float, k_new: TensorHandle | None = None,
                          v_new: TensorHandle | None = None,
                          kv8: bool = False):
        """Page-table flash-attention decode for ONE head: the j-th cache
        tile pair (kT tile id, V tile id) comes from ``pages``, packed as
        queue DATA rows at compile. ``pages[j]`` covers logical positions
        [j·TILE, (j+1)·TILE); kT tiles are (d, TILE) key columns, v tiles
        (TILE, d) value rows. ``k_new``/``v_new`` (the current token)
        join the softmax row by row. ``kv8=True``: the page tile ids
        address the e4m3 kv8 workspace (ATTN_DECODE_PAGED_F8)."""
        self._no_fp8(out, q, k_new, v_new)
        if q.rt != 1 or q.ct != 1 or out.rt != 1 or out.ct != 1:
            raise ValueError("q/out must be a single (TILE, TILE) tile")
        if (k_new is None) != (v_new is None):
            raise ValueError("pass both k_new and v_new or neither")
        if k_new is None and valid_len < 1:
            raise ValueError("cache-only attention needs valid_len >= 1")
        if valid_len > len(pages) * TILE:
            raise ValueError(
                f"valid_len {valid_len} exceeds table coverage "
                f"{len(pages) * TILE}")
        # valid_len == 0 (empty cache, current token only): visit no pages.
        k_tiles = min(len(pages), -(-valid_len // TILE))
        hz = self._K8_HAZARD if kv8 else 0
        reads = [q.tile(0, 0)]
        flat: list[int] = []
        for kt_t, v_t in pages:
            flat += [int(kt_t), int(v_t)]
        reads += [t + hz for pair in pages[:k_tiles] for t in pair]
        c0 = d0 = -1
        if k_new is not None:
            c0, d0 = k_new.tile(0, 0), v_new.tile(0, 0)
            reads += [c0, d0]
        tt = (TaskType.ATTN_DECODE_PAGED_F8 if kv8
              else TaskType.ATTN_DECODE_PAGED)
        tid = self._emit(
            Task(tt, out.tile(0, 0),
                 a0=q.tile(0, 0), b0=-1,   # b0 patched to table row at compile
                 k_tiles=k_tiles, a_stride=0,
                 b_stride=int(valid_len), arg=int(round(scale * 1e6)),
                 c0=c0, d0=d0),
            reads, [out.tile(0, 0)])
        self._task_tables[tid] = flat
        return tid

    def moe_topk(self, out_wt: TensorHandle, logits: TensorHandle,
                 topk: int, num_experts: int, batch: int):
        """Router top-k + softmax over the selected logits into the dense
        (E, B) TRANSPOSED weight tile ``out_wt`` (E = num_experts <=
        TILE). Rows >= ``batch`` and columns >= ``num_experts`` of the
        logits tile are masked: a zero-logit pad row would elect experts
        and defeat MOE_FFN's skip."""
        self._no_fp8(out_wt, logits)
        if not 1 <= topk <= num_experts <= TILE:
            raise ValueError(
                f"need 1 <= topk ({topk}) <= E ({num_experts}) <= {TILE}")
        if not 1 <= batch <= TILE:
            raise ValueError(f"batch {batch} out of range")
        if logits.rt != 1 or logits.ct != 1 or out_wt.rt != 1 \
                or out_wt.ct != 1:
            raise ValueError("logits/out_wt must be single (TILE, TILE) "
                             "tiles (E <= 128 experts)")
        self._emit(
            Task(TaskType.MOE_TOPK, out_wt.tile(0, 0),
                 a0=logits.tile(0, 0), b_stride=num_experts, arg=topk,
                 d0=batch),
            [logits.tile(0, 0)], [out_wt.tile(0, 0)])

    def moe_ffn(self, out: TensorHandle, xn: TensorHandle,
                wt: TensorHandle, w_gate: TensorHandle, w_up: TensorHandle,
                w_down: TensorHandle, num_experts: int):
        """One task = one layer's whole expert MLP (tasks.py MOE_FFN).
        xn/out: (TILE, hidden); wt: the (E, B) weight tile of
        :meth:`moe_topk`; w_gate/w_up: (E·hidden, ffn) stacked expert
        weights; w_down: (E·ffn, hidden). Experts no token selected are
        skipped before their weights are read. The expert weights are
        never written by a task, so their read set records each stack's
        base tile only (the full list would be E·HT·FT tiles per layer
        and add no edge)."""
        self._no_fp8(out, xn, wt, w_gate, w_up, w_down)
        if out.rt != 1 or xn.rt != 1 or out.ct != xn.ct:
            raise ValueError("xn/out must be (TILE, hidden) rows of equal "
                             "width")
        if wt.rt != 1 or wt.ct != 1:
            raise ValueError("wt must be the single MOE_TOPK output tile")
        ht = xn.ct
        if w_gate.rt % num_experts or w_gate.rt // num_experts != ht:
            raise ValueError(
                f"w_gate rows {w_gate.rows} != E*hidden "
                f"({num_experts}*{xn.cols})")
        ft = w_gate.ct
        if w_up.rt != w_gate.rt or w_up.ct != ft:
            raise ValueError("w_up shape mismatch with w_gate")
        if w_down.rt != num_experts * ft or w_down.ct != ht:
            raise ValueError(
                f"w_down must be (E*ffn_local, hidden), got "
                f"({w_down.rows}, {w_down.cols})")
        if num_experts > TILE:
            raise ValueError(f"E {num_experts} > {TILE} needs multi-tile "
                             "router output (unsupported)")
        reads = ([xn.tile(0, j) for j in range(ht)]
                 + [wt.tile(0, 0), w_gate.tile(0, 0), w_up.tile(0, 0),
                    w_down.tile(0, 0)])
        self._emit(
            Task(TaskType.MOE_FFN, out.tile(0, 0), a0=xn.tile(0, 0),
                 b0=wt.tile(0, 0), k_tiles=ht, a_stride=w_gate.tile(0, 0),
                 b_stride=w_up.tile(0, 0),
                 arg=num_experts | (ft << 16), c0=w_down.tile(0, 0)),
            reads, [out.tile(0, j) for j in range(ht)])
        self._max_moe_h = max(self._max_moe_h, ht)
        self._max_moe_f = max(self._max_moe_f, ft)
        self._max_row = max(self._max_row, ht)
        # The TPU kernel double-buffers two gate/up (ft) and two down (ht)
        # strips in its strip buffer; kept for the workspace geometry.
        self._max_strip = max(self._max_strip, 2 * ft, 2 * ht)

    def all_reduce(self, t: TensorHandle):
        """Sum ``t`` over the ranks in place (reference make_allreduce):
        one ALLREDUCE_ROW task per row of tiles, which pushes the whole row
        to each peer as one slab. On the card each block pushes its share,
        raises one flag a peer and waits for theirs, over two parity slot
        sets: no grid or exit barrier inside the task; the queue's barrier
        before each AllReduce row that follows another orders the sets'
        reuse (:func:`barrier_rows`). The single-tile ALLREDUCE stays
        dispatchable for the queue ABI; the builder no longer emits it."""
        self._no_fp8(t)
        for i in range(t.rt):
            row = [t.tile(i, j) for j in range(t.ct)]
            self._emit(Task(TaskType.ALLREDUCE_ROW, t.tile(i, 0),
                            k_tiles=t.ct), row, row)
        self._max_ar = max(self._max_ar, t.ct)

    # -- compile -------------------------------------------------------------
    def compile(self, dtype=torch.float32, head_dim: int | None = None, *,
                num_ranks: int = 1, axis: str = "tp",
                force_ar: bool = False) -> "CompiledMegaKernel":
        """Pack the queue. ``num_ranks``: the TP group the program runs on
        (every rank runs the same queue; the cross-rank tasks match by
        queue position, which the deterministic schedule keeps equal);
        ``axis``: the group's axis name; ``force_ar``: run the AllReduce
        protocol at ``num_ranks == 1`` against the rank itself (the
        one-card price of the in-kernel AR)."""
        if head_dim is None:
            head_dim = self.head_dim
        elif head_dim != self.head_dim:
            raise ValueError(
                f"compile(head_dim={head_dim}) mismatches the program's "
                f"build-time head_dim {self.head_dim} — the norm/rope "
                "sub-tile span is part of the assembly, not a free "
                "compile knob")
        if self._pending_pf is not None:
            raise ValueError(
                f"prefetch of tile {self._pending_pf[0]} never consumed — "
                "the kernel would exit with an outstanding warm on the "
                "reserved slot (emit the matching "
                "gemm(prefetch_first=True))")
        if self._pending_pf_mat is not None:
            raise ValueError(
                f"matrix prefetch of wsm base {self._pending_pf_mat[1]} "
                "never consumed — emit the matching "
                "gemm_mat(prefetch_first=True)")
        order = topo_schedule(len(self._tasks), self._edges,
                              task_types=[t.type for t in self._tasks])
        # Emission-order task id -> queue row (paged-serving hosts retarget
        # per-slot attention/append rows without re-deriving the schedule).
        task_rows = [0] * len(order)
        for pos, t in enumerate(order):
            task_rows[t] = pos
        rows = [self._tasks[t].encode() for t in order]
        n_exec = len(rows)
        # Page tables pack as DATA rows after the executable tasks; each
        # owning task's b0 becomes its table's absolute starting row.
        for pos, t in enumerate(order):
            flat = self._task_tables.get(t)
            if flat is None:
                continue
            rows[pos][3] = len(rows)
            padded = list(flat) + [0] * (-len(flat) % WORDS)
            for off in range(0, len(padded), WORDS):
                rows.append(padded[off:off + WORDS])
        queue = np.asarray(rows, np.int32).reshape(-1, WORDS)
        used_types = tuple(sorted({int(t.type) for t in self._tasks}))
        return CompiledMegaKernel(
            queue=queue, num_tiles=self._num_tiles,
            num_tiles8=self._num_tiles8,
            num_tiles_kv8=self._num_tiles_kv8,
            dtype=torch_dtype(dtype), num_exec=n_exec,
            max_gqa=self._max_gqa, max_gemm_width=self._max_gemm_width,
            max_row=self._max_row, max_strip=self._max_strip,
            max_moe_h=self._max_moe_h, max_moe_f=self._max_moe_f,
            num_mrows=self._num_mrows,
            mat_specs=tuple(self._mat_specs), used_types=used_types,
            num_ranks=int(num_ranks), axis=axis, max_ar=self._max_ar,
            force_ar=bool(force_ar),
            head_dim=int(head_dim), task_rows=tuple(task_rows),
            hazard_edges=tuple(self._edges),
            task_reads=tuple(self._reads),
            task_writes=tuple(self._writes),
            sync_before=barrier_rows(order, self._edges,
                                     [t.type for t in self._tasks]))


def barrier_rows(order: list[int], edges, types) -> np.ndarray:
    """Per queue row, 1 where the CUDA interpreter must hold a grid-wide
    barrier before the task starts, else 0.

    The TPU runs one task at a time, so its queue order alone keeps every
    dependency. The GPU kernel runs a task's work across all blocks and
    lets consecutive tasks with no hazard between them share one barrier
    interval: a task waits only when one of its hazard predecessors
    (RAW, WAR or WAW over workspace tiles — main, matrix and kv8 spaces
    alike, ``hazard_edges``) ran in the current interval. Every GEMM_MAT
    and MOE_FFN starts after a barrier, because the scratch they stage
    partial sums or expert activations in is shared, and ends its own
    interval (each holds a barrier inside); GEMM_WIDE keeps its sums
    inside one block and needs neither. The build-time edges cover
    the runtime ones. Paged programs: at build time every slot's page
    table and append target is the one scratch page, so every attention
    read and append write of a layer is ordered against every other's; at
    run time each slot's pages are its own. Linear programs: built at
    ``pos = max_seq - 1``, each attention task reads every tile of its
    head's cache, so the append of that head waits for it wherever
    ``advance_queue_pos`` moves the append to. An AllReduce row that
    follows another in the interval starts after a barrier too: the CUDA
    task has none of its own, and its two parity slot sets rest on one
    between any two AllReduce rows of a launch (``csrc/megakernel.cu``
    t_allreduce)."""
    preds: list[set[int]] = [set() for _ in types]
    for s, d in edges:
        preds[d].add(s)
    ar = (TaskType.ALLREDUCE, TaskType.ALLREDUCE_ROW)
    sync = np.zeros((len(order),), np.int32)
    open_tasks: set[int] = set()
    for pos, t in enumerate(order):
        scratch = types[t] in (TaskType.GEMM_MAT, TaskType.MOE_FFN)
        after_ar = types[t] in ar and any(types[u] in ar
                                          for u in open_tasks)
        if pos and (scratch or after_ar or preds[t] & open_tasks):
            sync[pos] = 1
            open_tasks = set()
        open_tasks.add(t)
    return sync


@dataclasses.dataclass
class CompiledMegaKernel:
    """Packed queue + workspace geometry; :meth:`step` is the single
    launch."""

    queue: np.ndarray             # (rows, WORDS) int32: tasks, then data
    num_tiles: int
    num_tiles8: int = 0           # e4m3 weight-workspace tiles (0 = unused)
    num_tiles_kv8: int = 0        # e4m3 KV-pool workspace tiles (0 = none)
    dtype: torch.dtype = torch.float32   # workspace dtype; compute is fp32
    num_exec: int | None = None   # dispatched rows (rest = page-table data)
    max_gqa: int = 1              # largest GQA group
    max_gemm_width: int = 1       # widest GEMM_WIDE strip (column tiles)
    max_row: int = 1              # widest resident row (tiles)
    max_strip: int = 1            # widest strip fetch of the TPU kernel
    max_moe_h: int = 0            # MoE hidden tiles (0 = no MoE tasks)
    max_moe_f: int = 0            # MoE ffn tiles
    num_mrows: int = 0            # 2D matrix-workspace rows (0 = unused)
    mat_specs: tuple = ()         # static GEMM_MAT shapes (spec index)
    used_types: tuple = ()        # task types in the queue
    num_ranks: int = 1            # the TP group the queue runs on
    axis: str = "tp"              # the group's axis name
    max_ar: int = 1               # widest ALLREDUCE_ROW slab (tiles)
    force_ar: bool = False        # run the AR protocol at n = 1 (loopback)
    head_dim: int = TILE          # NORM_ROPE_QKV sub-tile span
    task_rows: tuple | None = None    # emission task id -> queue row
    hazard_edges: tuple | None = None  # (src, dst) emission-id edges
    task_reads: tuple | None = None   # per-task read tile-id sets
    task_writes: tuple | None = None  # per-task write tile-id sets
    sync_before: np.ndarray | None = None  # per exec row: barrier first

    @property
    def _strip_pad(self) -> int:
        """Tail tiles of the JAX package's main and e4m3 weight
        workspaces: its static-size strip fetches may overrun the last
        real tile (ALLREDUCE_ROW's static max_ar slab push too). The CUDA
        kernel addresses exactly the tiles a task names and never reads
        the pad; it is kept so the two packages' workspaces have the same
        shape, tile for tile."""
        return max(self.max_strip, self.max_gemm_width, self.max_moe_h,
                   self.max_moe_f, self.max_ar, 8) - 1

    def scatter_input(self, ws: torch.Tensor, h: TensorHandle,
                      value) -> torch.Tensor:
        """Write (rows, cols) ``value`` into the tiled workspace (main,
        the e4m3 weight workspace for an fp8 handle, or kv8 for a kv8
        handle), in place; returns ``ws``. An e4m3 target takes the
        saturating cast (+-448 clamp), as the in-kernel append does."""
        if (h.kv8 or h.fp8) != (ws.dtype == E4M3):
            raise ValueError(f"handle fp8={h.fp8} kv8={h.kv8} does not "
                             f"match a {ws.dtype} workspace")
        v = saturate_cast(torch.as_tensor(value).to(ws.device), ws.dtype)
        if tuple(v.shape) != (h.rows, h.cols):
            raise ValueError(f"value {tuple(v.shape)} does not match handle "
                             f"({h.rows}, {h.cols})")
        tiles = v.reshape(h.rt, TILE, h.ct, TILE).permute(0, 2, 1, 3)
        ws[h.base:h.base + h.rt * h.ct] = tiles.reshape(-1, TILE, TILE)
        return ws

    def gather_output(self, ws: torch.Tensor, h: TensorHandle
                      ) -> torch.Tensor:
        """(rows, cols) of ``h`` from its workspace (kv8 handles from the
        kv8 workspace, as stored; fp8 weight handles are inputs only)."""
        if h.fp8:
            raise ValueError("fp8 weight-workspace tensors are read-only "
                             "inputs; gather_output reads the main "
                             "workspace")
        tiles = ws[h.base:h.base + h.rt * h.ct]
        return tiles.reshape(h.rt, h.ct, TILE, TILE).permute(
            0, 2, 1, 3).reshape(h.rows, h.cols)

    def make_workspace(self, inputs: dict, device=None) -> torch.Tensor:
        """Build the tiled MAIN workspace once (weights + caches +
        activations) on ``device`` (None: the card); matrix handles go to
        :meth:`make_workspace_mat`."""
        device = resolve_device(device)
        ws = torch.zeros((max(self.num_tiles, 1) + self._strip_pad,
                          TILE, TILE), dtype=self.dtype, device=device)
        for h, v in inputs.items():
            if isinstance(h, MatHandle):
                raise ValueError("matrix handle in main workspace feeds — "
                                 "pass it to make_workspace_mat (or use "
                                 "split_feeds)")
            if h.fp8:
                raise ValueError("fp8 handle in main workspace feeds — "
                                 "pass it to make_workspace8")
            if h.kv8:
                raise ValueError("kv8 pool handle in main workspace feeds "
                                 "— pass it to make_workspace_kv8")
            self.scatter_input(ws, h, v)
        return ws

    def make_workspace8(self, inputs: dict, device=None) -> torch.Tensor:
        """The e4m3 weight workspace (read-only input of every step):
        ``inputs`` (fp8 handles → (rows, cols) values) quantize through
        the saturating cast on scatter. ``device`` None: the card."""
        device = resolve_device(device)
        ws8 = torch.zeros((max(self.num_tiles8, 1) + self._strip_pad,
                           TILE, TILE), dtype=E4M3, device=device)
        for h, v in inputs.items():
            if not h.fp8:
                raise ValueError("non-fp8 handle in fp8 workspace feeds")
            self.scatter_input(ws8, h, v)
        return ws8

    def make_workspace_kv8(self, inputs: dict | None = None,
                           device=None) -> torch.Tensor:
        """The e4m3 KV-pool workspace: zeroed pools (updated in place by
        every step), ``inputs`` (kv8 handles → values) scattered through
        the saturating cast. ``device`` None: the card."""
        device = resolve_device(device)
        wkv8 = torch.zeros((max(self.num_tiles_kv8, 1), TILE, TILE),
                           dtype=E4M3, device=device)
        for h, v in (inputs or {}).items():
            if not getattr(h, "kv8", False):
                raise ValueError("non-kv8 handle in kv8 workspace feeds")
            self.scatter_input(wkv8, h, v)
        return wkv8

    @staticmethod
    def split_feeds(feeds: dict) -> tuple[dict, dict, dict]:
        """Split a mixed feeds dict into (main, fp8 weight, matrix)
        workspace feeds. kv8 pool handles are refused: pools start zeroed
        (:meth:`make_workspace_kv8`)."""
        for h in feeds:
            if not isinstance(h, MatHandle) and h.kv8:
                raise ValueError(
                    "kv8 pool handle in feeds — scatter_input it into "
                    "the kv8 workspace (make_workspace_kv8) instead")
        main = {h: v for h, v in feeds.items()
                if not isinstance(h, MatHandle) and not h.fp8}
        w8 = {h: v for h, v in feeds.items()
              if not isinstance(h, MatHandle) and h.fp8}
        wm = {h: v for h, v in feeds.items() if isinstance(h, MatHandle)}
        return main, w8, wm

    def scatter_mat(self, wsm: torch.Tensor, h: MatHandle,
                    value) -> torch.Tensor:
        """Write a weight matrix into the 2D matrix workspace, in place.
        ``value``: (k, n), or for ``h.pair`` a (gate, up) pair of (k, n)
        tensors interleaved per strip."""
        half = MAT_COLS // 2
        ns = h.n_strips

        def prep(x, width):
            x = torch.as_tensor(x).to(device=wsm.device, dtype=wsm.dtype)
            if tuple(x.shape) != (h.k, h.n):
                raise ValueError(f"value must be ({h.k}, {h.n}), got "
                                 f"{tuple(x.shape)}")
            x = torch.nn.functional.pad(x, (0, ns * width - h.n))
            return x.reshape(h.k, ns, width)

        if h.pair:
            g, u = value
            strips = torch.cat([prep(g, half), prep(u, half)], dim=2)
        else:
            strips = prep(value, MAT_COLS)
        wsm[h.base:h.base + h.rows] = strips.permute(1, 0, 2).reshape(
            h.rows, MAT_COLS)
        return wsm

    def make_workspace_mat(self, inputs: dict, device=None) -> torch.Tensor:
        """Build the 2D matrix weight workspace (read-only input of every
        step; pair handles take (gate, up) value tuples) on ``device``
        (None: the card)."""
        device = resolve_device(device)
        wsm = torch.zeros((max(self.num_mrows, 1), MAT_COLS),
                          dtype=self.dtype, device=device)
        for h, v in inputs.items():
            if not isinstance(h, MatHandle):
                raise ValueError("non-matrix handle in matrix workspace "
                                 "feeds")
            self.scatter_mat(wsm, h, v)
        return wsm

    def step(self, ws: torch.Tensor, queue=None,
             wsm: torch.Tensor | None = None, *,
             ws8: torch.Tensor | None = None,
             wkv8: torch.Tensor | None = None,
             live_rows: int = TILE, profile: bool = False,
             ar_tag: str = ""):
        """One queue execution over the workspace, in place; returns
        ``ws``. ``queue``: a host-retargeted copy of :attr:`queue`
        (default: the compiled one). ``ws8``: the e4m3 weight workspace
        of a program with GEMM_WIDE_W8 tasks; ``wkv8``: the kv8
        workspace, which a program with e4m3 pools needs (updated in
        place too). ``profile=True``: the kernel also stamps each task's
        dispatch record into an int32 (num_exec, 128) dump and the return
        becomes ``(ws, dump)``; decode it with
        ``obs.kernel_profile.KernelProfile.from_dump``.
        ``live_rows``: the rows of every 128-row block that carry data —
        the CUDA kernel computes only those (every handler is
        row-independent); the plain version computes all rows. A program
        compiled for a TP group (or with ``force_ar``) runs inside the
        group's rank runner (``DistContext.run``), each rank on its own
        workspace; its AllReduce slots are the symmetric buffer of
        ``ar_tag`` (``kernel.ar_slots``)."""
        if self.num_tiles_kv8 and wkv8 is None:
            raise ValueError(
                f"program uses {self.num_tiles_kv8} e4m3 KV-pool tiles "
                "but no wkv8 was passed — build it with "
                "make_workspace_kv8 and carry it through every step")
        if wkv8 is not None and (not self.num_tiles_kv8
                                 or wkv8.dtype != E4M3
                                 or wkv8.shape[0] < self.num_tiles_kv8):
            raise ValueError(
                f"wkv8 {tuple(wkv8.shape)} {wkv8.dtype} does not fit this "
                f"program ({self.num_tiles_kv8} e4m3 KV-pool tiles)")
        if self.num_tiles8 and ws8 is None:
            raise ValueError(
                f"program uses {self.num_tiles8} fp8 weight tiles but no "
                "ws8 was passed — build it with make_workspace8")
        if ws8 is not None and (ws8.dtype != E4M3 or ws8.dim() != 3
                                or ws8.shape[0] < self.num_tiles8):
            raise ValueError(
                f"ws8 {tuple(ws8.shape)} {ws8.dtype} does not fit this "
                f"program ({self.num_tiles8} e4m3 weight tiles)")
        if self.num_mrows and wsm is None:
            raise ValueError(
                f"program uses {self.num_mrows} matrix-workspace rows but "
                "no wsm was passed — build it with make_workspace_mat")
        if wsm is not None and (wsm.dim() != 2 or wsm.shape[1] != MAT_COLS
                                or wsm.shape[0] < max(self.num_mrows, 1)
                                or wsm.dtype != self.dtype):
            raise ValueError(
                f"wsm {tuple(wsm.shape)} {wsm.dtype} does not fit this "
                f"program: need (>= {max(self.num_mrows, 1)}, {MAT_COLS}) "
                f"{self.dtype} — was it built by make_workspace_mat of a "
                "different program?")
        if ws.dtype != self.dtype or ws.dim() != 3 \
                or ws.shape[0] < self.num_tiles:
            raise ValueError(f"ws {tuple(ws.shape)} {ws.dtype} does not fit "
                             f"this program ({self.num_tiles} tiles of "
                             f"{self.dtype})")
        return run_queue(self.queue if queue is None else queue, ws, wsm,
                         ws8=ws8, wkv8=wkv8,
                         num_exec=self.num_exec, mat_specs=self.mat_specs,
                         used_types=self.used_types, head_dim=self.head_dim,
                         sync_before=self.sync_before, live_rows=live_rows,
                         profile=profile, num_ranks=self.num_ranks,
                         axis=self.axis, max_ar=self.max_ar,
                         force_ar=self.force_ar, ar_tag=ar_tag)
