"""MegaKernel task model — typed tasks over a tiled workspace.

The port's own copy of the JAX package's ``megakernel/tasks.py``, word for
word in everything the queue encodes: the task-type values, the word
layout and the handles are the queue ABI both kernels interpret, and the
CPU tests hold the two builders' queues equal. The comments on each type
describe the JAX package's handler; the port's CUDA interpreter
(``csrc/megakernel.cu``) handles the subset ``kernel.PORTED_TYPES`` names.

Reference: ``python/triton_dist/mega_triton_kernel/core/task_base.py:150-218``
(``TaskBase``: (task_type, layer/task/tile ids, dependency, io tensor descs,
extra params) encoded to an int tuple) and the per-SM uint32 work queues of
``core/scheduler.py:40-95``.

Encoding: every tensor lives in ONE workspace shaped
``(num_tiles, TILE, TILE)``; a task is ``WORDS`` int32s addressing tiles by
index — so the device kernel needs no pointer decoding, only tile ids.
"""

from __future__ import annotations

import dataclasses
import enum

TILE = 128      # square tile: the workspace's unit of addressing
WORDS = 10      # int32 words per task
MAT_COLS = 1024  # matrix weight workspace width (strip columns)


class TaskType(enum.IntEnum):
    """Device-dispatchable task kinds; the values are the queue ABI. Word
    layout per row: [type, out, a0, b0, k_tiles, a_stride, b_stride, arg,
    c0, d0]. ``kernel.PORTED_TYPES`` names the ones the CUDA interpreter
    runs."""

    COPY = 0        # out <- a, one task per row of k_tiles tiles
    ADD = 1         # out <- a + b
    SILU_MUL = 2    # out <- silu(a) * b
    GEMM = 3        # retired slot (the builder emits GEMM_WIDE / GEMM_MAT)
    ALLREDUCE = 4   # out <- sum over ranks of out (one tile, one-shot,
    #                 through AR slot slab 0); the builder no longer
    #                 emits it
    SCALE = 5       # out <- a * scalar (word 7, fixed point 1e-6)
    RMS_NORM = 6    # out row <- a row * rsqrt(mean(a^2) + eps) * w over
    #                 k_tiles column tiles; w at b0 (broadcast rows); eps in
    #                 word 7 as fixed point 1e-9
    ROPE = 7        # retired slot (fused into NORM_ROPE)
    ATTN_DECODE = 8  # out <- softmax(q @ kT * scale, masked to valid) @ V
    #                 over a linear cache: a0 = q tile, b0 = kT base,
    #                 a_stride = V base, k_tiles = visited tiles, b_stride =
    #                 valid length, arg = scale*1e6, c0/d0 = the current
    #                 token's k/v tiles (-1 = cache only)
    ATTN_DECODE_PAGED = 9  # ATTN_DECODE over a PAGE TABLE: the j-th (kT
    #                 tile, V tile) pair sits at flat offsets (2j, 2j+1) of
    #                 the queue's data rows from row b0; a_stride = the
    #                 speculative candidate window (0 = each row's own
    #                 current token; win >= 1 folds rows j <= i < win
    #                 causally)
    PREFETCH = 10   # warm tile a0 into a reserved slot; the next GEMM_WIDE
    #                 with c0 == 1 consumes it
    ATTN_DECODE_GQA = 11  # ATTN_DECODE for a GQA group of g q-heads
    #                 sharing one kv head; arg = round(scale*1e6) | (g << 24)
    GEMM_WIDE = 12  # GEMM over arg contiguous output column tiles of the
    #                 tiled workspace; c0 = 1 consumes a PREFETCH; d0 = 4
    #                 fetches 4-row super-strips
    NORM_ROPE = 13  # out <- rope(rms_norm(a) * w) for one head tile; b0 =
    #                 norm weight, c0/d0 = cos/sin tiles, arg = eps 1e-9
    APPEND_KV = 14  # k_new row 0 (a0) -> column c0 of the kT tile out, v_new
    #                 row 0 (d0) -> row c0 of the V tile b0; a_stride /
    #                 b_stride = the pools' base tiles (for retargeting).
    #                 Window form: k_tiles = n >= 1 appends rows arg..arg+n-1
    #                 at columns c0..; c0 < 0 skips the row
    GEMM_WIDE_W8 = 15  # GEMM_WIDE with B tiles in the e4m3 weight workspace
    PREFETCH_W8 = 16  # PREFETCH of an e4m3 weight tile
    MOE_TOPK = 17   # router top-k + softmax over the selected logits of one
    #                 (B, E) tile into the dense transposed (E, B) weights
    MOE_FFN = 18    # one layer's expert MLP, skipping experts whose weight
    #                 column is all zero
    GEMM_MAT = 19   # out row <- A row @ W, W in the 2D matrix workspace as
    #                 MAT_COLS-column strips: out, a0 = A row base, b0 = wsm
    #                 row base, k_tiles, a_stride = MatSpec index, arg =
    #                 epilogue | (eps 1e-9 << 8), c0 = residual base, d0 /
    #                 b_stride = norm output / weight bases. Epilogues: 0
    #                 store; 1 silu(gate half) * up half of each strip; 2 +=
    #                 residual; 3 += residual, then rms_norm(stored row) * w
    #                 into the d0 row
    ADD_NORM = 20   # out <- a + b and d0 <- rms_norm(a + b) * w in one task
    NORM_ROPE_QKV = 21  # NORM_ROPE over the k_tiles q-head tiles from a0 and
    #                 the b_stride k-head tiles after them: b0 / a_stride =
    #                 q / k norm weights, c0/d0 = cos/sin, arg = eps 1e-9
    ALLREDUCE_ROW = 22  # AllReduce over k_tiles contiguous tiles (a whole
    #                 activation row) in one task: one slab push to each
    #                 peer, one delivery wait, one exit barrier. Words:
    #                 out = row base tile, k_tiles = row tiles (<= the
    #                 program's max_ar slab width)
    PREFETCH_MAT = 23  # warm the first chunk of the GEMM_MAT weight at wsm
    #                 row a0 (a_stride = the consuming task's MatSpec index);
    #                 a warm-spec GEMM_MAT consumes it
    ATTN_DECODE_PAGED_F8 = 24  # ATTN_DECODE_PAGED over e4m3 KV pools
    APPEND_KV_F8 = 25  # APPEND_KV into e4m3 KV pools (saturating cast)


@dataclasses.dataclass(frozen=True)
class Task:
    """One queue entry. Word layout:
    [type, out, a0, b0, k_tiles, a_stride, b_stride, arg, c0, d0]."""

    type: TaskType
    out: int
    a0: int = 0
    b0: int = 0
    k_tiles: int = 0
    a_stride: int = 0
    b_stride: int = 0
    arg: int = 0
    c0: int = 0
    d0: int = 0

    def encode(self) -> list[int]:
        return [int(self.type), self.out, self.a0, self.b0, self.k_tiles,
                self.a_stride, self.b_stride, self.arg, self.c0, self.d0]


@dataclasses.dataclass(frozen=True)
class TensorHandle:
    """A (R, C) tensor as a row-major grid of TILE×TILE tiles.

    ``fp8``: lives in the float8_e4m3fn WEIGHT workspace (a separate
    read-only input array with its own tile-id space) instead of the main
    workspace. ``kv8``: lives in the float8_e4m3fn KV-POOL workspace — a
    separate READ-WRITE array (aliased through the step like the main
    workspace) holding paged KV pools at half the bytes; only
    ATTN_DECODE_PAGED_F8 reads it and APPEND_KV_F8 writes it."""

    base: int
    rows: int
    cols: int
    fp8: bool = False
    kv8: bool = False

    @property
    def rt(self) -> int:
        return self.rows // TILE

    @property
    def ct(self) -> int:
        return self.cols // TILE

    def tile(self, i: int, j: int) -> int:
        return self.base + i * self.ct + j

    def tiles(self) -> list[int]:
        return list(range(self.base, self.base + self.rt * self.ct))


@dataclasses.dataclass(frozen=True)
class MatHandle:
    """A weight matrix in the 2D MATRIX workspace (wsm, (rows, MAT_COLS)).

    A (K, N) matrix stores as ``n_strips`` vertical strips of MAT_COLS
    columns (the last zero-padded), stacked: strip ``s`` occupies wsm rows
    ``[base + s*K, base + (s+1)*K)``. ``pair=True`` marks the interleaved
    gate|up layout: each strip's left MAT_COLS/2 columns come from the
    FIRST matrix of the pair and the right half from the second, so the
    silu-pair epilogue consumes both halves from one fetched chunk."""

    base: int        # starting row in wsm
    k: int           # contraction rows (== K)
    n: int           # real output columns (per matrix; for pair: of EACH)
    pair: bool = False

    fp8 = False      # never lives in the fp8 tile workspace

    @property
    def n_strips(self) -> int:
        if self.pair:
            return -(-self.n // (MAT_COLS // 2))
        return -(-self.n // MAT_COLS)

    @property
    def rows(self) -> int:
        return self.n_strips * self.k


@dataclasses.dataclass(frozen=True)
class MatSpec:
    """Static shape of a GEMM_MAT task (queue word a_stride indexes the
    program's list of them; the reference generates one specialised
    branch per shape, core/code_generator.py).

    ``kch``: contraction rows per fetched chunk (the largest of 512/256/128
    dividing K, capped at K). ``epi``: 0 plain, 1 silu-pair, 2 +residual,
    3 +residual then rms_norm into a second output row.
    ``nt_out``: output width in TILE columns (for pair epi: of the act).
    ``warm``: 1 = chunk 0 was warmed by a preceding PREFETCH_MAT."""

    kt: int          # A-row tiles (K / TILE)
    ns: int          # strips
    nt_out: int      # output tiles
    kch: int         # chunk rows
    epi: int         # epilogue kind
    warm: int = 0    # 1 = consume a PREFETCH_MAT warm for chunk 0

    @property
    def n_ch(self) -> int:
        return (self.kt * TILE) // self.kch


def mat_chunk_rows(k: int) -> int:
    """Largest power-of-two chunk row count (<= 512) dividing ``k``."""
    for c in (512, 256, 128):
        if k % c == 0:
            return min(c, k)
    raise ValueError(f"K {k} not a multiple of {TILE}")
