"""MegaKernel model assembly — a whole decode step as one task queue.

The port's counterpart of the JAX package's ``megakernel/models.py``, for
the forms the decoders compile (dense; the decoders build them with
in-kernel appends, ``inkernel_append=True``):

* the paged SERVING form (``kv_pool_pages``): matrix-layout weights, paged
  KV pools in the workspace dtype or e4m3 (``kv_fp8``: the kv8
  workspace), a speculative window of ``spec_window`` candidate rows per
  slot. Per layer and slot block:

    x ── rms_norm (layer 0 only; later layers get it fused) ── qkv proj ──
      qk-norm + RoPE (all heads, one task) ── paged attention per q head
      (cached pages + the current token, or the causal window of fresh
      rows) ── append k/v (a second, spill row per kv head when the
      window may cross a page) ──
      o-proj + residual + mlp norm ── gate|up + silu ── down + residual
      (+ the next layer's attn norm)

* the LINEAR form (no ``kv_pool_pages``; batch 1): each kv head's cache is
  a (d, max_seq) / (max_seq, d) tensor pair of the main workspace, one
  ATTN_DECODE_GQA task per kv head, appends retargeted per step by
  :func:`advance_queue_pos`. In the matrix layout the rest of the layer is
  the serving form's; with ``fp8_weights`` the TILE layout runs instead —
  weights as e4m3 tiles of the fp8 weight workspace:

    x ── rms_norm ── q, k, v proj (GEMM_WIDE_W8 strips) ── qk-norm + RoPE
      per head ── GQA attention ── append ── o proj ── add + mlp norm
      (ADD_NORM) ── gate, up proj ── silu·mul ── down proj ── add (+ the
      next norm: ADD_NORM)

  Both layouts take the Qwen3-MoE FFN (``moe_experts``): after the
  o-proj + residual + mlp norm, the router GEMM (GEMM_WIDE into one
  (TILE, TILE) logits tile; router columns padded to TILE), MOE_TOPK, and
  one expert-skipping MOE_FFN task, then the residual add (+ the next
  norm). The MoE programs also build without in-kernel appends
  (``inkernel_append=False``: the host feeds the caches, the batch rows
  share them) — the form of the JAX package's MoE tests, at a batch of up
  to TILE rows.

On a TP group (``num_ranks`` > 1; or ``force_ar_tasks`` at one rank, the
loopback that prices the in-kernel AllReduce on one card) each rank's
program holds its shard of the heads and the ffn, and the two row-parallel
reductions of a layer — the attention output after the o-proj and the MLP
(or MoE) output after the down projection — are ALLREDUCE_ROW tasks in
the queue: the o-proj stores its partial row, the AllReduce sums it over
the ranks (the gate/up weight warm, with ``mat_prefetch``, issued under
it), then ADD_NORM adds the residual and takes the mlp norm; the down
projection likewise, then ADD_NORM (or ADD) closes the layer. The fused
GEMM_MAT epilogues that add the residual are then n = 1 only.

Allocation and emission follow the JAX assembly step for step, so the
compiled queues are equal word for word.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from triton_distributed_tpu_torch.layers.common import rope_cos_sin
from triton_distributed_tpu_torch.megakernel.builder import MegaKernelBuilder
from triton_distributed_tpu_torch.megakernel.tasks import (
    TILE, MatHandle, TaskType, TensorHandle,
)


def broadcast_rows(vec) -> np.ndarray:
    """A (cols,) vector as the (TILE, cols) broadcast tensor the RMS_NORM /
    NORM_ROPE_QKV tasks read (row-replicated)."""
    vec = np.asarray(vec, np.float32)
    return np.broadcast_to(vec, (TILE, vec.shape[-1])).copy()


def rope_tables(pos: int, head_dim: int, theta: float
                ) -> tuple[np.ndarray, np.ndarray]:
    """(TILE, TILE) cos/sin tables at ``pos`` (HF half-split: each half
    repeats the head_dim/2 table; columns >= head_dim are zero)."""
    cos, sin = rope_cos_sin(torch.tensor([pos]), head_dim, theta)
    cos, sin = cos[0].numpy(), sin[0].numpy()
    cos2 = np.concatenate([cos, cos])
    sin2 = np.concatenate([sin, sin])
    if head_dim < TILE:
        pad = np.zeros(TILE - head_dim, np.float32)
        cos2 = np.concatenate([cos2, pad])
        sin2 = np.concatenate([sin2, pad])
    return broadcast_rows(cos2), broadcast_rows(sin2)


def pad_head_cols(w: torch.Tensor, head_dim: int) -> torch.Tensor:
    """(K, h·head_dim) → (K, h·TILE): each head's columns in the low
    ``head_dim`` lanes of its own tile, pad lanes zero."""
    if head_dim == TILE:
        return w
    k, total = w.shape
    w = w.reshape(k, total // head_dim, head_dim)
    return torch.nn.functional.pad(w, (0, TILE - head_dim)).reshape(k, -1)


def pad_head_rows(w: torch.Tensor, head_dim: int) -> torch.Tensor:
    """(h·head_dim, N) → (h·TILE, N): the o-proj twin of
    :func:`pad_head_cols` (pad rows zero)."""
    if head_dim == TILE:
        return w
    total, n = w.shape
    w = w.reshape(total // head_dim, head_dim, n)
    return torch.nn.functional.pad(w, (0, 0, 0, TILE - head_dim)).reshape(-1, n)


def pad_head_vec(vec, head_dim: int) -> np.ndarray:
    """A (head_dim,) per-head norm weight padded to the (TILE,) row."""
    vec = np.asarray(vec, np.float32)
    if head_dim == TILE:
        return vec
    return np.concatenate([vec, np.zeros(TILE - head_dim, np.float32)])


def _col(t: TensorHandle, j: int) -> TensorHandle:
    """Single column-tile view (valid because activations have rt == 1)."""
    assert t.rt == 1
    return TensorHandle(t.base + j, TILE, TILE)


@dataclasses.dataclass
class DecodeLayerHandles:
    """Workspace handles for one layer's weights + caches + outputs.

    Two weight layouts (feed either through :func:`feed_layer_weights`):
    the MATRIX layout (``wqkv``/``w_gateup`` fused MatHandles, ``wo``/
    ``w_down`` MatHandles, ``wq/wk/wv/w_gate/w_up`` None) and the TILE
    layout of the fp8-weight programs (every weight a TensorHandle in the
    e4m3 weight workspace, ``wqkv/w_gateup/qkv_out`` None)."""

    attn_norm: TensorHandle     # (TILE, hidden) broadcast
    mlp_norm: TensorHandle
    q_norm: TensorHandle        # (TILE, d) broadcast (Qwen3 qk-norm)
    k_norm: TensorHandle
    wo: TensorHandle | MatHandle      # (hq*d, hidden)
    w_down: TensorHandle | MatHandle  # (ffn, hidden)
    kT: list[TensorHandle]      # per kv head: (d, S) keys transposed
    v: list[TensorHandle]       # per kv head: (S, d); S = max_seq, or the
    #                             pool's pages·TILE in the serving form
    k_new: TensorHandle         # (TILE, hkv*d): this step's k (block 0's
    v_new: TensorHandle         # view in the serving form)
    wq: TensorHandle | None = None      # tile layout: (hidden, hq*d)
    wk: TensorHandle | None = None      # (hidden, hkv*d)
    wv: TensorHandle | None = None
    w_gate: TensorHandle | None = None  # (hidden, ffn)
    w_up: TensorHandle | None = None
    wqkv: MatHandle | None = None       # matrix layout: fused q|k|v
    w_gateup: MatHandle | None = None   # (hidden, ffn) pair
    qkv_out: TensorHandle | None = None  # (blocks·TILE, (hq+2*hkv)*d)
    # MoE FFN (None = dense MLP). Router columns padded to TILE (zero
    # weights give zero logits, masked by MOE_TOPK's E bound).
    moe_router: TensorHandle | None = None   # (hidden, TILE)
    moe_w_gate: TensorHandle | None = None   # (E·hidden, ffn)
    moe_w_up: TensorHandle | None = None
    moe_w_down: TensorHandle | None = None   # (E·ffn, hidden)


def feed_layer_weights(feeds: dict, h: DecodeLayerHandles, *, wq, wk, wv,
                       wo, w_gate=None, w_up=None, w_down=None,
                       head_dim: int = TILE) -> dict:
    """Insert one layer's projection/MLP weights into ``feeds`` in the
    layout the program was built with — matrix (fused qkv, (gate, up)
    pair) or tile (one fp8 handle per matrix); head_dim < TILE pads q/k/v
    columns and o-proj rows per head. A MoE layer takes its expert FFN
    through :func:`feed_moe_weights`; dense FFN values are ignored."""
    wq = pad_head_cols(wq, head_dim)
    wk = pad_head_cols(wk, head_dim)
    wv = pad_head_cols(wv, head_dim)
    feeds[h.wo] = pad_head_rows(wo, head_dim)
    if h.wqkv is not None:
        feeds[h.wqkv] = torch.cat([wq, wk, wv], dim=1)
    else:
        feeds[h.wq], feeds[h.wk], feeds[h.wv] = wq, wk, wv
    if h.moe_w_gate is not None:
        return feeds
    if w_gate is None or w_up is None or w_down is None:
        raise ValueError("feed_layer_weights needs w_gate, w_up and w_down "
                         "for a dense layer")
    feeds[h.w_down] = w_down
    if h.wqkv is not None:
        feeds[h.w_gateup] = (w_gate, w_up)
    else:
        feeds[h.w_gate], feeds[h.w_up] = w_gate, w_up
    return feeds


def feed_moe_weights(feeds: dict, h: DecodeLayerHandles, *, router,
                     w_gate, w_up, w_down) -> dict:
    """Insert one MoE layer's router (hidden, E) — padded to TILE columns
    — and expert stacks w_gate/w_up (E, hidden, ffn), w_down (E, ffn,
    hidden) — stacked to (E·hidden, ffn) / (E·ffn, hidden) — into
    ``feeds``."""
    num_experts, hidden, ffn = w_gate.shape
    feeds[h.moe_router] = torch.nn.functional.pad(
        torch.as_tensor(router), (0, TILE - num_experts))
    feeds[h.moe_w_gate] = w_gate.reshape(num_experts * hidden, ffn)
    feeds[h.moe_w_up] = w_up.reshape(num_experts * hidden, ffn)
    feeds[h.moe_w_down] = w_down.reshape(num_experts * ffn, hidden)
    return feeds


@dataclasses.dataclass
class DecodeStepProgram:
    """Builder + handles for a full decode step."""

    mb: MegaKernelBuilder
    x: TensorHandle
    layers: list[DecodeLayerHandles]
    cos: TensorHandle
    sin: TensorHandle
    x_out: TensorHandle
    x_out_blocks: list[TensorHandle]
    blocks: int
    # Serving form: per block, the emitted ATTN_DECODE_PAGED / APPEND_KV
    # task ids with their pool base tiles — the host rewrites these rows
    # (and the attention rows' table DATA rows) each step. None in the
    # linear form (advance_queue_pos retargets its rows).
    paged_meta: dict | None = None
    # final_norm=True: the final RMSNorm's weight handle (broadcast rows);
    # the norm runs in the kernel, fused into the last layer's tail, and
    # x_out is already normalized.
    fnorm: TensorHandle | None = None


def row_block(t: TensorHandle, b: int) -> TensorHandle:
    """Row-block ``b`` of a (bt·TILE, cols) tensor as its own (TILE, cols)
    view — row-major tile ids make block b's tiles contiguous at
    ``base + b·ct``."""
    return TensorHandle(t.base + b * t.ct, TILE, t.cols)


def advance_queue_pos(base_queue, pos: int,
                      num_exec: int | None = None) -> np.ndarray:
    """Re-target a compiled LINEAR decode queue to position ``pos``
    without recompiling: the attention tasks' valid length (word 6) and
    visited-tile count (word 4) are runtime queue words, and the
    APPEND_KV rows carry their cache base tiles (words 5/6), so one host
    edit per step moves every attention task and every append. RoPE
    tables are workspace inputs: feed ``rope_tables(pos, ...)`` alongside.

    ``base_queue`` (a CompiledMegaKernel, or a raw queue with
    ``num_exec``) must come from a program built at ``pos = max_seq - 1``
    (full cache capacity in word 4); returns an updated int32 copy."""
    if hasattr(base_queue, "queue"):
        if num_exec is None:
            num_exec = base_queue.num_exec
        base_queue = base_queue.queue
    q = np.asarray(base_queue).copy()
    paged = ((q[:, 0] == int(TaskType.ATTN_DECODE_PAGED))
             | (q[:, 0] == int(TaskType.ATTN_DECODE_PAGED_F8)))
    attn = ((q[:, 0] == int(TaskType.ATTN_DECODE)) | paged
            | (q[:, 0] == int(TaskType.ATTN_DECODE_GQA)))
    if num_exec is not None:
        # Rows beyond the executable prefix are page-table DATA — their
        # words must never be interpreted as task fields.
        attn[num_exec:] = False
    elif np.any(paged):
        raise ValueError(
            "queue contains ATTN_DECODE_PAGED tasks: pass the "
            "CompiledMegaKernel (or num_exec=) so page-table DATA rows "
            "are not misread as tasks")
    need = -(-pos // TILE)
    if np.any(q[attn, 4] < need):
        raise ValueError(
            f"base queue visits {int(q[attn, 4].min())} cache "
            f"tiles but pos {pos} needs {need} — build the program at "
            "pos = max_seq - 1 (silently dropping cache positions would "
            "corrupt the softmax)")
    if pos < 1 and np.any(q[attn, 8] < 0):
        raise ValueError("pos 0 with a cache-only attention task would be "
                         "an all-masked softmax")
    q[attn, 6] = pos
    q[attn, 4] = np.minimum(q[attn, 4], need)
    app = ((q[:, 0] == int(TaskType.APPEND_KV))
           | (q[:, 0] == int(TaskType.APPEND_KV_F8)))
    if num_exec is not None:
        app[num_exec:] = False
    ti, col = pos // TILE, pos % TILE
    q[app, 1] = q[app, 5] + ti        # out = kT base tile + pos tile
    q[app, 3] = q[app, 6] + ti        # b0  = v base tile + pos tile
    q[app, 8] = col                   # c0  = intra-tile column/row
    return q


def build_decode_layer(mb: MegaKernelBuilder, x: TensorHandle,
                       h: DecodeLayerHandles, cos: TensorHandle,
                       sin: TensorHandle, *, hq_local: int, hkv_local: int,
                       pos: int, eps: float, head_dim: int,
                       xn: TensorHandle | None,
                       out_norm: tuple[TensorHandle, TensorHandle] | None,
                       paged_tables: list[list[tuple[int, int]]] | None = None,
                       append_pos: int | None = None,
                       meta_out: dict | None = None,
                       spec_append: bool = False,
                       inkernel_append: bool = False,
                       mat_prefetch: bool = False,
                       moe_experts: int = 0, moe_topk: int = 0,
                       batch: int = 1, num_ranks: int = 1,
                       force_ar_tasks: bool = False):
    """Emit one transformer layer's decode tasks for ONE row block.
    ``xn``: the already-normalised input row from the previous layer's
    fused tail (None: emit the rms_norm). ``out_norm``: (norm_w, norm_out)
    of the next consumer, fused into this layer's residual tail.

    ``paged_tables`` (the serving form): per-kv-head (kT tile, v tile)
    page lists — one ATTN_DECODE_PAGED task per q head, appends parked at
    ``append_pos`` (the scratch page), their task ids collected in
    ``meta_out``; ``spec_append``: a second append row per kv head for a
    candidate window's spill into the next page. Without it (the linear
    form): one ATTN_DECODE_GQA task per kv head over the head's linear
    cache, and appends at ``pos`` (none with ``inkernel_append=False``:
    the host feeds the caches).

    Matrix layout (``h.wqkv``): the o-proj's first weight chunk is warmed
    (PREFETCH_MAT, with ``mat_prefetch``) ahead of the attention tasks,
    and the residual adds and norms ride the GEMM_MAT epilogues. Tile
    layout: per-head norm_rope, GEMM_WIDE strips, ADD_NORM / ADD tails.
    A MoE layer (``h.moe_w_gate``): router GEMM, MOE_TOPK over the
    ``batch`` real rows, MOE_FFN, then ADD_NORM / ADD. At ``num_ranks`` >
    1 (or with ``force_ar_tasks``) the attention and MLP outputs are
    summed over the ranks by ALLREDUCE_ROW tasks (the module docstring).
    Returns ``(x2, x2n)``."""
    hidden = x.cols
    d = TILE
    groups = hq_local // hkv_local
    scale = head_dim ** -0.5
    mat = h.wqkv is not None
    ar = num_ranks > 1 or force_ar_tasks
    if xn is None:
        xn = mb.tensor(TILE, hidden)
        mb.rms_norm(xn, x, h.attn_norm, eps)
    if mat:
        q = TensorHandle(h.qkv_out.base, TILE, hq_local * d)
        mb.gemm_mat(h.qkv_out, xn, h.wqkv)
        mb.norm_rope_qkv(q, hq_local, h.k_new, hkv_local, h.q_norm,
                         h.k_norm, cos, sin, eps)
        if mat_prefetch:
            mb.prefetch_mat(h.wo)
    else:
        q = mb.tensor(TILE, hq_local * d)
        mb.gemm(q, xn, h.wq)
        mb.gemm(h.k_new, xn, h.wk)
        mb.gemm(h.v_new, xn, h.wv)
        # k_new is not contiguous after q here, so the fused whole-row
        # task cannot apply — per-head qk-norm + RoPE.
        for j in range(hq_local):
            mb.norm_rope(_col(q, j), _col(q, j), h.q_norm, cos, sin, eps)
        for j in range(hkv_local):
            mb.norm_rope(_col(h.k_new, j), _col(h.k_new, j), h.k_norm,
                         cos, sin, eps)
    attn = mb.tensor(TILE, hq_local * d)
    if paged_tables is not None:
        for j in range(hq_local):
            kv = j // groups
            tid = mb.attn_decode_paged(_col(attn, j), _col(q, j),
                                       paged_tables[kv], valid_len=pos,
                                       scale=scale, k_new=_col(h.k_new, kv),
                                       v_new=_col(h.v_new, kv),
                                       kv8=h.kT[kv].kv8)
            meta_out.setdefault("attn", []).append(
                (tid, h.kT[kv].tile(0, 0), h.v[kv].tile(0, 0)))
    else:
        # One task per KV head: the whole GQA group's q-heads share the
        # head's cache.
        for kv in range(hkv_local):
            mb.attn_decode_gqa(attn, kv * groups, q, kv * groups, groups,
                               h.kT[kv], h.v[kv], valid_len=pos,
                               scale=scale, k_new=_col(h.k_new, kv),
                               v_new=_col(h.v_new, kv))
    apos = append_pos if append_pos is not None else pos
    for kv in range(hkv_local if inkernel_append else 0):
        for _ in range(2 if spec_append else 1):
            tid = mb.append_kv(h.kT[kv], h.v[kv], apos,
                               _col(h.k_new, kv), _col(h.v_new, kv))
            if meta_out is not None:
                meta_out.setdefault("append", []).append(
                    (tid, h.kT[kv].tile(0, 0), h.v[kv].tile(0, 0)))
    nw, nout = out_norm if out_norm is not None else (None, None)
    x1 = mb.tensor(TILE, hidden)
    x1n = mb.tensor(TILE, hidden)
    if mat and not ar:
        # o-proj + residual + this layer's mlp norm (epilogue 3).
        mb.gemm_mat(x1, attn, h.wo, residual=x, norm_w=h.mlp_norm,
                    norm_out=x1n, eps=eps, prefetch_first=mat_prefetch)
    else:
        o = mb.tensor(TILE, hidden)
        if mat:
            mb.gemm_mat(o, attn, h.wo, prefetch_first=mat_prefetch)
        else:
            mb.gemm(o, attn, h.wo)
        if ar:
            # The gate/up weight warm goes out before the AllReduce, so it
            # streams while the ranks meet.
            if mat_prefetch and h.w_gateup is not None:
                mb.prefetch_mat(h.w_gateup)
            mb.all_reduce(o)
        mb.add_norm(x1, x, o, h.mlp_norm, x1n, eps)
    if h.moe_w_gate is not None:
        # Router GEMM → in-kernel top-k/softmax → one expert-loop task
        # that skips the experts no row selected.
        down = mb.tensor(TILE, hidden)
        logits = mb.tensor(TILE, TILE)
        mb.gemm(logits, x1n, h.moe_router)
        wt = mb.tensor(TILE, TILE)
        mb.moe_topk(wt, logits, moe_topk, moe_experts, batch)
        mb.moe_ffn(down, x1n, wt, h.moe_w_gate, h.moe_w_up, h.moe_w_down,
                   moe_experts)
    elif mat:
        act = mb.tensor(TILE, h.w_gateup.n)
        mb.gemm_mat(act, x1n, h.w_gateup,
                    prefetch_first=mat_prefetch and ar)
        if not ar:
            x2 = mb.tensor(TILE, hidden)
            if nw is not None:
                mb.gemm_mat(x2, act, h.w_down, residual=x1, norm_w=nw,
                            norm_out=nout, eps=eps)
                return x2, nout
            mb.gemm_mat(x2, act, h.w_down, residual=x1)
            return x2, None
        down = mb.tensor(TILE, hidden)
        mb.gemm_mat(down, act, h.w_down)
    else:
        down = mb.tensor(TILE, hidden)
        ffn_local = h.w_gate.cols
        gate = mb.tensor(TILE, ffn_local)
        up = mb.tensor(TILE, ffn_local)
        act = mb.tensor(TILE, ffn_local)
        mb.gemm(gate, x1n, h.w_gate)
        mb.gemm(up, x1n, h.w_up)
        mb.silu_mul(act, gate, up)
        mb.gemm(down, act, h.w_down)
    if ar:
        mb.all_reduce(down)
    x2 = mb.tensor(TILE, hidden)
    if nw is not None:
        mb.add_norm(x2, x1, down, nw, nout, eps)
        return x2, nout
    mb.add(x2, x1, down)
    return x2, None


def _check_decode_step_config(*, hidden, hq_local, hkv_local, ffn_local,
                              num_layers, max_seq, pos, batch, head_dim,
                              fp8_weights: bool = False,
                              seq_blocks: bool = False,
                              kv_fp8: bool = False,
                              spec_window: int = 1,
                              inkernel_append: bool = False,
                              moe_experts: int = 0,
                              moe_topk: int = 0) -> None:
    """Named build-time validation: every TILE/geometry constraint raises
    here, naming the dimension and the ModelConfig field it comes from."""
    if head_dim not in (TILE // 2, TILE):
        raise ValueError(
            f"head_dim = {head_dim} unsupported: the megakernel decode "
            f"assembly packs each head into a lane-aligned tile — "
            f"supported head dims are {TILE // 2} (padded-head layout) and "
            f"{TILE} — config field head_dim")
    if hidden % TILE:
        raise ValueError(
            f"hidden = {hidden} is not a multiple of TILE ({TILE}) — "
            "config field hidden_size")
    if ffn_local % TILE:
        raise ValueError(
            f"ffn_local = {ffn_local} is not a multiple of TILE ({TILE}) "
            "— config field intermediate_size")
    if max_seq % TILE:
        raise ValueError(
            f"max_seq = {max_seq} is not a multiple of TILE ({TILE}) — "
            "the KV cache is tiled; pad the cache capacity (max_seq "
            "serving argument)")
    if batch < 1:
        raise ValueError(
            f"batch = {batch} invalid: a decode step needs at least one "
            "token row — batch serving argument")
    if batch > TILE:
        if fp8_weights:
            raise ValueError(
                f"batch = {batch} > TILE with fp8_weights: the tiled fp8 "
                "weight layout is single-block — batch > TILE needs the "
                "matrix layout (fp8_weights=False) — batch serving "
                "argument")
        if moe_experts:
            raise ValueError(
                f"batch = {batch} > TILE with MoE: MOE_TOPK masks one "
                "(B, E) logits tile, so the expert router is single-block "
                "— config field num_experts / batch serving argument")
        if inkernel_append and not seq_blocks:
            raise ValueError(
                f"batch = {batch} > TILE with inkernel_append on the "
                "linear cache: the append writes row 0 only (batch-1 "
                "serving); the paged serving lane appends per slot — "
                "batch serving argument")
    if kv_fp8:
        if not seq_blocks:
            raise ValueError(
                "kv_fp8=True requires the paged SERVING pool form "
                "(paged=True with kv_pool_pages): fp8 KV pools live in "
                "the separate read-write fp8 workspace the "
                "ATTN_DECODE_PAGED_F8 / APPEND_KV_F8 tasks address — "
                "the linear cache stays in the workspace dtype "
                "(kv_dtype serving argument)")
        if fp8_weights:
            raise ValueError(
                "kv_fp8=True with fp8_weights=True: the serving pool "
                "form runs the matrix weight layout, which the tiled "
                "fp8-weight programs forgo — pick fp8 KV pools (the "
                "decode-bandwidth lever) or tiled fp8 weights, not both "
                "— kv_dtype / fp8_weights serving arguments")
        if moe_experts:
            raise ValueError(
                "kv_fp8=True with MoE: the megakernel serving lane "
                "covers the dense stack — config field num_experts")
    if spec_window != 1:
        if not 1 <= spec_window <= TILE:
            raise ValueError(
                f"spec_window = {spec_window} out of range [1, {TILE}]: "
                "the candidate window rides the rows of one slot's TILE "
                "block — spec_k serving argument")
        if not seq_blocks:
            raise ValueError(
                f"spec_window = {spec_window} > 1 requires the paged "
                "SERVING pool form (paged=True with kv_pool_pages and "
                "in-kernel appends): the candidate window folds the "
                "slot's fresh k/v causally and appends it through the "
                "windowed APPEND_KV rows — spec_k serving argument")
        if moe_experts:
            raise ValueError(
                f"spec_window = {spec_window} > 1 with MoE: the "
                "megakernel serving lane covers the dense stack — "
                "config field num_experts")
    if num_layers < 1:
        raise ValueError(f"num_layers = {num_layers} must be >= 1 — "
                         "config field num_layers")
    if hq_local < 1 or hkv_local < 1:
        raise ValueError(
            f"hq_local = {hq_local}, hkv_local = {hkv_local} must be "
            ">= 1 — config fields num_heads / num_kv_heads")
    if hq_local % hkv_local:
        raise ValueError(
            f"hq_local = {hq_local} not divisible by hkv_local = "
            f"{hkv_local}: GQA groups q-heads evenly over kv heads — "
            "config fields num_heads / num_kv_heads")
    if moe_experts and not 1 <= moe_topk <= moe_experts <= TILE:
        raise ValueError(
            f"MoE config needs 1 <= moe_topk ({moe_topk}) <= moe_experts "
            f"({moe_experts}) <= TILE ({TILE}) — config fields "
            "num_experts_per_tok / num_experts")
    if not 0 <= pos < max_seq:
        raise ValueError(f"pos {pos} outside cache capacity {max_seq} "
                         "(the step appends this position's k/v)")


def build_decode_step(*, hidden: int, hq_local: int, hkv_local: int,
                      ffn_local: int, num_layers: int, max_seq: int,
                      pos: int, kv_pool_pages: int | None = None,
                      table_pages: int | None = None,
                      eps: float = 1e-6, batch: int = 1,
                      head_dim: int = TILE, kv_fp8: bool = False,
                      spec_window: int = 1, fp8_weights: bool = False,
                      final_norm: bool = False,
                      inkernel_append: bool = False,
                      mat_prefetch: bool = False,
                      moe_experts: int = 0,
                      moe_topk: int = 0, num_ranks: int = 1,
                      force_ar_tasks: bool = False) -> DecodeStepProgram:
    """Assemble a full decode step. Embedding and lm_head stay outside.

    With ``kv_pool_pages``: the paged SERVING form (the JAX
    ``build_decode_step(paged=True, inkernel_append=True,
    mat_prefetch=True, kv_pool_pages=..., kv_fp8=..., spec_window=...)``):
    every TILE-row block of ``batch`` is one sequence slot with its own
    ``table_pages``-entry page table over shared per-(layer, kv-head)
    pools of ``kv_pool_pages`` tiles (the last one the scratch page);
    tables start all-scratch and the host rewrites them, the valid
    lengths and the append targets per step (``prog.paged_meta``).
    ``kv_fp8``: the pools live in the e4m3 kv8 workspace
    (ATTN_DECODE_PAGED_F8 / APPEND_KV_F8). ``spec_window`` W > 1: the
    draft-and-verify shape — candidate rows 0..W-1 of each slot block,
    the attention rows fold the fresh window causally (queue word 5) and
    each kv head gets a second append row for a page-crossing spill; W is
    the only compile-time commitment, the live window rides the queue.

    Without it: the LINEAR form (the JAX ``build_decode_step(
    inkernel_append=True, fp8_weights=..., final_norm=...,
    mat_prefetch=not fp8_weights)``, as ``MegakernelDecoder`` builds it):
    per-kv-head linear caches of ``max_seq`` positions, GQA attention
    tasks, appends at ``pos`` (build at ``pos = max_seq - 1`` and
    retarget with :func:`advance_queue_pos`). ``fp8_weights``: the tile
    layout — projection/MLP weights in the e4m3 weight workspace,
    GEMM_WIDE_W8 strips. ``final_norm``: the model's final RMSNorm runs
    in the kernel, fused into the last layer's residual tail — ``x_out``
    is the normalized row and ``prog.fnorm`` the weight handle to feed.

    ``moe_experts`` > 0 (with ``moe_topk``): the Qwen3-MoE FFN in place
    of the dense MLP — ``ffn_local`` is the per-expert
    moe_intermediate_size, ``batch`` the real rows MOE_TOPK routes (the
    rest are masked). The linear form only. ``inkernel_append=False``
    drops the APPEND_KV rows (the host feeds the caches; the JAX
    package's MoE tests build this form, at ``batch`` rows sharing the
    caches) and ``mat_prefetch=False`` the PREFETCH_MAT warms: the JAX
    ``build_decode_step`` flags of the same names, with its defaults (both
    off; the decoders turn them on).

    ``num_ranks``: the TP group the program runs on; ``hq_local`` /
    ``hkv_local`` / ``ffn_local`` are one rank's shards, and the layer's
    two reductions become in-kernel AllReduce tasks (compile with
    ``compile(num_ranks=)``). ``force_ar_tasks``: emit those tasks at one
    rank too (compile with ``force_ar=True``: the loopback that prices
    the in-kernel AllReduce on one card)."""
    seq_blocks = kv_pool_pages is not None
    _check_decode_step_config(
        hidden=hidden, hq_local=hq_local, hkv_local=hkv_local,
        ffn_local=ffn_local, num_layers=num_layers, max_seq=max_seq,
        pos=pos, batch=batch, head_dim=head_dim, fp8_weights=fp8_weights,
        seq_blocks=seq_blocks, kv_fp8=kv_fp8, spec_window=spec_window,
        inkernel_append=inkernel_append, moe_experts=moe_experts,
        moe_topk=moe_topk)
    bt = -(-batch // TILE)
    mb = MegaKernelBuilder()
    mb.head_dim = head_dim
    x = mb.tensor(bt * TILE, hidden)
    # Per-slot positions (the serving form) need one rope table block per
    # slot; the linear form keeps one table pair.
    tbt = bt if seq_blocks else 1
    cos = mb.tensor(tbt * TILE, TILE)
    sin = mb.tensor(tbt * TILE, TILE)
    layers: list[DecodeLayerHandles] = []
    d = TILE
    tp = table_pages if table_pages is not None else (kv_pool_pages or 0)
    moe = moe_experts > 0
    moe_w_gate = moe_w_up = moe_w_down = moe_router = None
    for _ in range(num_layers):
        if moe:
            moe_w_gate = mb.tensor(moe_experts * hidden, ffn_local)
            moe_w_up = mb.tensor(moe_experts * hidden, ffn_local)
            moe_w_down = mb.tensor(moe_experts * ffn_local, hidden)
            moe_router = mb.tensor(hidden, TILE)
        if not fp8_weights:
            wqkv = mb.tensor_mat(hidden, (hq_local + 2 * hkv_local) * d)
            wo = mb.tensor_mat(hq_local * d, hidden)
            qkv_out = mb.tensor(bt * TILE, (hq_local + 2 * hkv_local) * d)
            k_new = TensorHandle(qkv_out.base + hq_local, TILE,
                                 hkv_local * d)
            v_new = TensorHandle(qkv_out.base + hq_local + hkv_local,
                                 TILE, hkv_local * d)
            w_gateup = (None if moe
                        else mb.tensor_mat(hidden, ffn_local, pair=True))
            w_down = (moe_w_down if moe
                      else mb.tensor_mat(ffn_local, hidden))
            wq = wk = wv = w_gate = w_up = None
        else:
            wqkv = w_gateup = qkv_out = None
            wq = mb.tensor(hidden, hq_local * d, fp8=True)
            wk = mb.tensor(hidden, hkv_local * d, fp8=True)
            wv = mb.tensor(hidden, hkv_local * d, fp8=True)
            wo = mb.tensor(hq_local * d, hidden, fp8=True)
            # A MoE layer's dense-FFN fields alias the expert stacks (the
            # MoE branch reads moe_w_*), as the JAX assembly allocates.
            w_gate = moe_w_gate if moe else mb.tensor(hidden, ffn_local,
                                                      fp8=True)
            w_up = moe_w_up if moe else mb.tensor(hidden, ffn_local,
                                                  fp8=True)
            w_down = moe_w_down if moe else mb.tensor(ffn_local, hidden,
                                                      fp8=True)
            k_new = mb.tensor(TILE, hkv_local * d)
            v_new = mb.tensor(TILE, hkv_local * d)
        if seq_blocks:
            kT = [mb.tensor(d, kv_pool_pages * TILE, kv8=kv_fp8)
                  for _ in range(hkv_local)]
            v = [mb.tensor(kv_pool_pages * TILE, d, kv8=kv_fp8)
                 for _ in range(hkv_local)]
        else:
            kT = [mb.tensor(d, max_seq) for _ in range(hkv_local)]
            v = [mb.tensor(max_seq, d) for _ in range(hkv_local)]
        layers.append(DecodeLayerHandles(
            attn_norm=mb.tensor(TILE, hidden),
            mlp_norm=mb.tensor(TILE, hidden),
            q_norm=mb.tensor(TILE, d),
            k_norm=mb.tensor(TILE, d),
            wq=wq, wk=wk, wv=wv, wo=wo, w_gate=w_gate, w_up=w_up,
            w_down=w_down, kT=kT, v=v, k_new=k_new, v_new=v_new,
            wqkv=wqkv, w_gateup=w_gateup, qkv_out=qkv_out,
            moe_router=moe_router, moe_w_gate=moe_w_gate,
            moe_w_up=moe_w_up, moe_w_down=moe_w_down))
    fnorm = mb.tensor(TILE, hidden) if final_norm else None
    cur = [row_block(x, b) for b in range(bt)]
    curn: list[TensorHandle | None] = [None] * bt
    block_meta = [dict() for _ in range(bt)] if seq_blocks else None
    scratch = (kv_pool_pages - 1) if seq_blocks else None
    for i, h in enumerate(layers):
        # Each layer's tail also produces the next consumer's normalised
        # row: the next layer's attn-norm input, or the final norm.
        if i + 1 < num_layers:
            nw = layers[i + 1].attn_norm
        elif final_norm:
            nw = fnorm
        else:
            nw = None
        nout = mb.tensor(bt * TILE, hidden) if nw is not None else None
        for b in range(bt):
            hb = h
            if bt > 1:
                qkv_b = row_block(h.qkv_out, b)
                hb = dataclasses.replace(
                    h, qkv_out=qkv_b,
                    k_new=TensorHandle(qkv_b.base + hq_local, TILE,
                                       hkv_local * d),
                    v_new=TensorHandle(qkv_b.base + hq_local + hkv_local,
                                       TILE, hkv_local * d))
            tables = None
            if seq_blocks:
                # Slot b's build-time page table: all-scratch entries.
                tables = [[(kt_h.tile(0, scratch), v_h.tile(scratch, 0))] * tp
                          for kt_h, v_h in zip(hb.kT, hb.v)]
            cur[b], curn[b] = build_decode_layer(
                mb, cur[b], hb, row_block(cos, b if seq_blocks else 0),
                row_block(sin, b if seq_blocks else 0),
                hq_local=hq_local, hkv_local=hkv_local, pos=pos, eps=eps,
                head_dim=head_dim, xn=curn[b],
                out_norm=(nw, row_block(nout, b)) if nw is not None
                else None,
                paged_tables=tables,
                append_pos=(scratch * TILE) if seq_blocks else None,
                meta_out=block_meta[b] if seq_blocks else None,
                spec_append=spec_window > 1,
                inkernel_append=inkernel_append, mat_prefetch=mat_prefetch,
                moe_experts=moe_experts, moe_topk=moe_topk,
                batch=min(batch, TILE), num_ranks=num_ranks,
                force_ar_tasks=force_ar_tasks)
    outs = [curn[b] if final_norm else cur[b] for b in range(bt)]
    meta = None
    if seq_blocks:
        meta = {"blocks": block_meta, "table_pages": tp,
                "pool_pages": kv_pool_pages, "kv_fp8": kv_fp8}
    return DecodeStepProgram(mb=mb, x=x, layers=layers, cos=cos, sin=sin,
                             x_out=outs[0], x_out_blocks=outs, blocks=bt,
                             paged_meta=meta, fnorm=fnorm)
