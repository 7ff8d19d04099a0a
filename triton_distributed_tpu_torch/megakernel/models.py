"""MegaKernel model assembly — a whole decode step as one task queue.

The port's counterpart of the JAX package's ``megakernel/models.py``, for
the form the paged serving lane compiles: matrix-layout weights, paged KV
pools (``kv_pool_pages``) in the workspace dtype or e4m3 (``kv_fp8``: the
kv8 workspace), in-kernel appends, one rank, a speculative window of
``spec_window`` candidate rows per slot, no fp8 weights, no MoE. Per layer
and slot block:

    x ── rms_norm (layer 0 only; later layers get it fused) ── qkv proj ──
      qk-norm + RoPE (all heads, one task) ── paged attention per q head
      (cached pages + the current token, or the causal window of fresh
      rows) ── append k/v (a second, spill row per kv head when the
      window may cross a page) ──
      o-proj + residual + mlp norm ── gate|up + silu ── down + residual
      (+ the next layer's attn norm)

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
    TILE, MatHandle, TensorHandle,
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
    """Workspace handles for one layer's weights + pools + outputs (the
    matrix layout: fused qkv and interleaved gate|up MatHandles)."""

    attn_norm: TensorHandle     # (TILE, hidden) broadcast
    mlp_norm: TensorHandle
    q_norm: TensorHandle        # (TILE, d) broadcast (Qwen3 qk-norm)
    k_norm: TensorHandle
    wqkv: MatHandle             # (hidden, (hq+2*hkv)*d) fused
    wo: MatHandle               # (hq*d, hidden)
    w_gateup: MatHandle         # (hidden, ffn) pair
    w_down: MatHandle           # (ffn, hidden)
    kT: list[TensorHandle]      # per kv head: (d, pool pages·TILE) pool
    v: list[TensorHandle]       # per kv head: (pool pages·TILE, d) pool
    qkv_out: TensorHandle       # (blocks·TILE, (hq+2*hkv)*d) q|k|v rows
    k_new: TensorHandle         # block 0's view of this step's k
    v_new: TensorHandle


def feed_layer_weights(feeds: dict, h: DecodeLayerHandles, *, wq, wk, wv,
                       wo, w_gate, w_up, w_down,
                       head_dim: int = TILE) -> dict:
    """Insert one layer's projection/MLP weights into ``feeds`` in the
    matrix layout (fused qkv, (gate, up) pair); head_dim < TILE pads
    q/k/v columns and o-proj rows per head."""
    wq = pad_head_cols(wq, head_dim)
    wk = pad_head_cols(wk, head_dim)
    wv = pad_head_cols(wv, head_dim)
    feeds[h.wqkv] = torch.cat([wq, wk, wv], dim=1)
    feeds[h.wo] = pad_head_rows(wo, head_dim)
    feeds[h.w_gateup] = (w_gate, w_up)
    feeds[h.w_down] = w_down
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
    # Per block, the emitted ATTN_DECODE_PAGED / APPEND_KV task ids with
    # their pool base tiles — the host rewrites these rows (and the
    # attention rows' table DATA rows) each step.
    paged_meta: dict


def row_block(t: TensorHandle, b: int) -> TensorHandle:
    """Row-block ``b`` of a (bt·TILE, cols) tensor as its own (TILE, cols)
    view — row-major tile ids make block b's tiles contiguous at
    ``base + b·ct``."""
    return TensorHandle(t.base + b * t.ct, TILE, t.cols)


def build_decode_layer(mb: MegaKernelBuilder, x: TensorHandle,
                       h: DecodeLayerHandles, cos: TensorHandle,
                       sin: TensorHandle, *, hq_local: int, hkv_local: int,
                       pos: int, eps: float, head_dim: int,
                       xn: TensorHandle | None,
                       out_norm: tuple[TensorHandle, TensorHandle] | None,
                       paged_tables: list[list[tuple[int, int]]],
                       append_pos: int, meta_out: dict,
                       spec_append: bool = False):
    """Emit one transformer layer's decode tasks for ONE row block (one
    serving slot). ``xn``: the already-normalised input row from the
    previous layer's fused tail (None: emit the rms_norm). ``out_norm``:
    (norm_w, norm_out) of the next consumer, fused into this layer's
    down-projection. The o-proj's first weight chunk is warmed
    (PREFETCH_MAT) ahead of the attention tasks, as in the JAX serving
    lane. ``spec_append``: each kv head gets a second append row for a
    candidate window's spill into the next page (parked on the scratch
    page at build time, like the primary). Returns ``(x2, x2n)``."""
    hidden = x.cols
    d = TILE
    groups = hq_local // hkv_local
    scale = head_dim ** -0.5
    if xn is None:
        xn = mb.tensor(TILE, hidden)
        mb.rms_norm(xn, x, h.attn_norm, eps)
    q = TensorHandle(h.qkv_out.base, TILE, hq_local * d)
    mb.gemm_mat(h.qkv_out, xn, h.wqkv)
    mb.norm_rope_qkv(q, hq_local, h.k_new, hkv_local, h.q_norm,
                     h.k_norm, cos, sin, eps)
    mb.prefetch_mat(h.wo)
    attn = mb.tensor(TILE, hq_local * d)
    for j in range(hq_local):
        kv = j // groups
        tid = mb.attn_decode_paged(_col(attn, j), _col(q, j),
                                   paged_tables[kv], valid_len=pos,
                                   scale=scale, k_new=_col(h.k_new, kv),
                                   v_new=_col(h.v_new, kv),
                                   kv8=h.kT[kv].kv8)
        meta_out.setdefault("attn", []).append(
            (tid, h.kT[kv].tile(0, 0), h.v[kv].tile(0, 0)))
    for kv in range(hkv_local):
        for _ in range(2 if spec_append else 1):
            tid = mb.append_kv(h.kT[kv], h.v[kv], append_pos,
                               _col(h.k_new, kv), _col(h.v_new, kv))
            meta_out.setdefault("append", []).append(
                (tid, h.kT[kv].tile(0, 0), h.v[kv].tile(0, 0)))
    x1 = mb.tensor(TILE, hidden)
    x1n = mb.tensor(TILE, hidden)
    # o-proj + residual + this layer's mlp norm (epilogue 3).
    mb.gemm_mat(x1, attn, h.wo, residual=x, norm_w=h.mlp_norm,
                norm_out=x1n, eps=eps, prefetch_first=True)
    act = mb.tensor(TILE, h.w_gateup.n)
    mb.gemm_mat(act, x1n, h.w_gateup)
    x2 = mb.tensor(TILE, hidden)
    if out_norm is not None:
        nw, nout = out_norm
        mb.gemm_mat(x2, act, h.w_down, residual=x1, norm_w=nw,
                    norm_out=nout, eps=eps)
        return x2, nout
    mb.gemm_mat(x2, act, h.w_down, residual=x1)
    return x2, None


def _check_decode_step_config(*, hidden, hq_local, hkv_local, ffn_local,
                              num_layers, max_seq, pos, batch, head_dim,
                              spec_window: int = 1) -> None:
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
    if not 1 <= spec_window <= TILE:
        raise ValueError(
            f"spec_window = {spec_window} out of range [1, {TILE}]: "
            "the candidate window rides the rows of one slot's TILE "
            "block — spec_k serving argument")
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
    if not 0 <= pos < max_seq:
        raise ValueError(f"pos {pos} outside cache capacity {max_seq} "
                         "(the step appends this position's k/v)")


def build_decode_step(*, hidden: int, hq_local: int, hkv_local: int,
                      ffn_local: int, num_layers: int, max_seq: int,
                      pos: int, kv_pool_pages: int, table_pages: int,
                      eps: float = 1e-6, batch: int = 1,
                      head_dim: int = TILE, kv_fp8: bool = False,
                      spec_window: int = 1) -> DecodeStepProgram:
    """Assemble a full decode step in the paged SERVING form (the JAX
    ``build_decode_step(paged=True, inkernel_append=True,
    mat_prefetch=True, kv_pool_pages=..., kv_fp8=..., spec_window=...)``):
    every TILE-row block of ``batch`` is one
    sequence slot with its own ``table_pages``-entry page table over
    shared per-(layer, kv-head) pools of ``kv_pool_pages`` tiles (the
    last one the scratch page); tables start all-scratch and the host
    rewrites them, the valid lengths and the append targets per step
    (``prog.paged_meta``). Embedding, final norm and lm_head stay
    outside.

    ``kv_fp8``: the pools live in the e4m3 kv8 workspace
    (ATTN_DECODE_PAGED_F8 / APPEND_KV_F8). ``spec_window`` W > 1: the
    draft-and-verify shape — candidate rows 0..W-1 of each slot block,
    the attention rows fold the fresh window causally (queue word 5) and
    each kv head gets a second append row for a page-crossing spill; W is
    the only compile-time commitment, the live window rides the queue."""
    _check_decode_step_config(
        hidden=hidden, hq_local=hq_local, hkv_local=hkv_local,
        ffn_local=ffn_local, num_layers=num_layers, max_seq=max_seq,
        pos=pos, batch=batch, head_dim=head_dim, spec_window=spec_window)
    bt = -(-batch // TILE)
    mb = MegaKernelBuilder()
    mb.head_dim = head_dim
    x = mb.tensor(bt * TILE, hidden)
    cos = mb.tensor(bt * TILE, TILE)        # one table block per slot
    sin = mb.tensor(bt * TILE, TILE)
    layers: list[DecodeLayerHandles] = []
    d = TILE
    for _ in range(num_layers):
        wqkv = mb.tensor_mat(hidden, (hq_local + 2 * hkv_local) * d)
        wo = mb.tensor_mat(hq_local * d, hidden)
        qkv_out = mb.tensor(bt * TILE, (hq_local + 2 * hkv_local) * d)
        w_gateup = mb.tensor_mat(hidden, ffn_local, pair=True)
        w_down = mb.tensor_mat(ffn_local, hidden)
        kT = [mb.tensor(d, kv_pool_pages * TILE, kv8=kv_fp8)
              for _ in range(hkv_local)]
        v = [mb.tensor(kv_pool_pages * TILE, d, kv8=kv_fp8)
             for _ in range(hkv_local)]
        layers.append(DecodeLayerHandles(
            attn_norm=mb.tensor(TILE, hidden),
            mlp_norm=mb.tensor(TILE, hidden),
            q_norm=mb.tensor(TILE, d),
            k_norm=mb.tensor(TILE, d),
            wqkv=wqkv, wo=wo, w_gateup=w_gateup, w_down=w_down,
            kT=kT, v=v, qkv_out=qkv_out,
            k_new=TensorHandle(qkv_out.base + hq_local, TILE,
                               hkv_local * d),
            v_new=TensorHandle(qkv_out.base + hq_local + hkv_local,
                               TILE, hkv_local * d)))
    cur = [row_block(x, b) for b in range(bt)]
    curn: list[TensorHandle | None] = [None] * bt
    block_meta: list[dict] = [dict() for _ in range(bt)]
    scratch = kv_pool_pages - 1
    for i, h in enumerate(layers):
        # Each layer's tail also produces the next layer's normalised input.
        nw = layers[i + 1].attn_norm if i + 1 < num_layers else None
        nout = mb.tensor(bt * TILE, hidden) if nw is not None else None
        for b in range(bt):
            qkv_b = row_block(h.qkv_out, b)
            hb = dataclasses.replace(
                h, qkv_out=qkv_b,
                k_new=TensorHandle(qkv_b.base + hq_local, TILE,
                                   hkv_local * d),
                v_new=TensorHandle(qkv_b.base + hq_local + hkv_local,
                                   TILE, hkv_local * d))
            # Slot b's build-time page table: all-scratch entries.
            tables = [[(kt_h.tile(0, scratch), v_h.tile(scratch, 0))] * table_pages
                      for kt_h, v_h in zip(hb.kT, hb.v)]
            cur[b], curn[b] = build_decode_layer(
                mb, cur[b], hb, row_block(cos, b), row_block(sin, b),
                hq_local=hq_local, hkv_local=hkv_local, pos=pos, eps=eps,
                head_dim=head_dim, xn=curn[b],
                out_norm=(nw, row_block(nout, b)) if nw is not None
                else None,
                paged_tables=tables, append_pos=scratch * TILE,
                meta_out=block_meta[b], spec_append=spec_window > 1)
    meta = {"blocks": block_meta, "table_pages": table_pages,
            "pool_pages": kv_pool_pages, "kv_fp8": kv_fp8}
    return DecodeStepProgram(mb=mb, x=x, layers=layers, cos=cos, sin=sin,
                             x_out=cur[0], x_out_blocks=cur, blocks=bt,
                             paged_meta=meta)
