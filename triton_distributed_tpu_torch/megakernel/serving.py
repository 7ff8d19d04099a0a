"""Megakernel serving — dense model params in, a paged decode lane out.

Counterpart of the JAX package's ``megakernel/serving.py`` for the serving
tier's lane (:class:`PagedMegakernelDecoder`): prefill runs elsewhere (the
engine's chunked prefill through K1), a finished prompt's KV pages scatter
into the workspace pools, and every decode step is ONE launch of the
megakernel over every slot, plus the final RMSNorm, lm_head and greedy
argmax outside the kernel. Not in this slice: the linear
``MegakernelDecoder``, ``copy_page`` (prefix copy-on-write), the
speculative window and fp8 KV pools.
"""

from __future__ import annotations

import numpy as np
import torch

from triton_distributed_tpu_torch.layers.common import rms_norm
from triton_distributed_tpu_torch.megakernel.kernel import (
    MegakernelUnsupportedError,
)
from triton_distributed_tpu_torch.megakernel.models import (
    DecodeStepProgram, broadcast_rows, build_decode_step,
    feed_layer_weights, pad_head_vec, rope_tables,
)
from triton_distributed_tpu_torch.megakernel.tasks import TILE, WORDS
from triton_distributed_tpu_torch.models.config import ModelConfig
from triton_distributed_tpu_torch.runtime.device import (
    resolve_device, torch_dtype,
)

__all__ = ["MegakernelUnsupportedError", "PagedMegakernelDecoder",
           "validate_megakernel_cfg", "weight_feeds"]


def validate_megakernel_cfg(cfg: ModelConfig, max_seq: int) -> None:
    if cfg.head_dim not in (TILE // 2, TILE):
        raise ValueError(
            f"megakernel needs head_dim {TILE // 2} (padded-head layout) "
            f"or {TILE} (got {cfg.head_dim})")
    if cfg.hidden_size % TILE or cfg.intermediate_size % TILE:
        raise ValueError("hidden/intermediate sizes must be TILE multiples")
    if max_seq % TILE:
        raise ValueError("max_seq must be a TILE multiple")
    if cfg.is_moe:
        raise ValueError("megakernel serving covers the dense stack")


def _vec(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def weight_feeds(prog: DecodeStepProgram, cfg: ModelConfig,
                 params: dict) -> dict:
    """Map a dense param tree (``init_dense_llm`` / ``params_from_numpy``
    layout) onto the program's workspace handles. Norm weights become
    broadcast rows; projection weights stay tensors on their device."""
    d = cfg.head_dim
    feeds: dict = {}
    for h, layer in zip(prog.layers, params["layers"]):
        attn, mlp = layer["attn"], layer["mlp"]
        feeds[h.attn_norm] = broadcast_rows(_vec(layer["attn_norm"]))
        feeds[h.mlp_norm] = broadcast_rows(_vec(layer["mlp_norm"]))
        qn = (_vec(attn["q_norm"]) if cfg.qk_norm
              else np.ones(d, np.float32))
        kn = (_vec(attn["k_norm"]) if cfg.qk_norm
              else np.ones(d, np.float32))
        feeds[h.q_norm] = broadcast_rows(pad_head_vec(qn, d))
        feeds[h.k_norm] = broadcast_rows(pad_head_vec(kn, d))
        feed_layer_weights(
            feeds, h, wq=attn["wq"], wk=attn["wk"], wv=attn["wv"],
            wo=attn["wo"], w_gate=mlp["w_gate"], w_up=mlp["w_up"],
            w_down=mlp["w_down"], head_dim=d)
    return feeds


class PagedMegakernelDecoder:
    """Paged-workspace megakernel decode for the serving tier.

    Every serving slot is one ROW BLOCK of the decode program (row 0 = the
    slot's token), with its own page table over shared per-(layer,
    kv-head) KV pools. Pool page ``p`` of the serving allocator IS pool
    tile ``p`` of every megakernel pool (page_size == TILE), so the
    allocator's page ids drive the kernel's tables directly. The LAST pool
    tile is the scratch page idle slots ride at ``kv_lens`` 0 (the serving
    loop reserves it in its allocator).

    Per step the host rewrites QUEUE WORDS only — per-slot valid lengths,
    visited-page counts, APPEND_KV targets and the page-table DATA rows —
    and launches the one compiled program. KV appends run in the kernel,
    so the workspace is the decode-time source of truth; ``load_prefill``
    scatters a finished prefill's pages in (recompute-on-resume
    re-prefills, so preemption needs no copy-out). The workspace is
    updated in place.

    ``device=None`` means the card; the CPU runs the kernel's plain
    version and only when asked for (``device="cpu"``). ``dtype``: the
    workspace type (default: the config's)."""

    def __init__(self, cfg: ModelConfig, params: dict, *, num_slots: int,
                 num_pages: int, max_pages: int, device=None, dtype=None):
        capacity = max_pages * TILE
        validate_megakernel_cfg(cfg, capacity)
        if num_slots < 1:
            raise ValueError(f"num_slots = {num_slots} must be >= 1")
        if num_pages < 1:
            raise ValueError(f"num_pages = {num_pages} must be >= 1")
        if max_pages < 1:
            raise ValueError(f"max_pages = {max_pages} must be >= 1")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = torch_dtype(dtype or cfg.dtype)
        self.num_slots = num_slots
        self.num_pages = num_pages          # usable pages (excl. scratch)
        self.max_pages = max_pages
        self.scratch = num_pages            # LAST pool tile, never owned
        self.capacity = capacity
        self.prog = build_decode_step(
            hidden=cfg.hidden_size, hq_local=cfg.num_heads,
            hkv_local=cfg.num_kv_heads, ffn_local=cfg.intermediate_size,
            num_layers=cfg.num_layers, max_seq=capacity,
            pos=capacity - 1, eps=cfg.rms_norm_eps,
            batch=num_slots * TILE, head_dim=cfg.head_dim,
            kv_pool_pages=num_pages + 1, table_pages=max_pages)
        self.comp = self.prog.mb.compile(dtype=self.dtype,
                                         head_dim=cfg.head_dim)
        self.params = params
        self.embed = params["embed"]
        self.final_norm = params["final_norm"]
        head = params.get("lm_head")
        head = head if head is not None else self.embed.T
        # The logits are an fp32 product (the JAX lane's
        # ``xn @ head.astype(f32)``): one fp32 copy of the head, made once.
        self.head32 = head.float()
        # Host retarget map, per slot: queue rows of the attention tasks
        # (with their pool bases and table DATA start row) and of the
        # appends (with their pool bases).
        q0 = self.comp.queue
        rows = self.comp.task_rows
        self._attn = []
        self._append = []
        for blk in self.prog.paged_meta["blocks"]:
            a = np.asarray([(rows[tid], kt0, v0) for tid, kt0, v0 in
                            blk["attn"]], np.int64).reshape(-1, 3)
            self._attn.append((a[:, 0], a[:, 1], a[:, 2],
                               q0[a[:, 0], 3].astype(np.int64)))
            p = np.asarray([(rows[tid], kt0, v0) for tid, kt0, v0 in
                            blk["append"]], np.int64).reshape(-1, 3)
            self._append.append((p[:, 0], p[:, 1], p[:, 2]))
        self._base_queue = q0
        self._table_rows = -(-2 * max_pages // WORDS)
        # Pool base tiles per (layer, kv head), for load_prefill.
        self._kt0 = torch.tensor([[h.kT[kv].tile(0, 0)
                                   for kv in range(cfg.num_kv_heads)]
                                  for h in self.prog.layers],
                                 dtype=torch.long, device=self.device)
        self._v0 = torch.tensor([[h.v[kv].tile(0, 0)
                                  for kv in range(cfg.num_kv_heads)]
                                 for h in self.prog.layers],
                                dtype=torch.long, device=self.device)
        self._rope_cache: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self._wsm = None
        # The last host-rewritten queue and the slot state it came from.
        self.last_retarget: dict | None = None

    # -- workspace ----------------------------------------------------------
    def start(self) -> torch.Tensor:
        """Weights loaded, pools zeroed. Returns the main workspace (carry
        it through every step; the steps update it in place)."""
        main, wm = self.comp.split_feeds(
            weight_feeds(self.prog, self.cfg, self.params))
        self._wsm = self.comp.make_workspace_mat(wm, device=self.device)
        del wm
        return self.comp.make_workspace(main, device=self.device)

    def load_prefill(self, ws: torch.Tensor, k_lin: torch.Tensor,
                     v_lin: torch.Tensor, pages: list[int], *,
                     first_page: int = 0) -> torch.Tensor:
        """Scatter a finished prefill's KV into the slot's pool pages, in
        place. ``k_lin``/``v_lin``: the linear prefill buffer (L, 1,
        S_buf, hkv, head_dim); page ``pages[i]`` receives positions
        [(first_page+i)*TILE, (first_page+i+1)*TILE)."""
        for p in pages:
            if not 0 <= int(p) < self.num_pages:
                raise ValueError(
                    f"page id {p} outside the usable pool "
                    f"[0, {self.num_pages}) — the scratch page is "
                    "reserved")
        if first_page < 0:
            raise ValueError(
                f"first_page = {first_page} invalid: the buffer offset "
                "counts skipped prefix pages — argument first_page")
        n = len(pages)
        if n == 0:
            return ws
        L, _, _, hkv, hd = k_lin.shape
        lo, hi = first_page * TILE, (first_page + n) * TILE
        pad = TILE - hd
        # (L, n·TILE, hkv, hd) -> kT tiles (L, hkv, n, hd, TILE) and V
        # tiles (L, hkv, n, TILE, hd), head dims padded to TILE.
        k = k_lin[:, 0, lo:hi].reshape(L, n, TILE, hkv, hd)
        v = v_lin[:, 0, lo:hi].reshape(L, n, TILE, hkv, hd)
        kt = torch.nn.functional.pad(k.permute(0, 3, 1, 4, 2),
                                     (0, 0, 0, pad))
        vt = torch.nn.functional.pad(v.permute(0, 3, 1, 2, 4), (0, pad))
        pg = torch.as_tensor(pages, dtype=torch.long, device=ws.device)
        ws[(self._kt0[..., None] + pg).reshape(-1)] = \
            kt.reshape(-1, TILE, TILE).to(ws.dtype)
        ws[(self._v0[..., None] + pg).reshape(-1)] = \
            vt.reshape(-1, TILE, TILE).to(ws.dtype)
        return ws

    # -- per-step host retarget ---------------------------------------------
    def _retarget(self, kv_lens, tables) -> np.ndarray:
        """Rewrite the compiled queue for this step's slot states: kv_lens
        (B,) ints; tables (B, <=max_pages) pool page ids per slot
        (missing/negative entries ride the scratch page)."""
        q = self._base_queue.copy()
        for b in range(self.num_slots):
            kvl = int(kv_lens[b])
            if kvl + 1 > self.capacity:
                raise ValueError(
                    f"slot {b} kv_len {kvl} (+ window 1) at capacity "
                    f"{self.capacity}: the step appends these positions "
                    "— evict or stop the sequence (serving scheduler "
                    "contract)")
            pages = [int(p) for p in tables[b] if int(p) >= 0]
            ktiles = -(-kvl // TILE)
            if ktiles > len(pages):
                raise ValueError(
                    f"slot {b} kv_len {kvl} needs {ktiles} mapped pages "
                    f"but the table holds {len(pages)} — the scheduler's "
                    "page growth must run before decode")
            flat = np.full((self.max_pages,), self.scratch, np.int64)
            flat[:min(len(pages), self.max_pages)] = pages[:self.max_pages]
            rows, kt0, v0, trow = self._attn[b]
            q[rows, 4] = ktiles
            q[rows, 6] = kvl
            ent = np.stack([kt0[:, None] + flat[None, :],
                            v0[:, None] + flat[None, :]], axis=-1)
            ent = ent.reshape(len(rows), -1)
            ent = np.pad(ent, ((0, 0), (0, self._table_rows * WORDS
                                        - ent.shape[1])))
            q[trow[:, None] + np.arange(self._table_rows)[None, :]] = \
                ent.reshape(len(rows), self._table_rows, WORDS)
            # Append target: the page holding position kv_len. An ACTIVE
            # slot whose append page is unmapped fails loudly — the write
            # would land on the shared scratch page and the token's KV
            # would be lost (idle slots park on scratch by design).
            ti, col = kvl // TILE, kvl % TILE
            if (kvl > 0 or pages) and ti >= len(pages):
                raise ValueError(
                    f"slot {b} appends at positions [{kvl}, {kvl + 1}) "
                    f"(page index {ti}) but the table maps "
                    f"{len(pages)} page(s) — the scheduler's page growth "
                    "must run before decode")
            ap = int(flat[ti]) if ti < self.max_pages else self.scratch
            rows, kt0, v0 = self._append[b]
            q[rows, 1] = kt0 + ap
            q[rows, 3] = v0 + ap
            q[rows, 8] = col
        self.last_retarget = {
            "queue": q,
            "kv_lens": [int(kv_lens[b]) for b in range(self.num_slots)],
            "tables": [[int(p) for p in tables[b]]
                       for b in range(self.num_slots)],
        }
        return q

    def _rope(self, pos: int) -> tuple[np.ndarray, np.ndarray]:
        t = self._rope_cache.get(pos)
        if t is None:
            cos_t, sin_t = rope_tables(pos, self.cfg.head_dim,
                                       self.cfg.rope_theta)
            t = (cos_t[0].copy(), sin_t[0].copy())    # compact rows
            self._rope_cache[pos] = t
        return t

    # -- one step over every slot --------------------------------------------
    def stage(self, ws: torch.Tensor, tokens, kv_lens, tables) -> np.ndarray:
        """Everything of a step before the launch: the queue rewrite
        (returned) and the step's inputs in the workspace — row 0 of slot
        b's block is its token's embedding (the other rows stay zero), and
        slot b's rope tables sit at its position ``kv_lens[b]``."""
        if self._wsm is None:
            raise ValueError("start() first: the weights are not loaded")
        queue = self._retarget(kv_lens, tables)
        B, prog, dev = self.num_slots, self.prog, ws.device
        tabs = [self._rope(int(kv_lens[b])) for b in range(B)]
        tok = torch.as_tensor(np.asarray(tokens, np.int64)).to(dev)
        xt = ws[prog.x.base:prog.x.base + B * prog.x.ct]
        xt.view(B, prog.x.ct, TILE, TILE)[:, :, 0, :] = (
            self.embed[tok].to(ws.dtype).view(B, prog.x.ct, TILE))
        for i, h in enumerate((prog.cos, prog.sin)):
            rows = torch.from_numpy(np.stack([t[i] for t in tabs]))
            rows = rows.to(dev).to(ws.dtype)
            ws[h.base:h.base + B] = rows[:, None, :].expand(B, TILE, TILE)
        return queue

    def launch(self, ws: torch.Tensor, queue: np.ndarray) -> torch.Tensor:
        """The step's one megakernel launch (rows 0 of the slot blocks)."""
        return self.comp.step(ws, queue, self._wsm, live_rows=1)

    def next_tokens(self, ws: torch.Tensor) -> torch.Tensor:
        """Final RMSNorm, lm_head and greedy argmax over the slots' output
        rows, outside the kernel, in fp32 (the JAX lane's math)."""
        x_out = torch.stack([self.comp.gather_output(ws, h)[0]
                             for h in self.prog.x_out_blocks])
        xn = rms_norm(x_out.float(), self.final_norm.float(),
                      self.cfg.rms_norm_eps)
        return torch.argmax(xn @ self.head32, dim=-1).to(torch.int32)

    def step(self, ws: torch.Tensor, tokens, kv_lens, tables):
        """One decode step over every slot. tokens: (B,) ints (idle
        slots: any id — their lane is discarded); kv_lens: (B,) host ints
        (0 = idle); tables: (B, <=max_pages) pool page ids (-1 =
        unmapped). Returns (workspace, next_tokens (B,) int32 on the
        workspace's device); the workspace is updated in place."""
        queue = self.stage(ws, tokens, kv_lens, tables)
        self.launch(ws, queue)
        return ws, self.next_tokens(ws)
