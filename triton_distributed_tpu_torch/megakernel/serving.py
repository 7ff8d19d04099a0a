"""Megakernel serving — dense model params in, a decode backend out.

Counterpart of the JAX package's ``megakernel/serving.py``. Two decoders
share the weight feeds:

* :class:`MegakernelDecoder` — the sequential batch-1 decode loop behind
  ``Engine.serve(backend="megakernel")``: the engine prefills into a
  linear cache, :meth:`MegakernelDecoder.start` transposes it into the
  per-head kT/v regions of a linear workspace, and every further token is
  ONE launch of the megakernel (the k/v append runs in the kernel;
  ``advance_queue_pos`` retargets the queue per position), plus the
  embedding row in and the final RMSNorm, lm_head and greedy argmax out.
  Matrix weight layout in the workspace dtype, or ``fp8_weights``: the
  tile layout over an e4m3 weight workspace. ``profile=True`` keeps each
  step's per-task dispatch dump on ``last_profile``
  (``obs.kernel_profile``). On a TP group (``num_ranks`` > 1) each rank
  holds its shard (:func:`weight_feeds` / :func:`cache_feeds` with
  ``rank``) and the in-kernel AllReduce tasks carry the reductions.
* :class:`PagedMegakernelDecoder` — the serving tier's lane: prefill runs
  elsewhere (the engine's chunked prefill through K1), a finished prompt's
  KV pages scatter into the workspace pools, and every decode step is ONE
  launch over every slot. It serves e4m3 KV pools (``kv_dtype``: the kv8
  workspace beside the main one) and the speculative window
  (``spec_window`` W <= TILE candidate rows per slot).

The paged lane stays single-rank, as the reference's serving loop keeps
it. Not ported: ``copy_page`` (prefix copy-on-write).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from triton_distributed_tpu_torch.layers.common import rms_norm
from triton_distributed_tpu_torch.megakernel.kernel import (
    MegakernelUnsupportedError,
)
from triton_distributed_tpu_torch.megakernel.models import (
    DecodeStepProgram, advance_queue_pos, broadcast_rows, build_decode_step,
    feed_layer_weights, feed_moe_weights, pad_head_vec, rope_tables,
)
from triton_distributed_tpu_torch.megakernel.tasks import TILE, WORDS
from triton_distributed_tpu_torch.models.config import ModelConfig
from triton_distributed_tpu_torch.models.fp8 import E4M3, saturate_cast
from triton_distributed_tpu_torch.runtime.device import (
    resolve_device, torch_dtype,
)

__all__ = ["MegakernelDecoder", "MegakernelUnsupportedError",
           "PagedMegakernelDecoder", "cache_feeds",
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


def _shard(w, dim: int, size: int, rank: int, sharded: bool):
    """Rank ``rank``'s ``size``-wide slice of ``w`` along ``dim``;
    ``sharded``: ``w`` is that slice already (``models/convert.
    shard_params``), taken as it is."""
    if not sharded:
        return w.narrow(dim, rank * size, size)
    if w.shape[dim] != size:
        raise ValueError(f"a rank's shard {tuple(w.shape)} is not {size} "
                         f"wide on dim {dim}")
    return w


def weight_feeds(prog: DecodeStepProgram, cfg: ModelConfig,
                 params: dict, *, rank: int = 0, num_ranks: int = 1,
                 sharded: bool = False, projections: bool = True) -> dict:
    """Map a param tree (``init_dense_llm`` / ``params_from_numpy``
    layout) onto the program's workspace handles — ``rank``'s TP shard:
    the q/k/v/gate/up columns and the o/down rows of that rank (the whole
    matrices at one rank). ``params``: the whole tree, or (``sharded``)
    rank ``rank``'s shard of it (``models/convert.shard_params``), whose
    leaves are taken as they are. Norm weights become broadcast rows;
    projection weights stay tensors on their device (``projections=False`` leaves them out:
    the norm rows alone, for a caller whose weight workspace is already
    built). A MoE layer's ``moe`` subtree feeds the program's router and
    expert stacks (``feed_moe_weights``; the experts cut on their ffn
    dim) — the decoders here serve dense models, the MoE programs are
    driven directly (``build_decode_step(moe_experts=)``)."""
    d = cfg.head_dim
    n = num_ranks
    hq_l, hkv_l = cfg.num_heads // n, cfg.num_kv_heads // n
    ffn_l = cfg.intermediate_size // n
    feeds: dict = {}

    def cut(w, dim, size):
        return _shard(w, dim, size, rank, sharded)

    for h, layer in zip(prog.layers, params["layers"]):
        attn = layer["attn"]
        feeds[h.attn_norm] = broadcast_rows(_vec(layer["attn_norm"]))
        feeds[h.mlp_norm] = broadcast_rows(_vec(layer["mlp_norm"]))
        qn = (_vec(attn["q_norm"]) if cfg.qk_norm
              else np.ones(d, np.float32))
        kn = (_vec(attn["k_norm"]) if cfg.qk_norm
              else np.ones(d, np.float32))
        feeds[h.q_norm] = broadcast_rows(pad_head_vec(qn, d))
        feeds[h.k_norm] = broadcast_rows(pad_head_vec(kn, d))
        if not projections:
            continue
        proj = dict(wq=cut(attn["wq"], 1, hq_l * d),
                    wk=cut(attn["wk"], 1, hkv_l * d),
                    wv=cut(attn["wv"], 1, hkv_l * d),
                    wo=cut(attn["wo"], 0, hq_l * d), head_dim=d)
        if "moe" in layer:
            moe = layer["moe"]
            f = cfg.moe_intermediate_size // n
            feed_layer_weights(feeds, h, **proj)
            feed_moe_weights(feeds, h, router=moe["router"],
                             w_gate=cut(moe["w_gate"], 2, f),
                             w_up=cut(moe["w_up"], 2, f),
                             w_down=cut(moe["w_down"], 1, f))
            continue
        mlp = layer["mlp"]
        feed_layer_weights(
            feeds, h, w_gate=cut(mlp["w_gate"], 1, ffn_l),
            w_up=cut(mlp["w_up"], 1, ffn_l),
            w_down=cut(mlp["w_down"], 0, ffn_l), **proj)
    return feeds


def cache_feeds(prog: DecodeStepProgram, cache, *, rank: int = 0,
                num_ranks: int = 1, sharded: bool = False) -> dict:
    """A linear KV cache (``models/kv_cache.KVCache``, batch 1) → rank
    ``rank``'s per-head kT (d, S) / v (S, d) feeds: its share of the kv
    heads of a cache of every kv head, or (``sharded``) the whole of a
    cache of the rank's own, as a TP engine's prefill leaves it;
    head_dim < TILE pads into the tile rows/cols (the padded-head
    layout)."""
    feeds: dict = {}
    k, v = cache.k, cache.v    # (L, 1, S, hkv, hd)
    pad = TILE - k.shape[-1]
    hkv_l = len(prog.layers[0].kT)
    first = 0 if sharded else rank * hkv_l
    if k.shape[3] != (hkv_l if sharded else hkv_l * num_ranks):
        raise ValueError(f"cache of {k.shape[3]} kv heads for rank {rank} "
                         f"of {num_ranks} with {hkv_l} a rank"
                         f"{' (its shard)' if sharded else ''}")
    for li, h in enumerate(prog.layers):
        for kv in range(hkv_l):
            kT = k[li, 0, :, first + kv, :].T             # (hd, S)
            vv = v[li, 0, :, first + kv, :]               # (S, hd)
            if pad:
                kT = torch.nn.functional.pad(kT, (0, 0, 0, pad))
                vv = torch.nn.functional.pad(vv, (0, pad))
            feeds[h.kT[kv]] = kT
            feeds[h.v[kv]] = vv
    return feeds


def _head32(params: dict) -> torch.Tensor:
    """The lm_head as one fp32 matrix (the tied embedding transposed when
    the model has none): the logits are an fp32 product, as the JAX
    decoders' ``xn @ head.astype(f32)``."""
    head = params.get("lm_head")
    return (head if head is not None else params["embed"].T).float()


_DECODERS = itertools.count()


class MegakernelDecoder:
    """Sequential batch-1 decode over the compiled megakernel's LINEAR
    workspace, on one rank or on the ranks of a TP group.

    Build once per (cfg, max_seq, num_ranks); :meth:`start` loads a
    prefilled KV cache into the workspace; :meth:`step` runs one token —
    the compiled queue is retargeted per position without recompiling
    (``models.advance_queue_pos``) and launched once. The workspace is
    updated in place.

    ``dtype``: the workspace type (default float32, as the JAX package's
    Engine builds it). ``fp8_weights``: projection/MLP weights stream
    from the e4m3 weight workspace in the tile layout (half the bf16
    weight bytes; outputs carry the e4m3 quantization). ``final_norm``:
    the model's final RMSNorm runs in the kernel, fused into the last
    layer's tail. ``device=None`` means the card; the CPU runs the
    kernel's plain version and only when asked for (``device="cpu"``).
    ``profile``: every step also stamps the kernel's per-task dispatch
    dump (int32 (num_exec, 128)); the newest is kept on
    :attr:`last_profile`, so steps stay (ws, tok)-shaped.

    **On a TP group** (``num_ranks`` > 1, ``ctx`` a one-axis
    ``runtime/context.DistContext`` of that many ranks, which places them:
    ``device`` stays None): rank r holds its shard of the heads, the kv
    heads and the ffn (``params`` the whole tree, or the ranks' shards as
    a list, as a TP ``Engine`` holds them), and the program's in-kernel
    AllReduce tasks carry the TP reductions — the reference's multi-GPU
    MegaTritonKernel serving shape. A step retargets the queue once on
    the host, then each rank stages its inputs and the ranks' launches go
    out together (``kernel.cuda_launcher``). The workspace is the list of
    the ranks' workspaces. Every rank's final row is bit-identical
    (:meth:`rank_rows`); rank 0's makes the token. The embedding, the
    final norm and the lm_head (gathered whole from a vocabulary-sharded
    one) are placed once, at construction, so no gather enters a step.
    Refused as the reference refuses: ``profile`` at n > 1, heads, kv
    heads or ffn not divisible by n, a per-rank ffn that is not a TILE
    multiple, a group of another size or axis."""

    def __init__(self, cfg: ModelConfig, params, *, max_seq: int,
                 dtype=torch.float32, device=None, ctx=None,
                 axis: str = "tp", num_ranks: int = 1,
                 fp8_weights: bool = False, profile: bool = False,
                 final_norm: bool = False):
        validate_megakernel_cfg(cfg, max_seq)
        n = num_ranks
        if profile and n > 1:
            raise ValueError(
                "profile=True is single-rank for now — the per-task dump "
                "is a per-core record and the TP step does not yet carry "
                "a sharded profile output")
        if cfg.num_heads % n or cfg.num_kv_heads % n or \
                cfg.intermediate_size % n:
            raise ValueError(f"heads/ffn not divisible by TP degree {n}")
        if (cfg.intermediate_size // n) % TILE:
            raise ValueError("per-rank ffn must stay a TILE multiple")
        if n > 1:
            if ctx is None:
                raise ValueError("num_ranks > 1 requires ctx (the rank "
                                 "group hosting the TP axis)")
            if ctx.tp_axis != axis or ctx.num_ranks != n:
                raise ValueError(
                    f"megakernel TP serving needs a one-axis group of {n} "
                    f"ranks over {axis!r}; got {ctx.num_ranks} ranks over "
                    f"{ctx.tp_axis!r} — rank r's workspace lives on the "
                    "group's r-th device")
            if device is not None:
                raise ValueError("pass ctx (a TP group) or device (one "
                                 "rank), not both — arguments ctx / device")
            self.devices = list(ctx.devices)
        else:
            self.devices = [resolve_device(device)]
        self.cfg = cfg
        self.n = n
        self.ctx = ctx if n > 1 else None
        self.axis = axis
        self.profile = profile
        self.last_profile: torch.Tensor | None = None
        self.max_seq = max_seq
        self.device = self.devices[0]
        self.dtype = torch_dtype(dtype)
        self.fp8_weights = fp8_weights
        # The first step() of a fresh decoder pays the kernel's build and
        # load; ``last_step_cold`` lets a recorder keep that sample out
        # of its step-latency percentiles.
        self.warm = False
        self.last_step_cold = True
        self.final_norm_inkernel = final_norm
        self.prog = build_decode_step(
            hidden=cfg.hidden_size, hq_local=cfg.num_heads // n,
            hkv_local=cfg.num_kv_heads // n,
            ffn_local=cfg.intermediate_size // n,
            num_layers=cfg.num_layers, max_seq=max_seq, pos=max_seq - 1,
            eps=cfg.rms_norm_eps, fp8_weights=fp8_weights,
            final_norm=final_norm, head_dim=cfg.head_dim,
            inkernel_append=True, mat_prefetch=not fp8_weights,
            num_ranks=n)
        self.comp = self.prog.mb.compile(dtype=self.dtype,
                                         head_dim=cfg.head_dim,
                                         num_ranks=n, axis=axis)
        # The AllReduce slots of this decoder (kernel.ar_slots).
        self.ar_tag = f"decoder-{next(_DECODERS)}"
        # The ranks' shards as a TP engine holds them, or the whole tree.
        self.sharded = isinstance(params, list)
        self.rank_params = list(params) if self.sharded else [params] * n
        if len(self.rank_params) != n:
            raise ValueError(f"{len(self.rank_params)} rank shards for a "
                             f"TP group of {n} — argument params")
        first = self.rank_params[0]
        self.final_norm = first["final_norm"]
        copies: dict = {}
        self.embeds = [copies.setdefault(d, first["embed"].to(d))
                       for d in self.devices]
        if n > 1 and first.get("lm_head") is not None \
                and first["lm_head"].shape[1] != cfg.vocab_size:
            head = torch.cat([p["lm_head"].to(self.device)
                              for p in self.rank_params], dim=1)
            self.head32 = head.float()
        else:
            self.head32 = _head32(first).to(self.device)
        self._rope_cache: dict = {}
        # Weight workspaces per rank, built by the first start() and kept:
        # the steps only read them.
        self._wsms: list | None = None
        self._ws8s: list | None = None

    # -- workspace ----------------------------------------------------------
    def start(self, cache):
        """The main workspace with the norm weights and the prefilled KV
        cache loaded, to carry through every step: one tensor at one rank,
        the ranks' list on a TP group. ``cache``: one linear cache of
        every kv head, or (on a TP group) the ranks' caches as a list. The
        first call also builds the weight workspaces of the layout
        (matrix, or e4m3 tiles), one a rank; later calls reuse them."""
        sharded = isinstance(cache, list)
        caches = cache if sharded else [cache] * self.n
        if len(caches) != self.n:
            raise ValueError(f"{len(caches)} caches for {self.n} ranks")
        for c in caches:
            if c.k.shape[1] != 1:
                raise ValueError("megakernel decode is batch-1 "
                                 f"(cache batch {c.k.shape[1]})")
            if c.max_seq != self.max_seq:
                raise ValueError(f"cache max_seq {c.max_seq} != decoder "
                                 f"max_seq {self.max_seq}")
        built = self._wsms is not None or self._ws8s is not None
        wsms, ws8s, out = [], [], []
        for r, dev in enumerate(self.devices):
            feeds = weight_feeds(self.prog, self.cfg, self.rank_params[r],
                                 rank=r, num_ranks=self.n,
                                 sharded=self.sharded, projections=not built)
            if self.final_norm_inkernel:
                feeds[self.prog.fnorm] = broadcast_rows(
                    _vec(self.final_norm))
            feeds.update(cache_feeds(self.prog, caches[r], rank=r,
                                     num_ranks=self.n, sharded=sharded))
            main, w8, wm = self.comp.split_feeds(feeds)
            del feeds
            if not built and self.fp8_weights:
                ws8s.append(self.comp.make_workspace8(w8, device=dev))
            if not built and self.comp.num_mrows:
                wsms.append(self.comp.make_workspace_mat(wm, device=dev))
            del w8, wm
            out.append(self.comp.make_workspace(main, device=dev))
        if not built:
            self._wsms = wsms or None
            self._ws8s = ws8s or None
        return out[0] if self.n == 1 else out

    def _rope(self, pos: int, device) -> tuple[torch.Tensor, torch.Tensor]:
        t = self._rope_cache.get((pos, device))
        if t is None:
            cos_t, sin_t = rope_tables(pos, self.cfg.head_dim,
                                       self.cfg.rope_theta)
            t = tuple(torch.from_numpy(x).to(device).to(self.dtype)
                      for x in (cos_t, sin_t))
            self._rope_cache[(pos, device)] = t
        return t

    # -- one token ----------------------------------------------------------
    def queue_at(self, pos: int) -> np.ndarray:
        """The compiled queue retargeted to ``pos`` (one host pass a step,
        the same for every rank)."""
        if pos >= self.max_seq:
            raise ValueError(
                f"pos {pos} >= max_seq {self.max_seq}: the step appends "
                "this position's k/v — past capacity it would write into "
                "the adjacent workspace region")
        return advance_queue_pos(self.comp.queue, pos,
                                 num_exec=self.comp.num_exec)

    def put_inputs(self, ws: torch.Tensor, token, pos: int,
                   rank: int = 0) -> None:
        """The step's inputs in rank ``rank``'s workspace: the token's
        embedding in row 0 of ``x`` (the other rows stay zero) and the
        rope tables at ``pos``."""
        prog = self.prog
        tok = torch.as_tensor(token).reshape(-1)[:1].to(ws.device)
        xt = ws[prog.x.base:prog.x.base + prog.x.ct]
        xt[:, 0, :] = self.embeds[rank][tok.long()].float().to(
            ws.dtype).view(prog.x.ct, TILE)
        cos, sin = self._rope(pos, ws.device)
        ws[prog.cos.base], ws[prog.sin.base] = cos, sin

    def weights(self, rank: int = 0) -> tuple:
        """Rank ``rank``'s weight workspaces (matrix, e4m3 tiles), None
        where the layout has none; the first :meth:`start` builds them."""
        return tuple(None if w is None else w[rank]
                     for w in (self._wsms, self._ws8s))

    def launch(self, ws: torch.Tensor, queue: np.ndarray,
               rank: int = 0) -> torch.Tensor:
        """Rank ``rank``'s one megakernel launch of the step (row 0 of
        every tile; on a TP group called in the rank's thread, and the
        ranks' launches go out together); with ``profile``, its dispatch
        dump goes to :attr:`last_profile`."""
        wsm, ws8 = self.weights(rank)
        out = self.comp.step(ws, queue, wsm, ws8=ws8, live_rows=1,
                             profile=self.profile, ar_tag=self.ar_tag)
        if self.profile:
            ws, self.last_profile = out
        return ws

    def next_token(self, ws: torch.Tensor) -> torch.Tensor:
        """Final RMSNorm (unless it ran in the kernel), lm_head and
        greedy argmax of the output row, in fp32: (1,) int32."""
        x_out = self.comp.gather_output(ws, self.prog.x_out)[0:1].float()
        if not self.final_norm_inkernel:
            x_out = rms_norm(x_out, self.final_norm.float().to(ws.device),
                             self.cfg.rms_norm_eps)
        return torch.argmax(x_out @ self.head32, dim=-1).to(torch.int32)

    def rank_rows(self, ws) -> list:
        """Every rank's final row (1, hidden), as stored: bit-identical
        across the ranks of a TP group."""
        wss = ws if isinstance(ws, list) else [ws]
        return [self.comp.gather_output(w, self.prog.x_out)[0:1]
                for w in wss]

    def step(self, ws, token, pos: int):
        """token: (1,) ints; pos: host int (current cache length). Returns
        (workspace, next token (1,) int32 on rank 0's device). On a TP
        group ``ws`` is the ranks' list and the step runs in the group's
        rank runner."""
        if self._wsms is None and self._ws8s is None:
            raise ValueError("start() first: the weights are not loaded")
        self.last_step_cold = not self.warm
        queue = self.queue_at(pos)
        wss = ws if self.n > 1 else [ws]

        def rank_step(r):
            self.put_inputs(wss[r], token, pos, r)
            self.launch(wss[r], queue, r)
            return self.next_token(wss[r]) if r == 0 else None

        tok = (rank_step(0) if self.ctx is None
               else self.ctx.run(rank_step)[0])
        # Warm only after a successful step: if the first call raises,
        # the retry still counts as cold.
        self.warm = True
        return ws, tok

    def check_comm(self) -> None:
        """Raise ``CommTimeoutError`` if an AllReduce wait of the steps so
        far timed out (reads the ranks' error words: a device sync)."""
        if self.n > 1:
            self.ctx.raise_on_comm_error()


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
    workspace type (default: the config's).

    ``kv_dtype`` ``float8_e4m3fn``: the pools live in the e4m3 kv8
    workspace (ATTN_DECODE_PAGED_F8 / APPEND_KV_F8); the workspace is then
    the ``(main, kv8)`` pair :meth:`start` returns, carried through
    :meth:`load_prefill` and :meth:`step`. ``spec_window`` W > 1: the
    draft-and-verify program — :meth:`step` takes (B, W) candidate tokens
    and per-slot windows and returns (B, W) verifier tokens. The window
    rides the rows of one slot block, so W is at most TILE."""

    def __init__(self, cfg: ModelConfig, params: dict, *, num_slots: int,
                 num_pages: int, max_pages: int, device=None, dtype=None,
                 kv_dtype=None, spec_window: int = 1):
        capacity = max_pages * TILE
        validate_megakernel_cfg(cfg, capacity)
        if num_slots < 1:
            raise ValueError(f"num_slots = {num_slots} must be >= 1")
        self.spec_w = int(spec_window)
        if self.spec_w > TILE:
            raise MegakernelUnsupportedError(
                f"spec_window = {self.spec_w}: the candidate window rides "
                f"the {TILE} rows of one slot block — serve spec_k <= "
                f"{TILE - 1} on this lane")
        if num_pages < 1:
            raise ValueError(f"num_pages = {num_pages} must be >= 1")
        if max_pages < 1:
            raise ValueError(f"max_pages = {max_pages} must be >= 1")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = torch_dtype(dtype or cfg.dtype)
        kv_dt = None if kv_dtype is None else torch_dtype(kv_dtype)
        self.kv_fp8 = kv_dt == E4M3
        if kv_dt not in (None, E4M3, self.dtype):
            raise ValueError(
                f"megakernel paged lane serves kv_dtype float8_e4m3fn "
                f"(the fp8 pool workspace) or the workspace dtype "
                f"({self.dtype}); got {kv_dt} — kv_dtype engine argument")
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
            kv_pool_pages=num_pages + 1, table_pages=max_pages,
            kv_fp8=self.kv_fp8, spec_window=self.spec_w,
            inkernel_append=True, mat_prefetch=True)
        self.comp = self.prog.mb.compile(dtype=self.dtype,
                                         head_dim=cfg.head_dim)
        self.params = params
        self.embed = params["embed"]
        self.final_norm = params["final_norm"]
        self.head32 = _head32(params)
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
    def start(self):
        """Weights loaded, pools zeroed. Returns the workspace to carry
        through every step (the steps update it in place): the main
        workspace, or the ``(main, kv8)`` pair with e4m3 pools."""
        main, _, wm = self.comp.split_feeds(
            weight_feeds(self.prog, self.cfg, self.params))
        self._wsm = self.comp.make_workspace_mat(wm, device=self.device)
        del wm
        ws = self.comp.make_workspace(main, device=self.device)
        if self.kv_fp8:
            return ws, self.comp.make_workspace_kv8(device=self.device)
        return ws

    def _split(self, ws):
        """(main workspace, the one holding the pools)."""
        return ws if self.kv_fp8 else (ws, ws)

    def load_prefill(self, ws, k_lin: torch.Tensor, v_lin: torch.Tensor,
                     pages: list[int], *, first_page: int = 0):
        """Scatter a finished prefill's KV into the slot's pool pages, in
        place, through the saturating cast the in-kernel append uses (e4m3
        pools quantize here). ``k_lin``/``v_lin``: the linear prefill
        buffer (L, 1, S_buf, hkv, head_dim); page ``pages[i]`` receives
        positions [(first_page+i)*TILE, (first_page+i+1)*TILE). Returns
        ``ws``."""
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
        pool = self._split(ws)[1]
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
        pg = torch.as_tensor(pages, dtype=torch.long, device=pool.device)
        pool[(self._kt0[..., None] + pg).reshape(-1)] = saturate_cast(
            kt.reshape(-1, TILE, TILE).float(), pool.dtype)
        pool[(self._v0[..., None] + pg).reshape(-1)] = saturate_cast(
            vt.reshape(-1, TILE, TILE).float(), pool.dtype)
        return ws

    # -- per-step host retarget ---------------------------------------------
    def _retarget(self, kv_lens, tables, wins=None) -> np.ndarray:
        """Rewrite the compiled queue for this step's slot states: kv_lens
        (B,) ints; tables (B, <=max_pages) pool page ids per slot
        (missing/negative entries ride the scratch page); ``wins`` (spec
        programs): per-slot windows in [1, spec_window] — the step
        appends ``win`` positions and the attention rows fold the fresh
        window causally (word 5)."""
        spec = self.spec_w > 1
        if wins is None:
            wins = [1] * self.num_slots
        q = self._base_queue.copy()
        for b in range(self.num_slots):
            kvl = int(kv_lens[b])
            win = int(wins[b])
            if not 1 <= win <= self.spec_w:
                raise ValueError(
                    f"slot {b} window {win} outside [1, {self.spec_w}] — "
                    "the program was compiled for spec_window = "
                    f"{self.spec_w}")
            if kvl + win > self.capacity:
                raise ValueError(
                    f"slot {b} kv_len {kvl} (+ window {win}) at capacity "
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
            if spec:
                q[rows, 5] = win          # causal window fold
            ent = np.stack([kt0[:, None] + flat[None, :],
                            v0[:, None] + flat[None, :]], axis=-1)
            ent = ent.reshape(len(rows), -1)
            ent = np.pad(ent, ((0, 0), (0, self._table_rows * WORDS
                                        - ent.shape[1])))
            q[trow[:, None] + np.arange(self._table_rows)[None, :]] = \
                ent.reshape(len(rows), self._table_rows, WORDS)
            # Append targets: the page(s) holding positions [kv_len,
            # kv_len + win). An ACTIVE slot whose append page is unmapped
            # fails loudly — the write would land on the shared scratch
            # page and the token's KV would be lost (idle slots park on
            # scratch by design).
            ti, col = kvl // TILE, kvl % TILE
            last_ti = (kvl + win - 1) // TILE
            if (kvl > 0 or pages) and last_ti >= len(pages):
                raise ValueError(
                    f"slot {b} appends at positions [{kvl}, {kvl + win}) "
                    f"(page index {last_ti}) but the table maps "
                    f"{len(pages)} page(s) — the scheduler's page growth "
                    "must run before decode")
            ap = int(flat[ti]) if ti < self.max_pages else self.scratch
            rows, kt0, v0 = self._append[b]
            if not spec:
                q[rows, 1] = kt0 + ap
                q[rows, 3] = v0 + ap
                q[rows, 8] = col
                continue
            # Spec programs emit (primary, spill) append rows per (layer,
            # kv head): the primary takes the window's first n1 rows at
            # columns col.., the spill the rest at columns 0.. of the next
            # page (parked with c0 = -1 when the window fits one page).
            n1 = min(win, TILE - col)
            rest = win - n1
            ap2 = (int(flat[ti + 1]) if ti + 1 < self.max_pages
                   else self.scratch)
            prim, spill = rows[0::2], rows[1::2]
            q[prim, 1] = kt0[0::2] + ap
            q[prim, 3] = v0[0::2] + ap
            q[prim, 8] = col
            q[prim, 4] = n1
            q[prim, 7] = 0
            if rest > 0:
                q[spill, 1] = kt0[1::2] + ap2
                q[spill, 3] = v0[1::2] + ap2
                q[spill, 8] = 0
                q[spill, 4] = rest
                q[spill, 7] = n1
            else:
                q[spill, 8] = -1
                q[spill, 4] = 0
                q[spill, 7] = 0
        self.last_retarget = {
            "queue": q,
            "kv_lens": [int(kv_lens[b]) for b in range(self.num_slots)],
            "tables": [[int(p) for p in tables[b]]
                       for b in range(self.num_slots)],
            "wins": [int(w) for w in wins],
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
    def stage(self, ws, tokens, kv_lens, tables, wins=None) -> np.ndarray:
        """Everything of a step before the launch: the queue rewrite
        (returned) and the step's inputs in the main workspace — rows
        0..W-1 of slot b's block are its candidate tokens' embeddings (row
        0 alone at W = 1; the other rows stay zero), and row i of its rope
        tables sits at position ``kv_lens[b] + min(i, win - 1)``."""
        if self._wsm is None:
            raise ValueError("start() first: the weights are not loaded")
        queue = self._retarget(kv_lens, tables, wins)
        ws = self._split(ws)[0]
        B, W, prog, dev = self.num_slots, self.spec_w, self.prog, ws.device
        ct = prog.x.ct
        tok = torch.as_tensor(np.asarray(tokens, np.int64).reshape(B, W))
        xt = ws[prog.x.base:prog.x.base + B * ct].view(B, ct, TILE, TILE)
        emb = self.embed[tok.to(dev)].to(ws.dtype)           # (B, W, hidden)
        xt[:, :, :W, :] = emb.view(B, W, ct, TILE).permute(0, 2, 1, 3)
        cos = np.empty((B, TILE, TILE), np.float32)
        sin = np.empty((B, TILE, TILE), np.float32)
        for b in range(B):
            kvl = int(kv_lens[b])
            win = 1 if wins is None else int(wins[b])
            for i in range(win):
                cos[b, i], sin[b, i] = self._rope(kvl + i)
            cos[b, win:], sin[b, win:] = cos[b, win - 1], sin[b, win - 1]
        for h, t in ((prog.cos, cos), (prog.sin, sin)):
            ws[h.base:h.base + B] = torch.from_numpy(t).to(dev).to(ws.dtype)
        return queue

    def launch(self, ws, queue: np.ndarray):
        """The step's one megakernel launch (rows 0..W-1 of the slot
        blocks)."""
        main, pool = self._split(ws)
        self.comp.step(main, queue, self._wsm,
                       wkv8=pool if self.kv_fp8 else None,
                       live_rows=self.spec_w)
        return ws

    def next_tokens(self, ws) -> torch.Tensor:
        """Final RMSNorm, lm_head and greedy argmax over the slots' output
        rows, outside the kernel, in fp32 (the JAX lane's math): (B,)
        int32, or (B, W) at W > 1 — column j the greedy token after the
        window prefix 0..j."""
        main = self._split(ws)[0]
        W = self.spec_w
        x_out = torch.cat([self.comp.gather_output(main, h)[:W]
                           for h in self.prog.x_out_blocks])
        xn = rms_norm(x_out.float(), self.final_norm.float(),
                      self.cfg.rms_norm_eps)
        tok = torch.argmax(xn @ self.head32, dim=-1).to(torch.int32)
        return tok.reshape(self.num_slots, W) if W > 1 else tok

    def step(self, ws, tokens, kv_lens, tables, wins=None):
        """One decode step over every slot. tokens: (B,) ints, or (B, W)
        at W > 1 (the last accepted token, then the drafts; idle slots:
        any ids — their lanes are discarded); kv_lens: (B,) host ints (0 =
        idle); tables: (B, <=max_pages) pool page ids (-1 = unmapped);
        wins: (B,) live windows (spec programs). Returns (workspace, next
        tokens on the workspace's device); the workspace is updated in
        place."""
        queue = self.stage(ws, tokens, kv_lens, tables, wins)
        self.launch(ws, queue)
        return ws, self.next_tokens(ws)
