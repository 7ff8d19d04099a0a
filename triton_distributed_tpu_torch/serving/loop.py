"""ServingEngine — the continuous-batching loop over ``Engine``;
counterpart of the JAX package's ``serving/loop.py`` (synchronous loop,
default backend).

A :class:`ServingEngine` owns ONE shared :class:`PagedModelCache` pool
(``max_batch`` decode slots over ``num_pages`` pages plus one scratch
page), a linear prefill buffer, and a host :class:`Scheduler`. Each
iteration runs one mixed step:

1. admissions — waiting requests take a free slot and their prompt's
   page reservation;
2. one chunked-prefill slice for the oldest prefilling request
   (``dense_prefill_slice`` → K1 at the slice start); the final slice's
   last real row yields the first token, and the buffer scatters into
   the request's pages;
3. page growth for the decode batch, preempting the lowest-priority
   youngest sequence under page pressure (recompute-on-resume);
4. one paged decode step over every running slot (``Engine.decode``
   → K2). Empty slots carry ``kv_lens = 0`` and point at the scratch
   page, so their discarded lane reads nothing and their appends land
   on that one page.

With ``Engine(backend="megakernel")`` step 4 is the persistent-kernel
lane instead: ONE launch of the megakernel decodes every slot
(``megakernel/serving.PagedMegakernelDecoder``), whose workspace holds
the KV pools — a finished prefill's pages scatter there, and the pool's
scratch page is the allocator's reserved page. The lane needs
``page_size == 128`` and a geometry it can tile; anything else raises
:class:`MegakernelUnsupportedError` at construction (the JAX package
demotes down its backend ladder there; the port has no ladder).

Two decode features ride both lanes:

- **fp8 KV** (``Engine(kv_dtype=torch.float8_e4m3fn)``): the pools hold
  e4m3 pages — K2's e4m3 lane on the eager lane, the megakernel's
  ATTN_DECODE_PAGED_F8 / APPEND_KV_F8 over its kv8 workspace on the
  persistent one. The prefill scatter quantizes through the saturating
  cast. ``kv_hbm_budget`` sizes the pool in bytes instead of pages, so
  e4m3 buys twice the bf16 pages.
- **speculative decode** (``spec_k``): each running slot drafts up to
  ``spec_k`` tokens from its own history (``serving/spec.NGramProposer``)
  and one step scores the window of ``spec_k + 1`` candidates
  (``dense_verify_step_paged`` eagerly, the megakernel's windowed program
  with ``spec_window = spec_k + 1`` on the persistent lane); the longest
  accepted prefix is kept and the rejected positions are rolled back
  (``kv_len`` truncation and ``PageAllocator.free_tail``). On the
  megakernel lane the window rides one 128-row slot block: ``spec_k``
  up to 127, :class:`MegakernelUnsupportedError` above.

On a TP group (``Engine(cfg, params, ctx)`` with n > 1 ranks) the
prefill buffer and the pools are per rank — each holds its shard of the
KV heads —, the page table and lengths are replicated, and one
``PageAllocator`` serves every rank. The slice, its logits, the decode
and the verify step run once per rank through the engine's rank runner
(``Engine.run``): prefill slices and verify steps reduce in mode
``"ar"`` (``ops/allreduce``'s AUTO: two-shot for a 256-row bf16 slice,
one-shot for a 16-row verify step at n = 4), decode through the parity
stream (``Engine._decode_run``), the logits gathered through the group.
After each step's host sync the ranks' error words are read
(``Engine.check_comm``): a collective that timed out raises
``CommTimeoutError`` there. The megakernel lane is single-rank and raises
:class:`MegakernelUnsupportedError` at n > 1, as the reference's does.

Greedy decoding end to end, so each request's tokens are identical to a
sequential ``Engine.serve`` of its prompt, with or without drafts. Not in
this slice: prefix cache, the spec lane's transient-fault fallback
(``_spec_disable``), KV host tier, the async loop, disaggregation, fleet,
flight recorder and observability hooks.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from triton_distributed_tpu_torch.megakernel.serving import (
    MegakernelUnsupportedError, PagedMegakernelDecoder,
    validate_megakernel_cfg,
)
from triton_distributed_tpu_torch.megakernel.tasks import TILE
from triton_distributed_tpu_torch.models import sampling
from triton_distributed_tpu_torch.models.dense import (
    dense_last_logits, dense_prefill_slice, dense_verify_step_paged,
)
from triton_distributed_tpu_torch.models.engine import Engine
from triton_distributed_tpu_torch.models.fp8 import saturate_cast
from triton_distributed_tpu_torch.models.kv_cache import (
    PageAllocator, init_kv_cache, init_paged_model_cache,
    kv_pool_pages_for_budget,
)
from triton_distributed_tpu_torch.serving.request import Request, RequestState
from triton_distributed_tpu_torch.serving.scheduler import (
    AdmitResult, Scheduler,
)
from triton_distributed_tpu_torch.serving.spec import NGramProposer


class ServingConfigError(ValueError):
    """A serving-tier sizing parameter is invalid — named, at
    construction."""


class ServingEngine:
    """Continuous-batching serving tier over an :class:`Engine`.

    Args:
      engine: the engine whose parameters, device and ``page_size`` serve.
      max_batch: decode slots (the in-flight batch width).
      num_pages: shared pool size in pages (default: every slot can hold
        its full ``max_pages`` allotment; smaller oversubscribes). One
        scratch page is always added for empty slots' discarded writes.
      kv_hbm_budget: the pool size in device BYTES instead: ``num_pages``
        becomes what the budget buys at the engine's ``kv_dtype``
        (``kv_pool_pages_for_budget``). Exclusive with ``num_pages``.
      prefill_chunk: tokens per prefill slice (a positive multiple of
        ``engine.page_size``; default one page).
      max_waiting: waiting-queue bound (admission backpressure beyond).
      clock: the time source stamped into requests.
      spec_k: speculative draft depth (0 = one-token decode).
    """

    def __init__(self, engine: Engine, *, max_batch: int = 4,
                 num_pages: int | None = None,
                 kv_hbm_budget: int | None = None,
                 prefill_chunk: int | None = None, max_waiting: int = 64,
                 clock=time.perf_counter, spec_k: int = 0):
        if engine.page_size is None:
            raise ServingConfigError(
                "engine has no paged cache: construct Engine(page_size=...) "
                "— the serving tier schedules against the paged pool "
                "(argument engine)")
        if engine.grouped and engine.ctx.num_ranks != engine.n:
            raise ServingConfigError(
                f"engine on a {engine.ctx.num_ranks}-rank group with axes "
                f"{engine.ctx.axis_names}: the serving tier runs one TP "
                "axis (the two-tier group serves through Engine.serve) — "
                "argument engine")
        page = engine.page_size
        chunk = prefill_chunk if prefill_chunk is not None else page
        if chunk < 1 or chunk % page:
            raise ServingConfigError(
                f"prefill_chunk = {chunk} invalid: must be a positive "
                f"multiple of page_size ({page}) so prefill slices scatter "
                "whole pages — argument prefill_chunk")
        if max_batch < 1:
            raise ServingConfigError(
                f"max_batch = {max_batch} invalid: the decode batch needs "
                "at least one slot — argument max_batch")
        self.engine = engine
        self.cfg = engine.cfg
        self.page = page
        self.max_pages = engine.max_pages
        self.max_batch = max_batch
        self.chunk = chunk
        self.clock = clock
        # Prefill buffer: whole chunks covering max_seq (page-aligned).
        self.s_buf = -(-engine.max_seq // chunk) * chunk
        capacity = min(self.max_pages * page, self.s_buf, engine.max_seq)
        self.kv_dtype = engine.kv_dtype
        if kv_hbm_budget is not None:
            if num_pages is not None:
                raise ServingConfigError(
                    "pass num_pages OR kv_hbm_budget, not both — two "
                    "pool sizes cannot both hold (arguments num_pages / "
                    "kv_hbm_budget)")
            num_pages = kv_pool_pages_for_budget(
                self.cfg, page_size=page, hbm_bytes=kv_hbm_budget,
                kv_dtype=self.kv_dtype)
        pool_pages = (num_pages if num_pages is not None
                      else max_batch * self.max_pages)
        if pool_pages < 1:
            raise ServingConfigError(
                f"num_pages = {pool_pages} invalid: the shared pool needs "
                "at least one page — argument num_pages")
        self.num_pages = pool_pages
        self.scratch_page = pool_pages        # last pool row, never owned
        if spec_k < 0 or int(spec_k) != spec_k:
            raise ServingConfigError(
                f"spec_k = {spec_k} invalid: the draft depth is a "
                "non-negative integer (0 disables speculative decode) — "
                "argument spec_k")
        self.spec_k = int(spec_k)
        self._proposer = NGramProposer(self.spec_k) if self.spec_k else None
        self._drafts: dict[str, list[int]] = {}
        n, devs = engine.n, engine.rank_devices
        self._pf_caches = engine.run(lambda r: init_kv_cache(
            self.cfg, 1, self.s_buf, device=devs[r], num_ranks=n))
        # The megakernel lane's workspace holds the KV pools, with the
        # scratch page as a reserved pool row (the budget math sees it);
        # the eager lane keeps a PagedModelCache per rank.
        self._mk = None
        self._mk_ws = None
        self._caches = None
        if engine.backend == "megakernel":
            self._mk = self._build_megakernel_lane(pool_pages)
            self._mk_ws = self._mk.start()
            allocator = PageAllocator(pool_pages + 1, self.max_pages,
                                      reserved=(self.scratch_page,))
        else:
            self._caches = engine.run(lambda r: init_paged_model_cache(
                self.cfg, max_batch, page_size=page,
                max_pages=self.max_pages, num_pages=pool_pages + 1,
                kv_dtype=self.kv_dtype, device=devs[r], num_ranks=n))
            allocator = PageAllocator(pool_pages, self.max_pages)
        self.sched = Scheduler(
            num_slots=max_batch, allocator=allocator,
            page_size=page, capacity_tokens=capacity,
            max_waiting=max_waiting)
        self._iter = 0
        self._finished: list[Request] = []

    @property
    def _cache(self):
        """Rank 0's paged cache (None on the megakernel lane)."""
        return None if self._caches is None else self._caches[0]

    @property
    def _pf_cache(self):
        """Rank 0's prefill buffer."""
        return self._pf_caches[0]

    def _build_megakernel_lane(self, pool_pages: int
                               ) -> PagedMegakernelDecoder:
        """The paged persistent-kernel decoder, or a named
        MegakernelUnsupportedError saying which dimension the lane cannot
        serve (TP degree, page shape, model geometry; the decoder names a
        draft depth past one slot block)."""
        if self.engine.n > 1:
            raise MegakernelUnsupportedError(
                f"megakernel serving lane is single-rank for now (TP group "
                f"of {self.engine.n}) — serve with backend='auto'")
        if self.page != TILE:
            raise MegakernelUnsupportedError(
                f"megakernel paged workspace needs page_size == TILE "
                f"({TILE}); engine has page_size={self.page} — pool pages "
                "must line up one-to-one with workspace KV tiles")
        try:
            validate_megakernel_cfg(self.cfg, self.max_pages * TILE)
        except ValueError as exc:
            raise MegakernelUnsupportedError(
                f"megakernel cannot serve this model: {exc}") from exc
        eng = self.engine
        return PagedMegakernelDecoder(
            self.cfg, eng.params, num_slots=self.max_batch,
            num_pages=pool_pages, max_pages=self.max_pages,
            device=eng.device, kv_dtype=self.kv_dtype,
            spec_window=self.spec_k + 1)

    # -- submission ----------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int, *, priority: int = 0,
               req_id: str | None = None
               ) -> tuple[Request, AdmitResult]:
        """Queue one request. Returns (request, verdict); on
        :data:`AdmitResult.QUEUE_FULL` the request is NOT queued."""
        kw = {"req_id": req_id} if req_id is not None else {}
        req = Request(prompt=[int(t) for t in np.asarray(prompt).ravel()],
                      max_new_tokens=int(max_new_tokens),
                      priority=priority, **kw)
        return req, self.sched.admit(req, self.clock())

    # -- the mixed iteration --------------------------------------------------
    def step(self) -> dict:
        """One scheduler iteration (admit → prefill slice → page growth /
        preemption → decode). Returns a host-side summary."""
        admitted = self.sched.schedule_admissions()
        head = self.sched.prefill_head()
        prefilled = self._prefill_slice(head) if head is not None else None
        # Drafts come before page growth, so the whole candidate window's
        # reservation rides the same growth pass.
        extra = self._plan_drafts() if self.spec_k else None
        ready, preempted = self.sched.ensure_decode_pages(extra=extra)
        if ready:
            self._decode(ready)
        self._iter += 1
        return {"iter": self._iter, "admitted": [r.req_id for r in admitted],
                "prefilled": prefilled,
                "preempted": [r.req_id for r in preempted],
                "decoded": len(ready),
                "waiting": len(self.sched.waiting),
                "active": self.sched.active_count,
                "free_pages": self.sched.allocator.free_count}

    def run(self, *, max_iters: int = 100_000) -> list[Request]:
        """Drive until every queued request finishes; returns them in
        finish order. Raises if ``max_iters`` elapses with work left."""
        start = len(self._finished)
        it = 0
        while self.sched.has_work():
            if it >= max_iters:
                raise RuntimeError(
                    f"serving loop still has work after {max_iters} "
                    f"iterations (waiting={len(self.sched.waiting)}, "
                    f"active={self.sched.active_count}) — scheduling "
                    "deadlock or max_iters too small")
            self.step()
            it += 1
        return self._finished[start:]

    # -- internals ------------------------------------------------------------
    def _prefill_slice(self, req: Request) -> str:
        eng = self.engine
        text = req.text
        T = len(text)
        start = req.prefill_pos
        ids = np.zeros((1, self.chunk), np.int32)
        real = text[start:start + self.chunk]
        ids[0, :len(real)] = real
        idr = eng.replicate(torch.from_numpy(ids))
        kw = eng.tp_kwargs(eng._decode_mode())
        outs = eng.run(lambda r: dense_prefill_slice(
            eng.rank_params[r], self.cfg, idr[r], self._pf_caches[r], start,
            **kw))
        self._pf_caches = [o[1] for o in outs]
        req.prefill_pos = min(start + self.chunk, T)
        if req.prefill_pos >= T:
            row = (T - 1) - start
            lkw = {k: v for k, v in kw.items() if k != "mode"}
            toks = eng.run(lambda r: sampling.greedy(dense_last_logits(
                eng.rank_params[r], self.cfg, outs[r][0][row:row + 1],
                **lkw)))
            tok = int(toks[0][0])                       # host sync
            eng.check_comm()
            now = self.clock()
            req.tokens.append(tok)
            req.kv_len = T
            if req.t_first_token is None:
                req.t_first_token = now
            self._complete_prefill(req)
        return req.req_id

    def _complete_prefill(self, req: Request) -> None:
        """Scatter the buffered prompt KV page-aligned into the request's
        pool pages (in place) and move it to the decode batch."""
        L, page = self.cfg.num_layers, self.page
        n_pages = -(-req.kv_len // page)
        owned = self.sched.allocator.pages(req.req_id)[:n_pages]
        if self._mk is not None:
            pf = self._pf_cache
            self._mk_ws = self._mk.load_prefill(self._mk_ws, pf.k, pf.v,
                                                owned)
        else:
            eng = self.engine

            def scatter(r):
                pf, cache = self._pf_caches[r], self._caches[r]
                pages = torch.as_tensor(owned, dtype=torch.long,
                                        device=eng.rank_devices[r])
                for pool, lin in ((cache.k_pools, pf.k),
                                  (cache.v_pools, pf.v)):
                    src = lin[:, 0].reshape(L, self.s_buf // page, page,
                                            *lin.shape[3:])[:, :n_pages]
                    pool[:, pages] = saturate_cast(src, pool.dtype)

            eng.run(scatter)
        req.advance(RequestState.RUNNING)
        if req.done:
            self._finish(req)

    def _finish(self, req: Request) -> None:
        self.sched.finish(req, self.clock())
        self._finished.append(req)

    def _slot_state(self, ready: list[Request], unmapped: int):
        """The decode batch per slot: (tokens, kv_lens, page table), the
        table's entries past a slot's pages set to ``unmapped``."""
        alloc = self.sched.allocator
        toks = np.zeros((self.max_batch,), np.int32)
        lens = np.zeros((self.max_batch,), np.int32)
        table = np.full((self.max_batch, self.max_pages), unmapped, np.int32)
        for req in ready:
            toks[req.slot] = req.tokens[-1]
            lens[req.slot] = req.kv_len
            pages = alloc.pages(req.req_id)
            table[req.slot, :len(pages)] = pages
        return toks, lens, table

    def _rank_caches(self, table: np.ndarray, lens: np.ndarray) -> list:
        """Each rank's paged cache with this step's page table and
        lengths (replicated on the ranks' devices)."""
        eng = self.engine
        tables = eng.replicate(torch.from_numpy(table))
        lensr = eng.replicate(torch.from_numpy(lens))
        return [c._replace(page_table=tables[r], kv_lens=lensr[r])
                for r, c in enumerate(self._caches)]

    def _plan_drafts(self) -> dict[str, int]:
        """Draft up to ``spec_k`` candidates per RUNNING slot from its own
        history; returns the per-request token reservation (1 + draft
        length) this iteration's page growth covers. Drafts are clamped
        to the request's remaining budget minus one, so the window never
        outgrows its admitted page budget."""
        extra: dict[str, int] = {}
        self._drafts.clear()
        w = self._proposer.window_tokens
        for req in self.sched.running():
            k_max = min(self.spec_k, req.max_new_tokens - len(req.tokens) - 1)
            draft = []
            if k_max > 0:
                tail = req.tokens[-w:]
                if len(tail) < w:
                    tail = req.prompt[-(w - len(tail)):] + tail
                draft = self._proposer.propose(tail, k_max)
            self._drafts[req.req_id] = draft
            extra[req.req_id] = 1 + len(draft)
        return extra

    def _decode(self, ready: list[Request]) -> None:
        if self.spec_k and (self._mk is not None or any(
                self._drafts.get(r.req_id) for r in ready)):
            # The eager lane with every draft empty takes the one-token
            # step: a window of 1 computes the same token. The megakernel
            # lane always runs its compiled window.
            self._decode_spec(ready)
            return
        if self._mk is not None:
            # The persistent-kernel lane: the host rewrites queue words
            # from the allocator's page ids and ONE launch decodes every
            # slot, its appends advancing the pool pages. Unmapped entries
            # are -1, so the decoder's page-coverage checks see them.
            toks, lens, table = self._slot_state(ready, -1)
            self._mk_ws, tok = self._mk.step(self._mk_ws, toks, lens, table)
            tok_np = tok.cpu().numpy()                  # host sync
        else:
            eng = self.engine
            toks, lens, table = self._slot_state(ready, self.scratch_page)
            caches = self._rank_caches(table, lens)
            tok, new = eng.decode(torch.from_numpy(toks),
                                  caches if eng.n > 1 else caches[0])
            self._caches = new if eng.n > 1 else [new]
            tok_np = tok.cpu().numpy()                  # host sync
            eng.check_comm()
        self._decode_tail(ready, {r.req_id: [int(tok_np[r.slot])]
                                  for r in ready})

    def _decode_spec(self, ready: list[Request]) -> None:
        """Draft-and-verify: every running slot's window [last token,
        drafts...] scores in one step; :meth:`_spec_tail` keeps the
        longest accepted prefix and rolls the rest back."""
        W = self.spec_k + 1
        unmapped = -1 if self._mk is not None else self.scratch_page
        _, lens, table = self._slot_state(ready, unmapped)
        toks = np.zeros((self.max_batch, W), np.int32)
        wins = np.ones((self.max_batch,), np.int32)
        drafts: dict[str, list[int]] = {}
        for req in ready:
            d = self._drafts.get(req.req_id, [])
            drafts[req.req_id] = d
            toks[req.slot, 0] = req.tokens[-1]
            toks[req.slot, 1:1 + len(d)] = d
            wins[req.slot] = 1 + len(d)
        if self._mk is not None:
            self._mk_ws, ver = self._mk.step(self._mk_ws, toks, lens, table,
                                             wins)
        else:
            eng = self.engine
            caches = self._rank_caches(table, lens)
            tokr = eng.replicate(torch.from_numpy(toks))
            kw = eng.tp_kwargs(eng._decode_mode())

            def verify(r):
                logits, cache = dense_verify_step_paged(
                    eng.rank_params[r], self.cfg, tokr[r], caches[r], **kw)
                b, w, v = logits.shape
                return (sampling.greedy(logits.reshape(b * w, v))
                        .reshape(b, w), cache)

            outs = eng.run(verify)
            self._caches = [o[1] for o in outs]
            ver = outs[0][0]
        ver_np = ver.cpu().numpy()                      # host sync
        self.engine.check_comm()
        self._spec_tail(ready, drafts, ver_np)

    def _spec_tail(self, ready: list[Request], drafts: dict,
                   ver_np: np.ndarray) -> None:
        """Acceptance and rollback: each slot keeps its longest accepted
        prefix (``sampling.accept_longest_prefix``); ``kv_len`` advances
        by the accepted count only, so the rejected positions are dead
        data the next append overwrites, and the pages past
        ``ceil(kv_len / page)`` go back to the pool."""
        accepted: dict[str, list[int]] = {}
        for req in ready:
            d = drafts.get(req.req_id, [])
            acc = sampling.accept_longest_prefix(
                d, ver_np[req.slot][:len(d) + 1])
            accepted[req.req_id] = [int(t) for t in acc]
            req.drafted_tokens += len(d)
            req.accepted_draft_tokens += len(acc) - 1
        self._decode_tail(ready, accepted)
        for req in ready:
            # Finished requests freed everything (free_tail of an unknown
            # owner is a no-op); running ones shrink to ceil(kv_len/page).
            self.sched.allocator.free_tail(req.req_id,
                                           -(-req.kv_len // self.page))

    def _decode_tail(self, ready: list[Request], new_tokens: dict) -> None:
        """Per-step bookkeeping: append each slot's new tokens (one on the
        one-token paths, 1..spec_k+1 accepted ones on the spec lane),
        advance its KV length by as many, finish the requests that are
        done."""
        for req in ready:
            ts = new_tokens[req.req_id]
            req.tokens.extend(ts)
            req.kv_len += len(ts)
            if req.done:
                self._finish(req)
