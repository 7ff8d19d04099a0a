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

Greedy decoding end to end, so each request's tokens are identical to a
sequential ``Engine.serve`` of its prompt. Not in this slice: prefix cache,
speculative decode, KV host tier, the async loop, disaggregation, fleet,
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
    dense_last_logits, dense_prefill_slice,
)
from triton_distributed_tpu_torch.models.engine import Engine
from triton_distributed_tpu_torch.models.kv_cache import (
    PageAllocator, init_kv_cache, init_paged_model_cache,
)
from triton_distributed_tpu_torch.serving.request import Request, RequestState
from triton_distributed_tpu_torch.serving.scheduler import (
    AdmitResult, Scheduler,
)


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
      prefill_chunk: tokens per prefill slice (a positive multiple of
        ``engine.page_size``; default one page).
      max_waiting: waiting-queue bound (admission backpressure beyond).
      clock: the time source stamped into requests.
    """

    def __init__(self, engine: Engine, *, max_batch: int = 4,
                 num_pages: int | None = None,
                 prefill_chunk: int | None = None, max_waiting: int = 64,
                 clock=time.perf_counter):
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
        pool_pages = (num_pages if num_pages is not None
                      else max_batch * self.max_pages)
        if pool_pages < 1:
            raise ServingConfigError(
                f"num_pages = {pool_pages} invalid: the shared pool needs "
                "at least one page — argument num_pages")
        self.num_pages = pool_pages
        self.scratch_page = pool_pages        # last pool row, never owned
        self._pf_cache = init_kv_cache(self.cfg, 1, self.s_buf,
                                       device=engine.device)
        # The megakernel lane's workspace holds the KV pools, with the
        # scratch page as a reserved pool row (the budget math sees it);
        # the eager lane keeps a PagedModelCache.
        self._mk = None
        self._mk_ws = None
        self._cache = None
        if engine.backend == "megakernel":
            self._mk = self._build_megakernel_lane(pool_pages)
            self._mk_ws = self._mk.start()
            allocator = PageAllocator(pool_pages + 1, self.max_pages,
                                      reserved=(self.scratch_page,))
        else:
            self._cache = init_paged_model_cache(
                self.cfg, max_batch, page_size=page,
                max_pages=self.max_pages, num_pages=pool_pages + 1,
                device=engine.device)
            allocator = PageAllocator(pool_pages, self.max_pages)
        self.sched = Scheduler(
            num_slots=max_batch, allocator=allocator,
            page_size=page, capacity_tokens=capacity,
            max_waiting=max_waiting)
        self._iter = 0
        self._finished: list[Request] = []

    def _build_megakernel_lane(self, pool_pages: int
                               ) -> PagedMegakernelDecoder:
        """The paged persistent-kernel decoder, or a named
        MegakernelUnsupportedError saying which dimension the lane cannot
        serve (page shape, model geometry)."""
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
            device=eng.device)

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
        ready, preempted = self.sched.ensure_decode_pages()
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
        x, self._pf_cache = dense_prefill_slice(
            eng.params, self.cfg, torch.from_numpy(ids).to(eng.device),
            self._pf_cache, start)
        req.prefill_pos = min(start + self.chunk, T)
        if req.prefill_pos >= T:
            row = (T - 1) - start
            logits = dense_last_logits(eng.params, self.cfg, x[row:row + 1])
            tok = int(sampling.greedy(logits)[0])       # host sync
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
        pf = self._pf_cache
        if self._mk is not None:
            self._mk_ws = self._mk.load_prefill(self._mk_ws, pf.k, pf.v,
                                                owned)
        else:
            pages = torch.as_tensor(owned, dtype=torch.long,
                                    device=self.engine.device)
            for pool, lin in ((self._cache.k_pools, pf.k),
                              (self._cache.v_pools, pf.v)):
                src = lin[:, 0].reshape(L, self.s_buf // page, page,
                                        *lin.shape[3:])[:, :n_pages]
                pool[:, pages] = src.to(pool.dtype)
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

    def _decode(self, ready: list[Request]) -> None:
        if self._mk is not None:
            # The persistent-kernel lane: the host rewrites queue words
            # from the allocator's page ids and ONE launch decodes every
            # slot, its appends advancing the pool pages. Unmapped entries
            # are -1, so the decoder's page-coverage checks see them.
            toks, lens, table = self._slot_state(ready, -1)
            self._mk_ws, tok = self._mk.step(self._mk_ws, toks, lens, table)
            self._decode_tail(ready, tok.cpu().numpy())    # host sync
            return
        eng = self.engine
        toks, lens, table = self._slot_state(ready, self.scratch_page)
        cache = self._cache._replace(
            page_table=torch.from_numpy(table).to(eng.device),
            kv_lens=torch.from_numpy(lens).to(eng.device))
        tok, self._cache = eng.decode(torch.from_numpy(toks), cache)
        self._decode_tail(ready, tok.cpu().numpy())    # host sync

    def _decode_tail(self, ready: list[Request], tok_np: np.ndarray) -> None:
        """Per-step bookkeeping: append each slot's token, advance its
        KV length, finish the requests that are done."""
        for req in ready:
            req.tokens.append(int(tok_np[req.slot]))
            req.kv_len += 1
            if req.done:
                self._finish(req)
