"""Inference engine — counterpart of the JAX package's
``models/engine.py``, on one device or on a tensor-parallel rank group.

Eager PyTorch: prefill writes a linear cache (``prefill_fn``, default
``dense_prefill``). With the reference's defaults (``backend="auto"``,
``page_size=None``) each decode step runs ``decode_fn`` (default
``dense_decode_step``) over that linear cache; with a ``page_size``,
:meth:`Engine.to_paged` mirrors the cache into the paged layout and each
step runs ``dense_decode_step_paged`` (K2). The greedy token follows on
the device — the host syncs once, when :meth:`Engine.serve` returns.
Callers that pass ``page_size`` and ``backend`` keep the behaviour they
had before ``"auto"`` became the default: ``"auto"`` and ``"xla"`` are
the same eager path at one rank.

``kv_dtype`` sets the paged pools' storage type: ``torch.float8_e4m3fn``
(or ``"float8_e4m3fn"``) halves the KV page, K2 reads it through its
e4m3 lane, and the linear prefill cache stays in the model dtype — the
linear→paged hand-off (:meth:`Engine.to_paged`, and the serving loop's
prefill scatter) is the quantization point, through the saturating
``models/fp8.saturate_cast``.

``backend`` picks the decode path: ``"auto"`` (the default),
``"overlap"`` (the reference's name for its overlapped multi-rank path:
at n = 1 the eager path, on a TP group the same perf-model choice as
``"auto"``) and ``"xla"`` (the name the JAX package gives its plain path)
are the eager steps above. ``"megakernel"`` decodes through the persistent
kernel: with a ``page_size`` the engine serves the serving tier's paged lane
(``ServingEngine`` decodes through ``megakernel/serving.py``); without
one, :meth:`Engine.serve` runs the sequential batch-1 loop over the
linear-workspace ``MegakernelDecoder`` — prefill as above, then one
megakernel launch per generated token. :meth:`Engine.decode` on the
megakernel, and :meth:`Engine.serve` on a megakernel engine that has a
``page_size``, refuse by name instead of decoding eagerly — there is no
demotion ladder. Not ported: the ladder, ``repartition``, observability
spans, and a CUDA graph for the decode step.

**On a TP group** (``Engine(cfg, params, ctx)``, ``ctx`` a
``runtime/context.DistContext`` of n > 1 ranks; ``device=`` stays the
one-rank form) the parameters are sharded per ``dense_llm_specs``
(``models/convert.shard_params``), each rank keeps its shard of the KV
heads, and every step runs once per rank through ``ctx.run`` (the
``shard_map`` counterpart). The prefill runs :meth:`Engine._prefill_mode`'s
mode: ``"overlap"`` (the perf model's pick for the prompts it pays on:
rows sharded over the ranks, the column-parallel projections through the
AG+GEMM kernel B9 and the row-parallel ones through the GEMM+RS kernel
B10), ``"ar"`` (replicated rows, each reduction through the AllReduce
kernel AUTO picks: one-shot, the double tree or two-shot), ``"xla"`` /
``"xla_rep"`` on ``backend="xla"``. Decode runs mode ``"ar"``
(``"xla_rep"`` on ``backend="xla"``) over the linear cache (the
default) or the paged one; with the default decode functions every
row-parallel reduction of a decode step rides the barrier-free
parity-stream AllReduce over a persistent workspace per batch shape
(:meth:`Engine._ar_state`; ``TDTPU_AR_STREAM=0`` opts out), and on the
linear step, where :meth:`Engine._use_fused_gemm_ar` says so
(``TDTPU_GEMM_AR=1``, or a measured win), every row-parallel projection
runs the fused GEMM+AR kernel B11 instead. A MoE config runs the TP-MoE
of ``ops/moe.py`` in each layer: the ring form in the ``"overlap"``
prefill (its tail the ring reduce-scatter), the replicated form reduced
by the parity stream in decode (``models/dense._mlp_or_moe``). The ranks
compute bit-identical logits; the engine returns rank 0's tokens.
``backend="megakernel"`` on a TP group (the reference's
``_serve_megakernel``): :meth:`Engine.serve` prefills in mode ``"ar"``
(replicated rows, :meth:`Engine._prefill_mode`), then decodes through
``MegakernelDecoder(num_ranks=n)``: one launch a rank a step, the TP
reductions inside the kernel (its AllReduce task types 4 and 22); a MoE
config is refused there, as the reference refuses it.

**On a two-tier group** (``ctx`` of two axes, e.g. ``mesh_shape=(2, 4),
axis_names=("dcn", "tp")``; reference ``models/engine.py:55-131``) the TP
group spans both tiers when ``inter_axis`` resolves to an axis (``None``:
the first other axis of size > 1; ``""`` opts out): the parameters and
the caches shard over the joint (inter, tp) index (``shard_axes``,
``n_total`` = n·n_inter KV-head shards), the prefill runs ``"overlap2d"``
(:meth:`Engine._prefill_mode`; rows over both tiers through
``ops/hierarchical``) or ``"ar"``, and decode reduces through the
two-tier ``tp_reduce`` (no parity stream, as the reference's). MoE
configs, ``backend="xla"`` and replaced model functions keep the one-axis
layout: the second axis replicates. ``backend="megakernel"`` is refused
there by name (``MegakernelUnsupportedError``): its in-kernel AllReduce
spans every rank of its group, and the linear decoder takes a one-axis
group only.
"""

from __future__ import annotations

import itertools
import os
import warnings

import numpy as np
import torch

from triton_distributed_tpu_torch.layers.tp_mlp import pick_mode
from triton_distributed_tpu_torch.megakernel.kernel import (
    MegakernelUnsupportedError,
)
from triton_distributed_tpu_torch.models import sampling
from triton_distributed_tpu_torch.models.config import ModelConfig
from triton_distributed_tpu_torch.models.convert import shard_params
from triton_distributed_tpu_torch.models.dense import (
    dense_decode_step, dense_decode_step_paged, dense_llm_specs,
    dense_prefill,
)
from triton_distributed_tpu_torch.models.fp8 import E4M3, saturate_cast
from triton_distributed_tpu_torch.models.kv_cache import (
    KVCache, PagedModelCache, init_kv_cache,
)
from triton_distributed_tpu_torch.runtime.device import (
    resolve_device, torch_dtype,
)


_ENGINE_SERIAL = itertools.count()


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


class Engine:
    """Serve a dense LLM on one device, or on the ranks of ``ctx`` (a TP
    group; see the module docstring).

    ``device=None`` means the card and raises without CUDA; pass
    ``device="cpu"`` for the CPU (the kernels' plain versions run there).
    ``params`` (from ``init_dense_llm`` or ``params_from_numpy``) are
    moved to ``device`` if they live elsewhere; on a TP group they may
    also be the ranks' shards, a list (``models/convert.shard_params``,
    which can shard a tree too large to keep twice: ``consume=True``).
    ``backend``: ``"auto"``, ``"xla"`` or ``"megakernel"``; ``page_size``:
    None decodes through the linear cache, a size through the paged one;
    ``kv_dtype``: the paged pools' type (see the module docstring). ``prefill_fn(params, cfg,
    ids, cache)`` and ``decode_fn(params, cfg, tokens, cache)`` replace the
    dense forward (the paged lane keeps ``dense_decode_step_paged`` unless
    ``decode_fn`` is given)."""

    BACKENDS = ("auto", "overlap", "xla", "megakernel")

    def __init__(self, cfg: ModelConfig, params: dict, ctx=None, *,
                 axis: str = "tp", device=None,
                 max_seq: int = 256, page_size: int | None = None,
                 backend: str = "auto", kv_dtype=None,
                 inter_axis: str | None = None,
                 prefill_fn=dense_prefill, decode_fn=dense_decode_step):
        if backend not in self.BACKENDS:
            raise ValueError(f"backend = {backend!r} unknown: expected one "
                             f"of {self.BACKENDS} — argument backend")
        if page_size is None:
            if kv_dtype is not None:
                raise ValueError(
                    "kv_dtype without page_size: the KV storage dtype is a "
                    "property of the PAGED pool (decode serving); linear "
                    "caches stay in the model dtype — pass page_size too")
        elif page_size < 1:
            raise ValueError(f"page_size = {page_size} invalid: a page holds "
                             "at least one position — argument page_size")
        self.kv_dtype = None if kv_dtype is None else torch_dtype(kv_dtype)
        if self.kv_dtype not in (None, E4M3, torch_dtype(cfg.dtype)):
            raise ValueError(f"kv_dtype = {kv_dtype} unsupported: the pools "
                             "hold the model dtype or float8_e4m3fn — "
                             "argument kv_dtype")
        if ctx is not None and device is not None:
            raise ValueError("pass ctx (a TP group) or device (one rank), "
                             "not both — arguments ctx / device")
        self.backend = backend
        self.cfg = cfg
        self.ctx = ctx
        self.axis = axis
        self.n = 1 if ctx is None else ctx.axis_size(axis)
        # Every rank of the group runs the steps (ctx.run); on a two-tier
        # group that is n·n_inter ranks, or n per slice with the second
        # axis replicating.
        self.grouped = ctx is not None and ctx.num_ranks > 1
        if backend == "megakernel" and ctx is not None and \
                ctx.num_ranks != self.n:
            raise MegakernelUnsupportedError(
                f"backend='megakernel' on a group of {ctx.num_ranks} ranks "
                f"over axes {ctx.axis_names} is not ported: the "
                "megakernel's in-kernel AllReduce spans every rank of its "
                f"group, so it needs a one-axis group of {self.n} ranks "
                f"over {axis!r} — argument ctx")
        self._resolve_tiers(inter_axis, prefill_fn, decode_fn)
        self.device = (ctx.devices[0] if ctx is not None
                       else resolve_device(device))
        self.max_seq = max_seq
        self.page_size = page_size
        self.max_pages = (None if page_size is None
                          else -(-max_seq // page_size))
        if self.grouped:
            if cfg.num_kv_heads % self.n_total:
                raise ValueError(f"num_kv_heads {cfg.num_kv_heads} not "
                                 f"divisible by TP degree {self.n_total}")
            self.param_specs = dense_llm_specs(cfg, self.shard_axes)
            if isinstance(params, list):
                if len(params) != ctx.num_ranks:
                    raise ValueError(f"{len(params)} rank shards for a "
                                     f"group of {ctx.num_ranks} — argument "
                                     "params")
                self.rank_params = params
            else:
                self.rank_params = shard_params(params, ctx, cfg,
                                                axis=self.shard_axes)
            self.params = None      # per rank: rank_params
        else:
            self.params = _to_device(params, self.device)
            self.rank_params = [self.params]
        # A tag of this engine's own for its parity workspaces: id() would
        # be reused by a later engine on the same context, which would
        # then find this one's flags already past its call indices.
        self._serial = next(_ENGINE_SERIAL)
        self._ar_states: dict = {}
        self._gemm_ar_choice: str | None = None
        self._prefill_fn = prefill_fn
        self._decode_fn = (dense_decode_step_paged
                           if page_size is not None
                           and decode_fn is dense_decode_step else decode_fn)
        self._mk = None       # the sequential serve's cached decoder

    def _resolve_tiers(self, inter_axis, prefill_fn, decode_fn) -> None:
        """The two-tier layout (reference ``Engine.__init__``):
        ``inter_axis`` None finds the first other axis of size > 1, ``""``
        opts out; the TP group spans it (``hierarchical``) only on the
        eager dense path with the reference's model functions, and when
        the KV heads divide over both tiers."""
        ctx, cfg = self.ctx, self.cfg
        if inter_axis == "" or ctx is None:
            inter_axis = None
        elif inter_axis is None:
            inter_axis = next((a for a in ctx.axis_names
                               if a != self.axis and ctx.axis_size(a) > 1),
                              None)
        self.inter_axis = inter_axis
        self.n_inter = (ctx.axis_size(inter_axis) if inter_axis is not None
                        else 1)
        self.hierarchical = (
            self.n_inter > 1 and self.backend in ("auto", "overlap")
            and not cfg.is_moe and prefill_fn is dense_prefill
            and decode_fn is dense_decode_step
            and cfg.num_kv_heads % (self.n * self.n_inter) == 0)
        if not self.hierarchical:
            self.n_inter = 1
        self.n_total = self.n * self.n_inter
        self.shard_axes = ((self.inter_axis, self.axis) if self.hierarchical
                           else self.axis)

    # -- the rank group ----------------------------------------------------
    @property
    def rank_devices(self) -> list:
        return self.ctx.devices if self.grouped else [self.device]

    def run(self, fn) -> list:
        """``fn(rank)`` on every rank (through ``ctx.run`` on a group, in
        the calling thread at one rank); the results in rank order."""
        if not self.grouped:
            return [fn(0)]
        return self.ctx.run(fn)

    def replicate(self, x) -> list:
        """A host array or CPU tensor on every rank's device (one copy per
        distinct device: virtual ranks on one card share it)."""
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
            np.asarray(x))
        copies: dict = {}
        return [copies.setdefault(d, t.to(d)) for d in self.rank_devices]

    def tp_kwargs(self, mode: str) -> dict:
        """The TP arguments of the model functions (none at one rank, so
        one-rank ``prefill_fn`` / ``decode_fn`` replacements keep their
        signature; the inter tier's on a two-tier engine)."""
        if not self.grouped:
            return {}
        kw = {"axis": self.axis, "num_ranks": self.n, "mode": mode}
        if self.hierarchical:
            kw.update(inter_axis=self.inter_axis, n_inter=self.n_inter)
        return kw

    def check_comm(self) -> None:
        """Raise ``CommTimeoutError`` if a collective kernel of the last
        steps timed out (reads the ranks' error words: a device sync)."""
        if self.grouped:
            self.ctx.raise_on_comm_error()

    def _prefill_mode(self, batch: int, seq: int) -> str:
        """The prefill's TP mode (reference ``_prefill_mode``): replicated
        ``"ar"`` on the megakernel; ``"xla"`` / ``"xla_rep"`` on
        ``backend="xla"``; on a two-tier engine ``"overlap2d"`` or
        ``"ar"`` (``backend="overlap"`` takes ``"overlap2d"`` whenever the
        rows divide over both tiers, ``"auto"`` the perf model's pick with
        the inter tier's crossover); else the perf model's ``pick_mode``
        (``"overlap"`` or ``"ar"``)."""
        itemsize = torch_dtype(self.cfg.dtype).itemsize
        if self.backend == "megakernel":
            return "ar"
        if self.backend == "xla":
            return "xla" if (batch * seq) % self.n == 0 else "xla_rep"
        if self.hierarchical:
            if self.backend == "overlap":
                return ("overlap2d" if (batch * seq) % self.n_total == 0
                        else "ar")
            m = pick_mode("auto", batch * seq, self.n,
                          hidden=self.cfg.hidden_size,
                          ffn=self.cfg.intermediate_size, itemsize=itemsize,
                          n_inter=self.n_inter)
            return m if m == "overlap2d" else "ar"
        m = pick_mode("auto", batch * seq, self.n,
                      hidden=self.cfg.hidden_size,
                      ffn=self.cfg.intermediate_size,
                      itemsize=torch_dtype(self.cfg.dtype).itemsize)
        return m if self.backend == "auto" else (
            "overlap" if m == "overlap" else "ar")

    def _decode_mode(self) -> str:
        return "xla_rep" if self.backend == "xla" else "ar"

    def _use_ar_stream(self) -> bool:
        """The barrier-free parity AR on the decode path: real TP, mode
        ``"ar"``, a dense decode function (a user's ``decode_fn`` has no
        ``ar_state`` contract), one tier (a two-tier engine reduces
        through the two-tier ``tp_reduce``, as the reference's).
        ``TDTPU_AR_STREAM=0`` opts out."""
        return (self.n > 1 and self.n_inter == 1
                and self.ctx.num_ranks == self.n
                and self._decode_mode() == "ar"
                and self._decode_fn in (dense_decode_step,
                                        dense_decode_step_paged)
                and os.environ.get("TDTPU_AR_STREAM", "1") != "0")

    def _use_fused_gemm_ar(self) -> bool:
        """The fused GEMM+AR kernel B11 in every row-parallel projection of
        the linear decode step (reference ``_use_fused_gemm_ar``):
        ``TDTPU_GEMM_AR=1`` forces it, ``=0`` forbids it; unset, the comm
        autotuner races dot + parity AR, fused and the plain sum at both
        site shapes (attention's output, the MLP's down; batch 1), and the
        fused path runs only where it won both
        (``runtime/autotuner.tuned_gemm_ar_path``; with comm tuning off,
        dot + parity AR). The paged step keeps dot + parity AR."""
        if not (self._use_ar_stream()
                and self._decode_fn is dense_decode_step):
            return False
        flag = os.environ.get("TDTPU_GEMM_AR", "auto")
        if flag in ("0", "1"):
            return flag == "1"
        if self._gemm_ar_choice is None:
            from triton_distributed_tpu_torch.runtime.autotuner import (
                tuned_gemm_ar_path,
            )

            dt = torch_dtype(self.cfg.dtype)
            h = self.cfg.hidden_size
            o = tuned_gemm_ar_path(1, self.cfg.q_size // self.n, h, dt,
                                   self.ctx, self.axis)
            dn = tuned_gemm_ar_path(1, self.cfg.intermediate_size // self.n,
                                    h, dt, self.ctx, self.axis)
            self._gemm_ar_choice = ("fused" if o == "fused" and dn == "fused"
                                    else "dot_ar")
        return self._gemm_ar_choice == "fused"

    def _ar_state(self, batch: int, fused: bool = False) -> list:
        """The persistent workspace of decode batch ``batch`` and each
        rank's call index: [(ws, idx)] per rank — the parity AR's, or with
        ``fused`` B11's. Allocated once per batch shape, with a tag of this
        engine's own — the symmetric-memory persistence the barrier-free
        protocol needs."""
        key = (batch, fused)
        if key not in self._ar_states:
            from triton_distributed_tpu_torch.ops.allreduce import (
                ar_stream_workspace,
            )
            from triton_distributed_tpu_torch.ops.gemm_allreduce import (
                gemm_ar_stream_workspace,
            )

            make = gemm_ar_stream_workspace if fused else ar_stream_workspace
            ws, idx = make(self.n, batch, self.cfg.hidden_size,
                           torch_dtype(self.cfg.dtype), ctx=self.ctx,
                           tag=f"engine-{self._serial}-"
                               f"{'gemm-ar' if fused else 'ar-stream'}")
            self._ar_states[key] = [(ws, idx)] * self.n
        return self._ar_states[key]

    def new_cache(self, batch: int):
        """A zeroed linear cache (on a group: one shard per rank, a list;
        ``n_total`` KV-head shards)."""
        if self.grouped:
            return self.run(lambda r: init_kv_cache(
                self.cfg, batch, self.max_seq, device=self.ctx.devices[r],
                num_ranks=self.n_total))
        return init_kv_cache(self.cfg, batch, self.max_seq,
                             device=self.device)

    def to_paged(self, cache):
        """Mirror a linear cache into the paged layout: sequence b owns
        pages ``[b*max_pages, (b+1)*max_pages)``, lengths = ``offset``. A
        view of the same storage when ``max_seq`` is a page multiple and
        the pools keep the model dtype; with ``kv_dtype`` e4m3 the pools
        are a saturating-cast copy (the quantization point). At n > 1,
        a list of rank shards → a list."""
        if isinstance(cache, list):
            return self.run(lambda r: self._to_paged_one(
                cache[r], self.rank_devices[r]))
        return self._to_paged_one(cache, self.device)

    def _to_paged_one(self, cache: KVCache, device) -> PagedModelCache:
        L, batch = cache.k.shape[0], cache.k.shape[1]
        P, mp = self.page_size, self.max_pages
        pad = mp * P - cache.max_seq

        def to_pools(x):   # (L, B, S, hkv, d) -> (L, B*mp, P, hkv, d)
            if pad:
                x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
            x = x.reshape(L, batch * mp, P, *x.shape[3:])
            if self.kv_dtype is not None:
                x = saturate_cast(x, self.kv_dtype)
            return x

        return PagedModelCache(
            k_pools=to_pools(cache.k), v_pools=to_pools(cache.v),
            page_table=torch.arange(batch * mp, dtype=torch.int32,
                                    device=device).reshape(batch, mp),
            kv_lens=torch.full((batch,), cache.offset, dtype=torch.int32,
                               device=device))

    def prefill(self, input_ids: torch.Tensor, cache: KVCache | None = None):
        """input_ids: (B, S). Returns (last-token logits (B, vocab), cache)."""
        batch, seq = input_ids.shape
        if seq > self.max_seq:
            raise ValueError(f"prompt {seq} exceeds max_seq {self.max_seq}")
        cache = cache if cache is not None else self.new_cache(batch)
        if not self.grouped:
            return self._prefill_fn(self.params, self.cfg,
                                    input_ids.to(self.device), cache)
        mode = self._prefill_mode(batch, seq)
        ids = self.replicate(input_ids)
        outs = self.run(lambda r: self._prefill_fn(
            self.rank_params[r], self.cfg, ids[r], cache[r],
            **self.tp_kwargs(mode)))
        return outs[0][0], [o[1] for o in outs]

    def _check_eager(self) -> None:
        if self.backend == "megakernel":
            raise MegakernelUnsupportedError(
                "Engine.decode on backend='megakernel' is not ported: the "
                "megakernel decodes through Engine.serve (sequential, "
                "page_size=None) or ServingEngine's paged lane — use "
                "backend='xla' for the eager step")

    def decode(self, tokens: torch.Tensor, cache):
        """tokens: (B,). ``cache``: the linear cache from :meth:`prefill`
        (without a ``page_size``), or a PagedModelCache (with one; a
        linear cache is converted on first use). Returns (next_tokens (B,)
        int32, cache). The eager step only: refused by name on
        ``backend="megakernel"``."""
        self._check_eager()
        if self.grouped:
            return self._decode_run(tokens, cache)
        if self.page_size is not None and isinstance(cache, KVCache):
            cache = self.to_paged(cache)
        logits, cache = self._decode_fn(self.params, self.cfg,
                                        tokens.to(self.device), cache)
        return sampling.greedy(logits), cache

    def _decode_run(self, tokens: torch.Tensor, caches: list):
        """One decode step on every rank (reference ``_decode_run``):
        ``caches`` the ranks' shards, linear or paged (a linear cache is
        mirrored into pages first when the engine has a ``page_size``);
        with :meth:`_use_ar_stream` every ``"ar"`` reduction rides the
        parity stream of this batch shape, or with
        :meth:`_use_fused_gemm_ar` every row-parallel projection runs B11.
        Returns (rank 0's next tokens, the ranks' caches)."""
        if self.page_size is not None and isinstance(caches[0], KVCache):
            caches = self.to_paged(caches)
        batch = int(tokens.shape[0])
        toks = self.replicate(tokens.cpu() if tokens.is_cuda else tokens)
        kw = self.tp_kwargs(self._decode_mode())
        if self._use_ar_stream():
            fused = self._use_fused_gemm_ar()
            states = self._ar_state(batch, fused)
            if fused:
                kw["fused_gemm_ar"] = True

            def step(r):
                logits, cache, st = self._decode_fn(
                    self.rank_params[r], self.cfg, toks[r], caches[r],
                    ar_state=states[r], **kw)
                states[r] = st
                return sampling.greedy(logits), cache
        else:
            def step(r):
                logits, cache = self._decode_fn(
                    self.rank_params[r], self.cfg, toks[r], caches[r], **kw)
                return sampling.greedy(logits), cache
        outs = self.run(step)
        return outs[0][0], [o[1] for o in outs]

    def serve(self, input_ids, gen_len: int) -> torch.Tensor:
        """Greedy generation: (B, S) prompt ids → (B, gen_len) int32 token
        ids on the device. The first token comes from the prefill logits;
        the rest from the eager step (linear or paged), or
        (``backend="megakernel"``, batch 1) from one megakernel launch
        each."""
        if not isinstance(input_ids, torch.Tensor):
            input_ids = torch.as_tensor(np.asarray(input_ids))
        if self.grouped:
            return self._serve_tp(input_ids, gen_len)
        if self.backend == "megakernel":
            self._check_megakernel_serve()
        if (self.page_size is None and self.backend != "megakernel"
                and input_ids.shape[1] + gen_len - 1 > self.max_seq):
            raise ValueError(
                f"prompt ({input_ids.shape[1]}) + gen_len ({gen_len}) "
                f"exceeds max_seq {self.max_seq} of the linear cache")
        logits, cache = self.prefill(input_ids.to(self.device))
        tok = sampling.greedy(logits)
        if self.backend == "megakernel":
            return self._serve_megakernel(tok, cache, gen_len)
        if self.page_size is not None:
            cache = self.to_paged(cache)
        outs = [tok]
        for _ in range(gen_len - 1):
            tok, cache = self.decode(tok, cache)
            outs.append(tok)
        if self.page_size is None:
            return torch.stack(outs, dim=1)
        saturated = cache.saturated.cpu().numpy()
        if saturated.any():
            warnings.warn(
                "paged KV pool saturated for sequence(s) "
                f"{np.flatnonzero(saturated).tolist()} — their final tokens "
                "attended a truncated cache; raise max_seq",
                RuntimeWarning, stacklevel=2)
        return torch.stack(outs, dim=1)

    def _serve_tp(self, input_ids: torch.Tensor, gen_len: int
                  ) -> torch.Tensor:
        """:meth:`serve` on a TP group: the prefill in its mode
        (:meth:`_prefill_mode`), then the decode steps over the linear
        cache, or over the paged one with a ``page_size``; on the
        megakernel, the linear decoder of the group (refused with a
        ``page_size``, as at one rank)."""
        if self.backend == "megakernel":
            self._check_megakernel_serve()
            logits, caches = self.prefill(input_ids)
            out = self._serve_megakernel(sampling.greedy(logits), caches,
                                         gen_len)
            self.check_comm()
            return out
        if (self.page_size is None
                and input_ids.shape[1] + gen_len - 1 > self.max_seq):
            raise ValueError(
                f"prompt ({input_ids.shape[1]}) + gen_len ({gen_len}) "
                f"exceeds max_seq {self.max_seq} of the linear cache")
        logits, caches = self.prefill(input_ids)
        tok = sampling.greedy(logits)
        if self.page_size is not None:
            caches = self.to_paged(caches)
        outs = [tok]
        for _ in range(gen_len - 1):
            tok, caches = self.decode(tok, caches)
            outs.append(tok)
        out = torch.stack(outs, dim=1)
        self.check_comm()
        return out

    def _check_megakernel_serve(self) -> None:
        if self.page_size is not None:
            # The JAX package demotes down its backend ladder here; the
            # port has none.
            raise MegakernelUnsupportedError(
                "megakernel sequential serve uses its own linear "
                "workspace cache, not the paged pool (page_size="
                f"{self.page_size}) — build the engine with "
                "page_size=None for Engine.serve, or use "
                "ServingEngine(backend='megakernel') for the paged "
                "persistent-kernel lane")

    def _serve_megakernel(self, tok: torch.Tensor, cache,
                          gen_len: int) -> torch.Tensor:
        """Decode loop through the persistent megakernel: one launch per
        token (a rank), the queue retargeted per position without
        recompiling. The decoder (float32 linear workspace, as the JAX
        package's Engine builds it; on a TP group the ranks' shards, its
        AllReduce tasks carrying the reductions) is cached on the engine;
        every serve reloads the prefilled cache (the ranks' caches) into
        fresh main workspaces."""
        from triton_distributed_tpu_torch.megakernel.serving import (
            MegakernelDecoder,
        )

        if self._mk is None:
            if self.grouped:
                self._mk = MegakernelDecoder(
                    self.cfg, self.rank_params, max_seq=self.max_seq,
                    ctx=self.ctx, axis=self.axis, num_ranks=self.n)
            else:
                self._mk = MegakernelDecoder(self.cfg, self.params,
                                             max_seq=self.max_seq,
                                             device=self.device)
        pos = int((cache[0] if isinstance(cache, list) else cache).offset)
        if pos + gen_len - 1 > self.max_seq:
            raise ValueError(
                f"prompt ({pos}) + gen_len ({gen_len}) exceeds max_seq "
                f"{self.max_seq} — reject up front rather than dying "
                "mid-generation")
        ws = self._mk.start(cache)
        outs = [tok]
        for _ in range(gen_len - 1):
            ws, tok = self._mk.step(ws, tok, pos)
            pos += 1
            outs.append(tok)
        return torch.stack(outs, dim=1)
