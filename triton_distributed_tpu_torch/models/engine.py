"""Inference engine on one device — counterpart of the JAX package's
``models/engine.py`` at tensor-parallel degree 1.

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

``backend`` picks the decode path: ``"auto"`` (the default) and
``"xla"`` (the name the JAX package gives its plain path) are the eager
steps above; ``"overlap"`` (the reference's overlapped multi-rank path)
is refused by name. ``"megakernel"`` decodes through the persistent
kernel: with a ``page_size`` the engine serves the serving tier's paged lane
(``ServingEngine`` decodes through ``megakernel/serving.py``); without
one, :meth:`Engine.serve` runs the sequential batch-1 loop over the
linear-workspace ``MegakernelDecoder`` — prefill as above, then one
megakernel launch per generated token. :meth:`Engine.decode` on the
megakernel, and :meth:`Engine.serve` on a megakernel engine that has a
``page_size``, refuse by name instead of decoding eagerly — there is no
demotion ladder. Not ported: the ladder, ``repartition``, observability
spans, and a CUDA graph for the decode step.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from triton_distributed_tpu_torch.megakernel.kernel import (
    MegakernelUnsupportedError,
)
from triton_distributed_tpu_torch.models import sampling
from triton_distributed_tpu_torch.models.config import ModelConfig
from triton_distributed_tpu_torch.models.dense import (
    dense_decode_step, dense_decode_step_paged, dense_prefill,
)
from triton_distributed_tpu_torch.models.fp8 import E4M3, saturate_cast
from triton_distributed_tpu_torch.models.kv_cache import (
    KVCache, PagedModelCache, init_kv_cache,
)
from triton_distributed_tpu_torch.runtime.device import (
    resolve_device, torch_dtype,
)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


class Engine:
    """Serve a dense LLM on one device.

    ``device=None`` means the card and raises without CUDA; pass
    ``device="cpu"`` for the CPU (the kernels' plain versions run there).
    ``params`` (from ``init_dense_llm`` or ``params_from_numpy``) are
    moved to ``device`` if they live elsewhere. ``backend``: ``"auto"``,
    ``"xla"`` or ``"megakernel"``; ``page_size``: None decodes through the
    linear cache, a size through the paged one; ``kv_dtype``: the paged
    pools' type (see the module docstring). ``prefill_fn(params, cfg,
    ids, cache)`` and ``decode_fn(params, cfg, tokens, cache)`` replace the
    dense forward (the paged lane keeps ``dense_decode_step_paged`` unless
    ``decode_fn`` is given)."""

    BACKENDS = ("auto", "xla", "megakernel")

    def __init__(self, cfg: ModelConfig, params: dict, *, device=None,
                 max_seq: int = 256, page_size: int | None = None,
                 backend: str = "auto", kv_dtype=None,
                 prefill_fn=dense_prefill, decode_fn=dense_decode_step):
        if backend == "overlap":
            raise ValueError(
                "backend = 'overlap' is not ported: the overlapped AG+GEMM "
                "/ GEMM+RS path needs the multi-GPU runtime — argument "
                "backend")
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
        self.backend = backend
        self.cfg = cfg
        self.device = resolve_device(device)
        self.max_seq = max_seq
        self.page_size = page_size
        self.max_pages = (None if page_size is None
                          else -(-max_seq // page_size))
        self.params = _to_device(params, self.device)
        self._prefill_fn = prefill_fn
        self._decode_fn = (dense_decode_step_paged
                           if page_size is not None
                           and decode_fn is dense_decode_step else decode_fn)
        self._mk = None       # the sequential serve's cached decoder

    def new_cache(self, batch: int) -> KVCache:
        return init_kv_cache(self.cfg, batch, self.max_seq,
                             device=self.device)

    def to_paged(self, cache: KVCache) -> PagedModelCache:
        """Mirror a linear cache into the paged layout: sequence b owns
        pages ``[b*max_pages, (b+1)*max_pages)``, lengths = ``offset``. A
        view of the same storage when ``max_seq`` is a page multiple and
        the pools keep the model dtype; with ``kv_dtype`` e4m3 the pools
        are a saturating-cast copy (the quantization point)."""
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
                                    device=self.device).reshape(batch, mp),
            kv_lens=torch.full((batch,), cache.offset, dtype=torch.int32,
                               device=self.device))

    def prefill(self, input_ids: torch.Tensor, cache: KVCache | None = None):
        """input_ids: (B, S). Returns (last-token logits (B, vocab), cache)."""
        batch, seq = input_ids.shape
        if seq > self.max_seq:
            raise ValueError(f"prompt {seq} exceeds max_seq {self.max_seq}")
        cache = cache if cache is not None else self.new_cache(batch)
        return self._prefill_fn(self.params, self.cfg,
                                input_ids.to(self.device), cache)

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
        if self.page_size is not None and isinstance(cache, KVCache):
            cache = self.to_paged(cache)
        logits, cache = self._decode_fn(self.params, self.cfg,
                                        tokens.to(self.device), cache)
        return sampling.greedy(logits), cache

    def serve(self, input_ids, gen_len: int) -> torch.Tensor:
        """Greedy generation: (B, S) prompt ids → (B, gen_len) int32 token
        ids on the device. The first token comes from the prefill logits;
        the rest from the eager step (linear or paged), or
        (``backend="megakernel"``, batch 1) from one megakernel launch
        each."""
        if not isinstance(input_ids, torch.Tensor):
            input_ids = torch.as_tensor(np.asarray(input_ids))
        if self.backend == "megakernel" and self.page_size is not None:
            # The JAX package demotes down its backend ladder here; the
            # port has none.
            raise MegakernelUnsupportedError(
                "megakernel sequential serve uses its own linear "
                "workspace cache, not the paged pool (page_size="
                f"{self.page_size}) — build the engine with "
                "page_size=None for Engine.serve, or use "
                "ServingEngine(backend='megakernel') for the paged "
                "persistent-kernel lane")
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

    def _serve_megakernel(self, tok: torch.Tensor, cache: KVCache,
                          gen_len: int) -> torch.Tensor:
        """Decode loop through the persistent megakernel: one launch per
        token, the queue retargeted per position without recompiling. The
        decoder (float32 linear workspace, as the JAX package's Engine
        builds it) is cached on the engine; every serve reloads the
        prefilled cache into a fresh main workspace."""
        from triton_distributed_tpu_torch.megakernel.serving import (
            MegakernelDecoder,
        )

        if self._mk is None:
            self._mk = MegakernelDecoder(self.cfg, self.params,
                                         max_seq=self.max_seq,
                                         device=self.device)
        pos = int(cache.offset)
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
