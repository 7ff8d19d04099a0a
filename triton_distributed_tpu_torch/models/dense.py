"""Dense decoder-only LLM (Qwen3-style) — counterpart of the JAX
package's ``models/dense.py``.

Parameters are a plain dict with the JAX package's structure and (in, out)
weight layout (``models/convert.py`` turns a JAX tree into one). Caches
are updated in place; each function returns the cache it was given, with
its host-side bookkeeping (``offset``, ``kv_lens``) advanced.

Per block (pre-norm):  x ─ rms_norm ─ attention ─(+)─ rms_norm ─ FFN ─(+)─ …

The FFN is the dense SwiGLU MLP, or on a MoE config (Qwen3-MoE) the
TP-MoE of ``ops/moe.moe_tp_fwd_local`` (on a TP group: the ring form in
the ``"overlap"`` prefill, the replicated ``"ar"`` form in decode).

Decode runs over the paged cache (``dense_decode_step_paged``, K2) or the
linear cache (:func:`dense_decode_step`: one host position for the whole
batch, attention by ``tp_attn_decode``'s plain ``_sdpa``). The linear step
takes ``dot_fn``, which replaces every projection and dense-MLP product:
the fp8 weight lane passes ``models/fp8.fp8_dot`` over a
``quantize_dense_weights`` tree (kernel B3's e4m3 lane on the card; MoE
expert stacks in e4m3 take B3 inside ``ragged_dot_dtype_aware``).

On a TP group (``num_ranks`` > 1, called inside ``DistContext.run`` with
each rank's shard of the parameters per :func:`dense_llm_specs`) the
vocabulary-sharded logits are gathered through the group (the
reference's ``jax.lax.all_gather``), and the activations run per
``mode`` (``layers/tp_mlp``): :func:`dense_prefill` row-sharded in
``"overlap"`` (kernels B9/B10) and ``"xla"`` — each rank takes its 1/n
of the prompt rows and the rows are gathered before the last token —,
replicated in ``"ar"`` and ``"xla_rep"``; the decode steps replicated.
The decode steps take ``ar_state``: every ``"ar"`` reduction then rides
the barrier-free parity stream (:func:`make_ar_stream_fn`), or, with
``fused_gemm_ar`` on the linear step, every row-parallel projection runs
the fused GEMM+AR kernel B11 (:func:`make_gemm_ar_stream_fn`).

On a TP group spanning a second, inter tier (``n_inter`` > 1: the
parameters sharded over the joint (inter, tp) index, ``dense_llm_specs(
cfg, (inter_axis, axis))``), :func:`dense_prefill` runs ``"overlap2d"``
with (B·S)/(n·n_inter) rows a rank — global shard g = inter·n + intra —
and the rows and the logits gather over both axes; the replicated modes
(and the decode steps) reduce through the two-tier ``tp_reduce``.
"""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.layers.common import rms_norm
from triton_distributed_tpu_torch.layers.ep_moe import init_ep_moe
from triton_distributed_tpu_torch.layers.tp_attn import (
    init_tp_attn, tp_attn_decode, tp_attn_decode_paged, tp_attn_prefill,
    tp_attn_prefill_chunk, tp_attn_specs, tp_attn_verify_paged,
)
from triton_distributed_tpu_torch.layers.tp_mlp import (
    check_mode, init_tp_mlp, tp_mlp_fwd, tp_mlp_specs,
)
from triton_distributed_tpu_torch.models.config import ModelConfig
from triton_distributed_tpu_torch.models.kv_cache import (
    KVCache, PagedModelCache,
)
from triton_distributed_tpu_torch.ops.moe import moe_tp_fwd_local
from triton_distributed_tpu_torch.runtime.context import (
    P, axis_index, group_all_gather,
)
from triton_distributed_tpu_torch.runtime.device import (
    resolve_device, torch_dtype,
)


def init_dense_llm(cfg: ModelConfig, *, generator: torch.Generator,
                   device=None) -> dict:
    """Random parameters with the JAX package's scales, drawn from
    ``generator`` (which must live on ``device``; ``None`` = the card).
    The values differ from the JAX initialiser's — to compare the two,
    convert the JAX tree with ``models/convert.params_from_numpy``.
    A MoE config gets a ``moe`` subtree per layer (``init_ep_moe``) in
    place of ``mlp``."""
    dev = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    h, v = cfg.hidden_size, cfg.vocab_size
    params: dict = {
        "embed": torch.randn((v, h), generator=generator, dtype=dt,
                             device=dev) * 0.02,
        "final_norm": torch.ones((h,), dtype=dt, device=dev),
        "layers": [],
    }
    for _ in range(cfg.num_layers):
        layer = {
            "attn_norm": torch.ones((h,), dtype=dt, device=dev),
            "mlp_norm": torch.ones((h,), dtype=dt, device=dev),
            "attn": init_tp_attn(cfg, dt, generator=generator, device=dev),
        }
        if cfg.is_moe:
            layer["moe"] = init_ep_moe(
                h, cfg.moe_intermediate_size, cfg.num_experts, dt,
                generator=generator, device=dev)
        else:
            layer["mlp"] = init_tp_mlp(h, cfg.intermediate_size, dt,
                                       generator=generator, device=dev)
        params["layers"].append(layer)
    if not cfg.tie_word_embeddings:
        params["lm_head"] = torch.randn((h, v), generator=generator,
                                        dtype=dt, device=dev) * 0.02
    return params


def dense_llm_specs(cfg: ModelConfig, axis: str = "tp") -> dict:
    """Partition specs matching :func:`init_dense_llm`'s structure:
    column-parallel q/k/v/gate/up, row-parallel o/down, ``lm_head`` by
    vocabulary, the embedding and norms replicated. ``axis`` may be a
    tuple of axes: the joint (inter, tp) sharding of a two-tier group."""
    specs: dict = {"embed": P(), "final_norm": P(), "layers": []}
    for _ in range(cfg.num_layers):
        layer = {"attn_norm": P(), "mlp_norm": P(),
                 "attn": tp_attn_specs(cfg, axis)}
        if cfg.is_moe:
            layer["moe"] = {"router": P(), "w_gate": P(None, None, axis),
                            "w_up": P(None, None, axis),
                            "w_down": P(None, axis, None)}
        else:
            layer["mlp"] = tp_mlp_specs(axis)
        specs["layers"].append(layer)
    if not cfg.tie_word_embeddings:
        specs["lm_head"] = P(None, axis)
    return specs


def _logits(params: dict, cfg: ModelConfig, x: torch.Tensor, *,
            axis: str = "tp", n: int = 1, inter_axis: str = "dcn",
            n_inter: int = 1) -> torch.Tensor:
    """Final norm + lm-head; at n·n_inter > 1 the vocabulary-sharded
    logits are gathered to the full vocabulary through the rank group,
    over (inter_axis, axis) when the head is sharded over both tiers
    (tied embeddings are replicated: full vocabulary locally)."""
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    head = params.get("lm_head")
    if head is None:
        return x @ params["embed"].T          # tied embeddings
    local = x @ head
    if n * n_inter == 1:
        return local
    gather_axis = (inter_axis, axis) if n_inter > 1 else axis
    return group_all_gather(local, axis=gather_axis, num_ranks=n * n_inter,
                            dim=1)


def _mlp_or_moe(layer: dict, cfg: ModelConfig, h: torch.Tensor, *,
                axis: str = "tp", n: int = 1, mode: str = "ar",
                inter_axis: str = "dcn", n_inter: int = 1, ar_fn=None,
                gemm_ar_fn=None, dot_fn=None) -> torch.Tensor:
    """FFN block dispatch: the dense SwiGLU MLP (``dot_fn`` replacing its
    products), or the TP-MoE (whose e4m3 stacks pick their lane by type,
    as the reference's). On a TP group the MoE maps the modes as the
    reference does: the row-sharded ``"overlap"`` prefill rides the ring
    pipeline (``"ring"``), the others pass through; ``ar_fn`` (the decode
    walk's parity AllReduce) sums its ``"ar"`` combine. The fused GEMM+AR
    hook is the dense MLP's only: without ``ar_fn`` the combine reduces
    through ``all_reduce_local``."""
    if "moe" in layer:
        p = layer["moe"]
        moe_mode = "ring" if mode == "overlap" and n > 1 else (
            mode if n > 1 else "overlap")
        return moe_tp_fwd_local(h, p["router"], p["w_gate"], p["w_up"],
                                p["w_down"], cfg.num_experts_per_tok,
                                axis=axis, num_ranks=n, mode=moe_mode,
                                ar_fn=ar_fn)
    return tp_mlp_fwd(layer["mlp"], h, axis=axis, num_ranks=n, mode=mode,
                      inter_axis=inter_axis, n_inter=n_inter, ar_fn=ar_fn,
                      gemm_ar_fn=gemm_ar_fn, dot_fn=dot_fn)


def _replicated(mode: str, n: int, what: str) -> None:
    """The decode and verify steps run replicated activations."""
    if n > 1 and mode not in ("ar", "xla_rep"):
        check_mode(mode, what)
        raise ValueError(f"{what}: a decode step runs replicated "
                         f"activations: mode 'ar' or 'xla_rep', got "
                         f"{mode!r} — argument mode")


def dense_prefill(params: dict, cfg: ModelConfig, input_ids: torch.Tensor,
                  cache: KVCache, *, axis: str = "tp", num_ranks: int = 1,
                  mode: str = "overlap", inter_axis: str = "dcn",
                  n_inter: int = 1):
    """Causal prefill of whole prompts. input_ids: (B, S), every rank's
    the same. Returns (last-token logits (B, vocab), cache filled for
    [0, S)). At n > 1 in ``"overlap"`` / ``"xla"`` each rank runs its
    (B·S)/n rows of the flattened prompt — in ``"overlap2d"`` its
    (B·S)/(n·n_inter), global shard inter·n + intra — and the final
    activations are gathered through the group; else the rows run
    replicated."""
    n = num_ranks
    N = n * n_inter
    batch, seq = input_ids.shape
    x = params["embed"][input_ids.reshape(-1).long()]       # (B·S, h)
    row_sharded = (n > 1 and mode in ("overlap", "xla")) or (
        N > 1 and mode == "overlap2d")
    if N > 1:
        check_mode(mode, "dense_prefill")
    two_tier = mode == "overlap2d" and n_inter > 1
    gather_axis = (inter_axis, axis) if two_tier else axis
    if row_sharded:
        shards = N if mode == "overlap2d" else n
        rows = (batch * seq) // shards
        if rows * shards != batch * seq:
            raise ValueError(f"dense_prefill: {batch} x {seq} rows do not "
                             f"divide over {shards} ranks in mode {mode!r}")
        me = axis_index(gather_axis)
        x = x[me * rows:(me + 1) * rows]
    for i, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["attn_norm"], cfg.rms_norm_eps)
        attn_out, _ = tp_attn_prefill(layer["attn"], cfg, h, batch, seq,
                                      cache.layer(i), axis=axis,
                                      num_ranks=n, mode=mode,
                                      inter_axis=inter_axis,
                                      n_inter=n_inter)
        x = x + attn_out
        h = rms_norm(x, layer["mlp_norm"], cfg.rms_norm_eps)
        x = x + _mlp_or_moe(layer, cfg, h, axis=axis, n=n, mode=mode,
                            inter_axis=inter_axis, n_inter=n_inter)
    if row_sharded:
        x = group_all_gather(x, axis=gather_axis)            # (B·S, h)
    last = x.reshape(batch, seq, -1)[:, -1]
    return (_logits(params, cfg, last, axis=axis, n=n, inter_axis=inter_axis,
                    n_inter=n_inter),
            cache._replace(offset=seq))


def dense_prefill_slice(params: dict, cfg: ModelConfig,
                        input_ids: torch.Tensor, cache: KVCache, start: int,
                        *, axis: str = "tp", num_ranks: int = 1,
                        mode: str = "ar"):
    """ONE chunk of causal prefill at host offset ``start`` — the serving
    loop's per-iteration slice. input_ids: (B, C). Returns (x (B·C, h)
    final-layer activations — feed the last REAL row to
    :func:`dense_last_logits` —, cache with K/V written at
    [start, start+C)). Activations run replicated: mode ``"ar"`` or
    ``"xla_rep"`` (anything else raises, as the reference's)."""
    if mode not in ("ar", "xla_rep"):
        raise ValueError(
            f"chunked prefill runs replicated activations: mode must be "
            f"'ar' or 'xla_rep', got {mode!r} — argument mode")
    n = num_ranks
    batch, chunk = input_ids.shape
    x = params["embed"][input_ids.reshape(-1).long()]       # (B·C, h)
    for i, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["attn_norm"], cfg.rms_norm_eps)
        attn_out, _ = tp_attn_prefill_chunk(layer["attn"], cfg, h,
                                            cache.layer(i), start, chunk,
                                            axis=axis, num_ranks=n,
                                            mode=mode)
        x = x + attn_out
        h = rms_norm(x, layer["mlp_norm"], cfg.rms_norm_eps)
        x = x + _mlp_or_moe(layer, cfg, h, axis=axis, n=n, mode=mode)
    return x, cache


def dense_prefill_chunked(params: dict, cfg: ModelConfig,
                          input_ids: torch.Tensor, cache: KVCache, *,
                          chunk: int):
    """Bounded-memory causal prefill: ``chunk`` prompt tokens at a time,
    each chunk attending the cached prefix (:func:`dense_prefill_slice`).
    input_ids: (B, S), S % chunk == 0. Returns (last-token logits
    (B, vocab), cache filled for [0, S))."""
    batch, seq = input_ids.shape
    if seq % chunk:
        raise ValueError(f"prompt length {seq} not a multiple of "
                         f"chunk {chunk} (pad the prompt)")
    for start in range(0, seq, chunk):
        x, cache = dense_prefill_slice(
            params, cfg, input_ids[:, start:start + chunk], cache, start)
    last = x.reshape(batch, chunk, -1)[:, -1]
    return _logits(params, cfg, last), cache._replace(offset=seq)


def dense_last_logits(params: dict, cfg: ModelConfig,
                      x_last: torch.Tensor, *, axis: str = "tp",
                      num_ranks: int = 1) -> torch.Tensor:
    """Final norm + lm-head for last-token activations (B, h); at n > 1
    the logits gathered to the full vocabulary."""
    return _logits(params, cfg, x_last, axis=axis, n=num_ranks)


def make_ar_stream_fn(ar_state, *, axis: str, n: int,
                      force_kernel: bool = False):
    """The barrier-free parity AllReduce hook of a decode walk.
    ``ar_state``: (ws, call_index) from ``ops/allreduce.
    ar_stream_workspace``, threaded through the loop by the caller.
    Returns (ar_fn, final_state_getter): every ``"ar"`` reduction of the
    step goes through the ONE workspace with one call counter — no
    barrier in steady state."""
    from triton_distributed_tpu_torch.ops.allreduce import all_reduce_stream

    state = list(ar_state)

    def ar_fn(y):
        out, ws, idx = all_reduce_stream(y, state[0], state[1], axis=axis,
                                         num_ranks=n,
                                         force_kernel=force_kernel)
        state[0], state[1] = ws, idx
        return out

    return ar_fn, lambda: (state[0], state[1])


def make_gemm_ar_stream_fn(state0, *, axis: str, n: int,
                           force_kernel: bool = False):
    """The fused GEMM+AR hook of a linear decode walk: every ``"ar"``
    row-parallel projection (attention's output, the MLP's down) runs
    ``ops/gemm_allreduce.gemm_ar_stream`` (kernel B11) in place of the
    product and its reduction. ``state0``: (ws, call_index) from
    ``gemm_ar_stream_workspace(n, B, hidden, dtype)`` — one workspace for
    every site (each reduces (B, hidden)). Returns (gemm_ar_fn,
    final_state_getter)."""
    from triton_distributed_tpu_torch.ops.gemm_allreduce import (
        gemm_ar_stream,
    )

    state = list(state0)

    def gemm_ar_fn(x, w):
        out, ws, idx = gemm_ar_stream(x, w, state[0], state[1], axis=axis,
                                      num_ranks=n, force_kernel=force_kernel)
        state[0], state[1] = ws, idx
        return out

    return gemm_ar_fn, lambda: (state[0], state[1])


def _decode_body(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                 attend, *, axis: str = "tp", n: int = 1, mode: str = "ar",
                 inter_axis: str = "dcn", n_inter: int = 1, ar_fn=None,
                 gemm_ar_fn=None, dot_fn=None) -> torch.Tensor:
    """The one-token transformer walk shared by the decode steps;
    ``attend(i, attn_params, h)`` supplies layer i's attention. The FFN
    runs ``mode`` when it is a replicated one, else ``"ar"`` (a one-row
    activation is never row-sharded)."""
    x = params["embed"][tokens.long()]                      # (B, h)
    ffn_mode = mode if mode in ("ar", "xla_rep") else "ar"
    for i, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["attn_norm"], cfg.rms_norm_eps)
        x = x + attend(i, layer["attn"], h)
        h = rms_norm(x, layer["mlp_norm"], cfg.rms_norm_eps)
        x = x + _mlp_or_moe(layer, cfg, h, axis=axis, n=n, mode=ffn_mode,
                            inter_axis=inter_axis, n_inter=n_inter,
                            ar_fn=ar_fn, gemm_ar_fn=gemm_ar_fn,
                            dot_fn=dot_fn)
    return _logits(params, cfg, x, axis=axis, n=n, inter_axis=inter_axis,
                   n_inter=n_inter)


def dense_decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                      cache: KVCache, *, axis: str = "tp",
                      num_ranks: int = 1, mode: str = "ar", ar_state=None,
                      force_ar_kernel: bool = False,
                      fused_gemm_ar: bool = False, dot_fn=None,
                      inter_axis: str = "dcn", n_inter: int = 1):
    """One-token decode over the linear cache at ``cache.offset`` (every
    sequence of the batch at that position). tokens: (B,), every rank's
    the same. ``dot_fn`` replaces every projection / dense-MLP product
    (``fp8_dot`` over a quantized tree). Returns (logits (B, vocab), cache
    with ``offset`` advanced by one); with ``ar_state``, (logits, cache,
    ar_state').

    ``ar_state``: (ws, call_index) of ``ops/allreduce.ar_stream_workspace``
    — every ``"ar"`` reduction of the step rides the barrier-free parity
    AllReduce — or, with ``fused_gemm_ar``, of ``ops/gemm_allreduce.
    gemm_ar_stream_workspace`` — every row-parallel projection runs the
    fused GEMM+AR kernel B11 in place of the product and its reduction.
    ``force_ar_kernel``: run that kernel at n = 1 too (its loopback)."""
    n = num_ranks
    pos = cache.offset
    ar_fn = gemm_ar_fn = final = None
    if ar_state is not None and mode == "ar" and (n > 1 or force_ar_kernel):
        if fused_gemm_ar:
            gemm_ar_fn, final = make_gemm_ar_stream_fn(
                ar_state, axis=axis, n=n, force_kernel=force_ar_kernel)
        else:
            ar_fn, final = make_ar_stream_fn(ar_state, axis=axis, n=n,
                                             force_kernel=force_ar_kernel)

    def attend(i, attn_params, h):
        out, _ = tp_attn_decode(attn_params, cfg, h, cache.layer(i), pos,
                                axis=axis, num_ranks=n, mode=mode,
                                inter_axis=inter_axis, n_inter=n_inter,
                                ar_fn=ar_fn, gemm_ar_fn=gemm_ar_fn,
                                dot_fn=dot_fn)
        return out

    logits = _decode_body(params, cfg, tokens, attend, axis=axis, n=n,
                          mode=mode, inter_axis=inter_axis, n_inter=n_inter,
                          ar_fn=ar_fn, gemm_ar_fn=gemm_ar_fn, dot_fn=dot_fn)
    cache = cache._replace(offset=pos + 1)
    if ar_state is not None:
        return logits, cache, (final() if final is not None else ar_state)
    return logits, cache


def dense_decode_step_paged(params: dict, cfg: ModelConfig,
                            tokens: torch.Tensor, cache: PagedModelCache,
                            *, axis: str = "tp", num_ranks: int = 1,
                            mode: str = "ar", ar_state=None,
                            inter_axis: str = "dcn", n_inter: int = 1):
    """One-token decode over a :class:`PagedModelCache` at per-sequence
    positions. tokens: (B,). Returns (logits (B, vocab), cache with
    ``kv_lens`` advanced by one — clamped at capacity, because a
    saturated sequence's append was dropped); with ``ar_state`` (the
    parity-stream AR at n > 1), (logits, cache, ar_state')."""
    n = num_ranks
    _replicated(mode, n, "dense_decode_step_paged")
    start_lens = cache.kv_lens
    ar_fn = final = None
    if ar_state is not None and mode == "ar" and n > 1:
        ar_fn, final = make_ar_stream_fn(ar_state, axis=axis, n=n)

    def attend(i, attn_params, h):
        # Every layer appends at the same positions: each starts from the
        # step's start lengths; the lengths advance once, below.
        out, _ = tp_attn_decode_paged(attn_params, cfg, h, cache.layer(i),
                                      axis=axis, num_ranks=n, mode=mode,
                                      inter_axis=inter_axis,
                                      n_inter=n_inter, ar_fn=ar_fn)
        return out

    logits = _decode_body(params, cfg, tokens, attend, axis=axis, n=n,
                          mode=mode, inter_axis=inter_axis, n_inter=n_inter,
                          ar_fn=ar_fn)
    new_lens = torch.clamp(start_lens + 1, max=cache.capacity)
    cache = cache._replace(kv_lens=new_lens)
    if ar_state is not None:
        return logits, cache, (final() if final is not None else ar_state)
    return logits, cache


def dense_verify_step_paged(params: dict, cfg: ModelConfig,
                            tokens: torch.Tensor, cache: PagedModelCache,
                            *, axis: str = "tp", num_ranks: int = 1,
                            mode: str = "ar"):
    """Speculative VERIFY decode: score W = k+1 candidate positions per
    sequence in one step. tokens: (B, W) — column 0 each sequence's last
    accepted token, columns 1..k its drafts. Every projection and MLP
    product runs over all B·W rows; attention runs each candidate as its
    own virtual sequence (:func:`tp_attn_verify_paged`), so row i's math
    is the one-token step's at position ``kv_lens + i``. Returns (logits
    (B, W, vocab), cache with all W positions appended and ``kv_lens``
    advanced by W, clamped at capacity); the caller truncates ``kv_lens``
    to the accepted prefix."""
    n = num_ranks
    _replicated(mode, n, "dense_verify_step_paged")
    batch, window = tokens.shape
    start_lens = cache.kv_lens
    x = params["embed"][tokens.reshape(-1).long()]           # (B·W, h)
    for i, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["attn_norm"], cfg.rms_norm_eps)
        out, _ = tp_attn_verify_paged(layer["attn"], cfg, h,
                                      cache.layer(i), window, axis=axis,
                                      num_ranks=n, mode=mode)
        x = x + out
        h = rms_norm(x, layer["mlp_norm"], cfg.rms_norm_eps)
        x = x + _mlp_or_moe(layer, cfg, h, axis=axis, n=n, mode=mode)
    logits = _logits(params, cfg, x, axis=axis, n=n)
    new_lens = torch.clamp(start_lens + window, max=cache.capacity)
    return (logits.reshape(batch, window, -1),
            cache._replace(kv_lens=new_lens.to(torch.int32)))
