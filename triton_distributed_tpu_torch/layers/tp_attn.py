"""Tensor-parallel attention — counterpart of the JAX package's
``layers/tp_attn.py``: column-parallel QKV (heads sharded over the ranks:
hq/n query and hkv/n KV heads a rank), row-parallel output projection.

Projections are ``torch.matmul`` on weights kept in the JAX ``(in, out)``
layout, or a ``dot_fn`` on the decode steps that take one (the fp8 weight
lane's ``fp8_dot``); attention goes through the port's kernels: K1 (flash
prefill, whole prompt or one chunk at a host-int offset) and K2 (paged
decode). The linear-cache decode (:func:`tp_attn_decode`) attends with
:func:`_sdpa`, plain tensor code as the reference's is plain XLA.

At n > 1 (call inside ``DistContext.run``) the modes are those of
``layers/tp_mlp``. In the row-sharded prefill modes the input is (B·S/n,
h): ``"overlap"`` projects q/k/v through the AG+GEMM kernel B9 (the
gather re-materializes the whole sequence, which attention needs) and the
output through the GEMM+RS kernel B10, back to B·S/n rows; ``"xla"`` does
the same through the rank group's plain all-gather and reduce-scatter. In
the replicated modes the output projection's partial sums reduce in
:func:`_out_proj`: ``"ar"`` through the AllReduce kernels, the decode
loop's parity stream (``ar_fn``) or the fused GEMM+AR kernel B11
(``gemm_ar_fn``, which replaces the projection too), ``"xla_rep"``
through the rank group's plain sum. The linear-cache decode
(:func:`tp_attn_decode`) attends over the rank's shard of the KV heads.
On a TP group spanning a second, inter tier (``n_inter`` > 1, heads
sharded over both tiers), ``"overlap2d"`` takes the prefill's rows
sharded over both tiers: q/k/v through ``ops/hierarchical.
ag_gemm_2d_local``, the output through ``gemm_rs_2d_local``; the
replicated modes reduce through the two-tier ``tp_reduce`` (``"ar"``) or
the plain sum over both axes (``"xla_rep"``).

Caches are updated IN PLACE (the port's stand-in for JAX's donated
functional updates): the functions write the new K/V into the cache
tensors they are given and return the same cache objects.
"""

from __future__ import annotations

import math

import torch

from triton_distributed_tpu_torch.layers.common import (
    KVSlice, apply_rope, plain_dot, rms_norm, rope_cos_sin, tp_reduce,
)
from triton_distributed_tpu_torch.layers.tp_mlp import check_mode
from triton_distributed_tpu_torch.models.config import ModelConfig
from triton_distributed_tpu_torch.ops.flash_attention import (
    flash_attention_partial, shard_attention,
)
from triton_distributed_tpu_torch.ops.paged_attention import (
    PagedKVCache, paged_append, paged_append_window, paged_decode_attention,
)
from triton_distributed_tpu_torch.runtime.context import (
    P, group_all_gather, group_psum, group_psum_scatter,
)
from triton_distributed_tpu_torch.runtime.device import resolve_device


def init_tp_attn(cfg: ModelConfig, dtype, *, generator: torch.Generator,
                 device=None) -> dict:
    """Random weights with the JAX package's scales, (in, out) layout, on
    ``device`` (None: the card)."""
    device = resolve_device(device)

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=device) * scale

    h, qs, kvs = cfg.hidden_size, cfg.q_size, cfg.kv_size
    params = {
        "wq": normal((h, qs), h ** -0.5),
        "wk": normal((h, kvs), h ** -0.5),
        "wv": normal((h, kvs), h ** -0.5),
        "wo": normal((qs, h), qs ** -0.5),
    }
    if cfg.qk_norm:
        params["q_norm"] = torch.ones((cfg.head_dim,), dtype=dtype,
                                      device=device)
        params["k_norm"] = torch.ones((cfg.head_dim,), dtype=dtype,
                                      device=device)
    return params


def tp_attn_specs(cfg: ModelConfig, axis: str = "tp") -> dict:
    specs = {"wq": P(None, axis), "wk": P(None, axis), "wv": P(None, axis),
             "wo": P(axis, None)}
    if cfg.qk_norm:
        specs["q_norm"] = P()
        specs["k_norm"] = P()
    return specs


def _project_qkv(params: dict, cfg: ModelConfig, x: torch.Tensor,
                 batch: int, seq: int, dot_fn=None, *, axis: str = "tp",
                 n: int = 1, mode: str = "ar", inter_axis: str = "dcn",
                 n_inter: int = 1):
    """x → q (B,S,hq,d), k/v (B,S,hkv,d) with Qwen3 qk-norm. In the
    row-sharded modes x is (B·S/n, h) — (B·S/(n·n_inter), h) in
    ``"overlap2d"`` — and the projection regathers the whole sequence;
    else x is (B·S, h) and ``dot_fn(x, w)`` replaces each ``x @ w``."""
    d = cfg.head_dim
    ws = (params["wq"], params["wk"], params["wv"])
    if n * n_inter > 1 and mode == "overlap2d":
        from triton_distributed_tpu_torch.ops.hierarchical import (
            ag_gemm_2d_local,
        )

        q, k, v = (ag_gemm_2d_local(x, w, intra_axis=axis,
                                    inter_axis=inter_axis, n_intra=n,
                                    n_inter=n_inter) for w in ws)
    elif n > 1 and mode == "overlap":
        from triton_distributed_tpu_torch.ops.allgather_gemm import (
            ag_gemm_local,
        )

        q, k, v = (ag_gemm_local(x, w, axis=axis, num_ranks=n) for w in ws)
    elif n > 1 and mode == "xla":
        full = group_all_gather(x, axis=axis, num_ranks=n)
        q, k, v = (full @ w for w in ws)
    else:
        dot = dot_fn or plain_dot
        q, k, v = (dot(x, w) for w in ws)
    q = q.reshape(batch, seq, -1, d)
    k = k.reshape(batch, seq, -1, d)
    v = v.reshape(batch, seq, -1, d)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.rms_norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.rms_norm_eps)
    return q, k, v


def _out_proj(attn: torch.Tensor, params: dict, *, axis: str = "tp",
              n: int = 1, mode: str = "ar", inter_axis: str = "dcn",
              n_inter: int = 1, ar_fn=None, gemm_ar_fn=None,
              dot_fn=None) -> torch.Tensor:
    """Row-parallel output projection of replicated rows and its TP
    reduction (the two-tier one at ``n_inter`` > 1). ``ar_fn`` replaces
    the ``"ar"`` reduction (the decode loop's parity-stream AR);
    ``gemm_ar_fn(attn, wo)`` replaces the projection and its reduction
    (the fused GEMM+AR); at n·n_inter = 1 a given hook still runs."""
    dot = dot_fn or plain_dot
    if n * n_inter == 1 or mode == "ar":
        if gemm_ar_fn is not None:
            return gemm_ar_fn(attn, params["wo"])
        y = dot(attn, params["wo"])
        if ar_fn is not None:
            return ar_fn(y)
        return y if n * n_inter == 1 else tp_reduce(
            y, axis=axis, n=n, inter_axis=inter_axis, n_inter=n_inter)
    if mode == "xla_rep":
        return group_psum(dot(attn, params["wo"]),
                          axis=(inter_axis, axis) if n_inter > 1 else axis)
    check_mode(mode, "attention")
    raise ValueError(f"attention: mode {mode!r} runs row-sharded prefill "
                     "activations; this projection takes replicated rows "
                     "('ar' or 'xla_rep') — argument mode")


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
          causal: bool, kv_len: int | None = None) -> torch.Tensor:
    """Grouped-query attention in fp32, plain tensor code (the decode path
    over a padded linear cache). q: (B, Sq, hq, d); k/v: (B, Skv, hkv, d);
    ``kv_len`` masks positions >= kv_len (masked logits are -1e30, as the
    reference's). Returns (B, Sq, hq, d) in q's type."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, sq, hkv, hq // hkv, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) / math.sqrt(d)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = torch.tril(mask, diagonal=skv - sq)
    if kv_len is not None:
        mask = mask & (torch.arange(skv, device=q.device) < kv_len)[None, :]
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, sq, hq, d).to(q.dtype)


def tp_attn_prefill(params: dict, cfg: ModelConfig, x: torch.Tensor,
                    batch: int, seq: int, kv_slice: KVSlice | None = None,
                    *, axis: str = "tp", num_ranks: int = 1,
                    mode: str = "overlap", inter_axis: str = "dcn",
                    n_inter: int = 1):
    """Causal prefill of whole prompts. x: (B·S/n, h) row-sharded in the
    ``"overlap"`` / ``"xla"`` modes at n > 1, (B·S/(n·n_inter), h) in
    ``"overlap2d"``, else (B·S, h). Writes the prompt's K/V (this rank's
    heads) into ``kv_slice`` at [0, S) in place; returns (out, in x's
    layout; the slice — or a fresh KVSlice of the prompt's K/V when none
    is given)."""
    n = num_ranks
    if n * n_inter > 1:
        check_mode(mode, "tp_attn_prefill")
    q, k, v = _project_qkv(params, cfg, x, batch, seq, axis=axis, n=n,
                           mode=mode, inter_axis=inter_axis, n_inter=n_inter)
    cos, sin = rope_cos_sin(torch.arange(seq, device=x.device),
                            cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, cos[None], sin[None])
    k = apply_rope(k, cos[None], sin[None])
    if kv_slice is not None:
        kv_slice.k[:, :seq] = k.to(kv_slice.k.dtype)
        kv_slice.v[:, :seq] = v.to(kv_slice.v.dtype)
        new_kv = kv_slice
    else:
        new_kv = KVSlice(k=k, v=v)
    attn = shard_attention(q, k, v, causal=True)          # K1, normalized
    attn = attn.reshape(batch * seq, -1)
    if n * n_inter > 1 and mode == "overlap2d":
        from triton_distributed_tpu_torch.ops.hierarchical import (
            gemm_rs_2d_local,
        )

        return gemm_rs_2d_local(attn, params["wo"], intra_axis=axis,
                                inter_axis=inter_axis, n_intra=n,
                                n_inter=n_inter), new_kv
    if n > 1 and mode == "overlap":
        from triton_distributed_tpu_torch.ops.gemm_reduce_scatter import (
            gemm_rs_local,
        )

        return gemm_rs_local(attn, params["wo"], axis=axis,
                             num_ranks=n), new_kv
    if n > 1 and mode == "xla":
        return group_psum_scatter(attn @ params["wo"], axis=axis,
                                  num_ranks=n), new_kv
    return _out_proj(attn, params, axis=axis, n=n, mode=mode,
                     inter_axis=inter_axis, n_inter=n_inter), new_kv


def tp_attn_prefill_chunk(params: dict, cfg: ModelConfig, x: torch.Tensor,
                          kv_slice: KVSlice, start: int, chunk_len: int, *,
                          axis: str = "tp", num_ranks: int = 1,
                          mode: str = "ar"):
    """Chunked-prefill attention: the chunk's queries (positions
    [start, start+chunk_len)) attend the cached prefix. ``start`` is a
    host int. Attention runs over the whole capacity of ``kv_slice``;
    positions past the written prefix are hidden by causality and K1 never
    loads their tiles. Writes the chunk's K/V into ``kv_slice`` in place;
    returns (out (B·C, h), kv_slice)."""
    batch = x.shape[0] // chunk_len
    q, k, v = _project_qkv(params, cfg, x, batch, chunk_len)
    pos = start + torch.arange(chunk_len, device=x.device)
    cos, sin = rope_cos_sin(pos, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, cos[None], sin[None])
    k = apply_rope(k, cos[None], sin[None])
    kv_slice.k[:, start:start + chunk_len] = k.to(kv_slice.k.dtype)
    kv_slice.v[:, start:start + chunk_len] = v.to(kv_slice.v.dtype)
    acc, _, l = flash_attention_partial(
        q, kv_slice.k.to(q.dtype), kv_slice.v.to(q.dtype),
        q_offset=start, k_offset=0, causal=True)           # K1, partial
    attn = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    return _out_proj(attn.reshape(batch * chunk_len, -1), params, axis=axis,
                     n=num_ranks, mode=mode), kv_slice


def tp_attn_decode(params: dict, cfg: ModelConfig, x: torch.Tensor,
                   kv_slice: KVSlice, pos: int, *, axis: str = "tp",
                   num_ranks: int = 1, mode: str = "ar",
                   inter_axis: str = "dcn", n_inter: int = 1, ar_fn=None,
                   gemm_ar_fn=None, dot_fn=None):
    """One-token decode over a linear cache at the host position ``pos``
    (every sequence of the batch at the same length). x: (B, h),
    replicated at n > 1, where ``kv_slice`` holds the rank's KV heads.
    Writes this token's K/V at ``pos`` in place (the reference's
    ``dynamic_update_slice``), then attends positions [0, pos] with
    :func:`_sdpa`; ``dot_fn`` replaces the projections, ``ar_fn`` /
    ``gemm_ar_fn`` the output projection's reduction (see
    :func:`_out_proj`). Returns (out (B, h), the slice)."""
    if not 0 <= pos < kv_slice.k.shape[1]:
        raise ValueError(f"decode position {pos} outside the linear cache "
                         f"of {kv_slice.k.shape[1]} positions")
    batch = x.shape[0]
    q, k, v = _project_qkv(params, cfg, x, batch, 1, dot_fn)
    cos, sin = rope_cos_sin(torch.tensor([pos], device=x.device),
                            cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, cos[None], sin[None])
    k = apply_rope(k, cos[None], sin[None])
    kv_slice.k[:, pos:pos + 1] = k.to(kv_slice.k.dtype)
    kv_slice.v[:, pos:pos + 1] = v.to(kv_slice.v.dtype)
    attn = _sdpa(q, kv_slice.k.to(q.dtype), kv_slice.v.to(q.dtype),
                 causal=False, kv_len=pos + 1)
    return _out_proj(attn.reshape(batch, -1), params, axis=axis,
                     n=num_ranks, mode=mode, inter_axis=inter_axis,
                     n_inter=n_inter, ar_fn=ar_fn, gemm_ar_fn=gemm_ar_fn,
                     dot_fn=dot_fn), kv_slice


def tp_attn_decode_paged(params: dict, cfg: ModelConfig, x: torch.Tensor,
                         cache: PagedKVCache, *, axis: str = "tp",
                         num_ranks: int = 1, mode: str = "ar",
                         inter_axis: str = "dcn", n_inter: int = 1,
                         ar_fn=None):
    """One-token decode over a paged cache at per-sequence positions
    (``cache.kv_lens``). Appends this token's K/V to the pools in place
    (through the saturating cast for e4m3 pools), then attends — so the
    current token is read back as stored; returns (out (B, h), cache
    with kv_lens advanced)."""
    batch = x.shape[0]
    q, k, v = _project_qkv(params, cfg, x, batch, 1)
    cos, sin = rope_cos_sin(cache.kv_lens, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, cos[:, None], sin[:, None])
    k = apply_rope(k, cos[:, None], sin[:, None])
    cache = paged_append(cache, k[:, 0], v[:, 0])
    attn = paged_decode_attention(q[:, 0], cache)          # K2
    return _out_proj(attn.reshape(batch, -1).to(x.dtype), params, axis=axis,
                     n=num_ranks, mode=mode, inter_axis=inter_axis,
                     n_inter=n_inter, ar_fn=ar_fn), cache


def tp_attn_verify_paged(params: dict, cfg: ModelConfig, x: torch.Tensor,
                         cache: PagedKVCache, window: int, *,
                         axis: str = "tp", num_ranks: int = 1,
                         mode: str = "ar", ar_fn=None):
    """Speculative VERIFY attention: ``window`` candidate positions per
    sequence in one call. x: (B·window, h), row ``b·window + i`` is
    sequence b's candidate i. All the window's k/v append at
    ``[kv_lens, kv_lens + window)`` first, then each candidate row attends
    as its own virtual sequence — the page table repeated ``window``
    times, lengths ``kv_lens + i + 1`` — so K2 runs over B·window rows
    whose tables repeat, and row i's math is the one-token step's at that
    position. Returns (out (B·window, h), cache advanced by ``window``)."""
    rows = x.shape[0]
    batch = rows // window
    pos = (cache.kv_lens.long()[:, None]
           + torch.arange(window, device=x.device)[None, :]).reshape(-1)
    q, k, v = _project_qkv(params, cfg, x, rows, 1)
    cos, sin = rope_cos_sin(pos, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, cos[:, None], sin[:, None])
    k = apply_rope(k, cos[:, None], sin[:, None])
    hkv, d = k.shape[2], k.shape[3]
    cache = paged_append_window(cache, k[:, 0].reshape(batch, window, hkv, d),
                                v[:, 0].reshape(batch, window, hkv, d))
    capacity = cache.page_table.shape[1] * cache.page_size
    virtual = PagedKVCache(
        cache.k_pool, cache.v_pool,
        torch.repeat_interleave(cache.page_table, window, dim=0),
        torch.clamp(pos + 1, max=capacity).to(torch.int32))
    attn = paged_decode_attention(q[:, 0], virtual)          # K2
    return _out_proj(attn.reshape(rows, -1).to(x.dtype), params, axis=axis,
                     n=num_ranks, mode=mode, ar_fn=ar_fn), cache
