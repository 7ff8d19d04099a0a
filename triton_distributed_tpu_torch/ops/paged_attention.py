"""Paged-KV decode attention — kernel K2 and its plain PyTorch version.

Counterpart of the JAX package's ``ops/paged_attention.py``. The TPU
kernel there (``_paged_decode_kernel``: a (batch, page) grid whose page
DMAs are addressed from a scalar-prefetched page table, with the online
softmax carried across a sequence's page steps in VMEM) becomes the
hand-written CUDA kernel ``csrc/paged_attention.cu``: one block per
(sequence, KV head), so the ``g`` query heads sharing a KV head load each
page once; the block reads its own page-table row and walks only pages
``j < ceil(kv_len / page)`` — table entries past them (-1, or the serving
loop's scratch page) are never read.

``kv_len = 0`` (an empty decode slot) gives zeros with ``m = -1e30`` and
``l = 0``, never NaN. Pools are float32, bfloat16 (the dtype of q) or
e4m3 (``init_paged_kv_cache(kv_dtype=torch.float8_e4m3fn)``): K2 reads an
e4m3 page at half the bytes and widens it to fp32 inside the softmax, as
the TPU kernel does, so the kernel and the plain version read the same
stored values (quantize-then-attend).

:func:`paged_append` and :func:`paged_append_window` stay plain tensor
code (XLA scatters in the JAX package). They update the pools IN PLACE —
the port's stand-in for JAX's donated functional update —, cast through
the saturating ``models/fp8.saturate_cast``, and return the cache with
``kv_lens`` advanced. Writes past a sequence's capacity are dropped,
never clamped.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from triton_distributed_tpu_torch.models.fp8 import E4M3, saturate_cast
from triton_distributed_tpu_torch.runtime.build import (
    CudaKernel, current_stream, ptr,
)
from triton_distributed_tpu_torch.runtime.device import resolve_device

_NEG = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_POOL_CODE = {torch.float32: 0, torch.bfloat16: 1, E4M3: 2}
_HEAD_DIMS = (64, 128)

PAGED_KERNEL = CudaKernel(
    "paged_attention.cu", "paged_decode_fwd",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p])


class PagedKVCache(NamedTuple):
    """A paged KV pool + per-sequence page tables.

    k_pool/v_pool: (num_pages, page, hkv, d); page_table: (B, max_pages)
    int32 (pool page id per logical page); kv_lens: (B,) int32 valid
    tokens."""

    k_pool: torch.Tensor
    v_pool: torch.Tensor
    page_table: torch.Tensor
    kv_lens: torch.Tensor

    @property
    def page_size(self) -> int:
        return self.k_pool.shape[1]


def init_paged_kv_cache(batch: int, *, num_pages: int, page_size: int,
                        num_kv_heads: int, head_dim: int, max_pages: int,
                        dtype=torch.float32, kv_dtype=None,
                        device=None) -> PagedKVCache:
    """Zeroed pool + identity page tables (sequence b owns pages
    ``[b*max_pages, (b+1)*max_pages) % num_pages``) on ``device`` (None:
    the card). ``kv_dtype`` overrides the pools' storage type
    (``torch.float8_e4m3fn``: half the page bytes of bf16); tables and
    lengths stay int32."""
    device = resolve_device(device)
    if kv_dtype is not None:
        dtype = kv_dtype
    shape = (num_pages, page_size, num_kv_heads, head_dim)
    table = (torch.arange(batch * max_pages, dtype=torch.int32,
                          device=device).reshape(batch, max_pages)
             % num_pages)
    return PagedKVCache(torch.zeros(shape, dtype=dtype, device=device),
                        torch.zeros(shape, dtype=dtype, device=device),
                        table,
                        torch.zeros((batch,), dtype=torch.int32,
                                    device=device))


def paged_append(cache: PagedKVCache, k_new: torch.Tensor,
                 v_new: torch.Tensor) -> PagedKVCache:
    """Write one token's k/v per sequence (k_new/v_new: (B, hkv, d)) at
    each sequence's current length, in place; returns the cache with
    ``kv_lens`` advanced.

    A sequence at capacity (``kv_lens == max_pages * page``) is saturated:
    its write is dropped (the stored value is written back) and its length
    stays. Duplicate targets — the serving loop's empty slots all point at
    one scratch page with ``kv_lens = 0`` — are harmless: the slots' values
    are discarded and the scatter takes them in any order."""
    P = cache.page_size
    b = k_new.shape[0]
    capacity = cache.page_table.shape[1] * P
    pos = cache.kv_lens.long()
    ok = pos < capacity
    safe_pos = torch.clamp(pos, max=capacity - 1)
    rows_b = torch.arange(b, device=pos.device)
    page_idx = cache.page_table[rows_b, safe_pos // P].long()
    row = safe_pos % P

    def scatter(pool, new):
        cur = pool[page_idx, row]
        pool[page_idx, row] = torch.where(ok[:, None, None],
                                          saturate_cast(new, pool.dtype), cur)

    scatter(cache.k_pool, k_new)
    scatter(cache.v_pool, v_new)
    return cache._replace(kv_lens=cache.kv_lens + ok.to(torch.int32))


def paged_append_window(cache: PagedKVCache, k_new: torch.Tensor,
                        v_new: torch.Tensor) -> PagedKVCache:
    """Write a window of W tokens' k/v per sequence (k_new/v_new: (B, W,
    hkv, d)) at positions ``[kv_lens, kv_lens + W)``, in place — the
    speculative verify step's append; returns the cache with ``kv_lens``
    advanced by the rows written.

    A row past capacity is DROPPED: it is masked out of the scatter. A
    clamped index would alias the last in-capacity position of the same
    scatter and could overwrite a real candidate's k/v (torch's
    ``index_put`` has no ``mode="drop"``). Stored values equal W
    sequential :func:`paged_append` calls."""
    P = cache.page_size
    b, w = k_new.shape[0], k_new.shape[1]
    capacity = cache.page_table.shape[1] * P
    pos = (cache.kv_lens.long()[:, None]
           + torch.arange(w, device=k_new.device)[None, :])      # (B, W)
    ok = pos < capacity
    rows_b = torch.arange(b, device=pos.device)[:, None].expand(b, w)[ok]
    pos_ok = pos[ok]
    page_idx = cache.page_table[rows_b, pos_ok // P].long()
    row = pos_ok % P
    cache.k_pool[page_idx, row] = saturate_cast(k_new[ok], cache.k_pool.dtype)
    cache.v_pool[page_idx, row] = saturate_cast(v_new[ok], cache.v_pool.dtype)
    return cache._replace(
        kv_lens=cache.kv_lens + ok.sum(dim=1).to(torch.int32))


# ---------------------------------------------------------------------------
# Plain version of K2.
# ---------------------------------------------------------------------------

def _paged_decode_plain(q: torch.Tensor, cache: PagedKVCache, *,
                        normalize: bool):
    """K2's function in plain tensor code: gather each sequence's pages
    (widened to fp32 as stored, e4m3 included), mask positions
    ``>= kv_len`` to -1e30, fp32 softmax statistics and PV.
    Returns (out, m, l); ``out`` is ``q.dtype`` when ``normalize`` else
    fp32 (B, hq, d)."""
    PAGED_KERNEL.count_plain()
    b, hq, d = q.shape
    _, page, hkv, _ = cache.k_pool.shape
    g = hq // hkv
    max_pages = cache.page_table.shape[1]
    lens = cache.kv_lens.long()
    n_tok = max_pages * page
    pos = torch.arange(n_tok, device=q.device)
    valid = pos[None, :] < lens[:, None]                       # (B, T)
    # Entries past the valid pages may be -1 or stale: read page 0 there;
    # those positions are masked below.
    n_valid_pages = (lens + page - 1) // page
    live = (torch.arange(max_pages, device=q.device)[None, :]
            < n_valid_pages[:, None])
    table = torch.where(live, cache.page_table.long(), 0)
    k = cache.k_pool[table].reshape(b, n_tok, hkv, d).float()
    v = cache.v_pool[table].reshape(b, n_tok, hkv, d).float()
    v = torch.where(valid[:, :, None, None], v, 0.0)
    qf = q.float().reshape(b, hkv, g, d)
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k) * (d ** -0.5)
    s = torch.where(valid[:, None, None, :], s, _NEG)
    m = torch.clamp(torch.amax(s, dim=-1), min=_NEG)
    p = torch.where(valid[:, None, None, :], torch.exp(s - m[..., None]),
                    0.0)
    l = torch.sum(p, dim=-1)
    acc = torch.einsum("bhgk,bkhd->bhgd", p, v).reshape(b, hq, d)
    m = m.reshape(b, hq)
    l = l.reshape(b, hq)
    if normalize:
        return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype), m, l
    return acc, m, l


# ---------------------------------------------------------------------------
# K2 launch.
# ---------------------------------------------------------------------------

def _check_cuda_inputs(q, cache: PagedKVCache) -> None:
    kp, vp, table, lens = cache
    for name, t in (("k_pool", kp), ("v_pool", vp), ("page_table", table),
                    ("kv_lens", lens)):
        if t.device != q.device:
            raise ValueError(f"paged decode: {name} on {t.device}, q on "
                             f"{q.device}")
    for name, t in (("q", q), ("k_pool", kp), ("v_pool", vp),
                    ("page_table", table), ("kv_lens", lens)):
        if not t.is_contiguous():
            raise ValueError(f"paged decode: {name} must be contiguous")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"paged decode: dtype {q.dtype} unsupported (K2 "
                         "takes float32 or bfloat16 queries)")
    if vp.dtype != kp.dtype or kp.dtype not in (q.dtype, E4M3):
        raise ValueError(f"paged decode: pools are {kp.dtype}/{vp.dtype}, q "
                         f"is {q.dtype} — K2 takes pools of q's dtype or "
                         "both float8_e4m3fn")
    if kp.data_ptr() % 16 or vp.data_ptr() % 16:
        raise ValueError("paged decode: pools must be 16-byte aligned (K2 "
                         "reads them in 16-byte chunks)")
    if table.dtype != torch.int32 or lens.dtype != torch.int32:
        raise ValueError("paged decode: page_table and kv_lens must be int32")
    if q.dim() != 3 or kp.dim() != 4 or kp.shape != vp.shape:
        raise ValueError(f"paged decode: q {tuple(q.shape)} must be (B, hq, "
                         f"d) and pools (P, page, hkv, d), got "
                         f"{tuple(kp.shape)}/{tuple(vp.shape)}")
    b, hq, d = q.shape
    if kp.shape[3] != d or d not in _HEAD_DIMS:
        raise ValueError(f"paged decode: head_dim {d} vs pool {kp.shape[3]} "
                         f"(K2 is built for {_HEAD_DIMS})")
    if hq % kp.shape[2]:
        raise ValueError(f"paged decode: {hq} query heads not a multiple of "
                         f"{kp.shape[2]} kv heads")
    if table.dim() != 2 or table.shape[0] != b or tuple(lens.shape) != (b,):
        raise ValueError(f"paged decode: table {tuple(table.shape)} / lens "
                         f"{tuple(lens.shape)} do not match batch {b}")


def _paged_decode_cuda(q: torch.Tensor, cache: PagedKVCache, *,
                       normalize: bool):
    _check_cuda_inputs(q, cache)
    b, hq, d = q.shape
    _, page, hkv, _ = cache.k_pool.shape
    out = torch.empty(q.shape, dtype=q.dtype if normalize else torch.float32,
                      device=q.device)
    m = l = None
    if not normalize:
        m = torch.empty((b, hq), dtype=torch.float32, device=q.device)
        l = torch.empty((b, hq), dtype=torch.float32, device=q.device)
    PAGED_KERNEL.launch(
        ptr(q), ptr(cache.k_pool), ptr(cache.v_pool), ptr(cache.page_table),
        ptr(cache.kv_lens), ptr(out), ptr(m), ptr(l),
        b, hq, hkv, d, page, cache.page_table.shape[1], int(normalize),
        _DTYPE_CODE[q.dtype], _POOL_CODE[cache.k_pool.dtype],
        current_stream(q.device),
        variants=("e4m3",) if cache.k_pool.dtype == E4M3 else ())
    return out, m, l


def paged_decode_attention(q: torch.Tensor, cache: PagedKVCache, *,
                           normalize: bool = True):
    """One-token GQA decode over the paged cache. q: (B, hq, d) →
    (B, hq, d) in ``q.dtype``; with ``normalize=False`` the split-KV
    partial (acc (B,hq,d) fp32, m (B,hq), l (B,hq)). K2 on a CUDA tensor,
    its plain version on a CPU tensor."""
    if q.device.type == "cuda":
        out, m, l = _paged_decode_cuda(q, cache, normalize=normalize)
    elif q.device.type == "cpu":
        out, m, l = _paged_decode_plain(q, cache, normalize=normalize)
    else:
        raise ValueError(f"paged decode: no kernel for device {q.device}")
    return out if normalize else (out, m, l)


def paged_decode_attention_golden(q: torch.Tensor,
                                  cache: PagedKVCache) -> np.ndarray:
    """Float64 numpy reference, reading the pools as stored."""
    qn = q.detach().double().cpu().numpy()
    kp = cache.k_pool.detach().double().cpu().numpy()
    vp = cache.v_pool.detach().double().cpu().numpy()
    table = cache.page_table.cpu().numpy()
    lens = cache.kv_lens.cpu().numpy()
    b, hq, d = qn.shape
    page = cache.page_size
    hkv = kp.shape[2]
    g = hq // hkv
    out = np.zeros_like(qn)
    for i in range(b):
        n_tok = int(lens[i])
        if n_tok == 0:
            continue
        pages = table[i][: -(-n_tok // page)]
        k = kp[pages].reshape(-1, hkv, d)[:n_tok]
        v = vp[pages].reshape(-1, hkv, d)[:n_tok]
        kg = np.repeat(k, g, axis=1)
        vg = np.repeat(v, g, axis=1)
        s = np.einsum("hd,khd->hk", qn[i], kg) / np.sqrt(d)
        p = np.exp(s - s.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        out[i] = np.einsum("hk,khd->hd", p, vg)
    return out
