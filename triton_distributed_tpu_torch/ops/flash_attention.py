"""Flash-attention prefill — kernel K1 and its plain PyTorch version.

Counterpart of the JAX package's ``ops/flash_attention.py``. The TPU
kernel there (``_flash_kernel``, a Pallas grid over (B, hq, q-tiles,
k-tiles) with VMEM-carried online-softmax state) becomes the hand-written
CUDA kernel ``csrc/flash_attention.cu``, in two lanes picked by dtype:
bf16 runs on ``wgmma`` + TMA (a persistent block an SM walks work tiles
of 128 queries of one head and batch; a producer warp streams 128-key K/V
tiles through a two-stage shared-memory ring, two consumer warpgroups run
the products), fp32 on fp32 FMA (the tensor cores would take it only as
TF32).
:func:`flash_launch_plan` holds the launch geometry of both. The VMEM
tile ladder, compile probe and tile autotuner of the TPU version have no
meaning here and are not ported; nor is the dense fallback, which existed
because of VMEM limits — on a CUDA tensor the wrappers below launch K1
or raise.

Contracts kept from the TPU kernel (the tests pin each):

- causality is positional: query row i sits at ``q_offset + i``, key row
  j at ``k_offset + j``, and ``q_pos >= k_pos`` is visible; key tiles past
  the causal frontier are never loaded (chunked prefill attends the whole
  capacity of its buffer, and the unwritten tail costs nothing);
- QK runs in fp32; ``p`` is rounded to V's dtype before the PV product
  (in bf16 that rounding point sets how close kernel and plain agree);
- a fully masked row leaves ``m = -1e30`` and ``l = 0``; the normalized
  output divides by ``max(l, 1e-30)``, so such a row is 0, never NaN.
  (The dense :func:`_block_attn` reports ``m = 0`` there instead;
  :func:`_merge` keys on ``l <= 0`` and takes both.)

Offsets are host ints: the serving loop knows each slice start in
Python, so passing it costs no device sync.
"""

from __future__ import annotations

import ctypes
import math

import torch

from triton_distributed_tpu_torch.runtime.build import (
    CudaKernel, current_stream, ptr,
)

_NEG = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)

FLASH_KERNEL = CudaKernel(
    "flash_attention.cu", "flash_attention_fwd",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 13 + [ctypes.c_void_p])

# The lanes' tiles, as csrc/flash_attention.cu compiles them.
_WG_TQ = _WG_TK = 128   # bf16: query rows a work tile, keys a K/V tile
_WG_STAGES = 2          # bf16: K/V ring depth
_WG_THREADS = 384       # two consumer warpgroups and a producer
_FMA_BQ, _FMA_BK, _FMA_THREADS = 64, 32, 256
H100_SMS = 132


# ---------------------------------------------------------------------------
# Dense golden + online-LSE merge (kept beside the kernel, as in the JAX
# package).
# ---------------------------------------------------------------------------

def _block_attn(q, k, v, mask):
    """Unnormalized dense attention with running-max stats.

    q: (B, Sq, hq, d); k/v: (B, Sk, hkv, d); mask: (Sq, Sk) bool or None.
    Returns (acc (B,Sq,hq,d) fp32, m (B,Sq,hq), l (B,Sq,hq)); a fully
    masked row reports m = 0, l = 0."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.float().reshape(b, sq, hkv, g, d)
    logits = torch.einsum("bqhgd,bkhd->bqhgk", qf, k.float()) / math.sqrt(d)
    if mask is not None:
        logits = torch.where(mask[None, :, None, None, :], logits,
                             float("-inf"))
    m = torch.amax(logits, dim=-1)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(logits - m_safe[..., None])
    if mask is not None:
        p = torch.where(mask[None, :, None, None, :], p, 0.0)
    l = torch.sum(p, dim=-1)
    acc = torch.einsum("bqhgk,bkhd->bqhgd", p, v.float())
    return (acc.reshape(b, sq, hq, d), m_safe.reshape(b, sq, hq),
            l.reshape(b, sq, hq))


def _merge(state, update):
    """Online LSE merge of two (acc, m, l) partials; a partial with
    ``l <= 0`` is dead whatever its ``m``."""
    acc0, m0, l0 = state
    acc1, m1, l1 = update
    dead0, dead1 = l0 <= 0, l1 <= 0
    m_new = torch.where(dead0, m1,
                        torch.where(dead1, m0, torch.maximum(m0, m1)))
    s0 = torch.where(dead0, 0.0, torch.exp(m0 - m_new))
    s1 = torch.where(dead1, 0.0, torch.exp(m1 - m_new))
    return (acc0 * s0[..., None] + acc1 * s1[..., None],
            m_new, l0 * s0 + l1 * s1)


# ---------------------------------------------------------------------------
# Plain version of K1 (the same arithmetic, one pass instead of online).
# ---------------------------------------------------------------------------

def _flash_plain(q, k, v, q_offset: int, k_offset: int, *, causal: bool,
                 normalize: bool):
    """K1's function in plain tensor code: fp32 QK, positional causal
    mask to -1e30, ``p`` rounded to V's dtype before PV, fp32 (acc, m, l).
    Returns (out, m, l) in the public (B, S, h, ...) layout; ``out`` is
    ``q.dtype`` when ``normalize`` else fp32."""
    FLASH_KERNEL.count_plain()
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.float().reshape(b, sq, hkv, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * (d ** -0.5)
    if causal:
        qpos = q_offset + torch.arange(sq, device=q.device)
        kpos = k_offset + torch.arange(sk, device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        s = torch.where(mask, s, _NEG)
    m = torch.clamp(torch.amax(s, dim=-1), min=_NEG)
    p = torch.exp(s - m[..., None])
    if causal:
        p = torch.where(mask, p, 0.0)
    l = torch.sum(p, dim=-1)
    acc = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    acc = acc.reshape(b, sq, hq, d)
    m = m.permute(0, 3, 1, 2).reshape(b, sq, hq)
    l = l.permute(0, 3, 1, 2).reshape(b, sq, hq)
    if normalize:
        return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype), m, l
    return acc, m, l


# ---------------------------------------------------------------------------
# K1 launch.
# ---------------------------------------------------------------------------

def key_frontier(sq: int, sk: int, q_offset: int, k_offset: int, *,
                 causal: bool) -> int:
    """Keys any query of the call can see: ``min(Sk, q_offset + Sq -
    k_offset)`` when causal (<= 0 when every row is hidden), else Sk."""
    return min(sk, q_offset + sq - k_offset) if causal else sk


def _lane(dtype) -> str:
    if dtype == torch.bfloat16:
        return "wgmma"
    if dtype == torch.float32:
        return "fma"
    raise ValueError(f"flash attention: dtype {dtype} unsupported (K1 "
                     "takes float32 or bfloat16)")


def _smem_bytes(lane: str, d: int) -> int:
    if lane == "wgmma":
        # 1024 to align the tiles to the swizzle's period, Q and the K/V
        # stages of 128 rows, the mbarriers.
        return 1024 + (1 + 2 * _WG_STAGES) * _WG_TQ * d * 2 + 128
    return 4 * (_FMA_BQ * (d + 1) + _FMA_BK * (d + 1) + _FMA_BK * d
                + _FMA_BQ * (_FMA_BK + 1))


def wgmma_schedule(grid: int, total: int) -> list:
    """The bf16 lane's persistent blocks' work tiles, as the kernel's
    ``tile_of`` walks them: round r takes tiles [r G, r G + G) forwards on
    even rounds and backwards on odd ones. Work tile w is query head
    w % hq of query-tile row w // hq (longest causal rows first)."""
    blocks = [[] for _ in range(grid)]
    for r in range(-(-total // grid)):
        for c in range(grid):
            w = r * grid + (grid - 1 - c if r & 1 else c)
            if w < total:
                blocks[c].append(w)
    return blocks


def flash_launch_plan(b: int, sq: int, sk: int, hq: int, d: int,
                      q_offset: int, k_offset: int, *, causal: bool,
                      dtype, num_sms: int = H100_SMS) -> dict:
    """K1's launch geometry, as ``csrc/flash_attention.cu`` computes it.

    ``lane`` ("wgmma" for bf16, "fma" for fp32), ``grid`` (x, y, z: on the
    bf16 lane one persistent block an SM, at most one a work tile),
    ``threads``, ``work_tiles`` (query tiles x heads x batch),
    ``key_frontier`` (the K/V tensor maps' row extent on the bf16 lane),
    ``key_tile`` (keys a tile), ``key_tiles`` (tiles each query tile
    loads, in query-tile order: never past the frontier of its last row)
    and ``smem_bytes`` (dynamic shared memory a block; the C entry refuses
    a plan whose number differs from its own)."""
    lane = _lane(dtype)
    frontier = key_frontier(sq, sk, q_offset, k_offset, causal=causal)
    tq, tk = (_WG_TQ, _WG_TK) if lane == "wgmma" else (_FMA_BQ, _FMA_BK)
    n_qt = -(-sq // tq)
    tiles = []
    for qt in range(n_qt):
        rows = min(tq, sq - qt * tq)
        n = -(-sk // tk)
        if causal:
            last = q_offset + qt * tq + rows - 1 - k_offset
            n = 0 if last < 0 or frontier <= 0 else min(
                -(-frontier // tk), last // tk + 1)
        tiles.append(n)
    work = n_qt * hq * b
    if lane == "wgmma":
        grid, threads = (min(num_sms, work), 1, 1), _WG_THREADS
    else:
        grid, threads = (n_qt, hq, b), _FMA_THREADS
    return {"lane": lane, "grid": grid, "threads": threads,
            "work_tiles": work, "key_frontier": frontier, "key_tile": tk,
            "key_tiles": tuple(tiles), "smem_bytes": _smem_bytes(lane, d)}


def _check_cuda_inputs(q, k, v) -> None:
    """Refuse what K1 does not take, by name: other devices or dtypes
    among q, k, v, a head_dim other than 64 / 128, and on the bf16 lane
    what TMA refuses (a base pointer not 16-byte aligned, a row stride not
    a multiple of 16 bytes)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash attention: {name} on {t.device}, q on "
                             f"{q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"flash attention: {name} is {t.dtype}, q is "
                             f"{q.dtype} — K1 takes one dtype")
        if t.dim() != 4:
            raise ValueError(f"flash attention: {name} must be (B, S, h, d),"
                             f" got shape {tuple(t.shape)}")
        if t.dtype == torch.bfloat16:
            if t.data_ptr() % 16:
                raise ValueError(f"flash attention: {name}'s base pointer is "
                                 "not 16-byte aligned (TMA refuses it)")
            row = t.stride(1) * t.element_size()
            if row % 16:
                raise ValueError(f"flash attention: {name}'s row stride "
                                 f"{row} bytes is not a multiple of 16 (TMA "
                                 "refuses it)")
        if not t.is_contiguous():
            raise ValueError(f"flash attention: {name} must be contiguous")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash attention: dtype {q.dtype} unsupported "
                         "(K1 takes float32 or bfloat16)")
    b, sq, hq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash attention: head_dim {d} unsupported (K1 is "
                         f"built for {_HEAD_DIMS})")
    if hq % k.shape[2]:
        raise ValueError(f"flash attention: {hq} query heads not a multiple "
                         f"of {k.shape[2]} kv heads")
    if sq < 1 or k.shape[1] < 1:
        raise ValueError("flash attention: empty query or key sequence")


def _flash_cuda(q, k, v, q_offset: int, k_offset: int, *, causal: bool,
                normalize: bool):
    _check_cuda_inputs(q, k, v)
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    lane = _lane(q.dtype)
    frontier = key_frontier(sq, sk, int(q_offset), int(k_offset),
                            causal=causal)
    out = torch.empty(q.shape, dtype=q.dtype if normalize else torch.float32,
                      device=q.device)
    m = l = None
    if not normalize:
        m = torch.empty((b, sq, hq), dtype=torch.float32, device=q.device)
        l = torch.empty((b, sq, hq), dtype=torch.float32, device=q.device)
    FLASH_KERNEL.launch(
        ptr(q), ptr(k), ptr(v), ptr(out), ptr(m), ptr(l),
        b, sq, sk, hq, hkv, d, int(q_offset), int(k_offset), int(causal),
        int(normalize), _DTYPE_CODE[q.dtype], frontier, _smem_bytes(lane, d),
        current_stream(q.device), variants=(lane,))
    return out, m, l


def _flash_call(q, k, v, q_offset, k_offset, *, causal: bool,
                normalize: bool):
    """K1 on a CUDA tensor, its plain version on a CPU tensor."""
    if q.device.type == "cuda":
        return _flash_cuda(q, k, v, q_offset, k_offset, causal=causal,
                           normalize=normalize)
    if q.device.type == "cpu":
        return _flash_plain(q, k, v, q_offset, k_offset, causal=causal,
                            normalize=normalize)
    raise ValueError(f"flash attention: no kernel for device {q.device}")


def flash_attention_partial(q, k, v, *, q_offset: int = 0,
                            k_offset: int = 0, causal: bool = True):
    """Blockwise flash attention returning UNnormalized partials.

    q: (B, Sq, hq, d); k/v: (B, Sk, hkv, d). Returns (acc (B,Sq,hq,d)
    fp32, m (B,Sq,hq), l (B,Sq,hq)) — the :func:`_merge` contract. A row
    hidden entirely by causality returns l = 0, m = -1e30."""
    return _flash_call(q, k, v, q_offset, k_offset, causal=causal,
                       normalize=False)


def flash_attention(q, k, v, *, q_offset: int = 0, k_offset: int = 0,
                    causal: bool = True):
    """Normalized flash attention: (B, Sq, hq, d) out in ``q.dtype``."""
    out, _, _ = _flash_call(q, k, v, q_offset, k_offset, causal=causal,
                            normalize=True)
    return out


def shard_attention_partial(q, k, v, *, q_offset: int = 0,
                            k_offset: int = 0, causal: bool = True):
    """Partial attention over one KV shard — K1 always (the JAX package's
    dense fallback for shapes VMEM could not hold has no GPU reason)."""
    return flash_attention_partial(q, k, v, q_offset=q_offset,
                                   k_offset=k_offset, causal=causal)


def shard_attention(q, k, v, *, causal: bool = True):
    """Normalized single-shard attention — K1 always."""
    return flash_attention(q, k, v, causal=causal)
