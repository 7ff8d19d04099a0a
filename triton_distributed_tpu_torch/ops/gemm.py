"""Tiled GEMM — kernel B3 and its plain PyTorch version.

Counterpart of the JAX package's ``ops/gemm.py``. The TPU kernel there
(``_grid_matmul_kernel``: a (m, n, k) grid whose sequential k axis carries
the fp32 sum in VMEM scratch) becomes the hand-written CUDA kernel
``csrc/gemm.cu``, on four routes (``GemmTile.route``): ``"wgmma"`` (bf16
and e4m3 at M >= ``TALL_ROWS``, aligned operands: the TMA + wgmma
mainloop, a persistent grid over every SM), ``"splitk"`` (bf16 and e4m3
at M <= ``SPLITK_ROWS``, aligned: B streamed over every SM, K split over a
cluster's CTAs and summed in one fixed order), ``"mma"`` (the mma.sync
tiles: every other tensor-core case, an unaligned operand, the mixed
lane) and ``"fma"`` (fp32 A).

:func:`pallas_matmul` keeps the reference's contract: ``out = a @ b``
accumulated in fp32; ``out_dtype`` defaults to ``a.dtype``; a B narrower
than A is upcast to A's type after the load (the mixed lane: bf16 x e4m3
streams the weight at one byte); a B as wide as A or wider, in another
type, raises; e4m3 operands are first-class, and an e4m3 store saturates
to ±448 (the reference's ``astype`` gives NaN there on the CPU; the port
keeps the saturation the reference's fp8 casts promise). The lanes and
output types the kernel compiles:

============================  =====================
A x B                         out
============================  =====================
fp32 x {fp32, bf16, e4m3}     fp32 (FMA, never TF32)
bf16 x {bf16, e4m3}           bf16, fp32
e4m3 x e4m3                   e4m3, bf16, fp32
============================  =====================

Anything else is refused by name on every device, so a CPU run never
accepts what the card would not.

``tile_m`` / ``tile_n`` / ``tile_k`` are caps, as ``pick_tile`` makes them
in the reference: the kernel runs a compiled tile not above them
(:func:`lane_tiles`); :func:`select_tile` takes the split-K tile at M <= 16,
a wgmma tile at tall M (the one whose last wave of pair tiles wastes
least, ``perf_model.WGMMA_TILE_TIME``), and otherwise an mma.sync tile no
taller than M rounded up to 16 that gives every SM a block. Operands whose
base or row is not a whole number of 16-byte units take the mma.sync
route (a route choice, counted as such). The kernel masks ragged edges,
so no dimension needs to divide a tile. A cap below every compiled tile
raises :class:`GemmConfigError`.

On a CUDA tensor the wrapper launches B3 (counted in
``GEMM_KERNEL.launches``, and in ``variant_launches`` per lane — ``"fp32"``,
``"bf16"``, ``"mixed"``, ``"e4m3"`` — and per route); on a CPU tensor it
runs :func:`matmul_plain`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from triton_distributed_tpu_torch.models.fp8 import E4M3, saturate_cast
from triton_distributed_tpu_torch.runtime.build import (
    CudaKernel, current_stream, ptr,
)
from triton_distributed_tpu_torch.runtime.perf_model import chip_spec

GEMM_KERNEL = CudaKernel(
    "gemm.cu", "gemm_run",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 + [ctypes.c_void_p])

_F32, _BF16 = torch.float32, torch.bfloat16
_TYPE_CODE = {_F32: 0, _BF16: 1, E4M3: 2}
_LANES = {(_F32, _F32): "fp32", (_F32, _BF16): "fp32", (_F32, E4M3): "fp32",
          (_BF16, _BF16): "bf16", (_BF16, E4M3): "mixed",
          (E4M3, E4M3): "e4m3"}
LANE_OUT = {"fp32": (_F32,), "bf16": (_BF16, _F32), "mixed": (_BF16, _F32),
            "e4m3": (E4M3, _BF16, _F32)}


class GemmConfigError(ValueError):
    """A lane, output type or tile cap the kernel does not compile."""


@dataclasses.dataclass(frozen=True)
class GemmTile:
    """One compiled tile of a lane: ``index`` is its slot in
    ``csrc/gemm.cu``'s ``run_tc`` / ``run_fma``; ``smem_bytes`` the shared
    memory a block uses (the formulas of ``TcCfg`` / ``FmaCfg``, the wgmma
    ring's ``wg::SMEM_BYTES``, the split-K ``SK_SMEM``); ``route`` the
    kernel it runs on (``ROUTES``)."""

    index: int
    tile_m: int
    tile_n: int
    tile_k: int
    smem_bytes: int
    route: str = "mma"

    @property
    def tiles(self) -> tuple[int, int, int]:
        return (self.tile_m, self.tile_n, self.tile_k)


ROUTES = ("wgmma", "splitk", "mma", "fma")
# Rows from which the wgmma route runs (B9's SHORT_TILE_ROWS; below it a
# 128-row tile computes mostly padding), and up to which split-K does.
TALL_ROWS = 64
SPLITK_ROWS = 16
# (BM, BN, BK of the bf16 lane, warps WM x WN x WK) — csrc/gemm.cu run_tc.
_TC = ((128, 128, 32, 2, 4, 1), (64, 128, 32, 2, 4, 1),
       (16, 64, 256, 1, 2, 4), (16, 32, 256, 1, 1, 8))
# (index, BM, BN, BK of the bf16 lane) — the wgmma route (e4m3: BK 128,
# and BN 128 only).
_WGMMA = ((4, 128, 256, 64), (5, 128, 128, 64))
# csrc/gemm_wgmma.cuh: 1024 to align the ring, the 192 KiB ring, the
# mbarriers.
WGMMA_SMEM_BYTES = 1024 + (192 << 10) + 128
# The split-K tile: its index, a warp's strip of columns by lane, the K of
# a warp's step; csrc/gemm.cu SK_SMEM.
_SPLITK_INDEX, _SPLITK_COLS, SPLITK_STEP = 6, {"bf16": 64, "e4m3": 128}, 32
SPLITK_SMEM_BYTES = 64 << 10
SPLITK_MAX_CLUSTER = 8
# CTAs a SM the split-K plan fills at most. Two fit an SM (registers), but
# on an H100 80GB HBM3 (700 W) every decode product ran slower once its
# grid passed ~200 CTAs in clusters (``scripts/time_port_gemm.py
# --sweep-splits``, kernel time: w_down 25.4 us at 6 splits, 33.7 at 8;
# w_gate/w_up 25.5 at 2, 32.7 at 3; wq/wo 13.1 at 6, 17.5 at 8): the
# clusters do not all fit at once, and a second wave follows.
SPLITK_CTAS_PER_SM = 1.5
# (BM, BN, BK) — csrc/gemm.cu run_fma.
_FMA = ((128, 128, 8), (16, 64, 32))


def _tc_tile(index: int, item: int) -> GemmTile:
    bm, bn, bk, wm, wn, wk = _TC[index]
    bk = bk * (2 if item == 1 else 1)            # e4m3 stages twice the K
    sd, sdb = bk + 16 // item, bk + 4
    stage = (bm * sd + bn * sdb) * item
    red = (wk - 1) * wm * wn * (bm // wm // 16) * (bn // wn // 8) * 4 * 32 * 4
    return GemmTile(index, bm, bn, bk, max(stage, red))


@functools.lru_cache(maxsize=None)
def lane_tiles(lane: str) -> tuple[GemmTile, ...]:
    """The compiled tiles of ``lane``, in kernel order."""
    if lane == "fp32":
        return tuple(GemmTile(i, bm, bn, bk,
                              (bk * (bm + 4) + bk * (bn + 4)) * 4, "fma")
                     for i, (bm, bn, bk) in enumerate(_FMA))
    item = 1 if lane == "e4m3" else 2
    tiles = [_tc_tile(i, item) for i in range(len(_TC))]
    if lane in _SPLITK_COLS:
        tiles += [GemmTile(i, bm, bn, bk * (2 // item), WGMMA_SMEM_BYTES,
                           "wgmma") for i, bm, bn, bk in _WGMMA
                  if item == 2 or bn == 128]
        tiles.append(GemmTile(_SPLITK_INDEX, SPLITK_ROWS,
                              _SPLITK_COLS[lane], SPLITK_STEP,
                              SPLITK_SMEM_BYTES, "splitk"))
    return tuple(tiles)


def tile_routes(lane: str) -> dict[tuple[int, int, int], str]:
    """{(tile_m, tile_n, tile_k): route} of ``lane``'s compiled tiles."""
    return {t.tiles: t.route for t in lane_tiles(lane)}


def gemm_lane(a_dtype, b_dtype) -> str:
    """The lane of an (A, B) pair, with the reference's refusal of a B as
    wide as A or wider in another type."""
    if b_dtype != a_dtype and b_dtype.itemsize >= a_dtype.itemsize:
        raise ValueError(f"mixed dtypes need B ({b_dtype}) narrower than "
                         f"A ({a_dtype})")
    lane = _LANES.get((a_dtype, b_dtype))
    if lane is None:
        raise GemmConfigError(
            f"no B3 lane for A {a_dtype} x B {b_dtype}: compiled lanes are "
            f"{[f'{a} x {b}' for a, b in _LANES]}")
    return lane


def _eligible(t: GemmTile, m: int, aligned: bool) -> bool:
    """Whether ``t``'s route takes these operands: the wgmma and split-K
    routes read 16-byte units (TMA, vector loads), split-K at most 16
    rows."""
    if t.route == "wgmma":
        return aligned
    if t.route == "splitk":
        return aligned and m <= SPLITK_ROWS
    return True


def wgmma_wave_cost(t: GemmTile, m: int, n: int, spec=None) -> float:
    """The wgmma route's time at (m, n) in units of one 128 x 128 pair
    tile: the waves of pair tiles over the card's clusters of two (the
    last one counted whole), times one pair tile's time at this width
    (``perf_model.WGMMA_TILE_TIME``, read on the card)."""
    from triton_distributed_tpu_torch.runtime.perf_model import (
        WGMMA_TILE_TIME,
    )

    clusters = max((spec or chip_spec()).sm_count // 2, 1)
    pairs = -(-(-(-max(m, 1) // t.tile_m)) // 2) * -(-max(n, 1) // t.tile_n)
    return -(-pairs // clusters) * WGMMA_TILE_TIME[t.tile_n]


def select_tile(lane: str, m: int, n: int, tile_m: int, tile_n: int,
                tile_k: int, spec=None, aligned: bool = True) -> GemmTile:
    """The compiled tile B3 runs for these caps: the tile itself when the
    caps name one exactly and its route takes the operands (the tuner's
    candidates); else, among the tiles not above the caps whose route
    takes them (``aligned``: A's and B's base and rows whole 16-byte
    units), the split-K tile at ``m`` <= 16, the wgmma tile of least
    :func:`wgmma_wave_cost` at ``m`` >= ``TALL_ROWS``, and otherwise the
    mma.sync / FMA tile (no taller than ``m`` rounded up to 16, when there
    are any) that launches the most blocks up to one per SM of ``spec``
    (default ``perf_model.chip_spec()``), then the largest (by area, then
    K)."""
    exact = [t for t in lane_tiles(lane)
             if t.tiles == (tile_m, tile_n, tile_k) and _eligible(t, m,
                                                                  aligned)]
    if exact:
        return exact[0]
    if min(tile_m, tile_n, tile_k) < 1:
        raise GemmConfigError(
            f"tile caps ({tile_m}, {tile_n}, {tile_k}) must be positive")
    capped = [t for t in lane_tiles(lane) if t.tile_m <= tile_m
              and t.tile_n <= tile_n and t.tile_k <= tile_k
              and _eligible(t, m, aligned)]
    if not capped:
        raise GemmConfigError(
            f"tile caps (tile_m={tile_m}, tile_n={tile_n}, tile_k={tile_k}) "
            f"are below every compiled {lane} tile that takes "
            f"{'these' if aligned else 'unaligned'} operands at m={m} "
            f"{[t.tiles for t in lane_tiles(lane)]} — arguments tile_m, "
            "tile_n, tile_k")
    by_route = {r: [t for t in capped if t.route == r] for r in ROUTES}
    if m <= SPLITK_ROWS and by_route["splitk"]:
        return by_route["splitk"][0]
    if m >= TALL_ROWS and by_route["wgmma"]:
        return min(by_route["wgmma"],
                   key=lambda t: (wgmma_wave_cost(t, m, n, spec),
                                  -t.tile_n))
    rest = by_route["mma"] + by_route["fma"] or capped
    short = [t for t in rest if t.tile_m <= -(-max(m, 1) // 16) * 16]
    if not short:
        return min(rest, key=lambda t: (t.tile_m, -t.tile_n, -t.tile_k))

    sms = (spec or chip_spec()).sm_count

    def blocks(t):
        return min(-(-max(m, 1) // t.tile_m) * -(-max(n, 1) // t.tile_n),
                   sms)

    return max(short, key=lambda t: (blocks(t), t.tile_m * t.tile_n,
                                     t.tile_k))


def splitk_plan(lane: str, m: int, n: int, k: int,
                spec=None) -> tuple[int, int, int]:
    """The split-K launch at (m, n, k): (CTAs a column strip — one
    cluster, at most 8 —, 32-row k-steps a CTA, k-steps of A staged in
    shared memory at once). Up to ``SPLITK_CTAS_PER_SM`` CTAs a SM of
    ``spec`` in all (one wave), no more than leave each warp of a CTA a
    k-step, and no CTA empty."""
    sms = (spec or chip_spec()).sm_count
    strips = -(-n // _SPLITK_COLS[lane])
    steps = -(-k // SPLITK_STEP)
    splits = max(1, min(SPLITK_MAX_CLUSTER,
                        int(SPLITK_CTAS_PER_SM * sms) // strips,
                        steps // 8))
    per = -(-steps // splits)
    splits = -(-steps // per)
    item = 1 if lane == "e4m3" else 2
    rows = max(m, 1)
    chunk = max(1, min(per, (SPLITK_SMEM_BYTES // rows - 16)
                       // (SPLITK_STEP * item)))
    return splits, per, chunk


@functools.lru_cache(maxsize=4096)
def _launch_plan(lane: str, m: int, n: int, k: int, tile_m: int,
                 tile_n: int, tile_k: int, aligned: bool):
    """(tile, split-K plan, counted variants) of one call's shape and caps
    — decided once per shape: the eager decode launches B3 hundreds of
    times a step, and its host time is the step's."""
    tile = select_tile(lane, m, n, tile_m, tile_n, tile_k, aligned=aligned)
    plan = (splitk_plan(lane, m, n, k) if tile.route == "splitk"
            else (0, 0, 0))
    return tile, plan, (lane, tile.route)


def matmul_plain(a: torch.Tensor, b: torch.Tensor, out_dtype) -> torch.Tensor:
    """B3's function in plain PyTorch: the fp32 product of the operands as
    stored (a narrower B upcasts exactly), then the output cast —
    saturating for e4m3."""
    GEMM_KERNEL.count_plain()
    return saturate_cast(a.float() @ b.float(), out_dtype)


def _aligned(t: torch.Tensor) -> bool:
    return (t.data_ptr() % 16 == 0
            and (t.shape[1] * t.element_size()) % 16 == 0)


def _matmul_cuda(a: torch.Tensor, b: torch.Tensor, out_dtype, lane: str,
                 tile: GemmTile, plan, variants,
                 out: torch.Tensor | None) -> torch.Tensor:
    if b.device != a.device:
        raise ValueError(f"B3: A on {a.device}, B on {b.device}")
    m, k = a.shape
    n = b.shape[1]
    if out is None:
        out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    # The e4m3 wgmma route's B^T, written by the kernel's pre-pass.
    ws = (torch.empty((n, k), dtype=E4M3, device=a.device)
          if tile.route == "wgmma" and lane == "e4m3" else None)
    GEMM_KERNEL.launch(
        ptr(a), ptr(b), ptr(out), ptr(ws), m, n, k, _TYPE_CODE[a.dtype],
        _TYPE_CODE[b.dtype], _TYPE_CODE[out_dtype], tile.index,
        int(_aligned(a)), int(_aligned(b)), *plan, current_stream(a.device),
        variants=variants)
    return out


def pallas_matmul(a: torch.Tensor, b: torch.Tensor, tile_m: int = 512,
                  tile_n: int = 1024, tile_k: int = 512,
                  out_dtype=None, *, out: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """out = a @ b with fp32 accumulation. a: (M, K), b: (K, N) → (M, N)
    in ``out_dtype`` (default ``a.dtype``). B3 on CUDA tensors, its plain
    version on CPU tensors. ``out``: a contiguous (M, N) tensor of that
    type on A's device to write into (a harness's NaN-filled output), else
    a fresh one."""
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"pallas_matmul takes 2-D operands, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    m, k = a.shape
    k2, _ = b.shape
    if k != k2:
        raise ValueError(f"inner dims mismatch {k} vs {k2}")
    lane = gemm_lane(a.dtype, b.dtype)
    out_dtype = a.dtype if out_dtype is None else out_dtype
    if out_dtype not in LANE_OUT[lane]:
        raise GemmConfigError(
            f"out_dtype {out_dtype} is not compiled for the {lane} lane "
            f"(A {a.dtype} x B {b.dtype}): expected one of "
            f"{list(LANE_OUT[lane])} — argument out_dtype")
    if out is not None and (out.shape != (m, b.shape[1])
                            or out.dtype != out_dtype
                            or out.device != a.device
                            or not out.is_contiguous()):
        raise ValueError(
            f"pallas_matmul: out must be a contiguous {(m, b.shape[1])} "
            f"{out_dtype} tensor on {a.device}, got {tuple(out.shape)} "
            f"{out.dtype} on {out.device} — argument out")
    a, b = a.contiguous(), b.contiguous()
    tile, plan, variants = _launch_plan(
        lane, m, b.shape[1], k, tile_m, tile_n, tile_k,
        _aligned(a) and _aligned(b))
    if a.device.type == "cuda":
        return _matmul_cuda(a, b, out_dtype, lane, tile, plan, variants,
                            out)
    if a.device.type == "cpu":
        res = matmul_plain(a, b, out_dtype)
        return res if out is None else out.copy_(res)
    raise ValueError(f"pallas_matmul: no kernel for device {a.device}")


def pallas_matmul_tuned(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """:func:`pallas_matmul` at the tiles the contextual autotuner measured
    for this shape, lane and card (``runtime/autotuner.tuned_matmul_tiles``:
    disk-cached; off the card, or with ``TDTPU_AUTOTUNE=0``, the static
    defaults)."""
    from triton_distributed_tpu_torch.runtime.autotuner import (
        tuned_matmul_tiles,
    )

    tiles = tuned_matmul_tiles(a.shape[0], a.shape[1], b.shape[1], a.dtype,
                               b_dtype=b.dtype, device=a.device)
    if tiles is None:
        return pallas_matmul(a, b)
    tm, tn, tk = tiles
    return pallas_matmul(a, b, tile_m=tm, tile_n=tn, tile_k=tk)
