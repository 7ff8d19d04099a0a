"""Tiled GEMM — kernel B3 and its plain PyTorch version.

Counterpart of the JAX package's ``ops/gemm.py``. The TPU kernel there
(``_grid_matmul_kernel``: a (m, n, k) grid whose sequential k axis carries
the fp32 sum in VMEM scratch) becomes the hand-written CUDA kernel
``csrc/gemm.cu``: one block per output tile, looping over K itself.

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
in the reference: the kernel runs the largest compiled tile not above
them (:func:`lane_tiles`), preferring one no taller than M rounded up to
16 and then one that gives every SM a block (:func:`select_tile`), so the
reference's defaults pick the 128 x 128 tile at large M and a 16-row tile
that splits K over warps at decode. The kernel masks ragged
edges, so no dimension needs to divide a tile. A cap below every
compiled tile raises :class:`GemmConfigError`.

On a CUDA tensor the wrapper launches B3 (counted in
``GEMM_KERNEL.launches``, and per lane in ``variant_launches``: ``"fp32"``,
``"bf16"``, ``"mixed"``, ``"e4m3"``); on a CPU tensor it runs
:func:`matmul_plain`.
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
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p])

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
    memory a block uses (the formulas of ``TcCfg`` / ``FmaCfg``)."""

    index: int
    tile_m: int
    tile_n: int
    tile_k: int
    smem_bytes: int

    @property
    def tiles(self) -> tuple[int, int, int]:
        return (self.tile_m, self.tile_n, self.tile_k)


# (BM, BN, BK of the bf16 lane, warps WM x WN x WK) — csrc/gemm.cu run_tc.
_TC = ((128, 128, 32, 2, 4, 1), (64, 128, 32, 2, 4, 1),
       (16, 64, 256, 1, 2, 4), (16, 32, 256, 1, 1, 8))
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
                              (bk * (bm + 4) + bk * (bn + 4)) * 4)
                     for i, (bm, bn, bk) in enumerate(_FMA))
    item = 1 if lane == "e4m3" else 2
    return tuple(_tc_tile(i, item) for i in range(len(_TC)))


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


def select_tile(lane: str, m: int, n: int, tile_m: int, tile_n: int,
                tile_k: int, spec=None) -> GemmTile:
    """The compiled tile B3 runs for these caps: the tile itself when the
    caps name one exactly (the tuner's candidates); else, among the tiles
    not above them (and no taller than ``m`` rounded up to 16, when there
    are any), the one that launches the most blocks up to one per SM of
    ``spec`` (default ``perf_model.chip_spec()``: a tile that leaves SMs
    idle loses to a smaller one that fills them), then the largest (by
    area, then K)."""
    exact = [t for t in lane_tiles(lane)
             if t.tiles == (tile_m, tile_n, tile_k)]
    if exact:
        return exact[0]
    if min(tile_m, tile_n, tile_k) < 1:
        raise GemmConfigError(
            f"tile caps ({tile_m}, {tile_n}, {tile_k}) must be positive")
    capped = [t for t in lane_tiles(lane) if t.tile_m <= tile_m
              and t.tile_n <= tile_n and t.tile_k <= tile_k]
    if not capped:
        raise GemmConfigError(
            f"tile caps (tile_m={tile_m}, tile_n={tile_n}, tile_k={tile_k}) "
            f"are below every compiled {lane} tile "
            f"{[t.tiles for t in lane_tiles(lane)]} — arguments tile_m, "
            "tile_n, tile_k")
    short = [t for t in capped if t.tile_m <= -(-max(m, 1) // 16) * 16]
    if not short:
        return min(capped, key=lambda t: (t.tile_m, -t.tile_n, -t.tile_k))

    sms = (spec or chip_spec()).sm_count

    def blocks(t):
        return min(-(-max(m, 1) // t.tile_m) * -(-max(n, 1) // t.tile_n),
                   sms)

    return max(short, key=lambda t: (blocks(t), t.tile_m * t.tile_n,
                                     t.tile_k))


def matmul_plain(a: torch.Tensor, b: torch.Tensor, out_dtype) -> torch.Tensor:
    """B3's function in plain PyTorch: the fp32 product of the operands as
    stored (a narrower B upcasts exactly), then the output cast —
    saturating for e4m3."""
    GEMM_KERNEL.count_plain()
    return saturate_cast(a.float() @ b.float(), out_dtype)


def _aligned(t: torch.Tensor) -> int:
    return int(t.data_ptr() % 16 == 0
               and (t.shape[1] * t.element_size()) % 16 == 0)


def _matmul_cuda(a: torch.Tensor, b: torch.Tensor, out_dtype, lane: str,
                 tile: GemmTile) -> torch.Tensor:
    if b.device != a.device:
        raise ValueError(f"B3: A on {a.device}, B on {b.device}")
    a, b = a.contiguous(), b.contiguous()
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    GEMM_KERNEL.launch(
        ptr(a), ptr(b), ptr(out), m, n, k, _TYPE_CODE[a.dtype],
        _TYPE_CODE[b.dtype], _TYPE_CODE[out_dtype], tile.index, _aligned(a),
        _aligned(b), current_stream(a.device), variants=(lane,))
    return out


def pallas_matmul(a: torch.Tensor, b: torch.Tensor, tile_m: int = 512,
                  tile_n: int = 1024, tile_k: int = 512,
                  out_dtype=None) -> torch.Tensor:
    """out = a @ b with fp32 accumulation. a: (M, K), b: (K, N) → (M, N)
    in ``out_dtype`` (default ``a.dtype``). B3 on CUDA tensors, its plain
    version on CPU tensors."""
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
    tile = select_tile(lane, m, b.shape[1], tile_m, tile_n, tile_k)
    if a.device.type == "cuda":
        return _matmul_cuda(a, b, out_dtype, lane, tile)
    if a.device.type == "cpu":
        return matmul_plain(a, b, out_dtype)
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
