"""The part of the JAX package's ``ops/tiling.py`` that the fused GEMM
kernels (B9-B11) use: the rank-swizzled visit order and the row padding
that sets B11's workspace shape.

``pick_tile`` and ``gemm_tiles`` are the TPU's tiling rules (Mosaic's
(8, 128) memref tiling) and are not ported: the CUDA kernels pick their
own tiles, as B3 does (``csrc/gemm_comm.cu``).
"""

from __future__ import annotations

import torch

SUBLANE = {2: 16, 4: 8, 1: 32}  # itemsize -> rows of one sublane tile


def sublane_align(dtype) -> int:
    """The reference's row alignment for ``dtype`` (8 fp32, 16 bf16, 32
    one-byte types): B11's workspace pads its rows to it, so the port's
    workspace has the reference's shape."""
    return SUBLANE.get(torch.empty((), dtype=dtype).element_size(), 8)


def swizzled_ranks(me: int, n: int) -> list[int]:
    """Visit order starting at the own rank: me, me+1, ..., me-1 (mod n)
    — the consumer starts on the rows it already has."""
    return [(me + i) % n for i in range(n)]
