"""The part of the JAX package's ``ops/tiling.py`` that the port uses:
the rank-swizzled visit order and the row padding that sets B11's
workspace shape (the fused GEMM kernels, B9-B11), and ``pick_tile``, which
sets the split-KV chunk of ``ops/flash_decode.py`` so that its page table
has the reference's shape.

``gemm_tiles`` is the TPU's tiling rule (Mosaic's (8, 128) memref
tiling) and is not ported: the CUDA kernels pick their own tiles, as B3
does (``csrc/gemm_comm.cu``).
"""

from __future__ import annotations

import torch

SUBLANE = {2: 16, 4: 8, 1: 32}  # itemsize -> rows of one sublane tile


def sublane_align(dtype) -> int:
    """The reference's row alignment for ``dtype`` (8 fp32, 16 bf16, 32
    one-byte types): B11's workspace pads its rows to it, so the port's
    workspace has the reference's shape."""
    return SUBLANE.get(torch.empty((), dtype=dtype).element_size(), 8)


def pick_tile(dim: int, cap: int, align: int = 1) -> int:
    """Largest divisor of ``dim`` not exceeding ``cap`` that is a multiple
    of ``align``; ``dim`` itself when no aligned divisor exists."""
    t = min(dim, cap)
    while t >= align:
        if dim % t == 0 and t % align == 0:
            return t
        t -= 1
    return dim


def swizzled_ranks(me: int, n: int) -> list[int]:
    """Visit order starting at the own rank: me, me+1, ..., me-1 (mod n)
    — the consumer starts on the rows it already has."""
    return [(me + i) % n for i in range(n)]
