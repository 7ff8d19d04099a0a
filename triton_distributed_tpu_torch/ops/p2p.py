"""Point-to-point transport (the pipeline-parallel stage boundary) —
counterpart of the JAX package's ``ops/p2p.py``: kernel B7, the ring shift
(``_p2p_shift_kernel``) and the static permutation
(``_p2p_permute_kernel``), as hand-written CUDA in ``csrc/p2p.cu``
(``tdt_p2p_shift``, ``tdt_p2p_permute``).

Semantics are ``jax.lax.ppermute``'s: the output on rank ``(d + shift) %
n`` is rank d's block; a permutation lists (src, dst) pairs — idle ranks,
multicast (one source, several destinations), no duplicate destination —
and a rank that receives nothing gets zeros. A permutation that is a full
ring shift takes the shift kernel.

On the card a source pushes its block into the destination's symmetric
receive buffer (one per (shape, dtype), which both kernels share) and
signals it; the destination copies the buffer to a fresh output. Both
kernels open with the reference's entry barrier, which here keeps a peer
from overwriting a receive buffer before its owner copied out the last
call. On the CPU
the plain version goes through the same buffers: the sources store into
their destinations' copies, the ranks meet, each copies its own out.
"""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.ops._comm import (
    P2P_PERMUTE_KERNEL, P2P_SHIFT_KERNEL, check_payload, launch, rank_of,
    rank_shards,
)
from triton_distributed_tpu_torch.runtime.context import (
    DistContext, get_context,
)
from triton_distributed_tpu_torch.runtime.symm import symm_zeros


def p2p_plain(xs, perm) -> list:
    """Plain version of both kernels: ``xs`` — the n ranks' blocks — moved
    by the (src, dst) pairs of ``perm``; a rank no pair names gets zeros."""
    outs = [torch.zeros_like(x) for x in xs]
    for s, d in perm:
        outs[d] = xs[s].clone()
    return outs


def _shift_perm(shift: int, n: int) -> list:
    return [(s, (s + shift) % n) for s in range(n)]


def _p2p(kernel, x: torch.Tensor, perm, ctx: DistContext, rank: int,
         n: int, extra: tuple) -> torch.Tensor:
    """One B7 call: ``kernel`` on a CUDA tensor (``extra``: its own
    arguments), the plain version on a CPU one."""
    buf = symm_zeros(ctx, tuple(x.shape), x.dtype, tag="p2p")
    if x.device.type == "cuda":
        x = check_payload(ctx, rank, x, "p2p", copy=True, dims=x.dim())
        out = torch.empty_like(x)
        launch(kernel, buf, rank, buf.next_epoch(rank), x, out,
               x.numel() * x.element_size(), *extra)
        return out
    if x.device.type != "cpu":
        raise ValueError(f"p2p: no kernel for device {x.device}")
    kernel.count_plain()
    ctx.barrier(rank, "p2p.entry")
    for s, d in perm:
        if s == rank:
            buf.tensors[d].copy_(x)
    ctx.barrier(rank, "p2p.data")
    src = [s for s, d in perm if d == rank]
    return buf.tensors[rank].clone() if src else torch.zeros_like(x)


def p2p_shift_local(x_local: torch.Tensor, shift: int = 1, axis: str = "tp",
                    num_ranks: int | None = None,
                    force_kernel: bool = False) -> torch.Tensor:
    """Rank-local ring shift inside ``DistContext.run``: the output on
    rank (d + shift) % n is rank d's ``x_local``. ``force_kernel`` runs
    the kernel at n = 1 too (the loopback: the rank pushes to itself)."""
    ctx, rank, n = rank_of(axis, num_ranks)
    if n == 1 and not force_kernel:
        return x_local
    return _p2p(P2P_SHIFT_KERNEL, x_local, _shift_perm(shift, n), ctx, rank,
                n, (int(shift),))


def p2p_shift(x, ctx: DistContext | None = None, shift: int = 1,
              axis: str = "tp") -> list:
    """Host-level ring shift: ``x`` — the n per-rank blocks (a list, or a
    tensor split by rows) → the n shifted blocks, rank r's on
    ``ctx.devices[r]``."""
    ctx = ctx or get_context()
    xs = rank_shards(ctx, axis, x)
    n = len(xs)
    outs = ctx.run(lambda r: p2p_shift_local(
        xs[r].to(ctx.devices[r]), shift=shift, axis=axis, num_ranks=n))
    ctx.raise_on_comm_error()
    return outs


def _as_shift(perm, n: int) -> int | None:
    """The uniform shift amount when ``perm`` is exactly a full ring shift
    (the fast-path detection), else None."""
    if len(perm) != n:
        return None
    shifts = {(d - s) % n for s, d in perm}
    if len(shifts) != 1:
        return None
    if {s for s, _ in perm} != set(range(n)):
        return None
    return shifts.pop()


def p2p_permute_local(x_local: torch.Tensor, perm, axis: str = "tp",
                      num_ranks: int | None = None,
                      force_kernel: bool = False) -> torch.Tensor:
    """Rank-local arbitrary-pair exchange inside ``DistContext.run``.

    ``perm``: static (src, dst) rank pairs — partial sends (idle ranks
    allowed), multicast (one src, several dsts); each dst at most once. A
    rank that receives nothing gets zeros. A perm that is a full ring
    shift takes the shift kernel. ``force_kernel`` runs the permute
    kernel even at n = 1 (there the ring fast path is suppressed, so THIS
    kernel is what runs); at n = 1 without it the result is ``x_local`` if
    (0, 0) is in the perm, else zeros."""
    ctx, rank, n = rank_of(axis, num_ranks)
    perm = tuple((int(s), int(d)) for s, d in perm)
    dsts = [d for _, d in perm]
    if len(set(dsts)) != len(dsts):
        raise ValueError(f"duplicate destination in perm {perm}")
    for s, d in perm:
        if not (0 <= s < n and 0 <= d < n):
            raise ValueError(f"pair ({s}, {d}) outside 0..{n - 1}")
    if n == 1 and not force_kernel:
        return x_local if (0, 0) in perm else torch.zeros_like(x_local)
    shift = _as_shift(perm, n)
    if shift is not None and not (force_kernel and n == 1):
        return p2p_shift_local(x_local, shift=shift, axis=axis, num_ranks=n,
                               force_kernel=force_kernel)
    send_mask = sum(1 << d for s, d in perm if s == rank)
    src = next((s for s, d in perm if d == rank), -1)
    return _p2p(P2P_PERMUTE_KERNEL, x_local, perm, ctx, rank, n,
                (send_mask, src))


def p2p_permute(x, perm, ctx: DistContext | None = None,
                axis: str = "tp") -> list:
    """Host-level arbitrary-pair exchange of the n per-rank blocks (a
    list, or a tensor split by rows)."""
    ctx = ctx or get_context()
    xs = rank_shards(ctx, axis, x)
    n = len(xs)
    perm = tuple((int(s), int(d)) for s, d in perm)
    outs = ctx.run(lambda r: p2p_permute_local(
        xs[r].to(ctx.devices[r]), perm, axis=axis, num_ranks=n))
    ctx.raise_on_comm_error()
    return outs
