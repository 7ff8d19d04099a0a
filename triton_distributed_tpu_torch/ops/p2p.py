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

On the card the sender writes the receiver's output, as the TPU kernels'
remote DMA does: each receiver publishes its fresh output's address to its
source (the call's epoch as the flag), the source writes its block
straight into it and signals, the receiver waits (the push protocol,
``csrc/push.cuh``). Only a signal pad is kept (tag ``"p2p"``, shared
by both kernels); there is no receive buffer, copy out or entry barrier.
On the CPU the plain version mirrors the protocol through the rank
group's rendezvous: the ranks exchange their outputs, the sources store
into their destinations' outputs, the ranks meet.
"""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.ops._comm import (
    P2P_PERMUTE_KERNEL, P2P_SHIFT_KERNEL, check_out, check_payload,
    launch_push, rank_of, rank_shards,
)
from triton_distributed_tpu_torch.runtime.context import (
    DistContext, get_context,
)
from triton_distributed_tpu_torch.runtime.symm import symm_pad


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
         n: int, extra: tuple, out: torch.Tensor | None) -> torch.Tensor:
    """One B7 call: ``kernel`` on a CUDA tensor (``extra``: its own
    arguments), the plain version on a CPU one. ``out``: the output to
    write (a harness's sentinel), else a fresh one."""
    if out is not None:
        out = check_out(ctx, rank, out, x.shape, x.dtype, "p2p")
    if x.device.type == "cuda":
        x = check_payload(ctx, rank, x, "p2p", copy=True, dims=x.dim())
        out = torch.empty_like(x) if out is None else out
        launch_push(kernel, symm_pad(ctx, tag="p2p"), rank, x, out,
                    x.numel() * x.element_size(), *extra)
        return out
    if x.device.type != "cpu":
        raise ValueError(f"p2p: no kernel for device {x.device}")
    kernel.count_plain()
    out = torch.empty_like(x) if out is None else out
    outs = ctx.exchange(rank, out, "p2p.addr")
    for s, d in perm:
        if s == rank:
            outs[d].copy_(x)
    if not any(d == rank for _, d in perm):
        out.zero_()
    ctx.barrier(rank, "p2p.data")
    return out


def p2p_shift_local(x_local: torch.Tensor, shift: int = 1, axis: str = "tp",
                    num_ranks: int | None = None,
                    force_kernel: bool = False,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """Rank-local ring shift inside ``DistContext.run``: the output on
    rank (d + shift) % n is rank d's ``x_local``. ``force_kernel`` runs
    the kernel at n = 1 too (the loopback: the rank pushes to itself).
    ``out``: the tensor the kernel writes (every element), else a fresh
    one; not taken at n = 1 without ``force_kernel``."""
    ctx, rank, n = rank_of(axis, num_ranks)
    if n == 1 and not force_kernel:
        if out is not None:
            raise ValueError("p2p: out= needs the kernel (n > 1 or "
                             "force_kernel)")
        return x_local
    return _p2p(P2P_SHIFT_KERNEL, x_local, _shift_perm(shift, n), ctx, rank,
                n, (int(shift),), out)


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
                      force_kernel: bool = False,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """Rank-local arbitrary-pair exchange inside ``DistContext.run``.

    ``perm``: static (src, dst) rank pairs — partial sends (idle ranks
    allowed), multicast (one src, several dsts); each dst at most once. A
    rank that receives nothing gets zeros. A perm that is a full ring
    shift takes the shift kernel. ``force_kernel`` runs the permute
    kernel even at n = 1 (there the ring fast path is suppressed, so THIS
    kernel is what runs); at n = 1 without it the result is ``x_local`` if
    (0, 0) is in the perm, else zeros. ``out``: as
    :func:`p2p_shift_local`'s."""
    ctx, rank, n = rank_of(axis, num_ranks)
    perm = tuple((int(s), int(d)) for s, d in perm)
    dsts = [d for _, d in perm]
    if len(set(dsts)) != len(dsts):
        raise ValueError(f"duplicate destination in perm {perm}")
    for s, d in perm:
        if not (0 <= s < n and 0 <= d < n):
            raise ValueError(f"pair ({s}, {d}) outside 0..{n - 1}")
    if n == 1 and not force_kernel:
        if out is not None:
            raise ValueError("p2p: out= needs the kernel (n > 1 or "
                             "force_kernel)")
        return x_local if (0, 0) in perm else torch.zeros_like(x_local)
    shift = _as_shift(perm, n)
    if shift is not None and not (force_kernel and n == 1):
        return p2p_shift_local(x_local, shift=shift, axis=axis, num_ranks=n,
                               force_kernel=force_kernel, out=out)
    send_mask = sum(1 << d for s, d in perm if s == rank)
    src = next((s for s, d in perm if d == rank), -1)
    return _p2p(P2P_PERMUTE_KERNEL, x_local, perm, ctx, rank, n,
                (send_mask, src), out)


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
