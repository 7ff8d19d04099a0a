"""Pipeline-parallel transport layer — stage-to-stage sends and
microbatching; counterpart of the JAX package's ``layers/pp.py``.

PP stages are the ranks of a group (any axis name: ``DistContext(tp_axis=
"pp")``); a stage-to-stage send is kernel B7's ring shift
(``ops/p2p.py``): every stage sends to me+1 and receives from me-1 in one
call. :class:`CommOp` runs any static set of (src, dst) sends.
:func:`pp_pipeline_forward` and :func:`pp_pipeline_interleaved` are the
GPipe and interleaved-chunk forward schedules, tick for tick the
reference's, the last tick's shift skipped: ``num_mb + n - 2`` shifts a
rank, and ``(num_mb + chunks·n - 2)·chunks`` for the interleaved form.

Call them inside ``DistContext.run``. The stage index is the rank, a host
int, so a stage computes only on the ticks where it holds a microbatch
(the reference computes every tick and masks the idle ones to zeros: the
same outputs and the same sends). Every rank reaches every shift in the
same order, which the shift's meeting needs.
"""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.ops.p2p import (
    p2p_permute_local, p2p_shift_local,
)
from triton_distributed_tpu_torch.runtime.context import current_rank


class CommOp:
    """Arbitrary-pair stage transport (the reference's PP ``CommOp``).
    ``exchange(x, perm)`` runs one static set of (src, dst) sends
    (``ops/p2p.p2p_permute_local``; a full ring takes the shift kernel).
    ``force_kernel`` runs the kernels at n = 1 too."""

    def __init__(self, axis: str = "pp", num_ranks: int | None = None,
                 force_kernel: bool = False):
        if num_ranks is None:
            raise ValueError("num_ranks required inside the rank runner")
        self.axis = axis
        self.n = num_ranks
        self.force_kernel = force_kernel

    def exchange(self, x: torch.Tensor, perm) -> torch.Tensor:
        # No n == 1 shortcut: p2p_permute_local keeps ppermute's zeros
        # unless (0, 0) is in the perm, as every n > 1 run feeds zeros.
        return p2p_permute_local(x, perm, axis=self.axis, num_ranks=self.n,
                                 force_kernel=self.force_kernel)

    def send(self, x: torch.Tensor, src: int, dst: int) -> torch.Tensor:
        """Single-pair send: ``dst`` receives src's block, every other rank
        zeros (call on every rank)."""
        return self.exchange(x, [(src, dst)])


class PPStream:
    """Rank-local PP transport. ``send_next(x)`` pushes this stage's
    activation to stage me+1 and returns the one received from me-1
    (stage 0 receives stage n-1's: callers ignore it)."""

    def __init__(self, axis: str = "pp", num_ranks: int | None = None):
        if num_ranks is None:
            raise ValueError("num_ranks required inside the rank runner")
        self.axis = axis
        self.n = num_ranks

    def send_next(self, x: torch.Tensor) -> torch.Tensor:
        if self.n == 1:
            return x
        return p2p_shift_local(x, shift=1, axis=self.axis, num_ranks=self.n)

    def send_prev(self, x: torch.Tensor) -> torch.Tensor:
        if self.n == 1:
            return x
        return p2p_shift_local(x, shift=-1, axis=self.axis, num_ranks=self.n)


def _stage(n: int) -> int:
    return current_rank()[1] if n > 1 else 0


def pp_pipeline_forward(stage_fn, x_microbatches: torch.Tensor, *,
                        axis: str = "pp", num_ranks: int | None = None
                        ) -> torch.Tensor:
    """Run microbatches through an n-stage pipeline (rank-local).

    stage_fn(mb): this stage's compute on one microbatch.
    x_microbatches: (num_mb, mb, cols), stage 0's inputs (the other
    stages' are ignored). Schedule: num_mb + n - 1 ticks; at tick t stage
    s computes microbatch t - s (when in range) and ships it onward. The
    last stage returns its outputs (num_mb, mb, cols); the others return
    zeros."""
    if num_ranks is None:
        raise ValueError("num_ranks required inside the rank runner")
    n = num_ranks
    stream = PPStream(axis=axis, num_ranks=n)
    me = _stage(n)
    num_mb, mb, cols = x_microbatches.shape
    out = torch.zeros_like(x_microbatches)
    carry = torch.zeros((mb, cols), dtype=x_microbatches.dtype,
                        device=x_microbatches.device)
    for t in range(num_mb + n - 1):
        idx = t - me
        if 0 <= idx < num_mb:
            y = stage_fn(x_microbatches[idx] if me == 0 else carry)
            if me == n - 1:
                out[idx] = y
        else:
            y = torch.zeros_like(carry)
        # The last tick's carry is never read: its shift is skipped.
        if t < num_mb + n - 2:
            carry = stream.send_next(y)
    return out


def pp_pipeline_interleaved(stage_fn, x_microbatches: torch.Tensor, *,
                            chunks: int, axis: str = "pp",
                            num_ranks: int | None = None) -> torch.Tensor:
    """Interleaved-chunk pipeline forward (rank-local): each rank hosts
    ``chunks`` model chunks round-robin — virtual stage σ = c·n + d lives
    on rank d.

    stage_fn(c, mb): this rank's chunk ``c`` on one microbatch.
    x_microbatches: (num_mb, mb, cols), virtual stage 0's inputs. Per tick
    every rank runs its active chunks and ships each chunk's output one
    rank right; rank n-1's output wraps to rank 0, where it enters the
    NEXT chunk. Returns the last virtual stage's outputs on rank n-1,
    zeros elsewhere."""
    if num_ranks is None:
        raise ValueError("num_ranks required inside the rank runner")
    n = num_ranks
    stream = PPStream(axis=axis, num_ranks=n)
    me = _stage(n)
    num_mb, mb, cols = x_microbatches.shape
    total = chunks * n
    out = torch.zeros_like(x_microbatches)
    zeros = torch.zeros((mb, cols), dtype=x_microbatches.dtype,
                        device=x_microbatches.device)
    # carry[c]: the activation this rank feeds chunk c next tick.
    carry = [zeros] * chunks
    for t in range(num_mb + total - 1):
        ys = []
        for c in range(chunks):
            idx = t - (c * n + me)
            if 0 <= idx < num_mb:
                x_in = (x_microbatches[idx] if c == 0 and me == 0
                        else carry[c])
                y = stage_fn(c, x_in)
                if c == chunks - 1 and me == n - 1:
                    out[idx] = y
            else:
                y = zeros
            ys.append(y)
        if t == num_mb + total - 2:
            break
        shifted = [stream.send_next(y) for y in ys]
        # Rank 0's inbound for chunk c comes from rank n-1's chunk c-1 (the
        # cross-chunk wrap); the other ranks stay within c.
        carry = ([shifted[c - 1] if c > 0 else zeros for c in range(chunks)]
                 if me == 0 else shifted)
    return out
