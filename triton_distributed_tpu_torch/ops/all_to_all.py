"""Low-latency MoE AllToAll — counterpart of the JAX package's
``ops/all_to_all.py``: kernel B8 in its barrier form (``_a2a_kernel``) and
its barrier-free parity form (``_a2a_parity_kernel``) as hand-written
CUDA in ``csrc/all_to_all.cu`` (``tdt_a2a``, ``tdt_a2a_parity``), and the
token layout helpers of the expert-parallel layer.

The layout contract is the JAX package's: a rank's send buffer is
``(n, cap, hidden)`` — slot p holds the token rows for rank p's experts,
sorted by expert, zero-padded to ``cap`` — with its splits ``(n, epr)``
int32 (rows per destination expert); ``cap`` is a multiple of the block
of ``block_rows`` rows, and only ``ceil(rows_p / block)`` blocks of slot
p move (traffic follows the real token count, not ``cap``). The receive
buffer has the same layout, slot p holding what rank p sent; rows past a
slot's count are unspecified.

On the card the splits ride the kernel with the payload (written before
the source's flag), so ``recv_splits`` is the kernel's output and no
host meeting sits between the layers of a decode step beyond the
launch's. The plain version — the CPU path, and ``chip_smoke.py``'s
yardstick — exchanges the splits through ``group_all_to_all`` (the JAX
package's ``jax.lax.all_to_all``) and the live blocks through a
symmetric buffer's slots.

On the card both forms run the push protocol (``csrc/push.cuh``), one
body under two kernels: each receiver publishes its fresh output and
splits, each sender writes its live rows and splits row straight into
them and signals every peer on every call, empty slots included — no
entry barrier, receive buffer, parity slab or copy-out. The barrier form
(the EP prefill's) keeps only a signal pad (tag ``"a2a"``), its grid a
block per 64 KiB of the send buffer (bandwidth-bound); the stream form
(the EP decode path) threads a persistent ``(workspace, call_index)``
pair, the reference's contract, the workspace the signal pad carrying the
epochs (call index + 1), its grid a block per 16 KiB (latency-bound).
Payloads are byte copies: float32, bfloat16 and float8_e4m3fn.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from triton_distributed_tpu_torch.ops._comm import (
    A2A_BLOCK_BYTES, A2A_KERNEL, A2A_LAYOUT, A2A_PARITY_KERNEL, check_out,
    check_payload, launch_push, rank_of, straggle,
)
from triton_distributed_tpu_torch.ops.tiling import sublane_align
from triton_distributed_tpu_torch.runtime.build import ptr
from triton_distributed_tpu_torch.runtime.context import (
    DistContext, get_context, group_all_to_all,
)
from triton_distributed_tpu_torch.runtime.symm import (
    SymmBuffer, symm_pad, symm_zeros,
)

# int32 a splits row of the stream workspace: room for up to this many
# experts a rank, whatever the layer (a2a_stream_workspace has no epr).
STREAM_SPLITS = 256


def default_block_rows(dtype) -> int:
    """The reference's block: 16 rows, or one sublane tile of a narrower
    type (32 rows of a one-byte type)."""
    return max(16, sublane_align(dtype))


def _check(send_buf: torch.Tensor, send_splits: torch.Tensor, n: int,
           block_rows: int | None) -> int:
    if send_buf.dim() != 3 or send_buf.shape[0] != n:
        raise ValueError(f"send_buf must be (n={n}, cap, hidden), "
                         f"got {tuple(send_buf.shape)}")
    if send_splits.dim() != 2 or send_splits.shape[0] != n:
        raise ValueError(f"send_splits must be (n={n}, experts_per_rank), "
                         f"got {tuple(send_splits.shape)}")
    if send_splits.device != send_buf.device:
        raise ValueError(f"send_splits on {send_splits.device}, send_buf on "
                         f"{send_buf.device}: the kernel reads both")
    cap = send_buf.shape[1]
    block = block_rows or default_block_rows(send_buf.dtype)
    if block % sublane_align(send_buf.dtype):
        raise ValueError(f"block_rows {block} not sublane-aligned")
    if cap % block:
        raise ValueError(f"slot capacity {cap} not a multiple of "
                         f"block_rows {block}")
    return block


def live_rows(splits: torch.Tensor, cap: int, block: int) -> list[int]:
    """Rows each slot moves: ``ceil(sum(splits[p]) / block)`` blocks of
    ``block`` rows, at most ``cap`` (host ints; a host read)."""
    out = []
    for s in splits.sum(dim=1).tolist():
        rows = min(max(int(s), 0), cap)
        out.append(-(-rows // block) * block)
    return out


def a2a_plain(send_bufs, send_splits, block: int):
    """Plain version of both kernels, on every rank's inputs at once:
    ``send_bufs`` (n, n, cap, h) — [d, p] rank d's slot for rank p —,
    ``send_splits`` (n, n, epr). Returns (recv (n, n, cap, h), recv_splits
    (n, n, epr)) with ``recv[d, p] = send[p, d]`` over slot [p, d]'s live
    blocks, zeros past them."""
    n, _, cap, _ = send_bufs.shape
    recv = torch.zeros_like(send_bufs)
    for p in range(n):
        rows = live_rows(send_splits[p], cap, block)
        for d in range(n):
            recv[d, p, :rows[d]] = send_bufs[p, d, :rows[d]]
    return recv, send_splits.transpose(0, 1).contiguous()


def _plain_local(ctx: DistContext, rank: int, n: int, send: torch.Tensor,
                 splits: torch.Tensor, block: int, slots: list,
                 what: str):
    """One rank's part of the plain version: the splits through the
    group's all-to-all (a meeting), the live blocks pushed into slot
    ``rank`` of every peer's ``slots`` (each rank's (n, cap, h) view) in
    :func:`a2a_push_schedule`'s order, a meeting, then this rank's slots
    copied out."""
    cap = send.shape[1]
    recv_splits = group_all_to_all(splits, num_ranks=n)
    rows = live_rows(splits, cap, block)
    for p, slot in a2a_push_schedule(n)[rank]:
        slots[p][slot, :rows[p]] = send[p, :rows[p]]
    ctx.barrier(rank, what)
    out = torch.zeros_like(send)
    for q, r in enumerate(live_rows(recv_splits, cap, block)):
        out[q, :r] = slots[rank][q, :r]
    return out, recv_splits


def fast_all_to_all_local(send_buf: torch.Tensor, send_splits: torch.Tensor,
                          axis: str = "tp", num_ranks: int | None = None,
                          block_rows: int | None = None):
    """Rank-local AllToAll inside ``DistContext.run`` (reference
    ``fast_all_to_all``). send_buf: (n, cap, hidden), slot p the tokens
    for rank p's experts; send_splits: (n, epr) token counts per
    destination expert. Returns (recv_buf (n, cap, hidden), recv_splits
    (n, epr) int32): slot p what rank p sent, ``recv_splits[p, j]`` the
    tokens rank p sent to this rank's j-th expert.

    On a card, the push protocol (kernel ``tdt_a2a``): each receiver
    publishes its fresh output and splits with the call's epoch; each
    sender writes every slot's live rows into slot ``rank`` of its
    receiver's output, its splits rows beside them, and releases its data
    words. Only the ``"a2a"`` pad is kept. On the CPU the splits go
    through the group's all-to-all and the live blocks through a symmetric
    (n, cap, hidden) buffer's slots."""
    ctx, rank, n = rank_of(axis, num_ranks)
    block = _check(send_buf, send_splits, n, block_rows)
    send_splits = send_splits.to(torch.int32)
    if n == 1:
        return send_buf, send_splits
    _, cap, hidden = send_buf.shape
    if send_buf.device.type == "cuda":
        x = check_payload(ctx, rank, send_buf, "all_to_all", copy=True,
                          dims=3)
        spl = send_splits.contiguous()
        out = torch.empty_like(x)
        out_splits = torch.empty_like(spl)
        launch_push(A2A_KERNEL, symm_pad(ctx, tag="a2a"), rank, x, out,
                    hidden * x.element_size(), ptr(spl), ptr(out_splits),
                    cap, block, spl.shape[1],
                    grid_bytes=x.numel() * x.element_size(),
                    layout=A2A_LAYOUT)
        return out, out_splits
    if send_buf.device.type != "cpu":
        raise ValueError(f"all_to_all: no kernel for device "
                         f"{send_buf.device}")
    A2A_KERNEL.count_plain()
    nb = n * cap * hidden * send_buf.element_size()
    buf = symm_zeros(ctx, (nb,), torch.uint8, tag="a2a")
    slots = [t.view(send_buf.dtype).view(n, cap, hidden)
             for t in buf.tensors]
    return _plain_local(ctx, rank, n, send_buf, send_splits, block, slots,
                        "a2a.data")


@dataclasses.dataclass
class A2AStreamWorkspace:
    """The persistent workspace of :func:`fast_all_to_all_stream` and the
    shape it was made for. On the card ``buf`` is the push protocol's
    signal pad (no payload: the senders write the receivers' outputs); on
    the CPU, where the plain version meets through slots, a symmetric byte
    buffer of two parity slabs, each n slots of (cap, hidden) ``dtype``
    rows then n splits rows of :data:`STREAM_SPLITS` int32.
    ``epochs[r]``: rank r's next call index."""

    buf: SymmBuffer
    n: int
    cap: int
    hidden: int
    dtype: torch.dtype

    @property
    def shape(self) -> tuple:
        return (2, self.n, self.cap, self.hidden)

    @property
    def epochs(self) -> list:
        return self.buf.epochs

    def slab_bytes(self) -> int:
        item = torch.empty((), dtype=self.dtype).element_size()
        return (self.n * self.cap * self.hidden * item
                + self.n * STREAM_SPLITS * 4)

    def slots(self, rank: int, parity: int) -> torch.Tensor:
        """Rank ``rank``'s (n, cap, hidden) slots of ``parity`` (the CPU
        workspace)."""
        item = torch.empty((), dtype=self.dtype).element_size()
        nb = self.n * self.cap * self.hidden * item
        t = self.buf.tensors[rank][parity * self.slab_bytes():][:nb]
        return t.view(self.dtype).view(self.n, self.cap, self.hidden)


def a2a_stream_workspace(n: int, cap: int, hidden: int, dtype, *,
                         ctx: DistContext | None = None,
                         tag: str = "a2a_stream"
                         ) -> tuple[A2AStreamWorkspace, int]:
    """The persistent (workspace, call_index) pair of
    :func:`fast_all_to_all_stream`, allocated once per (shape, dtype, tag)
    on the context; the call index is the workspace's next. Thread both
    through the decode loop; give each stream of calls (an engine, a
    layer owner) its own ``tag``."""
    ctx = ctx or get_context()
    if ctx.num_ranks != n:
        raise ValueError(f"n = {n} but the rank group has {ctx.num_ranks}")
    key = f"{tag}-{n}x{cap}x{hidden}-{dtype}"
    if ctx.is_cuda:
        buf = symm_pad(ctx, tag=key)
    else:
        item = torch.empty((), dtype=dtype).element_size()
        slab = n * cap * hidden * item + n * STREAM_SPLITS * 4
        buf = symm_zeros(ctx, (2 * slab,), torch.uint8, tag=key)
    ws = A2AStreamWorkspace(buf, n, cap, hidden, dtype)
    return ws, ws.epochs[0]


def a2a_push_schedule(n: int) -> list:
    """The stream kernel's writes, a sender each: (receiver, slot) pairs in
    the order the sender's blocks write them — its own slot first, then
    receivers me+1 ... me-1, each at slot ``me`` of the receiver's output
    and row ``me`` of its splits."""
    return [[((me + i) % n, me) for i in range(n)] for me in range(n)]


def fast_all_to_all_stream(send_buf: torch.Tensor, send_splits: torch.Tensor,
                           ws: A2AStreamWorkspace, call_index: int, *,
                           axis: str = "tp", num_ranks: int | None = None,
                           block_rows: int | None = None,
                           straggler: tuple | None = None,
                           force_kernel: bool = False,
                           out: torch.Tensor | None = None,
                           out_splits: torch.Tensor | None = None):
    """Barrier-free steady-state AllToAll (the EP decode path; kernel
    ``tdt_a2a_parity``): the contract of :func:`fast_all_to_all_local`
    plus the threaded (ws, call_index) pair of :func:`a2a_stream_workspace`.
    Returns (recv_buf, recv_splits, ws, call_index + 1). A call index out
    of sequence raises (a second stream of calls needs its own workspace
    tag). ``straggler``: hold a rank back (``chip_smoke``'s stress).
    ``force_kernel`` runs the kernel at n = 1 too. ``out`` /
    ``out_splits``: the outputs to write (a harness's sentinels), else
    fresh ones."""
    ctx, rank, n = rank_of(axis, num_ranks)
    send_splits = send_splits.to(torch.int32)
    if n == 1 and not force_kernel:
        return send_buf, send_splits, ws, call_index + 1
    block = _check(send_buf, send_splits, n, block_rows)
    _, cap, hidden = send_buf.shape
    if ws.shape != (2, n, cap, hidden):
        raise ValueError(f"workspace shape {ws.shape} != (2, {n}, {cap}, "
                         f"{hidden})")
    if ws.dtype != send_buf.dtype:
        raise ValueError(f"workspace dtype {ws.dtype} != payload "
                         f"{send_buf.dtype} — allocate a2a_stream_workspace "
                         "with the token dtype")
    if send_splits.shape[1] > STREAM_SPLITS:
        raise ValueError(f"{send_splits.shape[1]} experts a rank: the "
                         f"stream workspace holds {STREAM_SPLITS}")
    if call_index != ws.epochs[rank]:
        raise ValueError(
            f"fast_all_to_all_stream: call_index {call_index} on rank "
            f"{rank}, but this workspace's next call is {ws.epochs[rank]} — "
            "a (ws, call_index) pair must stay persistent and in sequence "
            "(a second stream of calls needs its own workspace tag)")
    if out is not None:
        out = check_out(ctx, rank, out, send_buf.shape, send_buf.dtype,
                        "all_to_all_stream")
    if out_splits is not None:
        out_splits = check_out(ctx, rank, out_splits, send_splits.shape,
                               torch.int32, "all_to_all_stream")
    straggle(straggler, n, rank, call_index)
    if send_buf.device.type == "cuda":
        x = check_payload(ctx, rank, send_buf, "all_to_all_stream",
                          copy=True, dims=3)
        spl = send_splits.contiguous()
        out = torch.empty_like(x) if out is None else out
        out_splits = torch.empty_like(spl) if out_splits is None \
            else out_splits
        # The pad's next epoch is call_index + 1: the kernel's flags.
        launch_push(A2A_PARITY_KERNEL, ws.buf, rank, x, out,
                    hidden * x.element_size(), ptr(spl), ptr(out_splits),
                    cap, block, spl.shape[1],
                    grid_bytes=x.numel() * x.element_size(),
                    block_bytes=A2A_BLOCK_BYTES, layout=A2A_LAYOUT)
        return out, out_splits, ws, call_index + 1
    if send_buf.device.type != "cpu":
        raise ValueError(f"all_to_all_stream: no kernel for device "
                         f"{send_buf.device}")
    A2A_PARITY_KERNEL.count_plain()
    ws.epochs[rank] = call_index + 1
    p = call_index % 2
    slots = [ws.slots(r, p) for r in range(n)]
    recv, recv_splits = _plain_local(ctx, rank, n, send_buf, send_splits,
                                     block, slots, "a2a_stream.data")
    if out is not None:
        out.copy_(recv)
        recv = out
    if out_splits is not None:
        out_splits.copy_(recv_splits)
        recv_splits = out_splits
    return recv, recv_splits, ws, call_index + 1


def fast_all_to_all(send_buf, send_splits, ctx: DistContext | None = None,
                    axis: str = "tp", block_rows: int | None = None):
    """Host-level AllToAll. ``send_buf``: (n, n, cap, hidden) — [d, p]
    rank d's tokens for rank p — or a list of the n ranks' (n, cap,
    hidden); ``send_splits``: (n, n, epr) or a list. Returns (recv_bufs,
    recv_splits), two lists of the n ranks' results, rank r's on
    ``ctx.devices[r]``: [p] of rank d's is what rank p sent it.

    With comm tuning opted in (``TDTPU_AUTOTUNE_COMM=1``), a None
    ``block_rows`` resolves by measurement over the aligned candidates
    (``runtime/autotuner.tuned_a2a_block_rows``)."""
    ctx = ctx or get_context()
    n = ctx.axis_size(axis)
    sends = list(send_buf) if isinstance(send_buf, (list, tuple)) else list(
        send_buf.unbind(0))
    splits = list(send_splits) if isinstance(send_splits, (list, tuple)) \
        else list(send_splits.unbind(0))
    if len(sends) != n or len(splits) != n:
        raise ValueError(f"{len(sends)} send buffers, {len(splits)} splits "
                         f"for {n} ranks")
    if block_rows is None and n > 1:
        from triton_distributed_tpu_torch.runtime.autotuner import (
            comm_autotune_enabled, tuned_a2a_block_rows,
        )

        if comm_autotune_enabled(ctx.devices[0]):
            block_rows = tuned_a2a_block_rows(sends, splits, ctx, axis=axis)
    outs = ctx.run(lambda r: fast_all_to_all_local(
        sends[r].to(ctx.devices[r]), splits[r].to(ctx.devices[r]),
        axis=axis, num_ranks=n, block_rows=block_rows))
    ctx.raise_on_comm_error()
    return [o[0] for o in outs], [o[1] for o in outs]


# ---------------------------------------------------------------------------
# Token layout helpers (the reference's pre-sorted input contract and its
# moe_utils.cu alignment, as the JAX package writes them: a stable sort and
# counts instead of a CUDA kernel).
# ---------------------------------------------------------------------------


class DispatchLayout(NamedTuple):
    """AllToAll send layout + the coordinates to invert it after combine."""

    send_buf: torch.Tensor     # (n, cap, hidden)
    send_splits: torch.Tensor  # (n, epr) int32
    sort_idx: torch.Tensor     # (m,) — expert-stable sort permutation
    sorted_rank: torch.Tensor  # (m,) — dest rank of sorted token i
    pos_in_slot: torch.Tensor  # (m,) — its row within that rank's slot
    overflow: torch.Tensor     # int32 — token copies dropped by the cap


def dispatch_layout(tokens: torch.Tensor, expert_ids: torch.Tensor,
                    num_experts: int, num_ranks: int, cap: int
                    ) -> DispatchLayout:
    """The AllToAll send layout of flat tokens (m, hidden) and their global
    experts (m,) (tokens replicated beforehand for top-k > 1): the tokens
    for one rank packed at the head of its slot, sorted by expert. Tokens
    past ``cap`` a rank are dropped and counted in ``overflow``, and the
    splits are clamped to what the slot holds (per-expert groups are
    packed in order, so the receiver never reads past the slot)."""
    m, hidden = tokens.shape
    n = num_ranks
    epr = num_experts // n
    ids = expert_ids.reshape(-1).long()
    dest = ids // epr
    sort_idx = torch.argsort(ids, stable=True)
    sorted_tokens = tokens[sort_idx]
    sorted_rank = dest[sort_idx]
    rank_counts = torch.bincount(dest, minlength=n)
    rank_starts = torch.cumsum(rank_counts, 0) - rank_counts
    pos_in_slot = (torch.arange(m, device=tokens.device)
                   - rank_starts[sorted_rank])
    # Dropped copies land in one extra row past the slots (no host read).
    keep = pos_in_slot < cap
    flat = torch.where(keep, sorted_rank * cap + pos_in_slot,
                       torch.full_like(pos_in_slot, n * cap))
    rows = tokens.new_zeros((n * cap + 1, hidden))
    rows[flat] = sorted_tokens
    send_buf = rows[:n * cap].view(n, cap, hidden)
    overflow = (~keep).sum().to(torch.int32)
    within = torch.bincount(ids, minlength=num_experts).reshape(n, epr)
    group_starts = torch.cumsum(within, 1) - within
    send_splits = torch.minimum(torch.clamp(cap - group_starts, min=0),
                                within).to(torch.int32)
    return DispatchLayout(send_buf, send_splits, sort_idx, sorted_rank,
                          pos_in_slot, overflow)


def combine_layout(recv_buf: torch.Tensor, recv_splits: torch.Tensor):
    """Flatten an AllToAll receive layout for the local expert MLP
    (reference ``all_to_all_post_process``). recv_buf: (n, cap, hidden);
    recv_splits: (n, epr). Returns (flat tokens (n·cap, hidden), local
    expert ids (n·cap,) int32 — ``epr`` marks padding rows —, group sizes
    (epr,) int32)."""
    n, cap, hidden = recv_buf.shape
    epr = recv_splits.shape[1]
    bounds = torch.cumsum(recv_splits.to(torch.int32), 1)        # (n, epr)
    rows = torch.arange(cap, device=recv_buf.device, dtype=torch.int32)
    eid = (rows[None, :, None] >= bounds[:, None, :]).sum(-1)     # (n, cap)
    valid = rows[None, :] < bounds[:, -1][:, None]
    eid = torch.where(valid, eid, torch.full_like(eid, epr)).to(torch.int32)
    group_sizes = recv_splits.sum(0).to(torch.int32)
    return recv_buf.reshape(n * cap, hidden), eid.reshape(-1), group_sizes
