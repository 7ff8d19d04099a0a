"""B5's one-shot AllReduce on the push protocol (``csrc/collectives.cu``
ar_one_shot: every rank reads every rank's input, no entry barrier and no
slot workspace) and the megakernel's in-kernel AllReduce
(``csrc/megakernel.cu`` t_allreduce: per-block flags over two parity slot
sets, no grid or exit barrier of its own) on the CPU: the host side of
both — the one-shot's launch arguments, grid, pad and buffers; the
megakernel's flag scope, flag words, slot sets, parity sequence and the
barriers its queue must hold — computed in Python so that it is checked
here; and both plain versions through the rank threads.

The port's ranks are CPU threads. Tolerance: bit for bit everywhere — both
sums run in rank order in fp32 from 0 and round once.
``tests/test_torch_collectives.py`` holds the one-shot's plain version
against the JAX package's one-shot ``all_reduce``; no JAX program runs
here.
"""

import pathlib
import re
import types

import numpy as np
import pytest
import torch

from triton_distributed_tpu_torch.megakernel import kernel as mk
from triton_distributed_tpu_torch.megakernel.builder import (
    MegaKernelBuilder,
)
from triton_distributed_tpu_torch.megakernel.tasks import TILE, Task, TaskType
from triton_distributed_tpu_torch.ops import _comm
from triton_distributed_tpu_torch.ops import allreduce as tar
from triton_distributed_tpu_torch.runtime.context import DistContext
from triton_distributed_tpu_torch.runtime.symm import SIGNAL_WORDS, symm_zeros

BF, F32 = torch.bfloat16, torch.float32
H100_SMS = 132
PORT = pathlib.Path(_comm.__file__).resolve().parents[1]
AR = (int(TaskType.ALLREDUCE), int(TaskType.ALLREDUCE_ROW))
_CTX: dict = {}


def tctx(n: int) -> DistContext:
    if n not in _CTX:
        _CTX[n] = DistContext([torch.device("cpu")] * n,
                              wait_timeout_ms=60_000)
    return _CTX[n]


def _x(shape, dtype, seed) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32)).to(dtype)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.uint8)


# ---------------------------------------------------------------------------
# The one-shot's launch on stand-ins for CUDA tensors.
# ---------------------------------------------------------------------------

class _FakeCuda:
    """A stand-in for a CUDA tensor: what the wrapper reads of it."""

    def __init__(self, shape, dtype=BF):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.device = types.SimpleNamespace(type="cuda")

    def dim(self):
        return len(self.shape)

    def element_size(self):
        return torch.empty((), dtype=self.dtype).element_size()

    def numel(self):
        return int(np.prod(self.shape))


class _TorchOut:
    """``torch`` for the wrapper's module: ``empty_like`` returns ("out",
    t) (the stand-ins have no memory to allocate on)."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def empty_like(t):
        return ("out", t)


def _drive(monkeypatch, n, rank, caps=33, cards=1):
    """Patch the wrapper's module for stand-ins on ``cards`` cards: the
    meeting records each launch's (kernel, pad tag, args); ``symm_zeros``
    fails (no payload buffer on the CUDA path); ``symm_pad`` hands out one
    pad a tag. Returns (launches, pads)."""
    seen, pads = [], {}
    ctx = types.SimpleNamespace(
        num_ranks=n, timeout_s=1.0, error_word=lambda r: None, is_cuda=True,
        devices=[torch.device(f"cuda:{r % cards}") for r in range(n)])

    def meeting(kernel, pad, r, dev, what, args, variants=()):
        seen.append((kernel, pad.tag, list(args)))

    def pad_for(c, tag):
        epochs = [0] * n

        def next_epoch(r):
            epochs[r] += 1
            return epochs[r]

        return pads.setdefault(tag, types.SimpleNamespace(
            ctx=c, tag=tag, table=[None] * n, signal_table=[None] * n,
            epochs=epochs, next_epoch=next_epoch))

    monkeypatch.setattr(_comm, "_launch_at_meeting", meeting)
    monkeypatch.setattr(_comm, "_sm_caps", lambda c: [caps])
    monkeypatch.setattr(_comm, "current_stream", lambda dev: "stream")
    monkeypatch.setattr(_comm, "ptr", lambda t: t)
    monkeypatch.setattr(tar, "symm_zeros", lambda *a, **k: pytest.fail(
        "the CUDA path asked for a payload buffer"))
    monkeypatch.setattr(tar, "symm_pad", pad_for)
    monkeypatch.setattr(tar, "rank_of", lambda axis, num: (ctx, rank, n))
    monkeypatch.setattr(tar, "check_payload", lambda c, r, x, *a, **k: x)
    monkeypatch.setattr(tar, "torch", _TorchOut())
    return seen, pads


@pytest.mark.parametrize("rank", [0, 3])
@pytest.mark.parametrize("dtype", [F32, BF], ids=str)
def test_one_shot_launch_arguments_and_no_payload_buffer(monkeypatch, rank,
                                                         dtype):
    """The one-shot's CUDA path asks for the ``"ar_one_shot"`` pad and no
    payload buffer, and hands ``tdt_ar_one_shot`` exactly its argument
    list: the group's (rank, n, the pad's next epoch), the input, the
    fresh output and the payload's bytes, the dtype code, then the grid
    (``push_grid`` over the payload at AR_ONE_SHOT_BLOCK_BYTES a block),
    the GPU's scope on one card and PUSH_LAYOUT's words, the stream last;
    a second call takes the next epoch."""
    n, m, cols = 4, 16, 4096
    seen, pads = _drive(monkeypatch, n, rank)
    x = _FakeCuda((m, cols), dtype)
    for _ in range(2):
        assert tar.all_reduce_local(x, num_ranks=n,
                                    method="one_shot") == ("out", x)
    assert list(pads) == ["ar_one_shot"]
    nbytes = m * cols * x.element_size()
    grid = _comm.push_grid(nbytes, [33], _comm.AR_ONE_SHOT_BLOCK_BYTES)
    assert len(seen) == 2
    for call, (kernel, ptag, args) in enumerate(seen):
        assert kernel is _comm.ONE_SHOT_KERNEL and ptag == "ar_one_shot"
        assert len(args) == len(_comm.ONE_SHOT_KERNEL.argtypes)
        assert args[3:6] == [rank, n, call + 1]
        assert args[7:11] == [x, ("out", x), nbytes, _comm.DTYPE_CODE[dtype]]
        assert args[11:-1] == [grid, 0, *_comm.PUSH_LAYOUT.args()]
        assert args[-1] == "stream"


def test_one_shot_scope_across_cards(monkeypatch):
    """A group whose ranks sit on four cards raises the flags at the
    system's scope (``push_scope``: 1), one card at the GPU's (0)."""
    for cards, scope in ((1, 0), (4, 1)):
        seen, _ = _drive(monkeypatch, 4, 1, cards=cards)
        tar.all_reduce_local(_FakeCuda((16, 4096)), num_ranks=4,
                             method="one_shot")
        assert seen[0][2][12] == scope


# (rows, cols) a rank: one 16-byte vector, the decode step's 4 rows, the
# verify step's 16, an odd tail, 2048 rows.
ONE_SHOT_SHAPES = ((1, 8), (4, 4096), (16, 4096), (3, 1000), (2048, 4096))


@pytest.mark.parametrize("ranks_on_card", [1, 2, 4, 8])
def test_one_shot_grid_same_on_every_rank(monkeypatch, ranks_on_card):
    """Through the wrapper itself: every rank of a group of 4 hands its C
    entry the same grid at every shape, within 1/r of an H100's 132 SMs
    (the cap 132 // r) and ``PUSH_MAX_BLOCKS``; at 4 ranks a card the
    verify step's 16 x 4096 bf16 (128 KiB) takes a block per
    AR_ONE_SHOT_BLOCK_BYTES and 2048 rows (16 MiB) the cap of 33."""
    n, cap = 4, H100_SMS // ranks_on_card
    for rows, cols in ONE_SHOT_SHAPES:
        grids = set()
        for rank in range(n):
            seen, _ = _drive(monkeypatch, n, rank, cap)
            tar.all_reduce_local(_FakeCuda((rows, cols)), num_ranks=n,
                                 method="one_shot")
            grids.add(seen[0][2][11])
        assert len(grids) == 1
        g = grids.pop()
        assert 1 <= g <= min(cap, _comm.PUSH_MAX_BLOCKS)
        assert g == _comm.push_grid(rows * cols * 2, [cap],
                                    _comm.AR_ONE_SHOT_BLOCK_BYTES)
    if ranks_on_card == 4:
        block = _comm.AR_ONE_SHOT_BLOCK_BYTES
        assert _comm.push_grid(16 * 4096 * 2, [cap], block) == min(
            cap, -(-(16 * 4096 * 2) // block))
        assert _comm.push_grid(2048 * 4096 * 2, [cap], block) == 33


def test_one_shot_pad_words_and_tag():
    """The one-shot's words at n = 2-8 and every grid up to the cap lie
    inside ``SIGNAL_WORDS`` in three disjoint ranges (as ``push.cuh``
    bad_layout checks), and its pad's tag ``"ar_one_shot"`` is its own:
    no other wrapper of the port asks ``symm_pad`` for it, so its epochs
    count one kernel's calls."""
    lay = _comm.PUSH_LAYOUT
    for n in range(2, 9):
        for grid in (1, 16, 33, _comm.PUSH_MAX_BLOCKS):
            words = lay.words(n, grid)
            flat = [w for ws in words.values() for w in ws]
            assert len(flat) == len(set(flat)) == 2 * n + n * grid
            assert 0 <= min(flat) and max(flat) < SIGNAL_WORDS
    tags = []
    for path in sorted(PORT.rglob("*.py")):
        tags += re.findall(r'symm_pad\(\s*\w+,\s*tag="([^"]+)"\)',
                           path.read_text())
    assert tags.count("ar_one_shot") == 1


@pytest.mark.parametrize("dtype", [F32, BF], ids=str)
@pytest.mark.parametrize("n", [2, 3, 4])
def test_one_shot_plain_equals_reduce_slots(n, dtype):
    """The rank threads' one-shot (the plain version, meeting through the
    slots of its own buffer) gives every rank ``reduce_slots_plain``'s sum
    bit for bit at one vector, an odd tail and the verify step's rows,
    twice in a row with new inputs; the counter counts each call."""
    ctx = tctx(n)
    cols = 16 // torch.empty((), dtype=dtype).element_size()
    for i, (rows, c) in enumerate(((1, cols), (3, 5 * cols), (16, 128))):
        calls = [[_x((rows, c), dtype, 100 * n + 10 * i + 2 * t + r)
                  for r in range(n)] for t in range(2)]
        before = _comm.ONE_SHOT_KERNEL.plain_calls
        got = ctx.run(lambda r: [tar.all_reduce_local(
            xs[r], num_ranks=n, method="one_shot") for xs in calls])
        assert _comm.ONE_SHOT_KERNEL.plain_calls - before == 2 * n
        for t, xs in enumerate(calls):
            want = tar.reduce_slots_plain(xs)
            assert all(torch.equal(_bits(g[t]), _bits(want)) for g in got)


# ---------------------------------------------------------------------------
# The megakernel's AllReduce: scope, flag words, slot sets, parity order.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_ar_scope_follows_ranks_on_card(n):
    """The flags' scope is the GPU's exactly when every rank of the group
    is on this card (``ranks_on_card == num_ranks``), the system's when a
    peer is on another."""
    assert mk.ar_scope(n, n) == 0
    for on_card in range(1, n):
        assert mk.ar_scope(on_card, n) == 1


def test_ar_flag_words_fit_the_pad():
    """The flag words a (parity, source) are the largest grid any body can
    take on an H100 with r ranks of the group on it (two blocks an SM on
    132 // r SMs: 264 at one rank, 66 at 4, 32 at 8), at least each body's
    grid; ``2 * n * stride`` words fit the pad for every n <= 8 and every
    r <= n (one card a rank up to all on one card); a stride past the pad
    raises."""
    assert mk.ar_flag_stride(H100_SMS, 1) == 264
    assert mk.ar_flag_stride(H100_SMS, 4) == 66
    assert mk.ar_flag_stride(H100_SMS, 8) == 32
    for n in range(1, 9):
        for r in range(1, n + 1):
            stride = mk.ar_flag_stride(H100_SMS, r)
            for per_sm in (1, 2):          # full bodies 1, the lean body 2
                assert per_sm * (H100_SMS // r) <= stride
            assert mk.ar_flag_words(n, stride) == 2 * n * stride
            assert 2 * n * stride <= SIGNAL_WORDS
    with pytest.raises(ValueError, match="flag words"):
        mk.ar_flag_words(8, SIGNAL_WORDS // 8)


def test_ar_slots_two_sets_on_the_card(monkeypatch):
    """On the card the slot buffer holds two parity sets, (2, n, max_ar,
    TILE, TILE): 8 MiB a rank at n = 4, max_ar 32 (Qwen3-8B's row), bf16;
    on the CPU one set, which the plain version's meetings order."""
    asked = []
    monkeypatch.setattr(mk, "symm_zeros",
                        lambda c, shape, dtype, tag: asked.append(
                            (tuple(shape), dtype, tag)))
    mk.ar_slots(types.SimpleNamespace(is_cuda=True), 4, 32, BF, "d")
    mk.ar_slots(types.SimpleNamespace(is_cuda=False), 4, 32, BF, "d")
    assert asked == [((2, 4, 32, TILE, TILE), BF, "megakernel-ar-d"),
                     ((4, 32, TILE, TILE), BF, "megakernel-ar-d")]
    assert np.prod(asked[0][0]) * 2 == 8 << 20


@pytest.mark.parametrize("sites", [1, 2, 3])
def test_ar_parity_sets_alternate_across_launches(sites):
    """Consecutive launches of one ArGroup with ``sites`` AllReduce rows
    each (an odd number included): the rows' epochs run on without a gap
    or a repeat, so the slot set ``epoch & 1`` alternates from row to row,
    across launch boundaries too, on every rank alike."""
    ctx = tctx(2)
    slots = symm_zeros(ctx, (1,), F32, tag=f"parity-seq-{sites}")
    groups = [mk.ArGroup(ctx, r, 2, slots, sites=sites) for r in range(2)]
    seqs = []
    for g in groups:
        epochs = []
        for _ in range(5):
            base = g.next_epochs()
            epochs += [base + k for k in range(sites)]
        seqs.append(epochs)
    assert seqs[0] == seqs[1] == list(range(1, 5 * sites + 1))
    sets = [e & 1 for e in seqs[0]]
    assert all(a != b for a, b in zip(sets, sets[1:]))


def _two_ar_program(n, single=True, force_ar=False):
    """chip_smoke.mk_ar_program's shape: ALLREDUCE_ROW over 3 tiles and the
    one-tile ALLREDUCE, with no hazard between them."""
    mb = MegaKernelBuilder()
    mb.all_reduce(mb.tensor(TILE, 3 * TILE))
    if single:
        t = mb.tensor(TILE, TILE).tile(0, 0)
        mb._emit(Task(TaskType.ALLREDUCE, t), [t], [t])
    return mb.compile(dtype=F32, num_ranks=n, force_ar=force_ar)


def test_ar_rows_never_share_a_barrier_interval():
    """Two AllReduce rows with no hazard between them still get a grid
    barrier between them (``barrier_rows``), which ``check_ar_barriers``
    holds the launch's queue to; a queue without it is refused by name."""
    comp = _two_ar_program(2)
    rows = np.flatnonzero(np.isin(comp.queue[:comp.num_exec, 0], AR))
    assert len(rows) == 2 and not comp.hazard_edges
    assert comp.sync_before[rows[1]] == 1
    mk.check_ar_barriers(comp.queue, comp.num_exec, comp.sync_before)
    bare = np.zeros_like(comp.sync_before)
    with pytest.raises(ValueError, match="share a barrier interval"):
        mk.check_ar_barriers(comp.queue, comp.num_exec, bare)
    one = _two_ar_program(2, single=False)
    mk.check_ar_barriers(one.queue, one.num_exec,
                         np.zeros_like(one.sync_before))


@pytest.mark.parametrize("n", [1, 2, 4])
def test_plain_ar_over_two_sets(n):
    """The plain version on a slot buffer of the card's layout (two sets,
    as ``ar_slots`` makes on CUDA tensors) meets through set 0 and gives
    every rank the rank-order fp32 sum rounded once, bit for bit, twice in
    a row (at n = 1 under ``force_ar``: the rank's own tiles)."""
    comp = _two_ar_program(n, force_ar=n == 1)
    assert comp.num_tiles == 4                 # every tile in an AR row
    ctx = DistContext([torch.device("cpu")] * n, wait_timeout_ms=60_000)
    slots = symm_zeros(ctx, (2, n, comp.max_ar, TILE, TILE), BF,
                       tag="two-sets")
    for it in range(2):
        X = _x((n, comp.num_tiles, TILE, TILE), BF, 40 + 10 * n + it)
        ws = [X[r].clone() for r in range(n)]

        def run(r):
            group = mk.ArGroup(ctx, r, n, slots, sites=2)
            mk.run_queue_plain(comp.queue, ws[r], None,
                               num_exec=comp.num_exec, mat_specs=(),
                               group=group)

        ctx.run(run)
        want = tar.reduce_slots_plain(list(X))
        for r in range(n):
            assert torch.equal(_bits(ws[r]), _bits(want))
        assert torch.count_nonzero(slots.tensors[0][1]) == 0
    ctx.close()
