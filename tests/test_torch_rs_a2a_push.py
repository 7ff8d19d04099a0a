"""B6's ring reduce-scatter and B8's parity AllToAll on the push protocol
(``csrc/push.cuh``, ``csrc/collectives.cu`` rs_ring, ``csrc/all_to_all.cu``
a2a_push) on the CPU: the host side of the card's launch — the pad
layouts, the grids, the argument lists, the buffers asked for — computed
in Python so that it is checked here; B6's read schedule (each owner reads
each source's chunk once, in the ring's order) against the ring's hops
simulated with their relay slots; B8's write schedule (one writer a slot
and splits row); and the plain versions through the rank threads.

The port's ranks are CPU threads. Tolerance: bit for bit everywhere — the
AllToAll moves bytes, and the reduce-scatter keeps the ring's order and
rounding (fp32 adds, one rounding to the payload type an add).
``tests/test_torch_collectives.py`` and ``tests/test_torch_all_to_all.py``
hold both plain versions against the JAX package's kernels.
"""

import types

import numpy as np
import pytest
import torch

from triton_distributed_tpu_torch.ops import _comm
from triton_distributed_tpu_torch.ops import all_to_all as ta2a
from triton_distributed_tpu_torch.ops import reduce_scatter as trs
from triton_distributed_tpu_torch.runtime.context import DistContext
from triton_distributed_tpu_torch.runtime.symm import SIGNAL_WORDS

COLS = 64
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
# The host side of the launch.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["push", "a2a"])
def test_layout_words_fit_the_pad_and_stay_apart(layout):
    """Every word of B6's layout (``PUSH_LAYOUT``) and of B8's
    (``A2A_LAYOUT``: a second address word a receiver, its splits) lies
    inside ``SIGNAL_WORDS`` and the kinds' ranges are disjoint, for n = 2-8
    and every grid up to the cap; the C entries' checks hold
    (``push.cuh`` bad_layout, ``all_to_all.cu``: addr < splits < ready)."""
    lay = _comm.PUSH_LAYOUT if layout == "push" else _comm.A2A_LAYOUT
    cap = _comm.PUSH_MAX_BLOCKS
    kinds = 3 if layout == "push" else 4
    for n in range(2, 9):
        for grid in range(1, cap + 1):
            words = lay.words(n, grid)
            assert len(words) == kinds
            flat = [w for ws in words.values() for w in ws]
            assert len(flat) == len(set(flat)) == (kinds - 1) * n + n * grid
            assert 0 <= min(flat) and max(flat) < SIGNAL_WORDS
        ranges = sorted((min(ws), max(ws))
                        for ws in lay.words(n, cap).values())
        assert all(a[1] < b[0] for a, b in zip(ranges, ranges[1:]))
    n = _comm.MAX_RANKS
    assert lay.stride >= cap and lay.data + n * lay.stride <= SIGNAL_WORDS
    assert lay.ready >= lay.addr + n and lay.data >= lay.ready + n
    args = lay.args()
    if layout == "a2a":
        assert args == (lay.addr, lay.splits, lay.ready, lay.data, lay.stride)
        assert lay.addr + n <= lay.splits and lay.splits + n <= lay.ready
    else:
        assert args == (lay.addr, lay.ready, lay.data, lay.stride)


@pytest.mark.parametrize("ranks_on_card", [1, 2, 4, 8])
def test_grids_same_on_every_rank(ranks_on_card):
    """Both grids are ``push_grid`` over bytes every rank shares — B6 over
    its input (n chunks) at a block per 64 KiB, B8 over its send buffer (n
    slots of cap rows, not the live rows) at a block per 16 KiB — so every
    rank computes the same one, within 1/r of the SMs. Main shapes on an
    H100 (132 SMs) at 4 ranks: B6's 256 x 4096 bf16 input (2 MiB) 32
    blocks; B8's cap 32 x 2048 bf16, 4 slots (512 KiB) 32 blocks."""
    cap = 132 // ranks_on_card
    for block in (_comm.PUSH_BLOCK_BYTES, _comm.A2A_BLOCK_BYTES):
        for n in (2, 4, 8):
            for rows, cols, item in ((1, 4, 4), (3, 1000, 2),
                                     (256, 4096, 2), (2048, 4096, 4)):
                grids = {_comm.push_grid(n * rows * cols * item, [cap],
                                         block) for _ in range(n)}
                assert len(grids) == 1
                g = grids.pop()
                assert 1 <= g <= min(cap, _comm.PUSH_MAX_BLOCKS)
    if ranks_on_card == 4:
        assert _comm.push_grid(256 * 4096 * 2, [cap]) == 32
        assert _comm.push_grid(4 * 32 * 2048 * 2, [cap],
                               _comm.A2A_BLOCK_BYTES) == 32
        assert _comm.push_grid(2048 * 4096 * 4, [cap]) == cap == 33


class _FakeCuda:
    """A stand-in for a CUDA tensor: what the wrappers read of it."""

    def __init__(self, shape, dtype=torch.bfloat16, item=2):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.device = types.SimpleNamespace(type="cuda")
        self._item = item

    def dim(self):
        return len(self.shape)

    def element_size(self):
        return self._item

    def numel(self):
        return int(np.prod(self.shape))

    def to(self, *a, **k):
        return self

    def contiguous(self):
        return self

    def data_ptr(self):
        return 4096


def _fake_stream_call(monkeypatch, n, rank, cap, hidden, epr):
    """Run the CUDA path of ``fast_all_to_all_stream`` on stand-ins, its
    launch captured: returns (launch_push's args, kwargs)."""
    seen = []
    ctx = types.SimpleNamespace(num_ranks=n, is_cuda=True)
    monkeypatch.setattr(ta2a, "rank_of", lambda axis, num: (ctx, rank, n))
    monkeypatch.setattr(ta2a, "check_payload", lambda c, r, x, *a, **k: x)
    monkeypatch.setattr(ta2a, "launch_push",
                        lambda *a, **k: seen.append((a, k)))
    ws = ta2a.A2AStreamWorkspace(
        types.SimpleNamespace(epochs=[0] * n), n, cap, hidden,
        torch.bfloat16)
    send = _FakeCuda((n, cap, hidden))
    spl = _FakeCuda((n, epr), torch.int32, 4)
    spl.device = send.device
    with monkeypatch.context() as m:
        m.setattr(ta2a.torch, "empty_like", lambda t: t)
        ta2a.fast_all_to_all_stream(send, spl, ws, 0, num_ranks=n)
    return seen


def test_cuda_paths_ask_for_no_relay_workspace(monkeypatch):
    """No relay slots and no parity slab: B6's CUDA path asks
    ``symm_zeros`` for nothing (only the ``"rs_ring"`` pad) and launches
    its kernel on the push protocol, with its input as the published
    payload and the grid sized by the input's bytes; B8's stream workspace
    on a card is the pad alone, its launch A2A_LAYOUT's."""
    asked, launched = [], []
    for mod in (trs, ta2a):
        monkeypatch.setattr(mod, "symm_zeros",
                            lambda ctx, shape, dtype, tag: asked.append(tag))
        monkeypatch.setattr(mod, "symm_pad", lambda ctx, tag: (
            types.SimpleNamespace(pad=tag, epochs=[0] * 4)))
    monkeypatch.setattr(trs, "check_payload", lambda c, r, x, *a, **k: x)
    monkeypatch.setattr(trs, "launch_push",
                        lambda *a, **k: launched.append((a, k)))
    x = _FakeCuda((4 * 64, 4096))
    with monkeypatch.context() as m:
        m.setattr(trs.torch, "empty", lambda *a, **k: "out")
        assert trs._rs_ring(x, 4, None, 2) == "out"
    (a, k), = launched
    assert a[0] is _comm.RS_RING_KERNEL and a[1].pad == "rs_ring"
    assert a[2:5] == (2, x, "out")
    assert a[5:] == (64 * 4096 * 2, _comm.DTYPE_CODE[torch.bfloat16])
    assert k == {"grid_bytes": 256 * 4096 * 2}
    ctx = types.SimpleNamespace(num_ranks=4, is_cuda=True)
    ws, idx = ta2a.a2a_stream_workspace(4, 32, 2048, torch.bfloat16,
                                        ctx=ctx, tag="t")
    assert ws.buf.pad == "t-4x32x2048-torch.bfloat16" and idx == 0
    assert asked == []
    (a, k), = _fake_stream_call(monkeypatch, 4, 1, 32, 2048, 32)
    assert a[0] is _comm.A2A_PARITY_KERNEL
    assert k["layout"] is _comm.A2A_LAYOUT
    assert k["grid_bytes"] == 4 * 32 * 2048 * 2
    assert k["block_bytes"] == _comm.A2A_BLOCK_BYTES


def test_launch_arguments(monkeypatch):
    """Each launch hands its C entry exactly its argument list: the
    group's (the epoch the pad's next: B8's call index + 1), B6's dtype
    code / B8's splits, cap, block and experts a rank, then the grid, the
    flags' scope and the layout's words, the stream last."""
    seen = {}

    def fake_meeting(kernel, pad, rank, dev, what, args, variants=()):
        seen[kernel.symbol] = list(args)

    monkeypatch.setattr(_comm, "_launch_at_meeting", fake_meeting)
    monkeypatch.setattr(_comm, "_sm_caps", lambda ctx: [33])
    monkeypatch.setattr(_comm, "current_stream", lambda dev: "stream")
    monkeypatch.setattr(_comm, "ptr", lambda t: t)
    ctx = types.SimpleNamespace(
        devices=[torch.device("cuda:0")] * 4, num_ranks=4, timeout_s=1.0,
        error_word=lambda r: None)
    epochs = [4] * 4

    def next_epoch(r):
        epochs[r] += 1
        return epochs[r]

    pad = types.SimpleNamespace(ctx=ctx, table=[None] * 4,
                                signal_table=[None] * 4, epochs=epochs,
                                next_epoch=next_epoch)
    x = torch.empty(256, 4096, dtype=torch.bfloat16)
    _comm.launch_push(_comm.RS_RING_KERNEL, pad, 2, x, x, 64 * 4096 * 2, 1,
                      grid_bytes=256 * 4096 * 2)
    args = seen[_comm.RS_RING_KERNEL.symbol]
    assert len(args) == len(_comm.RS_RING_KERNEL.argtypes)
    assert args[3:6] == [2, 4, 5] and args[9:11] == [64 * 4096 * 2, 1]
    assert args[11:-1] == [32, 0, *_comm.PUSH_LAYOUT.args()]
    assert args[-1] == "stream"
    # B8: the wrapper's own launch, replayed into the real launch_push.
    (a, k), = _fake_stream_call(monkeypatch, 4, 2, 32, 2048, 32)
    _comm.launch_push(*a[:1], pad, *a[2:], **k)
    args = seen[_comm.A2A_PARITY_KERNEL.symbol]
    assert len(args) == len(_comm.A2A_PARITY_KERNEL.argtypes)
    assert args[3:6] == [2, 4, 6]
    assert args[9] == 2048 * 2 and args[12:15] == [32, 16, 32]
    assert args[15:-1] == [32, 0, *_comm.A2A_LAYOUT.args()]
    assert args[-1] == "stream"


# ---------------------------------------------------------------------------
# The schedules.
# ---------------------------------------------------------------------------

def _add(a, b):
    """One of the kernel's adds: fp32, rounded to the payload type."""
    return (a.float() + b.float()).to(a.dtype)


def _ring_hops(xs, n: int, m: int) -> list:
    """The ring's n-1 dependent hops through each rank's relay slots (the
    first B6 kernel and the reference's): at step s rank r passes chunk
    (r-1-s) mod n on, its own contribution added to what it received at
    step s-1; the owner adds its own last."""
    slots = [[None] * (n - 1) for _ in range(n)]
    for s in range(n - 1):
        for r in range(n):
            c = (r - 1 - s) % n
            own = xs[r][c * m:(c + 1) * m]
            slots[(r + 1) % n][s] = own if s == 0 else _add(
                slots[r][s - 1], own)
    return [_add(slots[r][n - 2], xs[r][r * m:(r + 1) * m])
            for r in range(n)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_rs_read_schedule_equals_the_ring(n, dtype):
    """B6's one hop: owner c reads each source's chunk c exactly once, in
    ``ring_order`` (rank c+1 first, its own last), and sums in that order
    with the kernel's adds — bit for bit the ring's n-1 hops through relay
    slots, and ``rs_ring_plain``, on every owner."""
    m = 3
    reads = {}
    for c in range(n):
        order = trs.ring_order(n, c)
        assert sorted(order) == list(range(n))
        assert order[0] == (c + 1) % n and order[-1] == c
        for j in order:
            reads.setdefault((j, c), []).append(c)
    assert sorted(reads) == [(j, c) for j in range(n) for c in range(n)]
    assert all(owners == [c] for (_, c), owners in reads.items())
    xs = [_x((n * m, COLS), dtype, 10 * n + r) for r in range(n)]
    hops = _ring_hops(xs, n, m)
    for c in range(n):
        first, *rest = trs.ring_order(n, c)
        acc = xs[first][c * m:(c + 1) * m]
        for j in rest:
            acc = _add(acc, xs[j][c * m:(c + 1) * m])
        assert torch.equal(_bits(acc), _bits(hops[c]))
        assert torch.equal(_bits(trs.rs_ring_plain(xs, c)), _bits(hops[c]))


@pytest.mark.parametrize("n", range(1, 9))
def test_a2a_push_schedule_one_writer_a_slot(n):
    """B8's stream kernel: every (receiver, slot) of the outputs — and the
    same (receiver, row) of the splits — has exactly one writer, rank
    ``slot``; each sender writes its own slot first, then me+1 ... me-1."""
    plan = ta2a.a2a_push_schedule(n)
    writers = {}
    for me, writes in enumerate(plan):
        assert writes[0] == (me, me)
        assert [p for p, _ in writes] == [(me + i) % n for i in range(n)]
        for p, slot in writes:
            assert slot == me
            writers.setdefault((p, slot), []).append(me)
    assert sorted(writers) == [(p, s) for p in range(n) for s in range(n)]
    assert all(w == [s] for (_, s), w in writers.items())


# ---------------------------------------------------------------------------
# The plain versions through the rank threads.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_reduce_scatter_plain_equals_the_ring(n, dtype):
    """The rank threads' reduce-scatter (the plain version, meeting
    through slots) gives each rank the ring's hops' chunk bit for bit, at
    1 and 5 rows a chunk, twice in a row; the counter counts each call."""
    ctx = tctx(n)
    for m in (1, 5):
        xs = [_x((n * m, COLS), dtype, 300 + 10 * n + m + r)
              for r in range(n)]
        want = _ring_hops(xs, n, m)
        before = _comm.RS_RING_KERNEL.plain_calls
        got = ctx.run(lambda r: [trs.reduce_scatter_local(xs[r], num_ranks=n)
                                 for _ in range(2)])
        assert _comm.RS_RING_KERNEL.plain_calls - before == 2 * n
        for r, outs in enumerate(got):
            assert all(torch.equal(_bits(o), _bits(want[r])) for o in outs)


def test_a2a_stream_plain_into_sentinel():
    """The stream's plain version writes a harness's NaN-filled ``out=`` and
    ``out_splits=`` (-1) and returns them: live rows and splits equal to
    ``a2a_plain`` on every rank over three calls (both parities, an empty
    slot among them); the call index advances by one a call."""
    n, cap, hidden, epr = 4, 32, 16, 2
    ctx = tctx(n)
    rng = np.random.default_rng(5)
    calls = []
    for t in range(3):
        spl = rng.integers(0, cap // epr + 1, (n, n, epr)).astype(np.int32)
        spl[t % n, (t + 1) % n] = 0
        calls.append((_x((n, n, cap, hidden), torch.bfloat16, 60 + t),
                      torch.from_numpy(spl)))
    ws, idx0 = ta2a.a2a_stream_workspace(n, cap, hidden, torch.bfloat16,
                                         ctx=ctx, tag="sentinel")

    def body(r):
        idx, res = idx0, []
        for S, spl in calls:
            out = torch.full((n, cap, hidden), float("nan"),
                             dtype=torch.bfloat16)
            osp = torch.full((n, epr), -1, dtype=torch.int32)
            got, rs, _, idx = ta2a.fast_all_to_all_stream(
                S[r], spl[r], ws, idx, num_ranks=n, out=out, out_splits=osp)
            assert got is out and rs is osp
            res.append((got, rs))
        return idx, res

    outs = ctx.run(body)
    assert [o[0] for o in outs] == [idx0 + 3] * n
    for t, (S, spl) in enumerate(calls):
        want, want_rs = ta2a.a2a_plain(S, spl, 16)
        for d in range(n):
            got, rs = outs[d][1][t]
            assert torch.equal(rs, want_rs[d])
            rows = ta2a.live_rows(want_rs[d], cap, 16)
            for p in range(n):
                assert torch.equal(_bits(got[p, :rows[p]]),
                                   _bits(want[d, p, :rows[p]]))
