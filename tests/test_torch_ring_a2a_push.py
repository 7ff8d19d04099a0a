"""B4's ring AllGather and B8's barrier-form AllToAll on the push protocol
(``csrc/push.cuh``; ``csrc/collectives.cu`` ag_ring on the full-mesh
push's body ``ag_push``, ``csrc/all_to_all.cu`` a2a on the parity form's
body ``a2a_push``) on the CPU: the host side of both launches — the pad
layouts and tags, the grids, the argument lists, the buffers asked for —
computed in Python so that it is checked here; and both plain versions
through the rank threads.

The port's ranks are CPU threads. Tolerance: bit for bit everywhere — both
kernels move bytes. ``tests/test_torch_collectives.py`` and
``tests/test_torch_all_to_all.py`` hold both plain versions against the
JAX package's ``ring_1d`` gather and ``fast_all_to_all``.
"""

import pathlib
import re
import types

import numpy as np
import pytest
import torch

from triton_distributed_tpu_torch.ops import _comm
from triton_distributed_tpu_torch.ops import all_to_all as ta2a
from triton_distributed_tpu_torch.ops import allgather as tag
from triton_distributed_tpu_torch.runtime.context import DistContext
from triton_distributed_tpu_torch.runtime.symm import SIGNAL_WORDS

BF, F32, E4M3 = torch.bfloat16, torch.float32, torch.float8_e4m3fn
H100_SMS = 132
PORT = pathlib.Path(_comm.__file__).resolve().parents[1]
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
# The pads: words and tags.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", ["ag_ring", "a2a"])
def test_pad_words_fit_and_stay_apart(kernel):
    """The ring launches on PUSH_LAYOUT, the barrier A2A on A2A_LAYOUT (a
    second address word a receiver, its splits): at n = 2-8 and every grid
    up to the cap, every word lies inside ``SIGNAL_WORDS`` and the kinds'
    ranges are disjoint, as the C entries check (``push.cuh`` bad_layout;
    ``all_to_all.cu``: addr < splits < ready)."""
    lay = _comm.PUSH_LAYOUT if kernel == "ag_ring" else _comm.A2A_LAYOUT
    kinds = 3 if kernel == "ag_ring" else 4
    for n in range(2, 9):
        for grid in (1, 8, 33, _comm.PUSH_MAX_BLOCKS):
            words = lay.words(n, grid)
            flat = [w for ws in words.values() for w in ws]
            assert len(flat) == len(set(flat)) == (kinds - 1) * n + n * grid
            assert 0 <= min(flat) and max(flat) < SIGNAL_WORDS
            ranges = sorted((min(ws), max(ws)) for ws in words.values())
            assert all(a[1] < b[0] for a, b in zip(ranges, ranges[1:]))
    assert lay.data + _comm.MAX_RANKS * lay.stride <= SIGNAL_WORDS


def test_pad_tags_are_each_kernels_own():
    """Every push-protocol wrapper of the port asks ``symm_pad`` for a
    literal tag of its own: the ring's ``"ag_ring"`` and the barrier
    A2A's ``"a2a"`` are among them and no other wrapper shares them, so
    each pad's epochs count one kernel's calls (the parity streams' pads
    carry their shape in the tag: ``"a2a_stream-..."``, never ``"a2a"``)."""
    tags = []
    for path in sorted(PORT.rglob("*.py")):
        tags += re.findall(r'symm_pad\(\s*\w+,\s*tag="([^"]+)"\)',
                           path.read_text())
    assert "ag_ring" in tags and "a2a" in tags
    assert len(tags) == len(set(tags)), tags


# ---------------------------------------------------------------------------
# The grids.
# ---------------------------------------------------------------------------

# (what, payload bytes a rank): the ring's chunk (its rows x 4096 bf16: a
# 256-row slice's 64 rows, 2048 rows' 512, one vector, an odd tail) and
# the barrier A2A's send buffer (n slots of cap x 2048 bf16; n = 4).
RING_CHUNKS = [("main", 64 * 4096 * 2), ("2048_rows", 512 * 4096 * 2),
               ("one_vector", 16), ("tail", 3 * 1000 * 2)]
A2A_SENDS = [("main", 4 * 4096 * 2048 * 2), ("cap32", 4 * 32 * 2048 * 2),
             ("cap256", 4 * 256 * 2048 * 2), ("one_row", 4 * 16 * 16)]


@pytest.mark.parametrize("ranks_on_card", [1, 2, 4, 8])
def test_grids_same_on_every_rank(ranks_on_card):
    """Both grids are ``push_grid`` over bytes every rank shares — the
    ring over its chunk at a block per AG_RING_BLOCK_BYTES (32 KiB: the
    slice's gather is latency-bound), the barrier A2A over its whole send
    buffer (cap rows a slot, not the live rows) at a block per
    PUSH_BLOCK_BYTES (64 KiB: the prefill's is bandwidth-bound) — so
    every rank computes the same one, within 1/r of an H100's 132 SMs. At
    4 ranks: the ring's main chunk (512 KiB) 16 blocks, 2048 rows (4 MiB)
    the cap of 33; the A2A's cap 4096 x 2048 (64 MiB) 33."""
    cap = H100_SMS // ranks_on_card
    for sizes, block in ((RING_CHUNKS, _comm.AG_RING_BLOCK_BYTES),
                         (A2A_SENDS, _comm.PUSH_BLOCK_BYTES)):
        for _, nbytes in sizes:
            grids = {_comm.push_grid(nbytes, [cap], block)
                     for _ in range(ranks_on_card)}
            assert len(grids) == 1
            g = grids.pop()
            assert 1 <= g <= min(cap, _comm.PUSH_MAX_BLOCKS)
            assert g == min(cap, _comm.PUSH_MAX_BLOCKS,
                            max(1, -(-nbytes // block)))
    if ranks_on_card == 4:
        ring = dict(RING_CHUNKS)
        block = _comm.AG_RING_BLOCK_BYTES
        assert _comm.push_grid(ring["main"], [cap], block) == 16
        assert _comm.push_grid(ring["2048_rows"], [cap], block) == 33
        assert _comm.push_grid(dict(A2A_SENDS)["main"], [cap]) == 33


# ---------------------------------------------------------------------------
# Both launches on stand-ins for CUDA tensors.
# ---------------------------------------------------------------------------

class _FakeCuda:
    """A stand-in for a CUDA tensor: what the wrappers read of it."""

    def __init__(self, shape, dtype=BF, ptr=4096):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.device = types.SimpleNamespace(type="cuda")
        self.ptr = ptr

    def dim(self):
        return len(self.shape)

    def element_size(self):
        return torch.empty((), dtype=self.dtype).element_size()

    def numel(self):
        return int(np.prod(self.shape))

    def to(self, *a, **k):
        return self

    def contiguous(self):
        return self


class _TorchOut:
    """``torch`` for a wrapper module under test: ``empty`` and
    ``empty_like`` return the names "out" and ("out", t) (the stand-ins
    have no memory to allocate on)."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def empty(*args, **kwargs):
        return "out"

    @staticmethod
    def empty_like(t):
        return ("out", t)


def _fake_ctx(n):
    return types.SimpleNamespace(
        num_ranks=n, devices=[torch.device("cuda:0")] * n, timeout_s=1.0,
        error_word=lambda r: None, is_cuda=True)


def _fake_pad(ctx, tag, epochs):
    def next_epoch(r):
        epochs[r] += 1
        return epochs[r]

    return types.SimpleNamespace(ctx=ctx, tag=tag, table=[None] * 4,
                                 signal_table=[None] * 4, epochs=epochs,
                                 next_epoch=next_epoch)


def _drive(monkeypatch, n, rank, caps=33):
    """Patch both wrappers' modules for stand-ins: the meeting records each
    launch's (kernel, args); ``symm_zeros`` fails (no payload buffer on the
    CUDA path); ``symm_pad`` hands out one pad a tag and records the tag.
    Returns (launches, pads)."""
    seen, pads = [], {}
    ctx = _fake_ctx(n)

    def meeting(kernel, pad, r, dev, what, args, variants=()):
        seen.append((kernel, pad.tag, list(args)))

    monkeypatch.setattr(_comm, "_launch_at_meeting", meeting)
    monkeypatch.setattr(_comm, "_sm_caps", lambda c: [caps])
    monkeypatch.setattr(_comm, "current_stream", lambda dev: "stream")
    monkeypatch.setattr(_comm, "ptr", lambda t: t)
    for mod in (tag, ta2a):
        monkeypatch.setattr(mod, "symm_zeros", lambda *a, **k: pytest.fail(
            "the CUDA path asked for a payload buffer"))
        monkeypatch.setattr(mod, "symm_pad", lambda c, tag: pads.setdefault(
            tag, _fake_pad(c, tag, [0] * n)))
        monkeypatch.setattr(mod, "rank_of", lambda axis, num: (ctx, rank, n))
        monkeypatch.setattr(mod, "check_payload", lambda c, r, x, *a, **k: x)
        monkeypatch.setattr(mod, "torch", _TorchOut())
    monkeypatch.setattr(ta2a, "ptr", lambda t: t)
    return seen, pads


@pytest.mark.parametrize("rank", [0, 3])
def test_ring_launch_arguments_and_no_gather_buffer(monkeypatch, rank):
    """The ring's CUDA path asks for the ``"ag_ring"`` pad and no gather
    buffer, and hands ``tdt_ag_ring`` exactly its argument list: the
    group's (rank, n, the pad's next epoch), the input, the fresh output
    and the chunk's bytes, then the grid (16 blocks of 32 KiB at the
    256-row slice's 64 x 4096 bf16 chunk), the GPU's scope and
    PUSH_LAYOUT's words, the stream last; a second call takes the next
    epoch."""
    n, m, cols = 4, 64, 4096
    seen, pads = _drive(monkeypatch, n, rank)
    x = _FakeCuda((m, cols))
    for _ in range(2):
        assert tag.all_gather_local(x, num_ranks=n,
                                    method="ring_1d") == "out"
    assert list(pads) == ["ag_ring"]
    for call, (kernel, ptag, args) in enumerate(seen):
        assert kernel is _comm.AG_RING_KERNEL and ptag == "ag_ring"
        assert len(args) == len(_comm.AG_RING_KERNEL.argtypes)
        assert args[3:6] == [rank, n, call + 1]
        assert args[7:10] == [x, "out", m * cols * 2]
        assert args[10:-1] == [16, 0, *_comm.PUSH_LAYOUT.args()]
        assert args[-1] == "stream"
    assert len(seen) == 2


@pytest.mark.parametrize("rank", [1, 2])
def test_a2a_launch_arguments_and_no_receive_buffer(monkeypatch, rank):
    """The barrier A2A's CUDA path asks for the ``"a2a"`` pad and no
    receive buffer, and hands ``tdt_a2a`` exactly its argument list: the
    group's, the send buffer and the fresh output, the row's bytes, both
    splits, cap, block (16 bf16 rows) and experts a rank, then the grid
    (33 blocks: the EP prefill's 64 MiB send buffer at a block per 64 KiB,
    capped at 1/4 of the SMs), the GPU's scope and A2ALayout's five
    words, the stream last — the parity stream's list, on its own C
    entry and counter."""
    n, cap, h, epr = 4, 4096, 2048, 32
    seen, pads = _drive(monkeypatch, n, rank)
    send = _FakeCuda((n, cap, h))
    spl = _FakeCuda((n, epr), torch.int32)
    spl.device = send.device
    out, out_spl = ta2a.fast_all_to_all_local(send, spl, num_ranks=n)
    assert out == ("out", send) and out_spl == ("out", spl)
    assert list(pads) == ["a2a"]
    (kernel, ptag, args), = seen
    assert kernel is _comm.A2A_KERNEL and ptag == "a2a"
    assert _comm.A2A_KERNEL.argtypes == _comm.A2A_PARITY_KERNEL.argtypes
    assert len(args) == len(_comm.A2A_KERNEL.argtypes)
    assert args[3:6] == [rank, n, 1]
    assert args[7:10] == [send, out, h * 2]
    assert args[10:15] == [spl, out_spl, cap, 16, epr]
    assert args[15:-1] == [33, 0, *_comm.A2A_LAYOUT.args()]
    assert args[-1] == "stream"


@pytest.mark.parametrize("ranks_on_card", [1, 2, 4, 8])
def test_launch_grids_same_on_every_rank(monkeypatch, ranks_on_card):
    """Through the wrappers themselves: every rank of a group of 4 hands
    its C entry the same grid, for the ring at its main and 2048-row
    chunks and tails, and for the barrier A2A at caps 32, 256 and 4096,
    with r ranks on the card (the cap 132 // r)."""
    n = 4
    for shape in ((64, 4096), (512, 4096), (1, 8), (3, 1000)):
        grids = set()
        for rank in range(n):
            seen, _ = _drive(monkeypatch, n, rank, H100_SMS // ranks_on_card)
            tag.all_gather_local(_FakeCuda(shape), num_ranks=n,
                                 method="ring_1d")
            grids.add(seen[0][2][10])
        assert len(grids) == 1
        assert grids.pop() <= H100_SMS // ranks_on_card
    for cap in (32, 256, 4096):
        grids = set()
        for rank in range(n):
            seen, _ = _drive(monkeypatch, n, rank, H100_SMS // ranks_on_card)
            send = _FakeCuda((n, cap, 2048))
            spl = _FakeCuda((n, 32), torch.int32)
            spl.device = send.device
            ta2a.fast_all_to_all_local(send, spl, num_ranks=n)
            grids.add(seen[0][2][15])
        assert len(grids) == 1
        assert grids.pop() <= H100_SMS // ranks_on_card


# ---------------------------------------------------------------------------
# The plain versions through the rank threads.
# ---------------------------------------------------------------------------

# (rows, cols) a rank: one 16-byte vector, odd tails, many rows.
RING_TAILS = {F32: ((1, 4), (3, 12), (5, 1028)),
              BF: ((1, 8), (3, 24), (5, 2056)),
              E4M3: ((1, 16), (3, 48), (5, 4112))}


@pytest.mark.parametrize("dtype", [F32, BF, E4M3], ids=str)
@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_ring_plain_equals_ag_plain(n, dtype):
    """The rank threads' ring (the plain version, meeting through slots)
    gives every rank ``ag_plain``'s gather bit for bit at every tail,
    twice in a row with new inputs; the counter counts each call."""
    ctx = tctx(n)
    for i, (rows, cols) in enumerate(RING_TAILS[dtype]):
        calls = [[_x((rows, cols), dtype, 1000 * n + 100 * i + 10 * t + r)
                  for r in range(n)] for t in range(2)]
        before = _comm.AG_RING_KERNEL.plain_calls
        got = ctx.run(lambda r: [tag.all_gather_local(
            xs[r], num_ranks=n, method="ring_1d") for xs in calls])
        assert _comm.AG_RING_KERNEL.plain_calls - before == 2 * n
        for t, xs in enumerate(calls):
            want = tag.ag_plain(xs)
            assert all(torch.equal(_bits(g[t]), _bits(want)) for g in got)


def _a2a_case(kind, n, cap, epr, seed):
    rng = np.random.default_rng(seed)
    if kind == "empty":
        spl = np.zeros((n, n, epr), np.int32)
        spl[0, 1 % n, 0] = 1
    elif kind == "full":
        spl = np.zeros((n, n, epr), np.int32)
        spl[..., 0] = cap
    else:
        spl = rng.integers(0, cap // epr + 1, (n, n, epr)).astype(np.int32)
        spl[..., -1] = np.maximum(spl[..., -1] - 3, 0)
    return torch.from_numpy(spl)


@pytest.mark.parametrize("dtype", [F32, BF, E4M3], ids=str)
@pytest.mark.parametrize("n", [2, 4, 8])
def test_a2a_plain_equals_a2a_plain(n, dtype):
    """The rank threads' barrier A2A gives every rank ``a2a_plain``'s live
    rows and splits bit for bit, with empty, ragged and full slots (cap
    32, two experts a rank), twice in a row; the counter counts each
    call."""
    ctx = tctx(n)
    cap, hidden, epr = 32, 16, 2
    block = ta2a.default_block_rows(dtype)
    for i, kind in enumerate(("empty", "ragged", "full")):
        calls = [(_x((n, n, cap, hidden), dtype, 50 * n + 10 * i + t),
                  _a2a_case(kind, n, cap, epr, 7 * n + i + t))
                 for t in range(2)]
        before = _comm.A2A_KERNEL.plain_calls
        got = ctx.run(lambda r: [ta2a.fast_all_to_all_local(
            S[r], spl[r], num_ranks=n) for S, spl in calls])
        assert _comm.A2A_KERNEL.plain_calls - before == 2 * n
        for t, (S, spl) in enumerate(calls):
            want, want_rs = ta2a.a2a_plain(S, spl, block)
            for d in range(n):
                out, rs = got[d][t]
                assert torch.equal(rs, want_rs[d])
                rows = ta2a.live_rows(want_rs[d], cap, block)
                for p in range(n):
                    assert torch.equal(_bits(out[p, :rows[p]]),
                                       _bits(want[d, p, :rows[p]]))
