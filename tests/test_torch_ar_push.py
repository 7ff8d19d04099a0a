"""B5's parity AllReduce stream and B12's torus AllReduce on the push
protocol (``csrc/collectives.cu`` ar_parity: the one-shot's body over the
stream's own pad; ``csrc/multi_axis.cu`` ar_torus: the input published to
the grid row, a per-call mid to the grid column, no slot workspace or
entry barrier) on the CPU: the host side of both — their launch
arguments, grids, pads and buffers, the torus's pad words and its
schedule — computed in Python so that it is checked here; and both plain
versions through the rank threads.

The port's ranks are CPU threads. Tolerance: bit for bit everywhere —
each sum runs in a fixed order in fp32 from 0 and rounds once (the torus
once a phase). ``tests/test_torch_collectives.py`` and
``tests/test_torch_multi_axis.py`` hold both plain versions against the
JAX package's kernels; here the torus's schedule, replayed, is held
against the JAX ``all_reduce_torus`` on three grids.
"""

import pathlib
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from triton_distributed_tpu.ops import multi_axis as jma
from triton_distributed_tpu.runtime.context import DistContext as JDistContext
from triton_distributed_tpu_torch.ops import _comm
from triton_distributed_tpu_torch.ops import allreduce as tar
from triton_distributed_tpu_torch.ops import multi_axis as tma
from triton_distributed_tpu_torch.runtime.context import DistContext
from triton_distributed_tpu_torch.runtime.symm import SIGNAL_WORDS

BF, F32 = torch.bfloat16, torch.float32
H100_SMS = 132
CSRC = pathlib.Path(_comm.__file__).resolve().parents[1] / "csrc"
GRIDS = ((2, 4), (4, 2), (2, 2))
_CTX: dict = {}


def tctx(n: int) -> DistContext:
    if n not in _CTX:
        _CTX[n] = DistContext([torch.device("cpu")] * n,
                              wait_timeout_ms=60_000)
    return _CTX[n]


def gctx(shape) -> DistContext:
    """The port's group of CPU rank threads over axes ("x", "y")."""
    if shape not in _CTX:
        _CTX[shape] = DistContext(
            [torch.device("cpu")] * (shape[0] * shape[1]), mesh_shape=shape,
            axis_names=("x", "y"), wait_timeout_ms=60_000)
    return _CTX[shape]


def jctx(shape) -> JDistContext:
    devs = np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape)
    return JDistContext(mesh=Mesh(devs, ("x", "y")))


def _x(shape, dtype, seed) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32)).to(dtype)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.uint8)


# ---------------------------------------------------------------------------
# Both launches on stand-ins for CUDA tensors.
# ---------------------------------------------------------------------------

class _FakeCuda:
    """A stand-in for a CUDA tensor: what the wrappers read of it."""

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


class _TorchEmpty:
    """``torch`` for a wrapper module under test: ``empty_like`` hands out
    ("empty", k, t) for its k-th call (the stand-ins have no memory)."""

    def __init__(self):
        self.made = []

    def __getattr__(self, name):
        return getattr(torch, name)

    def empty_like(self, t):
        self.made.append(("empty", len(self.made), t))
        return self.made[-1]


def _drive(monkeypatch, mod, n, rank, caps, cards=1):
    """Patch ``mod`` (the wrapper's module) for stand-ins on ``cards``
    cards: the meeting records each launch's (kernel, pad tag, args);
    ``symm_zeros`` fails (no payload buffer on the CUDA path);
    ``symm_pad`` hands out one pad a tag. Returns (launches, pads, ctx,
    the module's torch)."""
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
            tensors=[torch.empty(0, dtype=torch.int64)] * n, epochs=epochs,
            next_epoch=next_epoch, call_index=lambda: epochs[0]))

    fake_torch = _TorchEmpty()
    monkeypatch.setattr(_comm, "_launch_at_meeting", meeting)
    monkeypatch.setattr(_comm, "_sm_caps", lambda c: [caps])
    monkeypatch.setattr(_comm, "current_stream", lambda dev: "stream")
    monkeypatch.setattr(_comm, "ptr", lambda t: t)
    if hasattr(mod, "symm_zeros"):
        monkeypatch.setattr(mod, "symm_zeros", lambda *a, **k: pytest.fail(
            "the CUDA path asked for a payload buffer"))
    if hasattr(mod, "ptr"):
        monkeypatch.setattr(mod, "ptr", lambda t: t)
    monkeypatch.setattr(mod, "symm_pad", pad_for)
    monkeypatch.setattr(mod, "rank_of", lambda axis, num: (ctx, rank, n))
    monkeypatch.setattr(mod, "check_payload", lambda c, r, x, *a, **k: x)
    monkeypatch.setattr(mod, "torch", fake_torch)
    return seen, pads, ctx, fake_torch


@pytest.mark.parametrize("rank", [0, 3])
@pytest.mark.parametrize("dtype", [F32, BF], ids=str)
def test_parity_launch_arguments_and_no_slab(monkeypatch, rank, dtype):
    """The parity stream's CUDA path asks for a pad tagged by tag, shape
    and dtype and no slab (``symm_zeros`` never called), and hands
    ``tdt_ar_parity`` exactly its argument list: the group's (rank, n,
    the epoch = the call index + 1), the input, the fresh output, the
    payload's bytes and the dtype code, then the grid (4 blocks at 4 x
    4096 bf16: a block per AR_ONE_SHOT_BLOCK_BYTES), the GPU's scope on one
    card and PUSH_LAYOUT's words, the stream last. The workspace keeps its
    (2, n, m, cols) shape and its epochs are the pad's."""
    n, m, cols = 4, 4, 4096
    seen, pads, ctx, made = _drive(monkeypatch, tar, n, rank, 33)
    ws, idx = tar.ar_stream_workspace(n, m, cols, dtype, ctx=ctx, tag="dec")
    assert list(pads) == [f"dec-{n}x{m}x{cols}-{dtype}"]
    assert ws.buf is pads[f"dec-{n}x{m}x{cols}-{dtype}"]
    assert idx == 0 and ws.shape == (2, n, m, cols) and ws.dtype == dtype
    assert ws.epochs is ws.buf.epochs and ws.tensors is ws.buf.tensors
    x = _FakeCuda((m, cols), dtype)
    for call in range(2):
        out, ws2, idx = tar.all_reduce_stream(x, ws, idx, num_ranks=n)
        assert ws2 is ws and idx == call + 1 and ws.epochs[rank] == call + 1
        assert out is made.made[call]
    nbytes = m * cols * x.element_size()
    grid = _comm.push_grid(nbytes, [33], _comm.AR_ONE_SHOT_BLOCK_BYTES)
    assert grid == (4 if dtype == BF else 8)
    assert len(seen) == 2
    for call, (kernel, ptag, args) in enumerate(seen):
        assert kernel is _comm.PARITY_KERNEL
        assert ptag == f"dec-{n}x{m}x{cols}-{dtype}"
        assert len(args) == len(_comm.PARITY_KERNEL.argtypes)
        assert args[3:6] == [rank, n, call + 1]
        assert args[7:11] == [x, made.made[call], nbytes,
                              _comm.DTYPE_CODE[dtype]]
        assert args[11:-1] == [grid, 0, *_comm.PUSH_LAYOUT.args()]
        assert args[-1] == "stream"


@pytest.mark.parametrize("rows,grid", [(4, 4), (16, 16), (2048, 33)])
def test_parity_grid_by_payload(monkeypatch, rows, grid):
    """The grid follows the payload at a block per 8 KiB, capped at 1/r of
    an H100's SMs (33 at 4 ranks a card): a decode step's 4 rows 4 blocks,
    the verify step's 16 rows 16, 2048 rows the cap."""
    seen, _, ctx, _ = _drive(monkeypatch, tar, 4, 1, H100_SMS // 4)
    ws, idx = tar.ar_stream_workspace(4, rows, 4096, BF, ctx=ctx)
    tar.all_reduce_stream(_FakeCuda((rows, 4096)), ws, idx, num_ranks=4)
    assert seen[0][2][11] == grid


def test_parity_scope_across_cards(monkeypatch):
    """A group whose ranks sit on four cards raises the flags at the
    system's scope (1), one card at the GPU's (0)."""
    for cards, scope in ((1, 0), (4, 1)):
        seen, _, ctx, _ = _drive(monkeypatch, tar, 4, 1, 33, cards=cards)
        ws, idx = tar.ar_stream_workspace(4, 4, 4096, BF, ctx=ctx)
        tar.all_reduce_stream(_FakeCuda((4, 4096)), ws, idx, num_ranks=4)
        assert seen[0][2][12] == scope


def test_parity_loopback_launches_at_one_rank(monkeypatch):
    """At one rank ``force_kernel`` launches the kernel (n = 1, a grid by
    the payload); without it the input comes back and nothing launches."""
    seen, _, ctx, _ = _drive(monkeypatch, tar, 1, 0, 132)
    ws, idx = tar.ar_stream_workspace(1, 64, 256, F32, ctx=ctx)
    x = _FakeCuda((64, 256), F32)
    out, _, idx = tar.all_reduce_stream(x, ws, idx, num_ranks=1)
    assert out is x and idx == 1 and not seen
    tar.all_reduce_stream(x, ws, 0, num_ranks=1, force_kernel=True)
    (kernel, _, args), = seen
    assert kernel is _comm.PARITY_KERNEL and args[3:6] == [0, 1, 1]


def test_parity_cpu_slabs_and_errors_unchanged():
    """On the CPU the workspace is the two parity slabs of (n, m, cols),
    zeroed, which the plain version fills (call t into slab t % 2, slot
    ``rank``); a workspace of another shape or dtype, and a call index out
    of sequence, are refused by name."""
    n, m, cols = 2, 3, 8
    ctx = tctx(n)
    ws, idx0 = tar.ar_stream_workspace(n, m, cols, F32, ctx=ctx,
                                       tag="cpu-slabs")
    assert ws.shape == (2, n, m, cols) and idx0 == 0
    assert all(tuple(t.shape) == (2, n, m, cols) and not t.any()
               for t in ws.tensors)
    xs = [_x((m, cols), F32, 10 + r) for r in range(n)]

    def body(r):
        out, _, idx = tar.all_reduce_stream(xs[r], ws, idx0, num_ranks=n)
        with pytest.raises(ValueError, match="call_index 0 on rank"):
            tar.all_reduce_stream(xs[r], ws, idx0, num_ranks=n)
        with pytest.raises(ValueError, match="workspace shape"):
            tar.all_reduce_stream(xs[r][:2], ws, idx, num_ranks=n)
        with pytest.raises(ValueError, match="workspace dtype"):
            tar.all_reduce_stream(xs[r].to(BF), ws, idx, num_ranks=n)
        return out, idx

    got = ctx.run(body)
    want = tar.reduce_slots_plain(xs)
    for out, idx in got:
        assert idx == 1 and torch.equal(_bits(out), _bits(want))
    for t in ws.tensors:
        for r in range(n):
            assert torch.equal(t[0, r], xs[r])
        assert not t[1].any()


@pytest.mark.parametrize("dtype", [F32, BF], ids=str)
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_parity_plain_equals_reduce_slots(n, dtype):
    """The rank threads' parity stream (at one rank under ``force_kernel``)
    gives every rank ``reduce_slots_plain``'s sum bit for bit over five
    calls alternating between two workspaces (two tags: each its own index
    and slabs), new inputs every call; the counter counts each call."""
    ctx = tctx(n)
    m, cols = 3, 40
    calls = [[_x((m, cols), dtype, 100 * n + 10 * t + r) for r in range(n)]
             for t in range(5)]
    wss = [tar.ar_stream_workspace(n, m, cols, dtype, ctx=ctx,
                                   tag=f"two-{k}-{dtype}") for k in range(2)]
    before = _comm.PARITY_KERNEL.plain_calls

    def body(r):
        idx = [i for _, i in wss]
        outs = []
        for t, xs in enumerate(calls):
            w = t % 2
            out, _, idx[w] = tar.all_reduce_stream(
                xs[r], wss[w][0], idx[w], num_ranks=n, force_kernel=n == 1)
            outs.append(out)
        return outs, idx

    got = ctx.run(body)
    assert _comm.PARITY_KERNEL.plain_calls - before == 5 * n
    for outs, idx in got:
        assert idx == [wss[0][1] + 3, wss[1][1] + 2]
        for t, xs in enumerate(calls):
            assert torch.equal(_bits(outs[t]),
                               _bits(tar.reduce_slots_plain(xs)))


def test_parity_cpu_loopback_plain():
    """At one CPU rank without ``force_kernel`` the input itself comes
    back (the workspace untouched); with it the plain version's sum of one
    input (fp32 from 0, one cast: -0 becomes +0)."""
    ctx = DistContext([torch.device("cpu")], wait_timeout_ms=60_000)
    x = _x((2, 8), BF, 5)
    x[0, 0] = -0.0
    ws, idx = tar.ar_stream_workspace(1, 2, 8, BF, ctx=ctx, tag="one")
    same, forced = ctx.run(lambda r: (
        tar.all_reduce_stream(x, ws, idx, num_ranks=1)[0],
        tar.all_reduce_stream(x, ws, idx, num_ranks=1,
                              force_kernel=True)[0]))[0]
    assert ws.epochs == [idx + 1]
    assert same is x
    assert torch.equal(_bits(forced), _bits(tar.reduce_slots_plain([x])))
    assert not torch.equal(_bits(forced), _bits(x))        # -0 -> +0


# ---------------------------------------------------------------------------
# The torus AR: launch, pad words, schedule.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rank", [0, 5])
@pytest.mark.parametrize("dtype", [F32, BF], ids=str)
def test_torus_launch_arguments_pad_and_mid(monkeypatch, rank, dtype):
    """The torus AR's CUDA path asks for the ``"ar_torus"`` pad and no
    workspace, allocates a per-call mid (then the output) on the rank's
    stream, and hands ``tdt_ar_torus`` exactly its argument list: the
    group's (rank, 8, the pad's next epoch), the input, the output, the
    payload's bytes, the mid, (n0, n1), the dtype code, then the grid (a
    block per AR_TORUS_BLOCK_BYTES, capped at 132 // 8 = 16: 16 at 16 x
    4096 bf16), the GPU's scope and TorusARLayout's six words, the stream
    last. A caller's ``out=`` is written in place of the fresh output."""
    n0, n1, m, cols = 2, 4, 16, 4096
    seen, pads, _, made = _drive(monkeypatch, tma, 8, rank, H100_SMS // 8)
    x = _FakeCuda((m, cols), dtype)
    assert tma.all_reduce_torus_local(x, axes=("x", "y"),
                                      dims=(n0, n1)) is made.made[1]
    sentinel = object()
    monkeypatch.setattr(tma, "check_out", lambda c, r, o, *a: o)
    assert tma.all_reduce_torus_local(x, axes=("x", "y"), dims=(n0, n1),
                                      out=sentinel) is sentinel
    assert list(pads) == ["ar_torus"] and len(made.made) == 3
    nbytes = m * cols * x.element_size()
    grid = _comm.push_grid(nbytes, [16], _comm.AR_TORUS_BLOCK_BYTES)
    assert grid == 16
    outs = [(made.made[1], made.made[0]), (sentinel, made.made[2])]
    for call, (kernel, ptag, args) in enumerate(seen):
        assert kernel is _comm.AR_TORUS_KERNEL and ptag == "ar_torus"
        assert len(args) == len(_comm.AR_TORUS_KERNEL.argtypes)
        assert args[3:6] == [rank, n0 * n1, call + 1]
        out, mid = outs[call]
        assert args[7:14] == [x, out, nbytes, mid, n0, n1,
                              _comm.DTYPE_CODE[dtype]]
        assert args[14:-1] == [grid, 0, *_comm.TORUS_AR_LAYOUT.args()]
        assert args[-1] == "stream"


def test_torus_scope_and_grid(monkeypatch):
    """Four cards raise the flags at the system's scope; the grid is the
    same on every rank and follows the payload: 2048 rows take the cap."""
    for cards, scope in ((1, 0), (4, 1)):
        seen, _, _, _ = _drive(monkeypatch, tma, 8, 3, 16, cards=cards)
        tma.all_reduce_torus_local(_FakeCuda((2048, 4096)), axes=("x", "y"),
                                   dims=(2, 4))
        assert seen[0][2][15] == scope and seen[0][2][14] == 16
    grids = set()
    for rank in range(8):
        seen, _, _, _ = _drive(monkeypatch, tma, 8, rank, 16)
        tma.all_reduce_torus_local(_FakeCuda((1, 8)), axes=("x", "y"),
                                   dims=(4, 2))
        grids.add(seen[0][2][14])
    assert grids == {1}


def test_torus_layout_words_disjoint_inside_pad():
    """TorusARLayout's words at n = 2-8 and every grid up to the cap lie
    inside SIGNAL_WORDS in five disjoint ranges (as multi_axis.cu's
    bad_torus_layout checks): no ready, released or mid word of one peer
    aliases another's, nor the three words a block sends one outer peer
    each other."""
    lay = _comm.TORUS_AR_LAYOUT
    for n in range(2, 9):
        for grid in (1, 16, 33, _comm.PUSH_MAX_BLOCKS):
            words = lay.words(n, grid)
            flat = [w for ws in words.values() for w in ws]
            assert len(flat) == len(set(flat)) == 2 * n + 3 * n * grid
            assert 0 <= min(flat) and max(flat) < SIGNAL_WORDS


def _c_fields(src: str, struct: str) -> list:
    body = re.search(r"struct %s \{(.*?)\};" % struct, src, re.S).group(1)
    return re.findall(r"int (\w+);", body)


def _c_params(src: str, entry: str) -> int:
    sig = re.search(r"int %s\((.*?)\) \{" % entry, src, re.S).group(1)
    return len(sig.split(","))


def test_c_entries_match_the_host():
    """The C side as the host calls it: TorusLayout's fields in
    TorusARLayout's order, each entry's parameters one a declared argument
    type; the old kernels' helpers gone (no parity slabs, slot puts, entry
    barrier or fixed grid)."""
    coll = (CSRC / "collectives.cu").read_text()
    ma = (CSRC / "multi_axis.cu").read_text()
    dist = (CSRC / "dist.cuh").read_text()
    assert _c_fields(ma, "TorusLayout") == [
        "addr", "ready", "released", "mid_ready", "mid_released", "stride"]
    assert _c_params(ma, "tdt_ar_torus") == len(
        _comm.AR_TORUS_KERNEL.argtypes)
    assert _c_params(coll, "tdt_ar_parity") == len(
        _comm.PARITY_KERNEL.argtypes)
    assert _comm.PARITY_KERNEL.argtypes == _comm.ONE_SHOT_KERNEL.argtypes
    for src, gone in ((coll, ("push_all", "grid_for", "reduce_slots")),
                      (ma, ("signal_some", "wait_some", "torus_base",
                            "kFlagsPerBlock", "kOuter", "grid_for", "put(",
                            "barrier_all")),
                      (dist, ("barrier_all(", "kStepBase", "kMaxBlocks"))):
        for word in gone:
            assert word not in src, word


def _replay(xs, n0, n1) -> list:
    """Every rank's result by :func:`torus_ar_schedule`: phase 1 the row's
    inputs into the rank's mid, phase 2 the column's mids — each what the
    publishing rank handed that reader."""
    plan = tma.torus_ar_schedule(n0, n1)
    mids = [tar.reduce_slots_plain([xs[s] for s in p["row"]]) for p in plan]
    return [tar.reduce_slots_plain([mids[s] for s in p["column"]])
            for p in plan]


@pytest.mark.parametrize("grid", GRIDS, ids=str)
def test_torus_schedule_and_replay(grid):
    """The schedule's roles: rank (a, b) publishes its input to exactly the
    ranks whose phase 1 reads it (its row) and its mid to exactly those
    whose phase 2 reads it (its column), the two sets disjoint; each
    rank's exit waits are its readers. Replayed, every rank's result is
    ``ar_torus_plain``'s and the JAX ``all_reduce_torus``'s bit for bit in
    bf16."""
    n0, n1 = grid
    n = n0 * n1
    plan = tma.torus_ar_schedule(n0, n1)
    for g, p in enumerate(plan):
        readers_in = [r for r in range(n) if r != g and g in plan[r]["row"]]
        readers_mid = [r for r in range(n)
                       if r != g and g in plan[r]["column"]]
        assert sorted(p["inner"]) == readers_in
        assert sorted(p["outer"]) == readers_mid
        assert not set(p["inner"]) & set(p["outer"])
        assert p["publish"] == {**{j: "input" for j in readers_in},
                                **{j: "mid" for j in readers_mid}}
        assert p["row"] == sorted(p["row"]) and g in p["row"]
        assert p["column"] == sorted(p["column"]) and g in p["column"]
    x = np.random.default_rng(n0 * 10 + n1).standard_normal(
        (n0, n1, 8, 128)).astype(np.float32)
    xs = [torch.from_numpy(x[a, b]).to(BF) for a in range(n0)
          for b in range(n1)]
    want = tma.ar_torus_plain(xs, n0, n1)
    got = _replay(xs, n0, n1)
    ref = np.asarray(jma.all_reduce_torus(jnp.asarray(x, jnp.bfloat16),
                                          jctx(grid)).astype(jnp.float32))
    for g in got:
        assert torch.equal(_bits(g), _bits(want))
        np.testing.assert_array_equal(g.float().numpy(), ref)


@pytest.mark.parametrize("grid", GRIDS, ids=str)
@pytest.mark.parametrize("dtype", [F32, BF], ids=str)
def test_torus_plain_into_sentinel(grid, dtype):
    """The rank threads' torus AR (the plain version, replaying the
    schedule through the exchange) writes a 0xFF-filled ``out=`` and
    returns it, ``ar_torus_plain``'s sum bit for bit on every rank, twice
    with new inputs; each call counted once a rank; ``out=`` with two-shot
    or on a degenerate grid is refused."""
    n0, n1 = grid
    n = n0 * n1
    ctx = gctx(grid)
    calls = [[_x((5, 24), dtype, 300 + 10 * t + r) for r in range(n)]
             for t in range(2)]
    before = _comm.AR_TORUS_KERNEL.plain_calls

    def body(r):
        res = []
        for xs in calls:
            out = torch.empty((5, 24), dtype=dtype)
            out.view(torch.uint8).fill_(0xFF)
            got = tar.all_reduce_local(xs[r], axis=("x", "y"),
                                       num_ranks=grid, out=out)
            assert got is out
            res.append(got)
        with pytest.raises(ValueError, match="out= is the one-shot's"):
            tma.all_reduce_torus_local(calls[0][r], axes=("x", "y"),
                                       dims=grid, method="two_shot",
                                       out=torch.empty((5, 24), dtype=dtype))
        return res

    outs = ctx.run(body)
    assert _comm.AR_TORUS_KERNEL.plain_calls - before == 2 * n
    for t, xs in enumerate(calls):
        want = tma.ar_torus_plain(xs, n0, n1)
        assert all(torch.equal(_bits(o[t]), _bits(want)) for o in outs)
    with pytest.raises(ValueError, match="out= is the one-shot's"):
        tma.all_reduce_torus_local(calls[0][0], axes=("x", "y"),
                                   dims=(n, 1), out=calls[0][0])
