"""B12's torus AllGather and B5's double tree on the push protocol
(``csrc/push.cuh``, ``csrc/multi_axis.cu`` ag_torus, ``csrc/collectives.cu``
ar_tree) on the CPU: the host side of the card's launch — the pad layouts,
the grids, the argument lists, the buffers asked for — computed in Python
so that it is checked here; the schedules the plain versions run (each
writer stores into its receivers' outputs, the ranks meet), enumerated
for one writer a slot; and the plain versions against ``tree_plain`` /
``torch.cat`` and the JAX package's kernels (Pallas interpret mode).

The port's ranks are CPU threads. Tolerance: bit for bit everywhere — the
AllGather moves bytes, and the tree keeps its kernel's order and rounding
(fp32 sums, one cast a level).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from triton_distributed_tpu.ops import allreduce as jar
from triton_distributed_tpu.runtime.context import DistContext as JDistContext
from triton_distributed_tpu_torch.ops import _comm
from triton_distributed_tpu_torch.ops import allgather as tag
from triton_distributed_tpu_torch.ops import allreduce as tar
from triton_distributed_tpu_torch.ops import multi_axis as tma
from triton_distributed_tpu_torch.runtime.context import DistContext
from triton_distributed_tpu_torch.runtime.symm import SIGNAL_WORDS

GRIDS = [(2, 2), (2, 3), (3, 2), (2, 4), (4, 2)]
COLS = 64
_CTX: dict = {}


def tctx(shape) -> DistContext:
    """A group of CPU rank threads: n ranks on one axis, or a 2-axis
    (x, y) grid."""
    if shape not in _CTX:
        if isinstance(shape, int):
            _CTX[shape] = DistContext([torch.device("cpu")] * shape,
                                      wait_timeout_ms=60_000)
        else:
            _CTX[shape] = DistContext(
                [torch.device("cpu")] * (shape[0] * shape[1]),
                mesh_shape=shape, axis_names=("x", "y"),
                wait_timeout_ms=60_000)
    return _CTX[shape]


def _x(shape, dtype, seed) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32)).to(dtype)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.uint8)


# ---------------------------------------------------------------------------
# The host side of the launch.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("trees", [1, 2])
def test_layout_words_fit_the_pad_and_stay_apart(trees):
    """Every word of both layouts lies inside ``SIGNAL_WORDS`` and the
    kinds' ranges are disjoint, for n = 2-8 and every grid up to the cap
    (the C entries refuse a layout that is not: ``push.cuh`` bad_layout,
    ``collectives.cu`` bad_tree_layout)."""
    push, tree = _comm.PUSH_LAYOUT, _comm.TREE_LAYOUT
    cap = _comm.PUSH_MAX_BLOCKS
    for n in range(2, 9):
        for grid in range(1, cap + 1):
            words = push.words(n, grid)
            flat = [w for ws in words.values() for w in ws]
            assert len(flat) == len(set(flat)) == 2 * n + n * grid
            assert 0 <= min(flat) and max(flat) < SIGNAL_WORDS
    ranges = []
    for grid in range(1, cap // trees + 1):
        words = tree.words(trees, grid)
        flat = [w for ws in words.values() for w in ws]
        assert len(flat) == len(set(flat)) == 4 * trees + 4 * trees * grid
        assert 0 <= min(flat) and max(flat) < SIGNAL_WORDS
        ranges = [(min(ws), max(ws)) for ws in words.values()]
    # The kinds' ranges at the largest grid do not overlap either, and the
    # C entry's checks hold for the layout itself.
    ranges.sort()
    assert all(a[1] < b[0] for a, b in zip(ranges, ranges[1:]))
    assert tree.ready >= tree.addr + 4 and tree.free >= tree.ready + 4
    assert tree.up >= tree.free + 2 * tree.stride
    assert tree.down >= tree.up + 4 * tree.stride
    assert tree.down + 2 * tree.stride <= SIGNAL_WORDS
    assert tree.stride >= cap


@pytest.mark.parametrize("ranks_on_card", [1, 2, 3, 4, 8])
def test_grids_same_on_every_rank(ranks_on_card):
    """Both grids are functions of the payload and the group alone, so
    every rank computes the same one: B12 ``push_grid`` over one shard's
    bytes; the tree G blocks a tree over its larger half, with 2G within
    the card's SMs over its ranks. Main shapes on an H100 (132 SMs): B12
    at 8 ranks, 2 MiB shards, 16 blocks; the tree at 4 ranks, 203 rows x
    4096 bf16, 16 a tree (the cap: 33 SMs a rank over two trees)."""
    sms = 132
    cap = sms // ranks_on_card
    for nbytes in (16, 4096, 64 << 10, (1 << 20) + 16, 2 << 20, 64 << 20):
        for trees in (1, 2):
            grids = {_comm.tree_grid(nbytes, trees, [cap])
                     for _ in range(ranks_on_card)}
            assert len(grids) == 1
            g = grids.pop()
            assert 1 <= g <= _comm.PUSH_MAX_BLOCKS and trees * g <= cap
            assert g == min(cap // trees, _comm.PUSH_MAX_BLOCKS,
                            -(-nbytes // _comm.TREE_BLOCK_BYTES))
        # The least of the cards' caps, on a group of several cards.
        assert _comm.push_grid(nbytes, [cap, 7]) == _comm.push_grid(
            nbytes, [7])
    if ranks_on_card == 8:
        assert _comm.push_grid(256 * 4096 * 2, [cap]) == 16
    if ranks_on_card == 4:
        assert _comm.tree_grid(102 * 4096 * 2, 2, [cap]) == 16


def _fake_cuda(shape, dtype=torch.bfloat16):
    """A stand-in for a CUDA payload: what the wrappers read of it."""
    return types.SimpleNamespace(
        shape=shape, dtype=dtype, device=types.SimpleNamespace(type="cuda"),
        dim=lambda: len(shape), element_size=lambda: 2)


def test_cuda_paths_ask_for_no_gather_buffer(monkeypatch):
    """No gather buffer: the CUDA path of ``ag_torus`` asks ``symm_zeros``
    for nothing (only the ``"ag_torus"`` pad) and launches the torus
    kernel on the push protocol; the tree's workspace has 2 slots a tree
    (no broadcast slot) and its launch is ``launch_tree``'s."""
    asked, launched = [], []
    # ops/multi_axis no longer imports symm_zeros (no torus kernel asks
    # for a workspace); were it back, every call would be recorded here.
    monkeypatch.setattr(tma, "symm_zeros",
                        lambda ctx, shape, dtype, tag: asked.append(tag),
                        raising=False)
    monkeypatch.setattr(tma, "symm_pad", lambda ctx, tag: ("pad", tag))
    monkeypatch.setattr(tma, "check_payload", lambda ctx, r, x, *a, **k: x)
    monkeypatch.setattr(tma, "check_out", lambda ctx, r, out, *a: out)
    monkeypatch.setattr(tma, "launch_push",
                        lambda *a, **k: launched.append(a))
    real_zeros = tar.symm_zeros
    monkeypatch.setattr(tar, "symm_zeros", lambda ctx, shape, dtype, tag: (
        asked.append((tag, shape)) or real_zeros(ctx, shape, dtype, tag=tag)))
    monkeypatch.setattr(tar, "check_payload", lambda ctx, r, x, *a, **k: x)
    monkeypatch.setattr(tar, "check_out", lambda ctx, r, out, *a: out)
    monkeypatch.setattr(tar, "launch_tree",
                        lambda *a: launched.append(("tree", *a)))
    ctx = tctx((2, 2))

    def body(r):
        x = _fake_cuda((4, COLS))
        tma.all_gather_torus_local(x, axes=("x", "y"), dims=(2, 2),
                                   out="out")
        tar._tree(_fake_cuda((7, COLS)), 4, ctx, r, out="out")
        return True

    assert all(ctx.run(body))
    assert asked == [("ar_tree", (2, 2, 4, COLS))] * 4
    torus = [a for a in launched if a[0] is _comm.AG_TORUS_KERNEL]
    assert len(torus) == 4
    for a in torus:
        assert a[1] == ("pad", "ag_torus") and a[4] == "out"
        assert a[5:] == (4 * COLS * 2, 2, 2)
    trees = [a for a in launched if a[0] == "tree"]
    assert [a[2] for a in trees] == [0, 1, 2, 3]
    assert all(a[4] == "out" and a[5] == 2 for a in trees)


def test_launch_arguments(monkeypatch):
    """Each launch hands its C entry exactly its argument list: the
    group's, the kernel's own (B12: n0, n1; the tree: rows, trees, dtype
    code), then the grid, the flags' scope and the pad layout, the stream
    last; the tree's grid is G blocks a tree (``tree_grid``)."""
    seen = {}

    def fake_meeting(kernel, pad, rank, dev, what, args, variants=()):
        seen[kernel.symbol] = list(args)

    monkeypatch.setattr(_comm, "_launch_at_meeting", fake_meeting)
    monkeypatch.setattr(_comm, "_sm_caps", lambda ctx: [33])
    monkeypatch.setattr(_comm, "current_stream", lambda dev: "stream")
    ctx = types.SimpleNamespace(
        devices=[torch.device("cuda:0")] * 4, num_ranks=4, timeout_s=1.0,
        error_word=lambda r: None)
    pad = types.SimpleNamespace(ctx=ctx, table=[None] * 4,
                                signal_table=[None] * 4,
                                next_epoch=lambda r: 5)
    x = torch.empty(203, 4096, dtype=torch.bfloat16)
    _comm.launch_push(_comm.AG_TORUS_KERNEL, pad, 2, x, x, 1 << 20, 2, 2)
    _comm.launch_tree(pad, 2, x, x, 2)
    args = seen[_comm.AG_TORUS_KERNEL.symbol]
    assert len(args) == len(_comm.AG_TORUS_KERNEL.argtypes)
    assert args[3:6] == [2, 4, 5] and args[9:12] == [1 << 20, 2, 2]
    assert args[12:-1] == [16, 0, *_comm.PUSH_LAYOUT.args()]
    args = seen[_comm.TREE_KERNEL.symbol]
    assert len(args) == len(_comm.TREE_KERNEL.argtypes)
    assert args[9:13] == [4096 * 2, 203, 2, 1]
    assert args[13:-1] == [16, 0, *_comm.TREE_LAYOUT.args()]
    assert args[-1] == "stream"


# ---------------------------------------------------------------------------
# The schedules: one writer a slot.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", GRIDS, ids=[f"{a}x{b}" for a, b in GRIDS])
def test_torus_schedule_one_writer_a_slot(shape):
    """Every slot of every receiver's output has exactly one writer, on
    one of the two hops; each rank writes its own slot itself; the ranks
    that write into an output are the ones it publishes to (its row and
    column of the grid); a rank forwards only slots it received on the
    first hop, from its inner peers, in the inner ring's order."""
    n0, n1 = shape
    n = n0 * n1
    plan = tma.torus_schedule(n0, n1)
    writers = {}
    first_hop = {}
    for w, p in enumerate(plan):
        for d in p["own"]:
            writers.setdefault((d, w), []).append(w)
            first_hop.setdefault(d, set()).add(w)
        for s, dests in p["forward"]:
            for d in dests:
                writers.setdefault((d, s), []).append(w)
    assert sorted(writers) == [(d, s) for d in range(n) for s in range(n)]
    assert all(len(ws) == 1 for ws in writers.values())
    for d, p in enumerate(plan):
        a, b = divmod(d, n1)
        assert writers[(d, d)] == [d]
        into = sorted({ws[0] for (r, _), ws in writers.items() if r == d}
                      - {d})
        assert into == p["writers"] == sorted(
            r for r in range(n) if r != d and (r // n1 == a or r % n1 == b))
        assert [s for s, _ in p["forward"]] == [
            a * n1 + (b - i) % n1 for i in range(1, n1)]
        assert all(s in first_hop[d] for s, _ in p["forward"])


@pytest.mark.parametrize("trees", [1, 2])
@pytest.mark.parametrize("n", range(2, 9))
def test_tree_schedule_one_writer_a_slot(n, trees):
    """Each parent slot (tree, slot 0 / 1) has exactly one writer, its
    child 2p+1 / 2p+2; each rank's rows of a tree are written by exactly
    one rank (its parent, or itself at the root); every rank holds one
    position a tree and sits one level below its parent; tree 1 is the
    heap over reversed ranks. At n >= 3 a rank is a leaf of one tree and
    interior in the other (separate blocks a tree keep them apart)."""
    plan = tar.tree_schedule(n, trees)
    for t, nodes in enumerate(plan):
        assert sorted(nd["pos"] for nd in nodes) == list(range(n))
        assert nodes[0 if t == 0 else n - 1]["parent"] is None
        slots = {}
        rows_by = {r: [] for r in range(n)}
        for r, nd in enumerate(nodes):
            if nd["parent"] is None:
                rows_by[r].append(r)
                assert nd["level"] == 0
            else:
                p = nodes[nd["parent"]]
                slots.setdefault((nd["parent"], nd["slot"]), []).append(r)
                assert nd["level"] == p["level"] + 1
                assert r in p["children"]
                assert p["children"].index(r) == nd["slot"]
            for c in nd["children"]:
                rows_by[c].append(r)
        assert all(len(w) == 1 for w in slots.values())
        assert len(slots) == n - 1
        assert all(len(w) == 1 for w in rows_by.values())
    if trees == 2 and n >= 3:
        assert any(bool(plan[0][r]["children"]) != bool(plan[1][r]["children"])
                   for r in range(n))


# ---------------------------------------------------------------------------
# The plain versions on the schedules.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", range(2, 9))
def test_tree_plain_protocol_equals_tree_plain(n, dtype):
    """The tree's plain version (partials into the parents' slots level by
    level, sums into the children's outputs) gives ``tree_plain``'s bits
    on every rank at 1, 2, 7 and 33 rows, twice over one workspace (the
    slots' reuse), each into a NaN-filled ``out=`` it returns whole."""
    ctx = tctx(n)
    for rows in (1, 2, 7, 33):
        xs = [_x((rows, COLS), dtype, 100 * n + rows + r) for r in range(n)]
        want = tar.tree_plain(xs)

        def body(r):
            got = []
            for _ in range(2):
                out = torch.full((rows, COLS), float("nan"), dtype=dtype)
                res = tar.all_reduce_local(xs[r], num_ranks=n,
                                           method="tree", out=out)
                assert res is out
                got.append(res)
            return got

        for outs in ctx.run(body):
            for o in outs:
                assert torch.equal(_bits(o), _bits(want))


def test_tree_vs_jax_three_ranks():
    """n = 3 (the heap's lone child; tree 1 over reversed ranks), fp32, 32
    rows (two trees on both sides), against the JAX package's tree in
    interpret mode, bit for bit."""
    n, rows = 3, 32
    assert tar._tree_halves(rows) == jar._tree_halves(rows, jnp.float32) == 2
    x = np.random.default_rng(3).standard_normal(
        (n, rows, 128)).astype(np.float32)
    jctx = JDistContext(mesh=Mesh(np.array(jax.devices()[:n]), ("tp",)))
    want = np.asarray(jar.all_reduce(jnp.asarray(x), jctx, method="tree"))
    got = tar.all_reduce(torch.from_numpy(x), tctx(n), method="tree")
    for out in got:
        np.testing.assert_array_equal(out.numpy(), want)


@pytest.mark.parametrize("shape", GRIDS, ids=[f"{a}x{b}" for a, b in GRIDS])
def test_torus_plain_into_sentinel(shape):
    """The torus AllGather's plain version (own shards, then the forward
    hop, into the receivers' outputs) writes every element of a NaN-filled
    ``out=`` it returns, twice in a row: ``torch.cat`` of the shards in
    joint order on every rank; the kernel's counter counts each call."""
    n0, n1 = shape
    n, m = n0 * n1, 3
    ctx = tctx(shape)
    xs = [_x((m, COLS), torch.bfloat16, 40 + r) for r in range(n)]
    want = torch.cat(xs)
    before = _comm.AG_TORUS_KERNEL.plain_calls

    def body(r):
        got = []
        for _ in range(2):
            out = torch.full((n * m, COLS), float("nan"),
                             dtype=torch.bfloat16)
            res = tag.all_gather_local(xs[r], axis=("x", "y"),
                                       num_ranks=shape, out=out)
            assert res is out
            got.append(res)
        return got

    for outs in ctx.run(body):
        assert all(torch.equal(_bits(o), _bits(want)) for o in outs)
    assert _comm.AG_TORUS_KERNEL.plain_calls - before == 2 * n


def test_out_refusals():
    """``out=`` belongs to the tree (pinned) and to the torus kernel on a
    real grid: anything else is refused by name, as is a wrong ``out``."""
    x = torch.ones((4, COLS))

    def body(r):
        with pytest.raises(ValueError, match="out= is the tree's"):
            tar.all_reduce_local(x, num_ranks=2, method="one_shot",
                                 out=torch.empty_like(x))
        with pytest.raises(ValueError, match="out must be"):
            tar.all_reduce_local(x, num_ranks=2, method="tree",
                                 out=torch.empty(3, COLS))
        with pytest.raises(ValueError, match="needs the torus kernel"):
            tma.all_gather_torus_local(x, axes=("x", "y"), dims=(2, 1),
                                       out=torch.empty(8, COLS))
        with pytest.raises(ValueError, match="torus kernel alone"):
            tag.all_gather_local(x, axis=("x", "y"), num_ranks=(2, 1),
                                 method="xla", out=torch.empty(8, COLS))
        return True

    assert all(tctx(2).run(body))
