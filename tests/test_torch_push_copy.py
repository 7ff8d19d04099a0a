"""The push protocol of B4's full-mesh push and B7 (``csrc/push.cuh``)
on the CPU: the plain versions — the ranks exchange their outputs, each
source stores into its destinations' outputs, the ranks meet — against the
JAX package's kernels on the conftest's CPU mesh (Pallas interpret mode),
bit for bit; and the host side of the card's launch (the pad layout, the
grid, the flags' scope, the argument list), computed in Python so that it
is checked here.

The port's ranks are CPU threads. Tolerance: bit for bit everywhere — the
push only moves bytes.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from triton_distributed_tpu.ops.allgather import all_gather as jall_gather
from triton_distributed_tpu.ops.p2p import p2p_permute as j_permute
from triton_distributed_tpu.ops.p2p import p2p_shift as j_shift
from triton_distributed_tpu.runtime.context import DistContext as JDistContext
from triton_distributed_tpu_torch.ops import _comm
from triton_distributed_tpu_torch.ops import allgather as tag
from triton_distributed_tpu_torch.ops import p2p as tp2p
from triton_distributed_tpu_torch.runtime.context import DistContext
from triton_distributed_tpu_torch.runtime.symm import SIGNAL_WORDS

TYPES = {"float32": (jnp.float32, torch.float32),
         "bfloat16": (jnp.bfloat16, torch.bfloat16)}
COLS = 128
_CTX: dict = {}


def jctx(n: int) -> JDistContext:
    return JDistContext(mesh=Mesh(np.array(jax.devices()[:n]), ("tp",)))


def tctx(n: int) -> DistContext:
    if n not in _CTX:
        _CTX[n] = DistContext([torch.device("cpu")] * n,
                              wait_timeout_ms=60_000)
    return _CTX[n]


def _bits(t: torch.Tensor) -> np.ndarray:
    """A payload's bytes, so that bf16 compares bit for bit."""
    return t.contiguous().view(torch.uint8).numpy()


def _jbits(a, dtype: str) -> np.ndarray:
    """A JAX result's bytes in the port's payload type (bf16 widens to
    fp32 exactly and narrows back)."""
    x = np.array(jnp.asarray(a).astype(jnp.float32))
    return _bits(torch.from_numpy(x).to(TYPES[dtype][1]))


def _inputs(n: int, rows: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (n * rows, COLS)).astype(np.float32)


@pytest.mark.parametrize("dtype", sorted(TYPES))
@pytest.mark.parametrize("rows", [1, 3, 64])
@pytest.mark.parametrize("n", [2, 4])
def test_push_vs_jax(n, rows, dtype):
    """B4's full-mesh push at 1, 3 and 64 rows a rank: every rank's
    gathered rows equal the JAX kernel's, bit for bit, through the plain
    version (n calls of it, one a rank)."""
    jdt, tdt = TYPES[dtype]
    x = _inputs(n, rows, 10 * n + rows)
    want = jall_gather(jnp.asarray(x, jdt), jctx(n),
                       method="full_mesh_push", stacked=True)
    before = _comm.AG_FULL_MESH_KERNEL.plain_calls
    got = tag.all_gather(torch.from_numpy(x).to(tdt), tctx(n),
                         method="full_mesh_push")
    assert _comm.AG_FULL_MESH_KERNEL.plain_calls - before == n
    for r, out in enumerate(got):
        assert out.shape == (n * rows, COLS) and out.dtype == tdt
        np.testing.assert_array_equal(_bits(out), _jbits(want[r], dtype))


@pytest.mark.parametrize("dtype", sorted(TYPES))
@pytest.mark.parametrize("shift", [1, -1, 3])
@pytest.mark.parametrize("n", [2, 4])
def test_p2p_shift_vs_jax(n, shift, dtype):
    """B7's ring shift by +1, -1 and 3: the port's blocks equal the JAX
    package's, bit for bit."""
    jdt, tdt = TYPES[dtype]
    x = _inputs(n, 8, 7 + n)
    want = j_shift(jnp.asarray(x, jdt), jctx(n), shift=shift)
    before = _comm.P2P_SHIFT_KERNEL.plain_calls
    got = torch.cat(tp2p.p2p_shift(torch.from_numpy(x).to(tdt), tctx(n),
                                   shift=shift))
    assert _comm.P2P_SHIFT_KERNEL.plain_calls - before == n
    np.testing.assert_array_equal(_bits(got), _jbits(want, dtype))


# (n, perm): a partial permutation with a multicast (rank 0 feeds two) and
# idle ranks; a butterfly; n = 2's lone pair (its butterfly is a ring).
PERMS = {
    "partial_multicast_4": (4, [(0, 3), (0, 1), (3, 0)]),
    "multicast_self_2": (2, [(0, 0), (0, 1)]),
    "butterfly_4": (4, [(s, s ^ 1) for s in range(4)]),
    "one_pair_2": (2, [(1, 0)]),
}


@pytest.mark.parametrize("dtype", sorted(TYPES))
@pytest.mark.parametrize("case", sorted(PERMS))
def test_p2p_permute_vs_jax(case, dtype):
    """B7's permutation: the destinations hold their source's block, the
    idle ranks zeros — the JAX package's, bit for bit."""
    n, perm = PERMS[case]
    jdt, tdt = TYPES[dtype]
    x = _inputs(n, 8, 31)
    want = j_permute(jnp.asarray(x, jdt), perm, jctx(n))
    before = _comm.P2P_PERMUTE_KERNEL.plain_calls
    got = torch.cat(tp2p.p2p_permute(torch.from_numpy(x).to(tdt), perm,
                                     tctx(n)))
    assert _comm.P2P_PERMUTE_KERNEL.plain_calls - before == n
    np.testing.assert_array_equal(_bits(got), _jbits(want, dtype))
    idle = set(range(n)) - {d for _, d in perm}
    for d in idle:
        assert not got[d * 8:(d + 1) * 8].any()


@pytest.mark.parametrize("n", [2, 4])
def test_back_to_back_calls(n):
    """Two calls of each kernel in one run, without a host sync between,
    on new data: each gives the plain version's bits (the receivers'
    outputs are fresh, so the second call's sources never touch the
    first call's)."""
    xs = [torch.from_numpy(_inputs(n, 4, 50 + t)).to(torch.bfloat16)
          for t in range(2)]
    perm = [(s, (s + 1) % n) for s in range(n - 1)]   # rank 0 idle

    def body(r):
        outs = []
        for x in xs:
            xl = x[r * 4:(r + 1) * 4]
            outs.append((tag.all_gather_local(xl, num_ranks=n,
                                              method="full_mesh_push"),
                         tp2p.p2p_shift_local(xl, 1, num_ranks=n),
                         tp2p.p2p_permute_local(xl, perm, num_ranks=n)))
        return outs

    got = tctx(n).run(body)
    for t, x in enumerate(xs):
        blocks = list(x.reshape(n, 4, COLS))
        shifted = tp2p.p2p_plain(blocks, [(s, (s + 1) % n)
                                          for s in range(n)])
        permuted = tp2p.p2p_plain(blocks, perm)
        for r in range(n):
            ag, sh, pm = got[r][t]
            assert torch.equal(ag.view(torch.int16), x.view(torch.int16))
            assert torch.equal(sh.view(torch.int16),
                               shifted[r].view(torch.int16))
            assert torch.equal(pm.view(torch.int16),
                               permuted[r].view(torch.int16))


def test_out_sentinel_every_element_written():
    """``out=`` (a harness's NaN sentinel): the push and both B7 kernels
    write every element of it, the idle rank's zeros included, and return
    it."""
    n, rows = 4, 3
    x = torch.from_numpy(_inputs(n, rows, 5))
    perm = [(0, 3), (0, 1), (3, 0)]

    def body(r):
        xl = x[r * rows:(r + 1) * rows]
        ag = torch.full((n * rows, COLS), float("nan"))
        sh = torch.full((rows, COLS), float("nan"))
        pm = torch.full((rows, COLS), float("nan"))
        got = (tag.all_gather_local(xl, num_ranks=n, method="full_mesh_push",
                                    out=ag),
               tp2p.p2p_shift_local(xl, -1, num_ranks=n, out=sh),
               tp2p.p2p_permute_local(xl, perm, num_ranks=n, out=pm))
        assert all(g is o for g, o in zip(got, (ag, sh, pm)))
        return got

    outs = tctx(n).run(body)
    blocks = list(x.reshape(n, rows, COLS))
    for r, (ag, sh, pm) in enumerate(outs):
        assert not any(bool(t.isnan().any()) for t in (ag, sh, pm))
        assert torch.equal(ag, x)
        assert torch.equal(sh, blocks[(r + 1) % n])
        assert torch.equal(pm, tp2p.p2p_plain(blocks, perm)[r])


def test_push_loopback_and_refusals():
    """At n = 1 the push returns its input unless ``force_kernel`` (the
    loopback: the plain version writes the rank's own slot); ``out`` and
    ``force_kernel`` belong to the push alone, and a wrong ``out`` is
    refused."""
    ctx = DistContext([torch.device("cpu")])
    x = torch.arange(4 * COLS, dtype=torch.float32).reshape(4, COLS)

    def body(r):
        before = _comm.AG_FULL_MESH_KERNEL.plain_calls
        same = tag.all_gather_local(x, num_ranks=1, method="full_mesh_push")
        forced = tag.all_gather_local(x, num_ranks=1,
                                      method="full_mesh_push",
                                      force_kernel=True)
        calls = _comm.AG_FULL_MESH_KERNEL.plain_calls - before
        with pytest.raises(ValueError, match="full-mesh push"):
            tag.all_gather_local(x, num_ranks=1, method="ring_1d",
                                 force_kernel=True)
        with pytest.raises(ValueError, match="out must be"):
            tag.all_gather_local(x, num_ranks=1, method="full_mesh_push",
                                 force_kernel=True, out=torch.empty(3, COLS))
        with pytest.raises(ValueError, match="needs the kernel"):
            tp2p.p2p_shift_local(x, 1, num_ranks=1, out=torch.empty_like(x))
        return same, forced, calls

    same, forced, calls = ctx.run(body)[0]
    assert same is x and forced is not x and torch.equal(forced, x)
    assert calls == 1
    ctx.close()


def test_no_payload_buffer():
    """The push and B7 keep no symmetric payload buffer (their outputs are
    the receivers' own): after calls of both, the group's cache holds no
    buffer tagged ``"ag_full_mesh"`` or ``"p2p"``."""
    n = 2
    ctx = tctx(n)
    x = torch.from_numpy(_inputs(n, 8, 3))
    tag.all_gather(x, ctx, method="full_mesh_push")
    tp2p.p2p_shift(x, ctx, shift=1)
    tp2p.p2p_permute(x, [(1, 0)], ctx)
    tags = {k[3] for k in ctx._symm if k[0] == "symm"}
    assert not tags & {"ag_full_mesh", "p2p"}


@pytest.mark.parametrize("n", range(1, 9))
def test_push_layout_words_fit_the_pad(n):
    """The address, ready and data words of a call at n ranks and the
    largest grid are distinct and inside ``SIGNAL_WORDS`` (the kernel
    refuses a layout that is not: ``push.cuh`` bad_layout)."""
    lay = _comm.PUSH_LAYOUT
    words = lay.words(n, _comm.PUSH_MAX_BLOCKS)
    flat = [w for ws in words.values() for w in ws]
    assert len(flat) == len(set(flat)) == 2 * n + n * _comm.PUSH_MAX_BLOCKS
    assert min(flat) >= 0 and max(flat) < SIGNAL_WORDS
    assert lay.ready >= lay.addr + _comm.MAX_RANKS
    assert lay.data >= lay.ready + _comm.MAX_RANKS
    assert lay.stride >= _comm.PUSH_MAX_BLOCKS
    assert lay.data + _comm.MAX_RANKS * lay.stride <= SIGNAL_WORDS


@pytest.mark.parametrize("ranks_on_card", [1, 2, 4, 8])
def test_push_grid_same_on_every_rank(ranks_on_card):
    """The grid: a block per PUSH_BLOCK_BYTES of a rank's payload, at
    least 1, at most the card's SMs over its ranks (132 on an H100) and
    the pad's PUSH_MAX_BLOCKS — a function of the payload and the group
    alone, so every rank computes the same one."""
    sms = 132
    cap = min(sms // ranks_on_card, _comm.PUSH_MAX_BLOCKS)
    for nbytes in (16, 4096, 16 << 10, (64 << 10) + 16, 4 << 20, 64 << 20):
        caps = [sms // ranks_on_card]
        grids = {_comm.push_grid(nbytes, caps) for _ in range(ranks_on_card)}
        assert len(grids) == 1
        grid = grids.pop()
        assert 1 <= grid <= cap
        assert grid == min(cap, -(-nbytes // _comm.PUSH_BLOCK_BYTES))
    # Main shapes: the push at n = 2 (4 MiB a rank) and B7 at n = 4.
    if ranks_on_card == 2:
        assert _comm.push_grid(4 << 20, [66]) == 64
    if ranks_on_card == 4:
        assert _comm.push_grid(4 << 20, [33]) == 33
    with pytest.raises(ValueError):
        _comm.push_grid(4096, [0])


def test_push_scope_and_launch_arguments(monkeypatch):
    """The flags' scope: the GPU's when the group is one card, the
    system's when ranks sit on several (a peer's output may be another
    card's memory). The launch hands the C entry exactly its argument
    list: the group's, the kernel's own, then grid, scope and the pad
    layout, the stream last."""
    one = types.SimpleNamespace(devices=[torch.device("cuda:0")] * 4)
    four = types.SimpleNamespace(
        devices=[torch.device(f"cuda:{i}") for i in range(4)])
    assert _comm.push_scope(one) == 0 and _comm.push_scope(four) == 1

    seen = {}

    def fake_meeting(kernel, pad, rank, dev, what, args, variants=()):
        seen[kernel.symbol] = list(args)

    monkeypatch.setattr(_comm, "_launch_at_meeting", fake_meeting)
    monkeypatch.setattr(_comm, "_sm_caps", lambda ctx: [33])
    monkeypatch.setattr(_comm, "current_stream", lambda dev: "stream")
    ctx = types.SimpleNamespace(
        devices=one.devices, num_ranks=4, timeout_s=1.0,
        error_word=lambda r: None)
    pad = types.SimpleNamespace(ctx=ctx, table=[None] * 4,
                                signal_table=[None] * 4,
                                next_epoch=lambda r: 7)
    x = torch.empty(512, 4096, dtype=torch.bfloat16)
    nbytes = x.numel() * 2
    _comm.launch_push(_comm.AG_FULL_MESH_KERNEL, pad, 1, x, x, nbytes)
    _comm.launch_push(_comm.P2P_SHIFT_KERNEL, pad, 1, x, x, nbytes, 1)
    _comm.launch_push(_comm.P2P_PERMUTE_KERNEL, pad, 1, x, x, nbytes, 6, 0)
    for kern, extra in ((_comm.AG_FULL_MESH_KERNEL, []),
                        (_comm.P2P_SHIFT_KERNEL, [1]),
                        (_comm.P2P_PERMUTE_KERNEL, [6, 0])):
        args = seen[kern.symbol]
        assert len(args) == len(kern.argtypes)
        assert args[3:6] == [1, 4, 7] and args[9] == nbytes
        assert args[10:-1] == extra + [33, 0, *_comm.PUSH_LAYOUT.args()]
        assert args[-1] == "stream"
