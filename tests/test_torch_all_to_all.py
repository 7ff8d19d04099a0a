"""The port's AllToAll (``ops/all_to_all``, kernel B8's plain versions) and
B4's full-mesh push against the JAX package on the conftest's CPU mesh
(Pallas interpret mode, remote DMA emulated), at n = 2 and 4.

The port's ranks are CPU threads; the plain versions exchange the splits
through ``group_all_to_all`` and the live blocks through a symmetric
buffer's slots. A copy has no rounding, so every comparison is bit for
bit (tolerance 0): the live rows and ``recv_splits`` against the JAX
package's interpret-mode kernel and against the golden ``recv[d, p] ==
send[p, d]``; the layout helpers' integers exact and their buffers
bit-exact. Rows past a slot's count are unspecified on both sides and
are not read.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from triton_distributed_tpu.ops import all_to_all as ja2a
from triton_distributed_tpu.ops.allgather import all_gather as jall_gather
from triton_distributed_tpu.runtime.context import DistContext as JDistContext
from triton_distributed_tpu_torch.ops import _comm
from triton_distributed_tpu_torch.ops import all_to_all as ta2a
from triton_distributed_tpu_torch.ops import allgather as tag
from triton_distributed_tpu_torch.runtime import autotuner
from triton_distributed_tpu_torch.runtime.context import DistContext

_CTX: dict = {}
TYPES = {"float32": (jnp.float32, torch.float32),
         "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def jctx(n: int) -> JDistContext:
    return JDistContext(mesh=Mesh(np.array(jax.devices()[:n]), ("tp",)))


def tctx(n: int) -> DistContext:
    if n not in _CTX:
        _CTX[n] = DistContext([torch.device("cpu")] * n,
                              wait_timeout_ms=60_000)
    return _CTX[n]


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _case(kind: str, n: int, epr: int, cap: int, hidden: int, seed: int):
    """(send (n, n, cap, h) fp32 numpy, splits (n, n, epr) int32): slot
    [d, p] holds rank d's rows for rank p, zero past its count."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        splits = rng.integers(0, cap // epr + 1, size=(n, n, epr))
    elif kind == "empty":
        splits = np.zeros((n, n, epr))
        splits[0, 1 % n, 0] = 3         # one live row in the whole call
    elif kind == "full":
        splits = np.zeros((n, n, epr))
        splits[:, 0, 0] = cap           # every rank fills rank 0's slot
    else:                               # ragged: counts off every block edge
        splits = rng.integers(0, 3, size=(n, n, epr)) * 7 + 1
        splits = np.minimum(splits, cap // epr)
    splits = splits.astype(np.int32)
    send = np.zeros((n, n, cap, hidden), np.float32)
    for d in range(n):
        for p in range(n):
            rows = int(splits[d, p].sum())
            send[d, p, :rows] = rng.standard_normal((rows, hidden))
    return send, splits


def _check_golden(recv, rsplits, send, splits, n):
    np.testing.assert_array_equal(rsplits, np.swapaxes(splits, 0, 1))
    for d in range(n):
        for p in range(n):
            rows = int(rsplits[d, p].sum())
            np.testing.assert_array_equal(recv[d, p, :rows],
                                          send[p, d, :rows],
                                          err_msg=f"recv[{d},{p}]")


@pytest.mark.parametrize("kind", ["random", "empty", "full", "ragged"])
@pytest.mark.parametrize("dtype", sorted(TYPES))
@pytest.mark.parametrize("n", [2, 4])
def test_fast_all_to_all_vs_jax(n, dtype, kind):
    epr, cap, hidden = 2, 32, 128
    send, splits = _case(kind, n, epr, cap, hidden, 10 * n + len(kind))
    jdt, tdt = TYPES[dtype]
    jrecv, jrs = ja2a.fast_all_to_all(jnp.asarray(send, jdt),
                                      jnp.asarray(splits), jctx(n))
    jrecv, jrs = _f32(jrecv), np.asarray(jrs)
    before = _comm.A2A_KERNEL.plain_calls
    recv, rs = ta2a.fast_all_to_all(torch.from_numpy(send).to(tdt),
                                    torch.from_numpy(splits), tctx(n))
    assert _comm.A2A_KERNEL.plain_calls - before == n
    recv = np.stack([_f32(r) for r in recv])
    rs = np.stack([r.numpy() for r in rs])
    assert rs.dtype == np.int32
    np.testing.assert_array_equal(rs, jrs)
    for d in range(n):
        for p in range(n):
            rows = int(rs[d, p].sum())
            np.testing.assert_array_equal(recv[d, p, :rows],
                                          jrecv[d, p, :rows])
    _check_golden(recv, rs, _f32(torch.from_numpy(send).to(tdt)), splits, n)
    # The host-level plain version on the stacked inputs (chip_smoke's
    # yardstick) agrees with the rank threads'.
    want, want_rs = ta2a.a2a_plain(torch.from_numpy(send).to(tdt),
                                   torch.from_numpy(splits), 16)
    np.testing.assert_array_equal(want_rs.numpy(), rs)
    for d in range(n):
        for p in range(n):
            rows = int(rs[d, p].sum())
            np.testing.assert_array_equal(_f32(want[d, p, :rows]),
                                          recv[d, p, :rows])


@pytest.mark.parametrize("dtype", ["float32", "float8_e4m3fn"])
def test_fast_all_to_all_stream(dtype):
    """Five calls over one persistent workspace at n = 4 — both parities,
    counts changing every call (empty slots included), a rotating
    straggler —, every call's live rows and splits equal to the golden;
    the call index advances by one a call and a call out of sequence is
    refused; an e4m3 payload crosses bit-exactly."""
    n, epr, cap, hidden = 4, 2, 32, 64
    tdt = {"float32": torch.float32, "float8_e4m3fn": torch.float8_e4m3fn}[
        dtype]
    ctx = tctx(n)
    calls = [_case("random" if t % 2 else "ragged", n, epr, cap, hidden,
                   50 + t) for t in range(5)]
    sends = [torch.from_numpy(s).to(tdt) for s, _ in calls]
    ws, idx0 = ta2a.a2a_stream_workspace(n, cap, hidden, tdt, ctx=ctx,
                                         tag=f"test-{dtype}")
    assert ws.shape == (2, n, cap, hidden)
    before = _comm.A2A_PARITY_KERNEL.plain_calls

    def run(r):
        idx, outs = idx0, []
        for t, (_, splits) in enumerate(calls):
            recv, rs, _, idx = ta2a.fast_all_to_all_stream(
                sends[t][r], torch.from_numpy(splits[r]), ws, idx,
                num_ranks=n, straggler=("rotate", 200_000))
            outs.append((recv, rs))
        return idx, outs

    res = ctx.run(run)
    assert _comm.A2A_PARITY_KERNEL.plain_calls - before == 5 * n
    assert [r[0] for r in res] == [idx0 + 5] * n
    for t, (_, splits) in enumerate(calls):
        recv = np.stack([_f32(res[r][1][t][0]) for r in range(n)])
        rs = np.stack([res[r][1][t][1].numpy() for r in range(n)])
        _check_golden(recv, rs, _f32(sends[t]), splits, n)
    with pytest.raises(ValueError, match="out of sequence|next call"):
        ctx_bad = DistContext([torch.device("cpu")] * n,
                              wait_timeout_ms=60_000)
        ws2, _ = ta2a.a2a_stream_workspace(n, cap, hidden, tdt, ctx=ctx_bad)
        ctx_bad.run(lambda r: ta2a.fast_all_to_all_stream(
            sends[0][r], torch.from_numpy(calls[0][1][r]), ws2, 3,
            num_ranks=n))


@pytest.mark.parametrize("force", [False, True])
def test_fast_all_to_all_stream_one_rank(force):
    """At n = 1 the stream form returns its input untouched and launches
    nothing, unless ``force_kernel``: then it runs the exchange through the
    workspace (here the plain version, one call a call) and still hands
    back what it was sent — against the JAX package's stream at n = 1
    with the same ``force_kernel`` (interpret mode), bit for bit."""
    from jax.sharding import PartitionSpec as P

    from triton_distributed_tpu.runtime import shard_map_on

    n, epr, cap, hidden = 1, 2, 32, 64
    calls = [_case("random", n, epr, cap, hidden, 70 + t) for t in range(3)]

    def jrun(sb, sp):
        ws, idx = ja2a.a2a_stream_workspace(n, cap, hidden, sb.dtype)
        outs, rss = [], []
        for t in range(len(calls)):
            rb, rs, ws, idx = ja2a.fast_all_to_all_stream(
                sb[0, t], sp[0, t], ws, idx, num_ranks=n,
                force_kernel=force)
            outs.append(rb)
            rss.append(rs)
        return jnp.stack(outs)[None], jnp.stack(rss)[None]

    jsend = jnp.asarray(np.stack([s[0] for s, _ in calls])[None])
    jspl = jnp.asarray(np.stack([sp[0] for _, sp in calls])[None])
    fn = shard_map_on(jctx(n), jrun, (P("tp"), P("tp")), (P("tp"), P("tp")))
    jouts, jrs = fn(jsend, jspl)
    jouts, jrs = _f32(jouts[0]), np.asarray(jrs[0])

    ctx = tctx(n)
    ws, idx0 = ta2a.a2a_stream_workspace(n, cap, hidden, torch.float32,
                                         ctx=ctx, tag=f"test-n1-{force}")
    before = _comm.A2A_PARITY_KERNEL.plain_calls

    def run(r):
        idx, outs = idx0, []
        for send, splits in calls:
            recv, rs, _, idx = ta2a.fast_all_to_all_stream(
                torch.from_numpy(send[r]), torch.from_numpy(splits[r]), ws,
                idx, num_ranks=n, force_kernel=force)
            outs.append((recv, rs))
        return idx, outs

    (idx, outs), = ctx.run(run)
    assert idx == idx0 + len(calls)
    assert (_comm.A2A_PARITY_KERNEL.plain_calls - before
            == (len(calls) if force else 0))
    for t, (send, splits) in enumerate(calls):
        recv, rs = _f32(outs[t][0]), outs[t][1].numpy()
        assert rs.dtype == np.int32
        np.testing.assert_array_equal(rs, jrs[t])
        np.testing.assert_array_equal(rs, splits[0])
        rows = int(rs[0].sum())
        np.testing.assert_array_equal(recv[0, :rows], jouts[t, 0, :rows])
        np.testing.assert_array_equal(recv[0, :rows], send[0, 0, :rows])


def test_fast_all_to_all_refusals():
    ctx = tctx(2)
    x = torch.zeros((2, 24, 16))
    s = torch.zeros((2, 2), dtype=torch.int32)
    ws, _ = ta2a.a2a_stream_workspace(2, 32, 16, torch.float32, ctx=ctx,
                                      tag="refusals")

    def body(r):
        with pytest.raises(ValueError, match="multiple of block_rows"):
            ta2a.fast_all_to_all_local(x, s, num_ranks=2)
        with pytest.raises(ValueError, match=r"send_buf must be \(n=2"):
            ta2a.fast_all_to_all_local(x[0], s, num_ranks=2)
        with pytest.raises(ValueError, match="workspace shape"):
            ta2a.fast_all_to_all_stream(torch.zeros((2, 16, 16)), s, ws, 0,
                                        num_ranks=2)
        with pytest.raises(ValueError, match="workspace dtype"):
            ta2a.fast_all_to_all_stream(
                torch.zeros((2, 32, 16), dtype=torch.bfloat16), s, ws, 0,
                num_ranks=2)
        return True

    assert ctx.run(body) == [True, True]


@pytest.mark.parametrize("n", [2, 4])
def test_dispatch_combine_layout_vs_jax(n):
    """dispatch_layout / combine_layout on the same tokens: every integer
    exact, the send buffer bit-exact; then through the AllToAll, each
    rank's local experts receive exactly the tokens routed to them."""
    epr, hidden, m, cap = 4, 32, 24, 32
    E = n * epr
    rng = np.random.default_rng(2 + n)
    tokens = rng.standard_normal((n, m, hidden)).astype(np.float32)
    eids = rng.integers(0, E, size=(n, m)).astype(np.int32)
    sends, splits = [], []
    for d in range(n):
        jl = ja2a.dispatch_layout(jnp.asarray(tokens[d]),
                                  jnp.asarray(eids[d]), E, n, cap)
        tl = ta2a.dispatch_layout(torch.from_numpy(tokens[d]),
                                  torch.from_numpy(eids[d]), E, n, cap)
        np.testing.assert_array_equal(tl.send_buf.numpy(),
                                      np.asarray(jl.send_buf))
        for f in ("send_splits", "sort_idx", "sorted_rank", "pos_in_slot",
                  "overflow"):
            np.testing.assert_array_equal(getattr(tl, f).numpy(),
                                          np.asarray(getattr(jl, f)),
                                          err_msg=f)
        assert tl.send_splits.dtype == torch.int32 and int(tl.overflow) == 0
        sends.append(tl.send_buf)
        splits.append(tl.send_splits)
    recv, rs = ta2a.fast_all_to_all(sends, splits, tctx(n))
    for d in range(n):
        flat, leid, gs = ta2a.combine_layout(recv[d], rs[d])
        jflat, jleid, jgs = ja2a.combine_layout(
            jnp.asarray(recv[d].numpy()), jnp.asarray(rs[d].numpy()))
        np.testing.assert_array_equal(leid.numpy(), np.asarray(jleid))
        np.testing.assert_array_equal(gs.numpy(), np.asarray(jgs))
        assert leid.dtype == torch.int32 and gs.dtype == torch.int32
        for j in range(epr):
            want = tokens[eids == d * epr + j]
            got = flat.numpy()[leid.numpy() == j]
            assert got.shape == want.shape
            np.testing.assert_array_equal(got[np.lexsort(got.T)],
                                          want[np.lexsort(want.T)])


def test_dispatch_layout_overflow_vs_jax():
    """A cap below m·topk drops copies and says how many; the splits are
    clamped to what each slot holds, as the reference's."""
    m, hidden, n, E, cap = 16, 8, 2, 4, 4
    rng = np.random.default_rng(3)
    tokens = rng.standard_normal((m, hidden)).astype(np.float32)
    for eids in (np.zeros((m,), np.int32),
                 rng.integers(0, E, size=(m,)).astype(np.int32)):
        jl = ja2a.dispatch_layout(jnp.asarray(tokens), jnp.asarray(eids), E,
                                  n, cap)
        tl = ta2a.dispatch_layout(torch.from_numpy(tokens),
                                  torch.from_numpy(eids), E, n, cap)
        assert int(tl.overflow) == int(jl.overflow) > 0
        np.testing.assert_array_equal(tl.send_splits.numpy(),
                                      np.asarray(jl.send_splits))
        np.testing.assert_array_equal(tl.send_buf.numpy(),
                                      np.asarray(jl.send_buf))
    full = ta2a.dispatch_layout(torch.from_numpy(tokens),
                                torch.zeros((m,), dtype=torch.int32), E, n,
                                m)
    assert int(full.overflow) == 0


@pytest.mark.parametrize("dtype", sorted(TYPES))
def test_all_gather_full_mesh_vs_jax(dtype):
    """B4's full-mesh push at n = 2 (AUTO's pick there) and pinned at
    n = 4: bit-identical to the JAX package's kernel, counted as the
    full-mesh plain version."""
    jdt, tdt = TYPES[dtype]
    for n, method in ((2, "auto"), (4, "full_mesh_push")):
        x = np.random.default_rng(40 + n).standard_normal(
            (n * 16, 128)).astype(np.float32)
        want = _f32(jall_gather(jnp.asarray(x, jdt), jctx(n),
                                method="full_mesh_push", stacked=True))
        before = _comm.AG_FULL_MESH_KERNEL.plain_calls
        got = tag.all_gather(torch.from_numpy(x).to(tdt), tctx(n),
                             method=method)
        assert _comm.AG_FULL_MESH_KERNEL.plain_calls - before == n
        for r, out in enumerate(got):
            np.testing.assert_array_equal(_f32(out), want[r])


def test_tuned_a2a_block_rows(tmp_path, monkeypatch):
    """The block measured among the aligned candidates that divide the
    capacity (host clock off the card), then a cache hit."""
    monkeypatch.setenv("TDTPU_AUTOTUNE_CACHE", str(tmp_path / "t.json"))
    n, cap = 2, 32
    send, splits = _case("random", n, 2, cap, 64, 9)
    sends = [torch.from_numpy(s) for s in send]
    spl = [torch.from_numpy(s) for s in splits]
    best = autotuner.tuned_a2a_block_rows(sends, spl, tctx(n))
    assert best in (16, 32)
    assert autotuner.tuned_a2a_block_rows(sends, spl, tctx(n)) == best
    recv, rs = ta2a.fast_all_to_all(sends, spl, tctx(n), block_rows=best)
    _check_golden(np.stack([r.numpy() for r in recv]),
                  np.stack([r.numpy() for r in rs]), send, splits, n)
