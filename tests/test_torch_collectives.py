"""The port's collectives (``ops/allreduce``, ``ops/reduce_scatter``,
``ops/allgather`` with its parity stream) against the JAX package's on the
conftest's CPU mesh (Pallas interpret mode, remote DMA emulated), method
pinned, at n = 2, 4 and 8 ranks, fp32 and bf16, on the shapes of
``tests/test_collectives.py``.

The port's ranks are CPU threads (``DistContext(devices=["cpu"] * n)``);
the kernels' plain versions run, rendezvousing through the symmetric
buffers' slots. Each keeps its kernel's order and rounding, so every
comparison is bit for bit — bf16 included: the one-shot sums in fp32 in
rank order and casts once, the ring RS rounds to bf16 after each hop in
the same chunk order, on both sides.

Also: AUTO's choices against the reference's cost formulas on the H100's
link constants, the named refusals, a lost peer's rendezvous raising
``CommTimeoutError`` instead of hanging, and the rank runner's failure
handling.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as JP

from triton_distributed_tpu.ops import allreduce as jar
from triton_distributed_tpu.ops import allgather as jag
from triton_distributed_tpu.ops.allgather import all_gather as jall_gather
from triton_distributed_tpu.ops.reduce_scatter import (
    reduce_scatter as jreduce_scatter,
)
from triton_distributed_tpu.runtime import perf_model as jpm
from triton_distributed_tpu.runtime import shard_map_on
from triton_distributed_tpu.runtime.context import DistContext as JDistContext
from triton_distributed_tpu_torch.layers.common import tp_reduce
from triton_distributed_tpu_torch.ops import allgather as tag
from triton_distributed_tpu_torch.ops import allreduce as tar
from triton_distributed_tpu_torch.ops import reduce_scatter as trs
from triton_distributed_tpu_torch.ops._comm import (
    AG_PARITY_KERNEL, ONE_SHOT_KERNEL,
)
from triton_distributed_tpu_torch.runtime import perf_model as tpm
from triton_distributed_tpu_torch.runtime.context import (
    CommTimeoutError, DistContext, RankGroupError, current_rank,
)

NS = (2, 4, 8)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
_CTX: dict = {}


def jctx(n: int) -> JDistContext:
    """An n-device JAX mesh (not installed as the global context)."""
    return JDistContext(mesh=Mesh(np.array(jax.devices()[:n]), ("tp",)))


def tctx(n: int) -> DistContext:
    """The port's rank group of n CPU threads, one per n for the module."""
    if n not in _CTX:
        _CTX[n] = DistContext([torch.device("cpu")] * n,
                              wait_timeout_ms=60_000)
    return _CTX[n]


def _data(shape, dtype: str, seed: int):
    """The same values on both sides: numpy fp32, cast to the type by
    each framework (round to nearest even in both)."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _bits(a) -> np.ndarray:
    """Exact comparison form: float32 holds every bf16 value."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("method", ["one_shot", "two_shot"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n", NS)
def test_all_reduce_vs_jax(n, dtype, method):
    # A second call reuses buffers; the one-shot at n <= 4 runs a third at
    # the verify step's 16 rows.
    shapes = [(n, 32, 128)] * 2
    if method == "one_shot" and n <= 4:
        shapes.append((n, 16, 256))
    for it, shape in enumerate(shapes):
        jx, tx = _data(shape, dtype, 20 + it)
        want = _bits(jar.all_reduce(jx, jctx(n), method=method))
        got = tar.all_reduce(tx, tctx(n), method=method)
        assert len(got) == n
        for r, out in enumerate(got):
            np.testing.assert_array_equal(_bits(out), want,
                                          err_msg=f"rank {r}")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n", NS)
def test_reduce_scatter_vs_jax(n, dtype):
    jx, tx = _data((n, n * 16, 128), dtype, 10 + n)
    want = _bits(jreduce_scatter(jx, jctx(n)))
    got = trs.reduce_scatter(tx, tctx(n))
    for r, out in enumerate(got):
        np.testing.assert_array_equal(_bits(out),
                                      want[r * 16:(r + 1) * 16],
                                      err_msg=f"rank {r}")


@pytest.mark.parametrize("rows", [16, 48])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n", NS)
def test_all_gather_ring_vs_jax(n, dtype, rows):
    jx, tx = _data((n * rows, 128), dtype, 30 + n + rows - 16)
    want = _bits(jall_gather(jx, jctx(n), method="ring_1d", stacked=True))
    got = tag.all_gather(tx, tctx(n), method="ring_1d")
    for r, out in enumerate(got):
        np.testing.assert_array_equal(_bits(out), want[r],
                                      err_msg=f"rank {r}")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n", NS)
def test_all_reduce_stream_vs_jax(n, dtype):
    """Repeated parity-stream calls over one persistent workspace (both
    parities, each twice), a rotating straggler on the port's side: each
    call's sum equals the JAX package's, bit for bit."""
    m, cols, steps = 8, 128, 4
    jx, tx = _data((n, steps * m, cols), dtype, 40 + n)

    def run(xl):
        xl = xl[0]
        ws, idx = jar.ar_stream_workspace(n, m, cols, xl.dtype)
        outs = []
        for t in range(steps):
            out, ws, idx = jar.all_reduce_stream(
                xl[t * m:(t + 1) * m], ws, idx, axis="tp", num_ranks=n)
            outs.append(out)
        return jnp.stack(outs)[None]

    want = _bits(jax.jit(shard_map_on(jctx(n), run, JP("tp"), JP("tp")))(jx))
    ctx = tctx(n)
    ws, idx0 = tar.ar_stream_workspace(n, m, cols, DTYPES[dtype][1], ctx=ctx,
                                       tag=f"test-{dtype}")

    def trun(r):
        idx, outs = idx0, []
        for t in range(steps):
            out, _, idx = tar.all_reduce_stream(
                tx[r, t * m:(t + 1) * m], ws, idx, num_ranks=n,
                straggler=("rotate", 100_000))
            outs.append(out)
        return torch.stack(outs), idx

    got = ctx.run(trun)
    for r, (outs, idx) in enumerate(got):
        assert idx == steps
        np.testing.assert_array_equal(_bits(outs), want[r],
                                      err_msg=f"rank {r}")


def _ag_stream_jax(n, x, calls, straggler):
    """The JAX package's parity AllGather over ``calls`` calls of
    x·(1 + t) on one workspace: the (calls, n·m, cols) gathers a rank
    and the index after."""
    m, cols = x.shape[1], x.shape[2]

    def run(xl):
        xl = xl[0]
        ws, idx = jag.ag_stream_workspace(n, m, cols, xl.dtype)
        outs = []
        for t in range(calls):
            out, ws, idx = jag.all_gather_stream(
                xl * (1.0 + t), ws, idx, axis="tp", num_ranks=n,
                straggler=straggler)
            outs.append(out)
        return jnp.stack(outs)[None], idx[None]

    outs, idx = jax.jit(shard_map_on(jctx(n), run, JP("tp"),
                                     (JP("tp"), JP("tp"))))(x)
    return _bits(outs), np.asarray(idx)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n", NS)
def test_all_gather_stream_fixed_straggler_vs_jax(n, dtype):
    """Barrier-free parity AllGather with a FIXED straggler (rank 1 held
    back on both sides): three calls over one workspace — both parities
    and a reuse — each gather bit for bit the JAX package's, on every
    rank; the index after is 3."""
    m, cols, calls = 16, 128, 3
    jx, tx = _data((n, m, cols), dtype, 50 + n)
    want, jidx = _ag_stream_jax(n, jx, calls, (1, 512))
    assert (jidx == calls).all()
    ctx = tctx(n)
    ws, idx0 = tag.ag_stream_workspace(n, m, cols, DTYPES[dtype][1],
                                       ctx=ctx, tag=f"test-fixed-{dtype}")
    before = AG_PARITY_KERNEL.plain_calls

    def trun(r):
        idx, outs = idx0, []
        for t in range(calls):
            out, _, idx = tag.all_gather_stream(
                tx[r] * (1.0 + t), ws, idx, axis="tp", num_ranks=n,
                straggler=(1, 100_000))
            outs.append(out)
        return torch.stack(outs), idx

    got = ctx.run(trun)
    assert AG_PARITY_KERNEL.plain_calls - before == n * calls
    for r, (outs, idx) in enumerate(got):
        assert idx == calls
        np.testing.assert_array_equal(_bits(outs), want[r],
                                      err_msg=f"rank {r}")


@pytest.mark.parametrize("n", [2, 4])
def test_all_gather_stream_rotating_200_calls(n):
    """200 parity calls over one workspace with a rotating straggler: each
    gather exact (x·(1 + t) in rank order, the JAX package's for the
    first four), every rank alike; the index after is 200; a call out of
    sequence and a workspace of another shape or type are refused."""
    m, cols, steps = 16, 128, 200
    jx, tx = _data((n, m, cols), "float32", 60 + n)
    want4, _ = _ag_stream_jax(n, jx, 4, ("rotate", 256))
    ctx = tctx(n)
    ws, idx0 = tag.ag_stream_workspace(n, m, cols, torch.float32, ctx=ctx,
                                       tag="test-rotating")
    full = torch.cat(list(tx))

    def trun(r):
        idx, bad, first = idx0, [], []
        for t in range(steps):
            out, _, idx = tag.all_gather_stream(
                tx[r] * (1.0 + t), ws, idx, num_ranks=n,
                straggler=("rotate", 1_000))
            if not torch.equal(out, full * (1.0 + t)):
                bad.append(t)
            if t < 4:
                first.append(out)
        with pytest.raises(ValueError, match="call_index"):
            tag.all_gather_stream(tx[r], ws, idx + 1, num_ranks=n)
        with pytest.raises(ValueError, match="workspace shape"):
            tag.all_gather_stream(tx[r][:8], ws, idx, num_ranks=n)
        with pytest.raises(ValueError, match="workspace dtype"):
            tag.all_gather_stream(tx[r].double(), ws, idx, num_ranks=n)
        return bad, torch.stack(first), idx

    for r, (bad, first, idx) in enumerate(ctx.run(trun)):
        assert bad == [] and idx == steps
        np.testing.assert_array_equal(_bits(first), want4[r],
                                      err_msg=f"rank {r}")
    # A second ask for the tag returns the workspace at its next call.
    assert tag.ag_stream_workspace(n, m, cols, torch.float32, ctx=ctx,
                                   tag="test-rotating") == (ws, steps)


def test_all_gather_stream_one_rank():
    """At n = 1 the input comes back without a call; ``force_kernel`` runs
    the plain version of the loopback (the push to itself)."""
    ctx = DistContext([torch.device("cpu")], wait_timeout_ms=60_000)
    x = torch.arange(4 * 128, dtype=torch.float32).reshape(4, 128)
    ws, idx = tag.ag_stream_workspace(1, 4, 128, torch.float32, ctx=ctx)

    def body(r):
        before = AG_PARITY_KERNEL.plain_calls
        same, _, i1 = tag.all_gather_stream(x, ws, idx, num_ranks=1)
        forced, _, i2 = tag.all_gather_stream(x, ws, idx, num_ranks=1,
                                              force_kernel=True)
        return same, forced, i1, i2, AG_PARITY_KERNEL.plain_calls - before

    same, forced, i1, i2, calls = ctx.run(body)[0]
    assert same is x and torch.equal(forced, x) and forced is not x
    assert (i1, i2, calls) == (1, 1, 1)
    ctx.close()


def test_plain_reduction_order():
    """The one-shot's plain sum starts from 0 (0 + -0 = +0, as the TPU
    kernel's zeroed accumulator) and adds in rank order in fp32; the ring
    RS's adds round in the payload type, chunk c starting at rank c+1."""
    neg0 = torch.full((1, 4), -0.0)
    out = tar.reduce_slots_plain([neg0, neg0])
    assert not torch.signbit(out).any()
    big, tiny = torch.tensor([[256.0]]), torch.tensor([[1.0]])
    xs = [t.to(torch.bfloat16) for t in (big, tiny, tiny)]
    # fp32 accumulation, one cast: 258 is a bf16 value.
    assert tar.reduce_slots_plain(xs).item() == 258.0
    # Ring order for chunk 0 of 3 ranks: (x1 + x2) + x0 in bf16 = 2 + 256.
    rows = [torch.cat([x, x, x]) for x in xs]
    assert trs.rs_ring_plain(rows, 0).item() == 258.0
    # Chunk 1: (x2 + x0) + x1 = 256 (1 + 256 rounds to 256), then + 1.
    assert trs.rs_ring_plain(rows, 1).item() == 256.0


def _h100_ref_spec():
    """The reference's ChipSpec carrying the H100's link constants (one
    NVLink, 450 GB/s a direction, 1 us a hop)."""
    return jpm.ChipSpec("h100", 989.0, 3350.0, 0, 450.0, 1, 1, 25.0,
                        ici_hop_latency_s=1e-6)


@pytest.mark.parametrize("n", NS)
def test_comm_cost_models_vs_reference(n):
    """The ring, two-shot and tree formulas equal the reference's on the
    H100's link constants at every n; one-shot and the full-mesh AG equal
    them at n = 2, where the reference's ring and NVLink agree (one hop);
    at n > 2 every NVLink peer is one hop, where the ring has ~n/4."""
    hs, rs = tpm.chip_spec("NVIDIA H100 80GB HBM3"), _h100_ref_spec()
    for rows in (4, 16, 64, 256, 2048):
        b = rows * 4096 * 2
        for m in ("two_shot", "tree"):
            assert tpm.allreduce_time_s(b, n, m, hs) == pytest.approx(
                jpm.allreduce_time_s(b, n, m, rs), rel=1e-12)
        assert tpm.allgather_ring_time_s(b, n, hs) == pytest.approx(
            jpm.allgather_ring_time_s(b, n, rs), rel=1e-12)
        one = tpm.allreduce_time_s(b, n, "one_shot", hs)
        assert one == pytest.approx((n - 1) * b / 450e9 + 1e-6, rel=1e-12)
        if n == 2:
            assert one == pytest.approx(
                jpm.allreduce_time_s(b, n, "one_shot", rs), rel=1e-12)
            assert tpm.allgather_full_mesh_time_s(b, n, hs) == \
                pytest.approx(jpm.allgather_full_mesh_time_s(b, n, rs),
                              rel=1e-12)


def test_auto_methods_on_h100():
    """AUTO on the H100: one-shot at n <= 2; at n = 4 in bf16 x 4096
    one-shot up to ~1.35 MB (164 rows), the double tree up to ~1.8 MB
    (219 rows), two-shot beyond — so the serving path's 4-row decode,
    16-row verify and 256-row slice take one-shot, one-shot, two-shot."""
    hs = tpm.chip_spec("NVIDIA H100 80GB HBM3")

    def auto(rows, n):
        return tar.get_auto_allreduce_method(
            rows * 4096 * 2, n, tree_halves=tar._tree_halves(rows),
            spec=hs).value

    assert {auto(r, 2) for r in (4, 256, 2048)} == {"one_shot"}
    assert [auto(r, 4) for r in (4, 16, 64, 164, 166, 218, 220, 256,
                                 2048)] == (
        ["one_shot"] * 4 + ["tree"] * 2 + ["two_shot"] * 3)
    # The reference's own selector with the same model picks the same
    # at n = 2 and on the ring-only payloads at n = 4.
    assert jar.get_auto_allreduce_method(256 * 4096 * 2, 2).value == \
        "one_shot"
    assert tag.get_auto_all_gather_method(1 << 20, 2).value == \
        "full_mesh_push"


def test_named_refusals():
    ctx = tctx(2)
    x = torch.ones((4, 128))

    def refused(r):
        out = []
        # The double tree is no longer refused: at n = 2 each rank is the
        # other's tree's leaf, and the sum of two equal inputs is exact.
        assert torch.equal(tar.all_reduce_local(x, num_ranks=2,
                                                method="tree"), 2 * x)
        # Nor is B4's full-mesh push, pinned or as AUTO's pick at n = 2:
        # every rank gets both ranks' rows.
        for how in ("full_mesh_push", "auto"):
            assert torch.equal(tag.all_gather_local(x, num_ranks=2,
                                                    method=how),
                               torch.cat([x, x]))
        # Nor is B4's parity stream: two calls over one workspace (both
        # parities) gather both ranks' rows.
        ws, idx = tag.ag_stream_workspace(2, 4, 128, x.dtype,
                                          tag="refusals")
        for t in range(2):
            got, _, idx = tag.all_gather_stream(x * (t + 1), ws, idx,
                                                num_ranks=2)
            assert torch.equal(got, torch.cat([x, x]) * (t + 1))
        out.append(idx == 2)
        # The tuple-axis forms (ops/multi_axis.py) and the two-tier
        # tp_reduce are ported: on this one-axis group a real (2, 2) grid
        # names the axis it does not have (tests/test_torch_multi_axis.py
        # runs them on 2-axis groups).
        for fn in (
                lambda: tar.all_reduce_local(x, axis=("dcn", "tp"),
                                             num_ranks=(2, 2)),
                lambda: trs.reduce_scatter_local(x, axis=("dcn", "tp"),
                                                 num_ranks=(2, 2))):
            with pytest.raises(ValueError, match="'dcn' unknown"):
                fn()
            out.append(True)
        with pytest.raises(ValueError, match="'dcn' unknown"):
            tp_reduce(x, axis="tp", n=2, n_inter=2)
        with pytest.raises(ValueError, match="num_ranks"):
            tar.all_reduce_local(x, num_ranks=4)
        with pytest.raises(ValueError, match="divisible"):
            trs.reduce_scatter_local(torch.ones((3, 128)), num_ranks=2)
        return out

    assert all(all(o) for o in ctx.run(refused))
    with pytest.raises(RuntimeError, match="outside a rank thread"):
        current_rank()


def test_lost_peer_times_out():
    """A rank that never joins: its peers' rendezvous raises
    CommTimeoutError within the deadline, the run re-raises it, and the
    spent group refuses further runs."""
    ctx = DistContext([torch.device("cpu")] * 4, wait_timeout_ms=300)
    x = torch.ones((4, 128))
    t0 = time.perf_counter()
    with pytest.raises(CommTimeoutError) as info:
        ctx.run(lambda r: None if r == 3 else tar.all_reduce_local(
            x, num_ranks=4, method="one_shot"))
    assert time.perf_counter() - t0 < 10
    assert info.value.expected == 4 and info.value.timeout_s == 0.3
    with pytest.raises(RankGroupError):
        ctx.run(lambda r: r)
    ctx.close()


def test_rank_failure_aborts_peers():
    """An exception on one rank breaks the others' rendezvous at once (no
    wait for the deadline) and is the one re-raised."""
    ctx = DistContext([torch.device("cpu")] * 4, wait_timeout_ms=60_000)
    x = torch.ones((4, 128))

    def body(r):
        if r == 2:
            raise KeyError("rank 2 failed")
        return tar.all_reduce_local(x, num_ranks=4, method="one_shot")

    t0 = time.perf_counter()
    with pytest.raises(KeyError, match="rank 2 failed"):
        ctx.run(body)
    assert time.perf_counter() - t0 < 10
    ctx.close()


def test_plain_calls_counted_per_rank():
    ctx = tctx(4)
    before = ONE_SHOT_KERNEL.plain_calls
    tar.all_reduce(torch.ones((4, 4, 128)), ctx, method="one_shot")
    assert ONE_SHOT_KERNEL.plain_calls - before == 4


def test_symmetric_buffers_cached_per_key():
    """One tensor per rank, of the asked shape, type and fill, cached on
    the context by (shape, dtype, tag): a second ask returns the same
    buffer, another tag a new one. CPU buffers carry no pointer tables."""
    from triton_distributed_tpu_torch.runtime.symm import (
        symm_full, symm_zeros,
    )

    ctx = tctx(2)
    a = symm_full(ctx, (3, 4), 7.0, torch.bfloat16, tag="t")
    assert len(a.tensors) == 2 and a.table is None
    assert all(t.shape == (3, 4) and t.dtype == torch.bfloat16
               and bool((t == 7).all()) for t in a.tensors)
    assert symm_full(ctx, (3, 4), 7.0, torch.bfloat16, tag="t") is a
    z = symm_zeros(ctx, (3, 4), torch.bfloat16, tag="t")
    assert z is not a and not any(bool(t.any()) for t in z.tensors)
    assert a.next_epoch(0) == 1 and a.next_epoch(0) == 2 and \
        a.next_epoch(1) == 1
