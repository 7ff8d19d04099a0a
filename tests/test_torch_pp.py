"""The port's pipeline-parallel transport (``ops/p2p``: kernel B7's ring
shift and permutation; ``layers/pp``: ``CommOp``, ``PPStream`` and the
GPipe and interleaved schedules) against the JAX package's on the
conftest's CPU mesh (Pallas interpret mode), at n = 2 and 4 with one case
at n = 8, on ``tests/test_pp.py``'s and
``tests/test_p2p_gemm_ar.py::test_p2p_shift``'s shapes.

The port's ranks are CPU threads of a group whose axis is named ``"pp"``;
B7's plain version moves the blocks through the symmetric receive
buffers. Tolerance: bit for bit everywhere — the transport only moves
bytes, and the stage functions add in the same order on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as JP

from triton_distributed_tpu.layers import pp as jpp
from triton_distributed_tpu.ops.p2p import (
    p2p_permute_local as j_permute_local, p2p_shift as j_shift,
)
from triton_distributed_tpu.runtime import shard_map_on
from triton_distributed_tpu.runtime.context import DistContext as JDistContext
from triton_distributed_tpu_torch.layers import pp as tpp
from triton_distributed_tpu_torch.ops import p2p as tp2p
from triton_distributed_tpu_torch.ops._comm import (
    P2P_PERMUTE_KERNEL, P2P_SHIFT_KERNEL,
)
from triton_distributed_tpu_torch.runtime.context import DistContext

_CTX: dict = {}


def jctx(n: int) -> JDistContext:
    return JDistContext(mesh=Mesh(np.array(jax.devices()[:n]), ("tp",)))


def tctx(n: int) -> DistContext:
    """The port's group of n CPU rank threads on the axis "pp"."""
    if n not in _CTX:
        _CTX[n] = DistContext([torch.device("cpu")] * n, tp_axis="pp",
                              wait_timeout_ms=60_000)
    return _CTX[n]


def _jax_blocks(n, fn, x):
    """``fn`` under shard_map over the n-device mesh: (n·m, cols) blocks
    in, blocks out."""
    return np.asarray(jax.jit(shard_map_on(jctx(n), fn, in_specs=JP("tp"),
                                           out_specs=JP("tp")))(
        jnp.asarray(x)))


def _port_blocks(n, fn, x):
    """``fn(rank, block)`` on the port's n ranks; the blocks stacked."""
    xs = torch.chunk(torch.from_numpy(x), n, dim=0)
    outs = tctx(n).run(lambda r: fn(r, xs[r]))
    return torch.cat(outs).numpy()


@pytest.mark.parametrize("n", [2, 4, 8])
def test_p2p_shift_vs_jax(n):
    """``test_p2p_shift``: a push and a pull around the ring, host level,
    the port's blocks equal to the JAX package's and to np.roll."""
    x = np.arange(n * 8 * 128, dtype=np.float32).reshape(n * 8, 128)
    before = P2P_SHIFT_KERNEL.plain_calls
    for shift in (1, -1):
        want = np.asarray(j_shift(jnp.asarray(x), jctx(n), shift=shift))
        got = tp2p.p2p_shift(torch.from_numpy(x), tctx(n), shift=shift,
                             axis="pp")
        np.testing.assert_array_equal(torch.cat(got).numpy(), want)
        np.testing.assert_array_equal(
            want, np.roll(x.reshape(n, 8, 128), shift, axis=0).reshape(
                n * 8, 128))
    assert P2P_SHIFT_KERNEL.plain_calls - before == 2 * n


@pytest.mark.parametrize("n", [2, 4])
def test_pp_stream_ring(n):
    """send_next / send_prev shift activations one stage around the ring,
    as the JAX package's PPStream; bf16 rides the byte copy."""
    m, cols = 8, 128
    x = np.random.default_rng(3).standard_normal((n * m, cols)).astype(
        np.float32)
    for way in ("send_next", "send_prev"):
        want = _jax_blocks(n, lambda xl: getattr(
            jpp.PPStream(axis="tp", num_ranks=n), way)(xl), x)
        got = _port_blocks(n, lambda r, xl: getattr(
            tpp.PPStream(axis="pp", num_ranks=n), way)(xl), x)
        np.testing.assert_array_equal(got, want)
    got = _port_blocks(n, lambda r, xl: tpp.PPStream(
        axis="pp", num_ranks=n).send_next(xl.to(torch.bfloat16)).float(), x)
    np.testing.assert_array_equal(
        got, np.roll(torch.from_numpy(x).to(torch.bfloat16).float().numpy()
                     .reshape(n, m, cols), 1, axis=0).reshape(n * m, cols))


def _pp_inputs(n, num_mb, mb, cols, seed):
    x = np.random.default_rng(seed).standard_normal(
        (num_mb, mb, cols)).astype(np.float32)
    return x, np.broadcast_to(x, (n, *x.shape)).reshape(n * num_mb, mb, cols)


@pytest.mark.parametrize("n", [2, 4])
def test_pp_pipeline_forward_vs_jax(n):
    """n-stage GPipe, each stage adding its stage id: the last stage's
    outputs equal the JAX package's and x + sum(stage ids); the other
    stages return zeros; num_mb + n - 2 shifts a rank."""
    num_mb, mb, cols = 6, 8, 128
    x, xs = _pp_inputs(n, num_mb, mb, cols, 0)

    def jrun(x_mb):
        return jpp.pp_pipeline_forward(
            lambda t: t + jax.lax.axis_index("tp").astype(t.dtype), x_mb,
            axis="tp", num_ranks=n)

    want = _jax_blocks(n, jrun, xs).reshape(n, num_mb, mb, cols)
    before = P2P_SHIFT_KERNEL.plain_calls
    got = _port_blocks(n, lambda r, x_mb: tpp.pp_pipeline_forward(
        lambda t: t + float(r), x_mb, axis="pp", num_ranks=n),
        xs).reshape(n, num_mb, mb, cols)
    assert P2P_SHIFT_KERNEL.plain_calls - before == n * (num_mb + n - 2)
    np.testing.assert_array_equal(got[n - 1], want[n - 1])
    np.testing.assert_allclose(got[n - 1], x + sum(range(n)), rtol=1e-5,
                               atol=1e-5)
    assert not got[:n - 1].any()


@pytest.mark.parametrize("n,chunks", [(2, 3), (4, 2)])
def test_pp_pipeline_interleaved_vs_jax(n, chunks):
    """Interleaved virtual stages (chunk c on rank d adds 100·c + d): the
    last virtual stage's outputs equal the JAX package's and the
    sequential composition; (num_mb + chunks·n - 2)·chunks shifts a
    rank."""
    num_mb, mb, cols = 5, 8, 128
    x, xs = _pp_inputs(n, num_mb, mb, cols, 1)

    def jrun(x_mb):
        return jpp.pp_pipeline_interleaved(
            lambda c, t: t + (100.0 * c
                              + jax.lax.axis_index("tp").astype(t.dtype)),
            x_mb, chunks=chunks, axis="tp", num_ranks=n)

    want = _jax_blocks(n, jrun, xs).reshape(n, num_mb, mb, cols)
    before = P2P_SHIFT_KERNEL.plain_calls
    got = _port_blocks(n, lambda r, x_mb: tpp.pp_pipeline_interleaved(
        lambda c, t: t + (100.0 * c + r), x_mb, chunks=chunks, axis="pp",
        num_ranks=n), xs).reshape(n, num_mb, mb, cols)
    assert P2P_SHIFT_KERNEL.plain_calls - before == \
        n * (num_mb + chunks * n - 2) * chunks
    np.testing.assert_array_equal(got[n - 1], want[n - 1])
    np.testing.assert_allclose(
        got[n - 1], x + sum(100.0 * c + d for c in range(chunks)
                            for d in range(n)), rtol=1e-5, atol=1e-5)


# (n, perm): a partial perm with a multicast (rank 0 feeds two), a
# butterfly, one pair (n = 2's butterfly is a ring), and a full ring that
# takes the shift kernel.
PERMS = {
    "partial_multicast_4": (4, [(0, 3), (2, 1), (0, 2)]),
    "partial_multicast_8": (8, [(0, 3), (5, 2), (0, 6)]),
    "butterfly_4": (4, [(s, s ^ 1) for s in range(4)]),
    "one_pair_2": (2, [(1, 0)]),
    "ring_shift3_4": (4, [(s, (s + 3) % 4) for s in range(4)]),
}


@pytest.mark.parametrize("case", sorted(PERMS))
def test_p2p_permute_vs_jax(case):
    """``p2p_permute_local`` against the JAX package's (ppermute's
    semantics: idle ranks get zeros): bit for bit; a full ring launches
    the shift, any other perm the permutation."""
    n, perm = PERMS[case]
    m, cols = 8, 128
    x = np.random.default_rng(7).standard_normal((n * m, cols)).astype(
        np.float32)
    want = _jax_blocks(n, lambda xl: j_permute_local(
        xl, perm, axis="tp", num_ranks=n), x)
    shift0, perm0 = (P2P_SHIFT_KERNEL.plain_calls,
                     P2P_PERMUTE_KERNEL.plain_calls)
    got = _port_blocks(n, lambda r, xl: tp2p.p2p_permute_local(
        xl, perm, axis="pp", num_ranks=n), x)
    np.testing.assert_array_equal(got, want)
    expect = np.zeros_like(x.reshape(n, m, cols))
    for s, d in perm:
        expect[d] = x.reshape(n, m, cols)[s]
    np.testing.assert_array_equal(got, expect.reshape(n * m, cols))
    ring = case.startswith("ring")
    assert P2P_SHIFT_KERNEL.plain_calls - shift0 == (n if ring else 0)
    assert P2P_PERMUTE_KERNEL.plain_calls - perm0 == (0 if ring else n)
    assert tp2p._as_shift(perm, n) == (3 if ring else None)


@pytest.mark.parametrize("n", [2, 4])
def test_commop_exchange_and_send_vs_jax(n):
    """CommOp's exchange(perm) and single-pair send composed on every
    rank, as the JAX package's."""
    m, cols = 8, 128
    x = np.arange(n * m * cols, dtype=np.float32).reshape(n * m, cols)
    src, dst = 0, n - 1

    def jf(xl):
        op = jpp.CommOp(axis="tp", num_ranks=n)
        return op.send(xl, src=src, dst=dst) + op.exchange(
            xl, [(s, (s + 1) % n) for s in range(n)])

    def tf(r, xl):
        op = tpp.CommOp(axis="pp", num_ranks=n)
        return op.send(xl, src=src, dst=dst) + op.exchange(
            xl, [(s, (s + 1) % n) for s in range(n)])

    np.testing.assert_array_equal(_port_blocks(n, tf, x),
                                  _jax_blocks(n, jf, x))


def test_commop_n1_keeps_ppermute_zeros():
    """At n = 1 CommOp has no shortcut: a perm without (0, 0) gives zeros
    (as every n > 1 run feeds an idle rank), with it the input; under
    ``force_kernel`` the permute kernel's plain version runs (not the
    shift's), and PPStream hands its input back."""
    ctx = DistContext([torch.device("cpu")], tp_axis="pp")
    x = torch.arange(8 * 128, dtype=torch.float32).reshape(8, 128)
    jx = jnp.asarray(x.numpy())
    want = _jax_blocks(1, lambda xl: jpp.CommOp(
        axis="tp", num_ranks=1).exchange(xl, []), x.numpy())
    assert not want.any()

    def body(r):
        op = tpp.CommOp(axis="pp", num_ranks=1)
        forced = tpp.CommOp(axis="pp", num_ranks=1, force_kernel=True)
        p0 = P2P_PERMUTE_KERNEL.plain_calls
        s0 = P2P_SHIFT_KERNEL.plain_calls
        out = (op.exchange(x, []), op.exchange(x, [(0, 0)]),
               forced.exchange(x, [(0, 0)]), forced.exchange(x, []),
               tpp.PPStream(axis="pp", num_ranks=1).send_next(x),
               tp2p.p2p_shift_local(x, 1, axis="pp", num_ranks=1,
                                    force_kernel=True))
        return out, (P2P_PERMUTE_KERNEL.plain_calls - p0,
                     P2P_SHIFT_KERNEL.plain_calls - s0)

    (zeros, same, f_same, f_zeros, stream, f_shift), counts = \
        ctx.run(body)[0]
    assert not zeros.any() and not f_zeros.any()
    assert torch.equal(same, x) and torch.equal(f_same, x)
    assert stream is x and torch.equal(f_shift, x)
    assert counts == (2, 1)
    np.testing.assert_array_equal(zeros.numpy(), np.asarray(jx * 0))
    ctx.close()


def test_p2p_refusals():
    """A duplicate destination and a rank outside the group raise, as the
    reference's; a stage layer without num_ranks raises."""
    ctx = DistContext([torch.device("cpu")] * 2, tp_axis="pp")
    x = torch.ones((8, 128))

    def body(r):
        with pytest.raises(ValueError, match="duplicate destination"):
            tp2p.p2p_permute_local(x, [(0, 1), (1, 1)], axis="pp",
                                   num_ranks=2)
        with pytest.raises(ValueError, match="outside"):
            tp2p.p2p_permute_local(x, [(0, 2)], axis="pp", num_ranks=2)
        with pytest.raises(ValueError, match="axis"):
            tp2p.p2p_shift_local(x, 1, axis="tp", num_ranks=2)
        return True

    assert all(ctx.run(body))
    for cls in (tpp.CommOp, tpp.PPStream):
        with pytest.raises(ValueError, match="num_ranks"):
            cls(axis="pp")
    ctx.close()
