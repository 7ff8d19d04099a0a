"""The port's two-level collectives (``ops/two_level``: the intra axis on
the kernels' plain versions over the fiber, the inter axis on the group's
plain operations) against the JAX package's on the conftest's 8-device
CPU mesh as (dcn=2, tp=4), in Pallas interpret mode, on
``tests/test_two_level.py``'s shapes and seeds.

Tolerances: the AllGather and the EP AllToAll move bytes (bit-identical);
the ReduceScatter, the AllReduce and the AG+GEMM on the tp axis of the
2-D group sum in fp32 in other orders than XLA may (atol = rtol = 1e-5;
the GEMM's 128-term products 1e-5 as well); the SP attention against the
JAX kernel at atol = rtol = 2e-5 (the two flash kernels' summation
orders), as ``tests/test_torch_sp_attention.py`` holds them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as JP

from triton_distributed_tpu.ops import ag_gemm as jag_gemm
from triton_distributed_tpu.ops import two_level as jtl
from triton_distributed_tpu.runtime import shard_map_on
from triton_distributed_tpu.runtime.context import DistContext as JDistContext
from triton_distributed_tpu_torch.ops import two_level as ttl
from triton_distributed_tpu_torch.ops._comm import (
    A2A_KERNEL, AG_FULL_MESH_KERNEL, AG_GEMM_KERNEL, AG_RING_KERNEL,
    RS_RING_KERNEL,
)
from triton_distributed_tpu_torch.ops.allgather_gemm import ag_gemm_local
from triton_distributed_tpu_torch.runtime.context import DistContext

TOL = dict(rtol=1e-5, atol=1e-5)
ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
_CTX: dict = {}


def jctx2d() -> JDistContext:
    devs = np.array(jax.devices()[:8]).reshape(2, 4)
    return JDistContext(mesh=Mesh(devs, ("dcn", "tp")))


def tctx2d() -> DistContext:
    if "2d" not in _CTX:
        _CTX["2d"] = DistContext([torch.device("cpu")] * 8,
                                 mesh_shape=(2, 4), axis_names=("dcn", "tp"),
                                 wait_timeout_ms=60_000)
    return _CTX["2d"]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def test_all_gather_2d_vs_jax():
    N, m, cols = 8, 16, 128
    x = np.random.default_rng(0).standard_normal((N * m, cols))
    ref = np.asarray(jtl.all_gather_2d(jnp.asarray(x, jnp.float32),
                                       jctx2d()))

    def ags():
        return AG_RING_KERNEL.plain_calls + AG_FULL_MESH_KERNEL.plain_calls

    before = ags()
    outs = ttl.all_gather_2d(_t(x), tctx2d())
    assert ags() == before + 8          # the intra kernel's (AUTO's pick)
    for o in outs:
        np.testing.assert_array_equal(o.numpy(), ref)


def test_all_reduce_2d_vs_jax():
    N, m, cols = 8, 32, 128
    x = np.random.default_rng(1).standard_normal((N, m, cols))
    ref = np.asarray(jtl.all_reduce_2d(jnp.asarray(x, jnp.float32),
                                       jctx2d()))
    before = (RS_RING_KERNEL.plain_calls, AG_RING_KERNEL.plain_calls)
    outs = ttl.all_reduce_2d(_t(x), tctx2d())
    assert RS_RING_KERNEL.plain_calls == before[0] + 8
    assert AG_RING_KERNEL.plain_calls == before[1] + 8
    for o in outs:
        assert torch.equal(o, outs[0])
    np.testing.assert_allclose(outs[0].numpy(), ref, **TOL)


def test_all_reduce_2d_rows_not_dividing():
    """Rows that do not divide over the intra axis take the plain sums
    over both axes (the reference's branch)."""
    x = np.random.default_rng(9).standard_normal((8, 2, 128))
    before = RS_RING_KERNEL.plain_calls
    outs = ttl.all_reduce_2d(_t(x), tctx2d())
    assert RS_RING_KERNEL.plain_calls == before
    np.testing.assert_allclose(outs[5].numpy(), x.sum(0), rtol=1e-5,
                               atol=1e-5)


def test_reduce_scatter_2d_vs_jax():
    N, m, cols = 8, 16, 128
    x = np.random.default_rng(2).standard_normal((N, N * m, cols))
    ref = np.asarray(jtl.reduce_scatter_2d(jnp.asarray(x, jnp.float32),
                                           jctx2d()))
    outs = ttl.reduce_scatter_2d(_t(x), tctx2d())
    np.testing.assert_allclose(np.concatenate([o.numpy() for o in outs]),
                               ref, **TOL)


def test_pallas_ops_work_on_tp_axis_of_2d_mesh():
    """A 1-D kernel (B9, the AG+GEMM) over the tp axis of the 2-D group:
    each rank's fiber is its slice's 4 ranks (the reference's
    ``tests/test_two_level.py:49`` case)."""
    n, m, k, cols = 4, 8, 128, 128
    rng = np.random.default_rng(3)
    a = rng.standard_normal((n * m, k)) * 0.1
    b = rng.standard_normal((k, n * cols)) * 0.1
    ref = np.asarray(jag_gemm(jnp.asarray(a, jnp.float32),
                              jnp.asarray(b, jnp.float32), jctx2d(),
                              axis="tp"))
    ctx = tctx2d()
    before = AG_GEMM_KERNEL.plain_calls

    def body(r):
        i = ctx.axis_index(r, "tp")
        return ag_gemm_local(_t(a[i * m:(i + 1) * m]),
                             _t(b[:, i * cols:(i + 1) * cols]), axis="tp",
                             num_ranks=n)

    outs = ctx.run(body)
    assert AG_GEMM_KERNEL.plain_calls == before + 8
    for r, o in enumerate(outs):
        i = ctx.axis_index(r, "tp")
        np.testing.assert_allclose(o.numpy(),
                                   ref[:, i * cols:(i + 1) * cols], **TOL)
        assert torch.equal(o, outs[i])     # the two slices agree


def test_fast_all_to_all_2d_vs_jax():
    """The hierarchical EP AllToAll (the inter hop, then B8 in each slice)
    delivers the JAX package's slots and splits, bit for bit where
    tokens live."""
    N, cap, hidden, epr = 8, 16, 64, 2
    rng = np.random.default_rng(3)
    send = rng.standard_normal((N, N, cap, hidden)).astype(np.float32)
    counts = rng.integers(0, cap // epr, size=(N, N, epr)).astype(np.int32)

    def run(sb, sp):
        rb, rs = jtl.fast_all_to_all_2d_local(sb[0], sp[0], n_intra=4,
                                              n_inter=2)
        return rb[None], rs[None]

    fn = shard_map_on(jctx2d(), run,
                      (JP(("dcn", "tp")), JP(("dcn", "tp"))),
                      (JP(("dcn", "tp")), JP(("dcn", "tp"))))
    jrb, jrs = (np.asarray(t) for t in fn(jnp.asarray(send),
                                          jnp.asarray(counts)))
    ctx = tctx2d()
    before = A2A_KERNEL.plain_calls
    outs = ctx.run(lambda r: ttl.fast_all_to_all_2d_local(
        _t(send[r]), torch.from_numpy(counts[r]), n_intra=4, n_inter=2))
    assert A2A_KERNEL.plain_calls == before + 8 * 2
    for dst, (rb, rs) in enumerate(outs):
        np.testing.assert_array_equal(rs.numpy(), jrs[dst])
        for src in range(N):
            used = int(counts[src, dst].sum())
            np.testing.assert_array_equal(rb[src, :used].numpy(),
                                          jrb[dst, src, :used])
            np.testing.assert_array_equal(rb[src, :used].numpy(),
                                          send[src, dst, :used])


def test_sp_ag_attention_2d_vs_jax():
    N, b, s, hq, hkv, d = 8, 1, 256, 4, 2, 64
    rng = np.random.default_rng(4)
    q = (rng.standard_normal((b, s, hq, d)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((b, s, hkv, d)) * 0.3).astype(np.float32)
    v = (rng.standard_normal((b, s, hkv, d)) * 0.3).astype(np.float32)
    fn = shard_map_on(
        jctx2d(),
        lambda qq, kk, vv: jtl.sp_ag_attention_2d_local(
            qq, kk, vv, n_intra=4, n_inter=2, causal=True),
        (JP(None, ("dcn", "tp")),) * 3, JP(None, ("dcn", "tp")))
    ref = np.asarray(fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    ctx = tctx2d()
    sl = s // N

    def body(r):
        g = ctx.axis_index(r, ("dcn", "tp"))
        cut = slice(g * sl, (g + 1) * sl)
        return ttl.sp_ag_attention_2d_local(
            _t(q[:, cut]), _t(k[:, cut]), _t(v[:, cut]), n_intra=4,
            n_inter=2, causal=True)

    outs = ctx.run(body)
    got = np.concatenate([o.numpy() for o in outs], axis=1)
    np.testing.assert_allclose(got, ref, **ATTN_TOL)


@pytest.mark.parametrize("fn", ["all_gather_2d_local", "all_reduce_2d_local",
                                "reduce_scatter_2d_local",
                                "fast_all_to_all_2d_local"])
def test_local_forms_need_both_degrees(fn):
    args = ((torch.ones(8, 4), torch.ones(8, 1, dtype=torch.int32))
            if fn == "fast_all_to_all_2d_local" else (torch.ones(8, 4),))
    with pytest.raises(ValueError, match="n_intra/n_inter required"):
        getattr(ttl, fn)(*args, n_intra=4)
