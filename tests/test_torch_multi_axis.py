"""The port's 2-axis rank group (``runtime/context``: mesh_shape,
axis_names, fibers) and its collectives over both axes
(``ops/multi_axis``: kernel B12's plain versions, the tuple-axis 1-D entry
points) against the JAX package's ``ops/multi_axis`` on the conftest's
8-device CPU mesh (Pallas interpret mode), on ``tests/test_multi_axis.py``'s
shapes and seeds, over (2, 4) and (8, 1) grids.

Tolerances: the AllGather and the ReduceScatter are bit-identical (a copy;
the ring RS adds in the payload type in the reference's ring order). The
AllReduce sums each phase's slots in fp32 in slot order in both
frameworks, but XLA is free to fuse the reference's reduction otherwise:
it is held at atol = rtol = 1e-5 against the JAX result in fp32 and at one
bf16 unit (2^-7) in bf16 — measured difference 0 in every case here (one
and two shot on (2, 4), (8, 1), bf16) —, and bit-identical on every rank
of the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from triton_distributed_tpu.ops import multi_axis as jma
from triton_distributed_tpu.runtime.context import DistContext as JDistContext
from triton_distributed_tpu_torch.ops import allgather as tag
from triton_distributed_tpu_torch.ops import allreduce as tar
from triton_distributed_tpu_torch.ops import multi_axis as tma
from triton_distributed_tpu_torch.ops import reduce_scatter as trs
from triton_distributed_tpu_torch.ops._comm import (
    AG_TORUS_KERNEL, AR_TORUS_KERNEL,
)
from triton_distributed_tpu_torch.runtime.context import (
    DistContext, Fiber, axis_index, group_all_gather, group_all_to_all,
    group_ppermute, group_psum, group_psum_scatter,
)

TOL = dict(rtol=1e-5, atol=1e-5)
_CTX: dict = {}


def jctx(shape) -> JDistContext:
    """The JAX mesh of ``shape`` over axes ("x", "y") (not installed as the
    global context)."""
    devs = np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape)
    return JDistContext(mesh=Mesh(devs, ("x", "y")))


def tctx(shape) -> DistContext:
    """The port's group of CPU rank threads over axes ("x", "y")."""
    if shape not in _CTX:
        _CTX[shape] = DistContext(
            [torch.device("cpu")] * (shape[0] * shape[1]), mesh_shape=shape,
            axis_names=("x", "y"), wait_timeout_ms=60_000)
    return _CTX[shape]


def _t(a, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


# ---------------------------------------------------------------------------
# The 2-axis group.
# ---------------------------------------------------------------------------

def test_group_layout_row_major():
    ctx = tctx((2, 4))
    assert ctx.axis_names == ("x", "y") and ctx.tp_axis == "x"
    assert ctx.num_ranks == 8
    assert (ctx.axis_size("x"), ctx.axis_size("y"),
            ctx.axis_size(("x", "y"))) == (2, 4, 8)
    assert ctx.coords(6) == (1, 2)
    assert ctx.axis_index(6, "x") == 1 and ctx.axis_index(6, "y") == 2
    assert ctx.axis_index(6, ("x", "y")) == 6
    assert ctx.axis_index(6, ("y", "x")) == 5
    assert ctx.fiber_members(6, "y") == (4, 5, 6, 7)
    assert ctx.fiber_members(6, "x") == (2, 6)
    fib, i = ctx.fiber(6, "x")
    assert isinstance(fib, Fiber) and i == 1 and fib.num_ranks == 2
    assert ctx.fiber(6, "x")[0] is fib           # one view per fiber
    assert ctx.fiber(6, ("x", "y")) == (ctx, 6)  # the whole group
    with pytest.raises(ValueError, match="'z' unknown"):
        ctx.axis_size("z")
    with pytest.raises(ValueError, match="does not cover"):
        DistContext([torch.device("cpu")] * 6, mesh_shape=(2, 4),
                    axis_names=("x", "y"))


def test_one_axis_group_unchanged():
    """A one-axis group is its own fiber: every collective sees the group
    itself, as before the 2-axis group existed."""
    ctx = DistContext([torch.device("cpu")] * 4, tp_axis="tp")
    assert ctx.axis_names == ("tp",) and ctx.mesh_shape == (4,)
    assert all(ctx.fiber(r, "tp") == (ctx, r) for r in range(4))


@pytest.mark.parametrize("axis", ["x", "y", ("x", "y")])
def test_group_ops_on_a_fiber(axis):
    """The plain group operations act on the caller's fiber along
    ``axis`` (every rank of the group meeting at the call)."""
    ctx = tctx((2, 4))
    xs = [torch.full((8, 4), float(r)) for r in range(8)]

    def body(r):
        members = ctx.fiber_members(r, axis)
        i = axis_index(axis)
        n = len(members)
        s = group_psum(xs[r], axis=axis, num_ranks=n)
        g = group_all_gather(xs[r][:1], axis=axis)
        a2a = group_all_to_all(xs[r], axis=axis)
        ps = group_psum_scatter(xs[r], axis=axis)
        shift = group_ppermute(xs[r], [(j, (j + 1) % n) for j in range(n)],
                               axis=axis)
        return (members, i, s[0, 0].item(), g[:, 0].tolist(),
                a2a[:, 0].tolist(), tuple(ps.shape), shift[0, 0].item())

    for r, (members, i, s, g, a2a, ps, shift) in enumerate(ctx.run(body)):
        n = len(members)
        assert members[i] == r
        assert s == float(sum(members))
        assert g == [float(m) for m in members]
        assert a2a == [float(m) for m in members for _ in range(8 // n)]
        assert ps == (8 // n, 4)
        assert shift == float(members[(i - 1) % n])


# ---------------------------------------------------------------------------
# B12 and the torus collectives against the JAX package.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,seed,cols", [(torch.float32, 0, 128),
                                             (torch.bfloat16, 1, 256)])
def test_all_gather_torus_vs_jax(dtype, seed, cols):
    N, m = 8, 16
    x = np.random.default_rng(seed).standard_normal((N * m, cols))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = np.asarray(jma.all_gather_torus(jnp.asarray(x, jdt),
                                          jctx((2, 4))), np.float32)
    before = AG_TORUS_KERNEL.plain_calls
    outs = tma.all_gather_torus(_t(x, dtype), tctx((2, 4)))
    assert AG_TORUS_KERNEL.plain_calls == before + 8
    for o in outs:
        assert o.dtype == dtype
        np.testing.assert_array_equal(_np(o), ref)


@pytest.mark.parametrize("method", ["one_shot", "two_shot", "auto"])
def test_all_reduce_torus_vs_jax(method):
    n0, n1, m, cols = 2, 4, 32, 128
    x = np.random.default_rng(2).standard_normal((n0, n1, m, cols))
    jm = "one_shot" if method == "auto" else method
    ref = np.asarray(jma.all_reduce_torus(jnp.asarray(x, jnp.float32),
                                          jctx((2, 4)), method=jm))
    outs = tma.all_reduce_torus(_t(x), tctx((2, 4)), method=method)
    for o in outs:
        assert torch.equal(o, outs[0])
    np.testing.assert_allclose(_np(outs[0]), ref, **TOL)
    np.testing.assert_allclose(_np(outs[0]), x.sum((0, 1)), rtol=1e-4,
                               atol=1e-4)
    if method != "two_shot":
        # The kernel's order: each row of the grid, then the rows.
        slots = [_t(x[a, b]) for a in range(n0) for b in range(n1)]
        assert torch.equal(outs[0], tma.ar_torus_plain(slots, n0, n1))


def test_all_reduce_torus_bf16_order():
    """bf16: each phase sums in fp32 and rounds once, so the result is
    the plain version's bit for bit on every rank (the inner rows'
    rounding is part of the contract)."""
    n0, n1, m, cols = 2, 4, 16, 256
    x = np.random.default_rng(7).standard_normal((n0, n1, m, cols))
    before = AR_TORUS_KERNEL.plain_calls
    outs = tma.all_reduce_torus(_t(x, torch.bfloat16), tctx((2, 4)))
    assert AR_TORUS_KERNEL.plain_calls == before + 8
    slots = [_t(x[a, b], torch.bfloat16) for a in range(n0)
             for b in range(n1)]
    want = tma.ar_torus_plain(slots, n0, n1)
    assert all(torch.equal(o, want) for o in outs)
    ref = np.asarray(jma.all_reduce_torus(jnp.asarray(x, jnp.bfloat16),
                                          jctx((2, 4))), np.float32)
    np.testing.assert_allclose(_np(want), ref, rtol=2 ** -7, atol=2 ** -7)


def test_reduce_scatter_torus_vs_jax():
    n0, n1, mo, cols = 2, 4, 16, 128
    N = n0 * n1
    x = np.random.default_rng(3).standard_normal((n0, n1, N * mo, cols))
    ref = np.asarray(jma.reduce_scatter_torus(jnp.asarray(x, jnp.float32),
                                              jctx((2, 4))))
    outs = tma.reduce_scatter_torus(_t(x), tctx((2, 4)))
    np.testing.assert_array_equal(np.concatenate([_np(o) for o in outs]),
                                  ref)


def test_all_gather_torus_degenerate_axis():
    """n1 == 1 takes the 1-D ring (no torus kernel)."""
    N, m, cols = 8, 8, 128
    x = np.random.default_rng(4).standard_normal((N * m, cols))
    ref = np.asarray(jma.all_gather_torus(jnp.asarray(x, jnp.float32),
                                          jctx((8, 1))))
    before = AG_TORUS_KERNEL.plain_calls
    outs = tma.all_gather_torus(_t(x), tctx((8, 1)))
    assert AG_TORUS_KERNEL.plain_calls == before
    for o in outs:
        np.testing.assert_array_equal(_np(o), ref)


@pytest.mark.parametrize("method", ["one_shot", "auto"])
def test_all_reduce_torus_degenerate_axis(method):
    n0, n1, m, cols = 8, 1, 16, 128
    x = np.random.default_rng(5).standard_normal((n0, n1, m, cols))
    ref = np.asarray(jma.all_reduce_torus(jnp.asarray(x, jnp.float32),
                                          jctx((8, 1)), method=method))
    before = AR_TORUS_KERNEL.plain_calls
    outs = tma.all_reduce_torus(_t(x), tctx((8, 1)), method=method)
    assert AR_TORUS_KERNEL.plain_calls == before
    for o in outs:
        assert torch.equal(o, outs[0])
    np.testing.assert_allclose(_np(outs[0]), ref, **TOL)


def test_reduce_scatter_torus_degenerate_axis():
    n0, n1, mo, cols = 8, 1, 8, 128
    x = np.random.default_rng(8).standard_normal((n0, n1, 8 * mo, cols))
    ref = np.asarray(jma.reduce_scatter_torus(jnp.asarray(x, jnp.float32),
                                              jctx((8, 1))))
    outs = tma.reduce_scatter_torus(_t(x), tctx((8, 1)))
    np.testing.assert_array_equal(np.concatenate([_np(o) for o in outs]),
                                  ref)


def test_single_axis_entry_points_dispatch_tuple_axis():
    """``all_gather_local`` / ``all_reduce_local`` / ``reduce_scatter_local``
    take a tuple axis and route to the torus forms (``"xla"``: the plain
    operations over both axes)."""
    N, m, cols = 8, 8, 128
    rng = np.random.default_rng(6)
    x = _t(rng.standard_normal((N * m, cols)))
    y = rng.standard_normal((N, m, cols))
    z = rng.standard_normal((N, N * m, cols))
    ctx = tctx((2, 4))
    ax, dims = ("x", "y"), (2, 4)

    def body(r):
        g = ctx.axis_index(r, ax)
        xl = x[g * m:(g + 1) * m]
        return (tag.all_gather_local(xl, axis=ax, num_ranks=dims),
                tag.all_gather_local(xl, axis=ax, num_ranks=dims,
                                     method="xla"),
                tar.all_reduce_local(_t(y[g]), axis=ax, num_ranks=dims),
                tar.all_reduce_local(_t(y[g]), axis=ax, num_ranks=dims,
                                     method="xla"),
                trs.reduce_scatter_local(_t(z[g]), axis=ax, num_ranks=dims))

    outs = ctx.run(body)
    for r, (ag, ag_x, ar, ar_x, rs) in enumerate(outs):
        assert torch.equal(ag, x) and torch.equal(ag_x, x)
        np.testing.assert_allclose(_np(ar), y.sum(0), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(_np(ar_x), y.sum(0), rtol=1e-4,
                                   atol=1e-4)
        g = ctx.axis_index(r, ax)
        np.testing.assert_allclose(_np(rs), z.sum(0)[g * m:(g + 1) * m],
                                   rtol=1e-4, atol=1e-4)

    def pinned(r):
        with pytest.raises(ValueError, match="no multi-axis form"):
            tag.all_gather_local(x[:m], axis=ax, num_ranks=dims,
                                 method="full_mesh_push")
        return True

    assert all(ctx.run(pinned))
