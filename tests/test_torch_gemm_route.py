"""The fused kernels' route (B9 AG+GEMM, B10 GEMM+RS, B11 GEMM+AR) and the
edge shapes of the wgmma route, against the JAX package.

- The route pickers (``ops/allgather_gemm.gemm_tile_for``, B11's
  ``ops/gemm_allreduce.gemm_ar_route``) over every shape of
  ``chip_smoke.FUSED_MAIN``, ``FUSED_SMALL`` and ``FUSED_EDGE`` in fp32
  and bf16 at n = 2, 4, 8: the main and edge bf16 shapes of B9 and B10 go
  to the wgmma + TMA mainloop, B11's bf16 shapes to its split-K weight
  stream; fp32, the short tile and the unaligned B stay on B3's mma.sync
  tiles, and the "_tall" controls keep bf16 on the tall one. The launch
  carries the route's tile code and counts under its name
  (``_comm.GEMM_ROUTES``).
- The edge shapes (rows of a sub-block not a multiple of 128, at sub 1, 2
  and 4; K = 1032; 1000 columns) at n = 2 and 4, through
  ``ag_gemm_local`` / ``gemm_rs_local`` on CPU rank threads (the plain
  versions) against the JAX kernels under ``shard_map`` in interpret mode,
  float32, at B3's tolerance: 2^-13 sqrt(K) rms(A) rms(B), plus one unit
  of float32 relative to the value.
"""

import importlib.util
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as JP

from triton_distributed_tpu.ops import allgather_gemm as jagm
from triton_distributed_tpu.ops import gemm_reduce_scatter as jgrs
from triton_distributed_tpu.runtime import shard_map_on
from triton_distributed_tpu_torch.ops import _comm
from triton_distributed_tpu_torch.ops import allgather_gemm as tagm
from triton_distributed_tpu_torch.ops import gemm_allreduce as tgar
from triton_distributed_tpu_torch.ops import gemm_reduce_scatter as tgrs
from triton_distributed_tpu_torch.runtime.context import DistContext

ROOT = Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
SHAPES = [(op, kind, sh) for kind, table in (("main", CS.FUSED_MAIN),
                                             ("small", CS.FUSED_SMALL),
                                             ("edge", CS.FUSED_EDGE))
          for op, shapes in table.items() for sh in shapes]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _route(op, sh, dtype, n) -> str:
    """The route the wrapper takes for ``sh`` (name, rows a rank, K, N[,
    sub]) on B contiguous, 16-byte aligned unless the name starts with
    "offset_b" (then one element past), as the kernels get it."""
    name, m, k, ncols = sh[:4]
    b = torch.empty((k, ncols), dtype=dtype)
    if name.startswith("offset_b"):
        b = torch.empty(k * ncols + 1, dtype=dtype)[1:].view(k, ncols)
    aligned = tagm.aligned_rows(b)
    if op == "ag_gemm":
        sub = tagm._ag_sub_chunks(m, sh[4] if len(sh) > 4 else 2, dtype)
        tile = tagm.gemm_tile_for(m // sub, dtype, aligned)
    elif op == "gemm_rs":
        tile = tagm.gemm_tile_for(m // n, dtype, aligned)
    else:
        nc = ncols // tgar._gemm_ar_chunks(ncols, 4)
        tile = tgar.gemm_ar_route(m, k, nc, dtype,
                                  aligned and tagm.aligned_rows(b, nc))
    return _comm.GEMM_ROUTES[tile]


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("op,kind,sh", SHAPES,
                         ids=[f"{op}-{kind}-{sh[0]}" for op, kind, sh
                              in SHAPES])
def test_route_picker(op, kind, sh, dtype, n):
    got = _route(op, sh, DTYPES[dtype], n)
    _, m, k, ncols = sh[:4]
    if dtype == "float32":
        assert got in ("mma_tall", "mma_short")
    elif op == "gemm_ar":
        assert got == "splitk"
    elif kind in ("main", "edge"):
        assert got == "wgmma"
    elif sh[0] == "unaligned":          # 100 columns: 200-byte B rows
        assert got != "wgmma"
    elif sh[0].endswith("_tall"):       # unaligned B at >= 64 rows
        assert got == "mma_tall"
    if got == "wgmma":
        assert (ncols * 2) % 16 == 0 and (k * 2) % 16 == 0
    rows = (m // n if op == "gemm_rs" else m)
    if rows < tagm.SHORT_TILE_ROWS and got != "splitk":
        assert got == "mma_short"


def test_route_picker_rules():
    """Only dtype, rows and alignment decide: bf16 at 64 rows or more
    with aligned rows takes wgmma; fewer rows the short tile; fp32 or an
    unaligned B the tall mma.sync tile."""
    bf, f32 = torch.bfloat16, torch.float32
    assert tagm.gemm_tile_for(64, bf, True) == 2
    assert tagm.gemm_tile_for(63, bf, True) == 1
    assert tagm.gemm_tile_for(512, bf, False) == 0
    assert tagm.gemm_tile_for(512, f32, True) == 0
    assert tagm.gemm_tile_for(512) == 0
    assert _comm.GEMM_ROUTES == ("mma_tall", "mma_short", "wgmma",
                                 "splitk")


@pytest.mark.parametrize("tile", [0, 1, 2, 3])
def test_launch_passes_route_and_workspace(monkeypatch, tile):
    """``launch_gemm_comm`` hands the C entry one argument per declared
    type (the workspace base among them, the ranks on the card and the
    flags' scope after the route) and counts the launch under its route's
    name."""
    seen = {}

    def fake_launch(kernel, buf, rank, dev, what, args, variants=()):
        seen.update(args=args, variants=variants, kernel=kernel)

    monkeypatch.setattr(_comm, "_launch_at_meeting", fake_launch)
    monkeypatch.setattr(_comm, "current_stream", lambda dev: None)
    x = torch.zeros((256, 64), dtype=torch.bfloat16)
    b = torch.zeros((64, 128), dtype=torch.bfloat16)
    out = torch.zeros((512, 128), dtype=torch.bfloat16)
    ws = torch.zeros((512, 64), dtype=torch.bfloat16)
    ctx = types.SimpleNamespace(ranks_on=lambda dev: 2,
                                error_word=lambda r: None, num_ranks=2,
                                timeout_s=1.0,
                                devices=[torch.device("cuda:0")] * 2)
    buf = types.SimpleNamespace(ctx=ctx, table=[None, None],
                                signal_table=[None, None],
                                tensors=[ws, ws])
    _comm.launch_gemm_comm(_comm.AG_GEMM_KERNEL, buf, 0, 1, x, b, out, m=256,
                           mp=256, k=64, ncols=128, ldb=128, parts=2,
                           tile=tile, vec_b=True)
    args = seen["args"]
    assert len(args) == len(_comm._GEMM_COMM_ARGS)
    assert seen["variants"] == (_comm.GEMM_ROUTES[tile],)
    assert args[10].value == ws.data_ptr()       # the workspace base
    assert args[19] == tile
    assert tuple(args[21:23]) == (2, 0)  # 2 ranks on the card, GPU scope


# ---------------------------------------------------------------------------
# The edge shapes against the JAX kernels (interpret mode).
# ---------------------------------------------------------------------------

_CTX: dict = {}


def _tctx(n):
    if n not in _CTX:
        _CTX[n] = DistContext([torch.device("cpu")] * n,
                              wait_timeout_ms=60_000)
    return _CTX[n]


def _jctx_mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("tp",))


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _b3_close(got, want, k, a, b):
    s = np.sqrt(k) * np.sqrt(np.mean(a ** 2)) * np.sqrt(np.mean(b ** 2))
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=2.0 ** -13 * s, rtol=2.0 ** -23)


AG_EDGE = [sh for sh in CS.FUSED_EDGE["ag_gemm"]]
RS_EDGE = [sh for sh in CS.FUSED_EDGE["gemm_rs"]]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("sh", AG_EDGE, ids=[sh[0] for sh in AG_EDGE])
def test_ag_gemm_edge_vs_jax(n, sh):
    from triton_distributed_tpu.runtime.context import (
        DistContext as JDistContext,
    )

    _, m, k, ncols, sub = sh
    assert tagm._ag_sub_chunks(m, sub, torch.bfloat16) == sub
    a = _rand((n * m, k), 11)
    b = _rand((k, n * ncols), 12, scale=k ** -0.5)
    jctx = JDistContext(mesh=_jctx_mesh(n))
    cfg = jagm.AGGemmConfig(sub_chunks=sub)
    want, wgath = (np.asarray(t) for t in jax.jit(shard_map_on(
        jctx, lambda x, w: jagm.ag_gemm_local(
            x, w, axis="tp", num_ranks=n, cfg=cfg, return_gathered=True),
        (JP("tp"), JP(None, "tp")), (JP(None, "tp"), JP("tp"))))(
        jnp.asarray(a), jnp.asarray(b)))
    tcfg = tagm.AGGemmConfig(sub_chunks=sub)
    got = _tctx(n).run(lambda r: tagm.ag_gemm_local(
        torch.from_numpy(a[r * m:(r + 1) * m]),
        torch.from_numpy(b[:, r * ncols:(r + 1) * ncols]), num_ranks=n,
        cfg=tcfg, return_gathered=True))
    for r, (out, gath) in enumerate(got):
        _b3_close(out.numpy(), want[:, r * ncols:(r + 1) * ncols], k, a, b)
        np.testing.assert_array_equal(
            gath.numpy(), wgath[r * n * m:(r + 1) * n * m])


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("sh", RS_EDGE, ids=[sh[0] for sh in RS_EDGE])
def test_gemm_rs_edge_vs_jax(n, sh):
    from triton_distributed_tpu.runtime.context import (
        DistContext as JDistContext,
    )

    _, m, k, ncols = sh
    a = _rand((m, n * k), 13)
    b = _rand((n * k, ncols), 14, scale=(n * k) ** -0.5)
    jctx = JDistContext(mesh=_jctx_mesh(n))
    want = np.asarray(jax.jit(shard_map_on(
        jctx, lambda x, w: jgrs.gemm_rs_local(x, w, axis="tp", num_ranks=n),
        (JP(None, "tp"), JP("tp")), JP("tp")))(jnp.asarray(a),
                                               jnp.asarray(b)))
    xs = [torch.from_numpy(a[:, r * k:(r + 1) * k]) for r in range(n)]
    bs = [torch.from_numpy(b[r * k:(r + 1) * k]) for r in range(n)]
    got = tgrs.gemm_rs(xs, bs, _tctx(n))
    mc = m // n
    for r, out in enumerate(got):
        # The sum of n partials: B3's tolerance of the whole K.
        _b3_close(out.numpy(), want[r * mc:(r + 1) * mc], n * k, a, b)
        assert torch.equal(out, tgrs.gemm_rs_plain(xs, bs, r))
