"""The port's overlapped TP path against the JAX package at n = 4 (and the
tree at n = 2, 4, 8): the fused kernels' plain versions (B9 AG+GEMM, B10
GEMM+RS, B11 GEMM+AR) and the double-tree AllReduce, the row-sharded
prefill, the linear-cache decode at n > 1, and ``Engine.serve`` on a TP
group with the reference's defaults.

The JAX side runs under ``shard_map`` on the conftest's CPU mesh (Pallas
interpret mode: remote DMA and semaphores emulated), not installed as the
global context. The port's ranks are CPU threads
(``DistContext(["cpu"] * n)``) running the kernels' plain versions, which
keep the kernels' order and rounding. ``tiny_config`` (2 layers, hidden
128; the "overlap" prefill and the decode steps that follow it at one
layer, because the JAX package's interpret-mode AG+GEMM / GEMM+RS cost
~20 s a layer here), float32, atol = rtol = 1e-5 (the frameworks'
matmuls sum in other orders); the AllReduce forms bit for bit; the
port's ranks bit-identical.
``Engine.serve`` is held against the JAX package's ``Engine`` on
``backend="xla"`` (its ``psum`` path; greedy tokens do not depend on the
mode, and its Pallas overlap engine costs minutes in interpret mode here)
and against the port at one rank.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as JP

from triton_distributed_tpu.models import dense as jdense
from triton_distributed_tpu.models.config import tiny_config as jtiny
from triton_distributed_tpu.models.engine import Engine as JEngine
from triton_distributed_tpu.models.kv_cache import (
    init_kv_cache as jinit_kv, kv_cache_specs as jkv_specs,
)
from triton_distributed_tpu.ops import allgather_gemm as jagm
from triton_distributed_tpu.ops import allreduce as jar
from triton_distributed_tpu.ops import gemm_reduce_scatter as jgrs
from triton_distributed_tpu.runtime import shard_map_on
from triton_distributed_tpu.runtime.context import DistContext as JDistContext
from triton_distributed_tpu_torch.models import dense as tdense
from triton_distributed_tpu_torch.models.config import tiny_config
from triton_distributed_tpu_torch.models.convert import (
    params_from_numpy, shard_params,
)
from triton_distributed_tpu_torch.models.engine import Engine
from triton_distributed_tpu_torch.models.kv_cache import init_kv_cache
from triton_distributed_tpu_torch.ops import _comm
from triton_distributed_tpu_torch.ops import allgather_gemm as tagm
from triton_distributed_tpu_torch.ops import allreduce as tar
from triton_distributed_tpu_torch.ops import gemm_allreduce as tgar
from triton_distributed_tpu_torch.ops import gemm_reduce_scatter as tgrs
from triton_distributed_tpu_torch.runtime.context import DistContext

# The package's ``ops`` namespace exports a function of this module's name.
jgar = sys.modules["triton_distributed_tpu.ops.gemm_allreduce"]

N = 4
TOL = dict(atol=1e-5, rtol=1e-5)
MAX_SEQ = 48
_CTX: dict = {}


def jctx(n: int = N) -> JDistContext:
    return JDistContext(mesh=Mesh(np.array(jax.devices()[:n]), ("tp",)))


def tctx(n: int = N) -> DistContext:
    """One rank group of n CPU threads per n for the module."""
    if n not in _CTX:
        _CTX[n] = DistContext([torch.device("cpu")] * n,
                              wait_timeout_ms=60_000)
    return _CTX[n]


def _rand(shape, seed, dtype=np.float32, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(dtype)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **TOL)


def _is_spec(x):
    return isinstance(x, JP)


def _jshard(tree, specs, ctx):
    return jax.device_put(tree, jax.tree.map(
        lambda s: NamedSharding(ctx.mesh, s), specs, is_leaf=_is_spec))


# ---------------------------------------------------------------------------
# The kernels' plain versions against the JAX kernels (interpret mode).
# ---------------------------------------------------------------------------

AG = dict(m=16, k=128, ncols=64)


@pytest.fixture(scope="module")
def ag_jax():
    """The JAX kernel's (output, gathered A) at 1 and 2 sub-blocks."""
    m, k, ncols = AG["m"], AG["k"], AG["ncols"]
    a, b = _rand((N * m, k), 1), _rand((k, N * ncols), 2, scale=0.1)
    out = {}
    for sub in (1, 2):
        cfg = jagm.AGGemmConfig(sub_chunks=sub)
        got = jax.jit(shard_map_on(
            jctx(), lambda x, w, cfg=cfg: jagm.ag_gemm_local(
                x, w, axis="tp", num_ranks=N, cfg=cfg, return_gathered=True),
            (JP("tp"), JP(None, "tp")), (JP(None, "tp"), JP("tp"))))(
            jnp.asarray(a), jnp.asarray(b))
        out[sub] = tuple(np.asarray(t) for t in got)
    return a, b, out


@pytest.mark.parametrize("sub,gathered", [(1, False), (2, False), (2, True)],
                         ids=["sub1", "sub2", "return_gathered"])
def test_ag_gemm_local_vs_jax(ag_jax, sub, gathered):
    m, ncols = AG["m"], AG["ncols"]
    a, b, jout = ag_jax
    wout, wgath = jout[sub]
    tcfg = tagm.AGGemmConfig(sub_chunks=sub)
    assert tagm._ag_sub_chunks(m, sub, torch.float32) == sub
    got = tctx().run(lambda r: tagm.ag_gemm_local(
        torch.from_numpy(a[r * m:(r + 1) * m]),
        torch.from_numpy(b[:, r * ncols:(r + 1) * ncols]), num_ranks=N,
        cfg=tcfg, return_gathered=gathered))
    for r, g in enumerate(got):
        out = g[0] if gathered else g
        _close(out.numpy(), wout[:, r * ncols:(r + 1) * ncols])
        if gathered:
            np.testing.assert_array_equal(
                g[1].numpy(), wgath[r * N * m:(r + 1) * N * m])


def test_gemm_rs_local_vs_jax():
    m, k, ncols = 32, 32, 128
    a, b = _rand((m, N * k), 3), _rand((N * k, ncols), 4, scale=0.1)
    want = np.asarray(jax.jit(shard_map_on(
        jctx(), lambda x, w: jgrs.gemm_rs_local(x, w, axis="tp",
                                                num_ranks=N),
        (JP(None, "tp"), JP("tp")), JP("tp")))(jnp.asarray(a),
                                               jnp.asarray(b)))
    xs = [torch.from_numpy(a[:, r * k:(r + 1) * k]) for r in range(N)]
    bs = [torch.from_numpy(b[r * k:(r + 1) * k]) for r in range(N)]
    got = tgrs.gemm_rs(xs, bs, tctx())
    mc = m // N
    for r, out in enumerate(got):
        _close(out.numpy(), want[r * mc:(r + 1) * mc])
        assert torch.equal(out, tgrs.gemm_rs_plain(xs, bs, r))


def test_gemm_ar_stream_both_parities_vs_jax():
    """Three calls over one persistent workspace (parities 0, 1, 0) with a
    rotating straggler on the port's side; each call's sum equals the
    JAX kernel's, and the ranks' sums are bit-identical; a call index
    out of sequence raises."""
    m, k, ncols, steps = 2, 32, 256, 3
    x, w = _rand((N, steps * m, k), 5), _rand((N * k, ncols), 6, scale=0.1)

    def run(xl, wl):
        ws, idx = jgar.gemm_ar_stream_workspace(N, m, ncols, jnp.float32)
        outs = []
        for t in range(steps):
            out, ws, idx = jgar.gemm_ar_stream(
                xl[0, t * m:(t + 1) * m], wl, ws, idx, axis="tp",
                num_ranks=N)
            outs.append(out)
        return jnp.stack(outs)[None]

    want = np.asarray(jax.jit(shard_map_on(
        jctx(), run, (JP("tp"), JP("tp")), JP("tp")))(jnp.asarray(x),
                                                      jnp.asarray(w)))
    ctx = tctx()
    ws, idx0 = tgar.gemm_ar_stream_workspace(N, m, ncols, torch.float32,
                                             ctx=ctx, tag="test-overlap")
    jws, _ = jgar.gemm_ar_stream_workspace(N, m, ncols, jnp.float32)
    assert tuple(ws.tensors[0].shape) == jws.shape

    def trun(r):
        idx, outs = idx0, []
        for t in range(steps):
            out, _, idx = tgar.gemm_ar_stream(
                torch.from_numpy(x[r, t * m:(t + 1) * m]),
                torch.from_numpy(w[r * k:(r + 1) * k]), ws, idx, num_ranks=N,
                straggler=("rotate", 100_000))
            outs.append(out)
        with pytest.raises(ValueError, match="out of sequence|in sequence"):
            tgar.gemm_ar_stream(torch.from_numpy(x[r, :m]),
                                torch.from_numpy(w[r * k:(r + 1) * k]), ws,
                                idx0, num_ranks=N)
        return torch.stack(outs)

    got = ctx.run(trun)
    for r, outs in enumerate(got):
        _close(outs.numpy(), want[r])
        assert torch.equal(outs, got[0])


@pytest.mark.parametrize("n,rows,dtype", [
    (2, 32, "float32"), (2, 1, "float32"), (4, 32, "float32"),
    (4, 1, "float32"), (8, 32, "float32"), (8, 1, "float32"),
    (4, 32, "bfloat16")],
    ids=["n2_double", "n2_single", "n4_double", "n4_single", "n8_double",
         "n8_single", "n4_double_bf16"])
def test_tree_all_reduce_vs_jax(n, rows, dtype):
    """The double tree (rows split in halves, two complementary trees) and
    its single-tree fallback at one row, bit for bit: each node adds its
    own rows and its children's in fp32 and rounds once a level."""
    x = _rand((n, rows, 128), 7 + n + rows)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (
        jnp.float32, torch.float32)
    assert tar._tree_halves(rows) == jar._tree_halves(rows, jdt)
    want = np.asarray(jnp.asarray(jar.all_reduce(
        jnp.asarray(x, jdt), jctx(n), method="tree"), jnp.float32))
    got = tar.all_reduce(torch.from_numpy(x).to(tdt), tctx(n), method="tree")
    for out in got:
        np.testing.assert_array_equal(out.float().numpy(), want)


# ---------------------------------------------------------------------------
# The model: the row-sharded prefill and the linear-cache decode at n = 4.
# ---------------------------------------------------------------------------

def _models(layers: int):
    jcfg = jtiny(num_layers=layers)
    jparams = jdense.init_dense_llm(jax.random.PRNGKey(11), jcfg)
    tcfg = tiny_config(num_layers=layers)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def models():
    return _models(2)


PROMPT = np.random.default_rng(12).integers(0, 256, (2, 16)).astype(
    np.int32)
# The JAX package's "overlap" prefill runs its Pallas AG+GEMM / GEMM+RS in
# interpret mode, ~20 s a layer here: it is held at one layer, "xla" at two.
PREFILL_LAYERS = {"overlap": 1, "xla": 2}


@pytest.fixture(scope="module")
def prefills(models):
    """``dense_prefill`` of a 2 x 16 prompt at n = 4 in "overlap" (one
    layer) and "xla" (two) on both sides: (the models, JAX logits, JAX
    cache, the port's per-rank (logits, cache))."""
    out = {}
    for mode, layers in PREFILL_LAYERS.items():
        model = models if layers == 2 else _models(layers)
        jcfg, jparams, tcfg, tparams = model
        ctx = jctx()
        pspecs = jdense.dense_llm_specs(jcfg, "tp")
        jp = _jshard(jparams, pspecs, ctx)
        shards = shard_params(tparams, tctx(), tcfg)
        jcache = _jshard(jinit_kv(jcfg, 2, MAX_SEQ), jkv_specs("tp"), ctx)
        jlog, jcache = jax.jit(shard_map_on(
            ctx, lambda p, i, c, mode=mode, jcfg=jcfg: jdense.dense_prefill(
                p, jcfg, i, c, axis="tp", num_ranks=N, mode=mode),
            (pspecs, JP(), jkv_specs("tp")), (JP(), jkv_specs("tp"))))(
            jp, jnp.asarray(PROMPT), jcache)

        def tpre(r, mode=mode, tcfg=tcfg, shards=shards):
            cache = init_kv_cache(tcfg, 2, MAX_SEQ, device="cpu",
                                  num_ranks=N)
            return tdense.dense_prefill(shards[r], tcfg,
                                        torch.from_numpy(PROMPT), cache,
                                        axis="tp", num_ranks=N, mode=mode)

        out[mode] = (model, np.asarray(jlog), jcache, tctx().run(tpre))
    return out


@pytest.mark.parametrize("mode", ["overlap", "xla"])
def test_dense_prefill_row_sharded_vs_jax(prefills, mode):
    """Each rank runs its 8 of the 32 prompt rows; logits and every rank's
    cache shard (its 2 of the 8 KV heads) equal the JAX package's."""
    _, jlog, jcache, touts = prefills[mode]
    jk, jv = np.asarray(jcache.k), np.asarray(jcache.v)
    for r, (logits, cache) in enumerate(touts):
        _close(logits.numpy(), jlog)
        assert torch.equal(logits, touts[0][0]), f"rank {r} differs"
        assert cache.offset == PROMPT.shape[1]
        hk = cache.k.shape[3]
        _close(cache.k.numpy(), jk[..., r * hk:(r + 1) * hk, :])
        _close(cache.v.numpy(), jv[..., r * hk:(r + 1) * hk, :])


@pytest.mark.parametrize("fused", [False, True],
                         ids=["parity_ar", "fused_gemm_ar"])
def test_dense_decode_step_linear_vs_jax(prefills, fused):
    """Three linear-cache decode steps at n = 4 from the "overlap" prefill,
    every reduction on the parity stream (``ar_state``) or every
    row-parallel projection through the fused GEMM+AR
    (``fused_gemm_ar``), the workspace threaded through: each step's
    logits equal the JAX package's, the ranks' bit-identical."""
    (jcfg, jparams, tcfg, tparams), _, jcache, touts = prefills["overlap"]
    toks = np.random.default_rng(13).integers(0, 256, (3, 2)).astype(
        np.int32)
    ctx = jctx()
    pspecs = jdense.dense_llm_specs(jcfg, "tp")
    B, h = 2, jcfg.hidden_size

    def jrun(p, t, c):
        if fused:
            state = jgar.gemm_ar_stream_workspace(N, B, h, jnp.float32)
        else:
            state = jar.ar_stream_workspace(N, B, h, jnp.float32)
        outs = []
        for s in range(3):
            logits, c, state = jdense.dense_decode_step(
                p, jcfg, t[s], c, axis="tp", num_ranks=N, mode="ar",
                ar_state=state, fused_gemm_ar=fused)
            outs.append(logits)
        return jnp.stack(outs)

    want = np.asarray(jax.jit(shard_map_on(
        ctx, jrun, (pspecs, JP(), jkv_specs("tp")), JP()))(
        _jshard(jparams, pspecs, ctx), jnp.asarray(toks), jcache))
    shards = shard_params(tparams, tctx(), tcfg)
    make = (tgar.gemm_ar_stream_workspace if fused
            else tar.ar_stream_workspace)
    state0 = make(N, B, h, torch.float32, ctx=tctx(),
                  tag=f"test-decode-{fused}")
    kernel = _comm.GEMM_AR_KERNEL if fused else _comm.PARITY_KERNEL
    before = kernel.plain_calls

    def tdec(r):
        cache = touts[r][1]
        cache = cache._replace(k=cache.k.clone(), v=cache.v.clone())
        state, outs = state0, []
        for s in range(3):
            logits, cache, state = tdense.dense_decode_step(
                shards[r], tcfg, torch.from_numpy(toks[s]), cache,
                axis="tp", num_ranks=N, mode="ar", ar_state=state,
                fused_gemm_ar=fused)
            outs.append(logits)
        assert cache.offset == PROMPT.shape[1] + 3
        return torch.stack(outs), state[1]

    got = tctx().run(tdec)
    L = tcfg.num_layers
    assert kernel.plain_calls - before == N * 3 * 2 * L
    for r, (logits, idx) in enumerate(got):
        _close(logits.numpy(), want)
        assert torch.equal(logits, got[0][0]), f"rank {r} differs"
        assert idx == 3 * 2 * L


# ---------------------------------------------------------------------------
# Engine.serve at n = 4 with the reference's defaults.
# ---------------------------------------------------------------------------

TREE_PROMPT = np.random.default_rng(14).integers(0, 256, (1, 11)).astype(
    np.int32)
GEN = 5


@pytest.fixture(scope="module")
def goldens(models):
    """The JAX package's ``Engine.serve`` at n = 4 (``backend="xla"``) and
    the port's at one rank, for both prompts."""
    jcfg, jparams, tcfg, tparams = models
    jeng = JEngine(jcfg, jparams, jctx(), backend="xla", max_seq=MAX_SEQ)
    one = Engine(tcfg, tparams, device="cpu", max_seq=MAX_SEQ)
    return {name: (np.asarray(jeng.serve(jnp.asarray(p), GEN)),
                   one.serve(p, GEN).numpy())
            for name, p in (("wide", PROMPT), ("tree", TREE_PROMPT))}


@pytest.mark.parametrize("case", ["defaults", "gemm_ar", "tree", "xla"])
def test_engine_serve_n4_vs_jax(models, goldens, monkeypatch, case):
    """``Engine(cfg, params, ctx of 4 ranks)`` with the reference's
    defaults (backend "auto", page_size None): the 2 x 16 prompt's
    prefill takes "overlap" (B9 / B10), the decode runs the linear cache
    over the parity AR; ``TDTPU_GEMM_AR=1`` puts B11 in every row-parallel
    projection instead; a 1 x 11 prompt takes "ar", its reductions pinned
    to the double tree (AUTO picks it at 165-219 bf16 rows of 4096, not at
    these widths); ``backend="xla"`` the rank group's plain collectives.
    Greedy tokens identical to the JAX package's and to one rank's."""
    _, _, tcfg, tparams = models
    prompt = TREE_PROMPT if case == "tree" else PROMPT
    monkeypatch.delenv("TDTPU_GEMM_AR", raising=False)
    if case == "gemm_ar":
        monkeypatch.setenv("TDTPU_GEMM_AR", "1")
    if case == "tree":
        monkeypatch.setattr(tar, "get_auto_allreduce_method",
                            lambda *a, **k: tar.AllReduceMethod.TREE)
    eng = Engine(tcfg, tparams, tctx(), max_seq=MAX_SEQ,
                 backend="xla" if case == "xla" else "auto")
    assert eng.page_size is None
    mode = eng._prefill_mode(*prompt.shape)
    assert mode == {"defaults": "overlap", "gemm_ar": "overlap",
                    "tree": "ar", "xla": "xla"}[case]
    kernels = {"defaults": [_comm.AG_GEMM_KERNEL, _comm.GEMM_RS_KERNEL,
                            _comm.PARITY_KERNEL],
               "gemm_ar": [_comm.GEMM_AR_KERNEL],
               "tree": [_comm.TREE_KERNEL, _comm.PARITY_KERNEL],
               "xla": []}[case]
    before = [k.plain_calls for k in kernels]
    got = eng.serve(prompt, GEN).numpy()
    L = tcfg.num_layers
    ran = [k.plain_calls - b for k, b in zip(kernels, before)]
    expect = {"defaults": [N * 5 * L, N * 2 * L, N * 2 * L * (GEN - 1)],
              "gemm_ar": [N * 2 * L * (GEN - 1)],
              "tree": [N * 2 * L, N * 2 * L * (GEN - 1)], "xla": []}[case]
    assert ran == expect
    jwant, one = goldens["tree" if case == "tree" else "wide"]
    np.testing.assert_array_equal(got, jwant)
    np.testing.assert_array_equal(got, one)


def test_host_level_wrappers():
    """``ag_gemm``, ``gemm_rs`` and ``gemm_allreduce`` take the ranks'
    parts stacked (n leading) or as lists and return one output a rank:
    all_gather(A) @ B_r, rank r's rows of A @ B, and A @ B on every
    rank."""
    m, k, ncols = 8, 32, 16
    a, b = _rand((N, m, k), 15), _rand((N, k, ncols), 16, scale=0.1)
    full = np.concatenate(list(a))
    outs = tagm.ag_gemm(torch.from_numpy(a), torch.from_numpy(b), tctx())
    for r, out in enumerate(outs):
        _close(out.numpy(), full @ b[r])
    want = sum(a[r] @ b[r] for r in range(N))
    rows = m // N
    for r, out in enumerate(tgrs.gemm_rs(list(torch.from_numpy(a)),
                                         list(torch.from_numpy(b)), tctx())):
        _close(out.numpy(), want[r * rows:(r + 1) * rows])
    outs = tgar.gemm_allreduce(torch.from_numpy(a), torch.from_numpy(b),
                               tctx(), method="tree")
    for out in outs:
        _close(out.numpy(), want)
        assert torch.equal(out, outs[0])


def test_fused_gemm_ar_switch(models, monkeypatch):
    """``TDTPU_GEMM_AR`` = 1 forces the fused GEMM+AR on the linear decode
    step, 0 forbids it; unset, the measured choice — and with comm tuning
    off (``TDTPU_AUTOTUNE_COMM`` unset, or no card) the tuner measures
    nothing and dot + parity AR stays. The paged step never fuses."""
    from triton_distributed_tpu_torch.runtime import autotuner

    _, _, tcfg, tparams = models
    eng = Engine(tcfg, tparams, tctx(), max_seq=MAX_SEQ)
    paged = Engine(tcfg, tparams, tctx(), max_seq=MAX_SEQ, page_size=4)
    monkeypatch.setenv("TDTPU_AUTOTUNE_COMM", "1")
    assert not autotuner.comm_autotune_enabled("cpu")
    assert autotuner.tuned_gemm_ar_path(1, 32, 128, torch.float32,
                                        tctx()) is None
    for flag, want in (("1", True), ("0", False), (None, False)):
        if flag is None:
            monkeypatch.delenv("TDTPU_GEMM_AR", raising=False)
        else:
            monkeypatch.setenv("TDTPU_GEMM_AR", flag)
        assert eng._use_fused_gemm_ar() is want
        assert paged._use_fused_gemm_ar() is False
    assert eng._gemm_ar_choice == "dot_ar"
