"""The port's two-tier fused operations (``ops/hierarchical``), the
``"overlap2d"`` mode of the layers and the two-tier ``Engine`` against the
JAX package's on the conftest's 8-device CPU mesh (Pallas interpret
mode), on ``tests/test_hierarchical.py``'s shapes and seeds: (dcn=2,
tp=4), and (dcn=4, tp=1) whose intra tier is one rank.

Tolerances: the products are fp32 over 64-128 terms in other orders than
XLA's (atol = rtol = 1e-5); the SP attention 2e-5 (two flash kernels).
Greedy tokens are held exactly: on (2, 1) against the JAX ``Engine`` on the
same numpy weights (``models/convert.params_from_numpy``); on (2, 4)
against the port's one-rank engine, and the layout choice against the
JAX engine's (the JAX side does not serve on (2, 4) here: its interpret
mode would cost minutes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from triton_distributed_tpu.layers import tp_mlp as jtp_mlp
from triton_distributed_tpu.models import dense as jdense
from triton_distributed_tpu.models.config import ModelConfig as JModelConfig
from triton_distributed_tpu.models.engine import Engine as JEngine
from triton_distributed_tpu.ops import hierarchical as jhi
from triton_distributed_tpu.runtime import perf_model as jpm
from triton_distributed_tpu.runtime.context import DistContext as JDistContext
from triton_distributed_tpu_torch.layers import tp_mlp as ttp_mlp
from triton_distributed_tpu_torch.megakernel.kernel import (
    MegakernelUnsupportedError,
)
from triton_distributed_tpu_torch.models.config import ModelConfig
from triton_distributed_tpu_torch.models.convert import params_from_numpy
from triton_distributed_tpu_torch.models.dense import init_dense_llm
from triton_distributed_tpu_torch.models.engine import Engine
from triton_distributed_tpu_torch.ops import hierarchical as thi
from triton_distributed_tpu_torch.ops._comm import (
    AG_GEMM_KERNEL, GEMM_RS_KERNEL,
)
from triton_distributed_tpu_torch.ops.gemm import GEMM_KERNEL
from triton_distributed_tpu_torch.runtime import perf_model as tpm
from triton_distributed_tpu_torch.runtime.context import DistContext
from triton_distributed_tpu_torch.serving.loop import (
    ServingConfigError, ServingEngine,
)

TOL = dict(rtol=1e-5, atol=1e-5)
ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
_CTX: dict = {}


def jctx(shape) -> JDistContext:
    devs = np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape)
    return JDistContext(mesh=Mesh(devs, ("dcn", "tp")))


def tctx(shape) -> DistContext:
    if shape not in _CTX:
        _CTX[shape] = DistContext(
            [torch.device("cpu")] * (shape[0] * shape[1]), mesh_shape=shape,
            axis_names=("dcn", "tp"), wait_timeout_ms=60_000)
    return _CTX[shape]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _joint(ctx, r) -> int:
    return ctx.axis_index(r, ("dcn", "tp"))


# ---------------------------------------------------------------------------
# ag_gemm_2d / gemm_rs_2d / sp_ag_attention_2d.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,seed", [((2, 4), 0), ((4, 1), 5)])
def test_ag_gemm_2d_vs_jax(shape, seed):
    n_inter, n_intra = shape
    N, m, k, cols = n_inter * n_intra, 16, 128, 128
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((N * m, k)) * 0.1
    b = rng.standard_normal((k, n_intra * cols)) * 0.1
    ref = np.asarray(jhi.ag_gemm_2d(jnp.asarray(a, jnp.float32),
                                    jnp.asarray(b, jnp.float32),
                                    jctx(shape)))
    ctx = tctx(shape)
    before = (AG_GEMM_KERNEL.plain_calls, GEMM_KERNEL.plain_calls)
    outs = thi.ag_gemm_2d(_t(a), _t(b), ctx)
    # B9 in each slice (B3 at one rank a slice), B3 for the remote slice.
    if n_intra > 1:
        assert AG_GEMM_KERNEL.plain_calls == before[0] + N
    assert GEMM_KERNEL.plain_calls >= before[1] + N * (n_inter - 1)
    for r, o in enumerate(outs):
        i = ctx.axis_index(r, "tp")
        np.testing.assert_allclose(o.numpy(), ref[:, i * cols:(i + 1) * cols],
                                   **TOL)


@pytest.mark.parametrize("shape,seed", [((2, 4), 1), ((4, 1), 6)])
def test_gemm_rs_2d_vs_jax(shape, seed):
    n_inter, n_intra = shape
    N, m, cols = n_inter * n_intra, 32, 128
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, N * 64)) * 0.1
    b = rng.standard_normal((N * 64, cols)) * 0.1
    ref = np.asarray(jhi.gemm_rs_2d(jnp.asarray(a, jnp.float32),
                                    jnp.asarray(b, jnp.float32),
                                    jctx(shape)))
    ctx = tctx(shape)
    before = GEMM_RS_KERNEL.plain_calls
    outs = thi.gemm_rs_2d(_t(a), _t(b), ctx)
    if n_intra > 1:
        assert GEMM_RS_KERNEL.plain_calls == before + N * n_inter
    got = [None] * N
    for r, o in enumerate(outs):
        got[_joint(ctx, r)] = o.numpy()
    np.testing.assert_allclose(np.concatenate(got), ref, **TOL)


def test_dcn_ring_reduce_order():
    """The inter ring adds chunk me's partials in the order (me+1, ...,
    me), one add a hop in the payload type — the order the reference
    documents, bit for bit."""
    ctx = tctx((4, 1))
    parts = np.random.default_rng(12).standard_normal((4, 4, 8)).astype(
        np.float32)

    def body(r):
        me = ctx.axis_index(r, "dcn")
        return thi.dcn_ring_reduce(lambda c: _t(parts[me, c]),
                                   inter_axis="dcn", n_inter=4, me_inter=me)

    for me, out in enumerate(ctx.run(body)):
        acc = _t(parts[(me + 1) % 4, me])
        for s in range(2, 5):
            acc = acc + _t(parts[(me + s) % 4, me])
        assert torch.equal(out, acc)


def test_sp_ag_attention_2d_vs_jax():
    b, s, hq, hkv, d = 1, 256, 4, 2, 64
    rng = np.random.default_rng(2)
    q = (rng.standard_normal((b, s, hq, d)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((b, s, hkv, d)) * 0.3).astype(np.float32)
    v = (rng.standard_normal((b, s, hkv, d)) * 0.3).astype(np.float32)
    ref = np.asarray(jhi.sp_ag_attention_2d(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v), jctx((2, 4))))
    ctx = tctx((2, 4))
    outs = thi.sp_ag_attention_2d(_t(q), _t(k), _t(v), ctx)
    got = [None] * 8
    for r, o in enumerate(outs):
        got[_joint(ctx, r)] = o.numpy()
    np.testing.assert_allclose(np.concatenate(got, axis=1), ref, **ATTN_TOL)


# ---------------------------------------------------------------------------
# The perf model's inter tier and pick_mode's crossover.
# ---------------------------------------------------------------------------

H100 = tpm.chip_spec("NVIDIA H100 80GB HBM3")


def test_pick_mode_overlap2d_crossover():
    """The reference's crossover cases on the H100's model: the two-tier
    path at a large prefill, declined at small rows (the inter hop's
    latency), never on one axis; on (n_inter, 1) the joint degree gates
    it. The reference's own selector agrees on each case."""
    kw = dict(hidden=4096, ffn=12288, itemsize=2)
    cases = [((8192, 4, 2), "overlap2d"), ((64, 4, 2), None),
             ((8192, 4, 1), None), ((8192, 1, 4), "overlap2d"),
             ((16, 1, 4), "ar")]
    for (m, n, n_inter), want in cases:
        got = ttp_mlp.pick_mode("auto", m, n, n_inter=n_inter, spec=H100,
                                **kw)
        jgot = jtp_mlp.pick_mode("auto", m, n, n_inter=n_inter, **kw)
        if want is None:
            assert got != "overlap2d" and jgot != "overlap2d"
        else:
            assert got == want == jgot
    # Without dims: the two-tier form wherever its rows divide into >= 8
    # a joint rank, else the one-tier overlap, else "ar" — as the
    # reference's.
    for m, want in ((64, "overlap2d"), (32, "overlap"), (12, "ar")):
        assert ttp_mlp.pick_mode("auto", m, 4, n_inter=2) == want
        assert jtp_mlp.pick_mode("auto", m, 4, n_inter=2) == want
    assert ttp_mlp.pick_mode("overlap2d", 8, 4) == "overlap2d"


@pytest.mark.parametrize("fn", ["ag_gemm_2d_time_s", "gemm_rs_2d_time_s"])
def test_perf_model_2d_estimates(fn):
    """The 2-D estimates rise with the rows and with the inter hops, and
    at n_inter = 1 are the one-tier estimate (the reference's
    properties); the inter tier's constants are the H100 system's, not a
    TPU's DCN."""
    est = getattr(tpm, fn)
    one = getattr(tpm, fn.replace("_2d", ""))
    assert est(4096, 4096, 4096, 4, 1, 2, H100) == one(4096, 4096, 4096, 4,
                                                        2, H100)
    sizes = [est(m, 4096, 4096, 4, 2, 2, H100)
             for m in (256, 1024, 4096, 16384)]
    assert sizes == sorted(sizes) and sizes[0] < sizes[-1]
    assert est(4096, 4096, 4096, 4, 4, 2, H100) > est(4096, 4096, 4096, 4,
                                                      2, 2, H100)
    jest = getattr(jpm, fn)
    assert jest(4096, 4096, 4096, 4, 1, 2) == getattr(
        jpm, fn.replace("_2d", ""))(4096, 4096, 4096, 4, 2)
    assert (H100.dcn_gbps, H100.dcn_latency_s) == (50.0, 5e-6)
    assert tpm.dcn_collective_time_s(1 << 20, 1, H100) == 0.0
    assert tpm.dcn_collective_time_s(1 << 20, 2, H100) == pytest.approx(
        (1 << 19) / 50e9 + 5e-6)


# ---------------------------------------------------------------------------
# The engine's layout and Engine.serve.
# ---------------------------------------------------------------------------

def _cfg_args(**over) -> dict:
    args = dict(hidden_size=128, intermediate_size=256, num_layers=1,
                num_heads=4, num_kv_heads=2, head_dim=32, vocab_size=64,
                dtype="float32")
    args.update(over)
    return args


def _models(**over):
    jcfg = JModelConfig(**_cfg_args(**over))
    jparams = jdense.init_dense_llm(jax.random.PRNGKey(0), jcfg)
    tcfg = ModelConfig(**_cfg_args(**over))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def models_2x1():
    return _models()


@pytest.fixture(scope="module")
def models_2x4():
    # The kv heads divide the joint TP degree 8 (the reference's case).
    return _models(num_heads=8, num_kv_heads=8, head_dim=16)


IDS = np.arange(1, 17, dtype=np.int32)[None, :]


def test_engine_serve_2x1_vs_jax(models_2x1):
    """(dcn=2, tp=1): the parameters and cache sharded over both tiers,
    the prefill in "overlap2d" (the inter rotation over B3, the inter ring
    over the one-rank GEMM), tokens identical to the JAX engine's on the
    same weights and mesh, and to the port's one-rank engine."""
    jcfg, jparams, tcfg, tparams = models_2x1
    jctx2 = jctx((2, 1))
    jeng = JEngine(jcfg, jparams, jctx2, backend="overlap", max_seq=32)
    assert jeng.hierarchical
    want = np.asarray(jeng.serve(jnp.asarray(IDS), gen_len=3))
    eng = Engine(tcfg, tparams, tctx((2, 1)), backend="overlap", max_seq=32)
    assert (eng.hierarchical, eng.n_total, eng.shard_axes) == (
        True, 2, ("dcn", "tp"))
    assert eng._prefill_mode(1, 16) == jeng._prefill_mode(1, 16) \
        == "overlap2d"
    before = GEMM_KERNEL.plain_calls
    got = eng.serve(torch.from_numpy(IDS), 3).numpy()
    assert GEMM_KERNEL.plain_calls > before
    np.testing.assert_array_equal(got, want)
    one = Engine(tcfg, tparams, device="cpu", max_seq=32)
    np.testing.assert_array_equal(got, one.serve(torch.from_numpy(IDS),
                                                 3).numpy())


@pytest.mark.parametrize("backend,prompt", [("overlap", (2, 16)),
                                            ("auto", (2, 16)),
                                            ("overlap", (1, 12))])
def test_engine_serve_2x4_vs_one_rank(models_2x4, backend, prompt):
    """(dcn=2, tp=4): the layout choice is the JAX engine's (checked
    without serving there); the port's tokens equal its one-rank
    engine's, the "overlap2d" prefill through B9 / B10 and the "ar" one
    (rows that do not divide over both tiers) through the two-tier
    AllReduce."""
    jcfg, jparams, tcfg, tparams = models_2x4
    jeng = JEngine(jcfg, jparams, jctx((2, 4)), backend=backend, max_seq=32)
    eng = Engine(tcfg, tparams, tctx((2, 4)), backend=backend, max_seq=32)
    assert (eng.hierarchical, eng.n_inter, eng.n_total, eng.shard_axes) == (
        jeng.hierarchical, jeng.n_inter, jeng.n_total, jeng.shard_axes)
    mode = eng._prefill_mode(*prompt)
    assert mode == jeng._prefill_mode(*prompt)
    ids = np.random.default_rng(21).integers(0, 64, prompt).astype(np.int32)
    before = (AG_GEMM_KERNEL.plain_calls, GEMM_RS_KERNEL.plain_calls)
    got = eng.serve(torch.from_numpy(ids), 4).numpy()
    if mode == "overlap2d":
        assert AG_GEMM_KERNEL.plain_calls == before[0] + 8 * 5
        assert GEMM_RS_KERNEL.plain_calls == before[1] + 8 * 2 * 2
    one = Engine(tcfg, tparams, device="cpu", max_seq=32)
    np.testing.assert_array_equal(got, one.serve(torch.from_numpy(ids),
                                                 4).numpy())


def test_engine_layout_choices(models_2x4):
    """Who takes the two-tier layout, as the reference decides: a one-axis
    group never; ``inter_axis=""`` opts out (the second axis replicates,
    the tokens still the one-rank engine's); ``backend="xla"`` keeps one
    axis (a MoE config: the next test); the serving tier refuses a
    two-tier engine by name."""
    jcfg, jparams, tcfg, tparams = models_2x4
    one_axis = Engine(tcfg, tparams, DistContext([torch.device("cpu")] * 4),
                      max_seq=32)
    assert (one_axis.hierarchical, one_axis.n_inter,
            one_axis.shard_axes) == (False, 1, "tp")
    assert one_axis._prefill_mode(2, 16) != "overlap2d"
    out = Engine(tcfg, tparams, tctx((2, 4)), inter_axis="", max_seq=32)
    jout = JEngine(jcfg, jparams, jctx((2, 4)), inter_axis="", max_seq=32)
    assert (out.hierarchical, out.n, out.shard_axes) == (
        jout.hierarchical, jout.n, jout.shard_axes) == (False, 4, "tp")
    ids = torch.from_numpy(IDS)
    one = Engine(tcfg, tparams, device="cpu", max_seq=32)
    assert torch.equal(out.serve(ids, 3), one.serve(ids, 3))
    xla = Engine(tcfg, tparams, tctx((2, 4)), backend="xla", max_seq=32)
    assert not xla.hierarchical
    paged = Engine(tcfg, tparams, tctx((2, 4)), max_seq=32, page_size=4)
    with pytest.raises(ServingConfigError, match="two-tier group"):
        ServingEngine(paged, max_batch=2, prefill_chunk=4)


def test_megakernel_refused_on_two_tier_group(models_2x4):
    """``backend="megakernel"`` on a (dcn, tp) group raises by name at
    construction (its in-kernel AllReduce spans the whole group); on the
    one-axis group of the same ranks' tp size it is built."""
    _, _, tcfg, tparams = models_2x4
    with pytest.raises(MegakernelUnsupportedError, match="is not ported"):
        Engine(tcfg, tparams, tctx((2, 4)), backend="megakernel",
               max_seq=32)
    eng = Engine(tcfg, tparams, DistContext([torch.device("cpu")] * 4),
                 backend="megakernel", max_seq=32)
    assert (eng.n, eng.hierarchical) == (4, False)


def test_moe_engine_on_2x4_replicates_dcn():
    """A MoE config on (2, 4) keeps the one-axis layout (the reference's
    rule): each tp rank its slice of every expert, the dcn slices
    replicas; the tokens are the one-rank engine's."""
    cfg = ModelConfig(**_cfg_args(num_heads=8, num_kv_heads=8, head_dim=16,
                                  num_experts=8, num_experts_per_tok=2,
                                  moe_intermediate_size=64))
    params = init_dense_llm(cfg, generator=torch.Generator().manual_seed(5),
                            device="cpu")
    eng = Engine(cfg, params, tctx((2, 4)), max_seq=32)
    assert (eng.hierarchical, eng.n, eng.shard_axes) == (False, 4, "tp")
    ids = torch.from_numpy(IDS)
    one = Engine(cfg, params, device="cpu", max_seq=32)
    assert torch.equal(eng.serve(ids, 3), one.serve(ids, 3))
