"""The port's entry points called with the reference's defaults, against
the JAX package's.

- ``tp_mlp_fwd``, ``tp_attn_prefill`` and ``dense_prefill`` default to
  ``mode="overlap"``, as the reference's do: on 2 CPU rank threads, with
  the reference's row-sharded layout and no ``mode`` given, each matches
  the JAX function under ``shard_map`` with no ``mode`` given (Pallas
  interpret mode), float32, atol = rtol = 1e-5 (the two frameworks'
  matmuls sum in different orders). The inputs: ``init_tp_mlp(16, 32)``
  from generator seed 0 and x (8, 16) from numpy seed 0 for the MLP; the
  tiny config at one layer for the other two;
- ``build_decode_step`` defaults to the JAX builder's flags
  (``inkernel_append=False, mat_prefetch=False``): a default build's queue
  is the JAX default build's, word for word;
- the rank-local TP-MoE functions take no default group size: called
  without ``num_ranks`` inside a rank group they raise the reference's
  "num_ranks required inside shard_map", where they used to return one
  rank's unreduced slice.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as JP

from triton_distributed_tpu.layers import tp_attn as jattn
from triton_distributed_tpu.layers import tp_mlp as jmlp
from triton_distributed_tpu.megakernel.models import (
    build_decode_step as jbuild,
)
from triton_distributed_tpu.models import dense as jdense
from triton_distributed_tpu.models.config import tiny_config as jtiny
from triton_distributed_tpu.models.kv_cache import (
    init_kv_cache as jinit_kv, kv_cache_specs as jkv_specs,
)
from triton_distributed_tpu.runtime import shard_map_on
from triton_distributed_tpu.runtime.context import DistContext as JDistContext
from triton_distributed_tpu_torch.layers import tp_attn as tattn
from triton_distributed_tpu_torch.layers import tp_mlp as tmlp
from triton_distributed_tpu_torch.megakernel.models import build_decode_step
from triton_distributed_tpu_torch.models import dense as tdense
from triton_distributed_tpu_torch.models.config import tiny_config
from triton_distributed_tpu_torch.models.convert import (
    params_from_numpy, shard_params, shard_tree,
)
from triton_distributed_tpu_torch.models.kv_cache import init_kv_cache
from triton_distributed_tpu_torch.ops import moe as tmoe
from triton_distributed_tpu_torch.runtime.context import DistContext, P

N = 2
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def jctx():
    return JDistContext(mesh=Mesh(np.array(jax.devices()[:N]), ("tp",)))


@pytest.fixture(scope="module")
def tctx():
    ctx = DistContext([torch.device("cpu")] * N, wait_timeout_ms=60_000)
    yield ctx
    ctx.close()


def _is_spec(x):
    return isinstance(x, JP)


def _jshard(tree, specs, ctx):
    return jax.device_put(tree, jax.tree.map(
        lambda s: NamedSharding(ctx.mesh, s), specs, is_leaf=_is_spec))


def _tspecs(jspecs):
    """The JAX package's specs as the port's ``P`` tree."""
    return jax.tree.map(lambda s: P(*s), jspecs, is_leaf=_is_spec)


def _x(rows, cols):
    return np.random.default_rng(0).standard_normal((rows, cols)).astype(
        np.float32)


def test_tp_mlp_fwd_defaults_to_overlap_vs_jax(jctx, tctx):
    """Queue C's inputs: the port's row halves, mode omitted, equal the JAX
    function's (whose default is ``"overlap"``) and the unsharded SwiGLU."""
    tp = tmlp.init_tp_mlp(16, 32, torch.float32,
                          generator=torch.Generator().manual_seed(0),
                          device="cpu")
    x = _x(8, 16)
    jp = {k: jnp.asarray(v.numpy()) for k, v in tp.items()}
    specs = jmlp.tp_mlp_specs("tp")
    want = np.asarray(jax.jit(shard_map_on(
        jctx, lambda p, xx: jmlp.tp_mlp_fwd(p, xx, axis="tp", num_ranks=N),
        (specs, JP("tp")), JP("tp")))(jp, jnp.asarray(x)))
    shards = shard_tree(tp, _tspecs(specs), tctx)
    got = tctx.run(lambda r: tmlp.tp_mlp_fwd(
        shards[r], torch.from_numpy(x[r * 4:(r + 1) * 4]), num_ranks=N))
    np.testing.assert_allclose(torch.cat(got).numpy(), want, **TOL)
    h = torch.from_numpy(x)
    full = tmlp.swiglu(h @ tp["w_gate"], h @ tp["w_up"]) @ tp["w_down"]
    np.testing.assert_allclose(torch.cat(got).numpy(), full.numpy(), **TOL)


@pytest.fixture(scope="module")
def models():
    jcfg = jtiny(num_layers=1)
    jparams = jdense.init_dense_llm(jax.random.PRNGKey(5), jcfg)
    tcfg = tiny_config(num_layers=1)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


def test_tp_attn_prefill_defaults_to_overlap_vs_jax(models, jctx, tctx):
    """One layer's attention on a row-sharded (8, hidden) prompt, mode
    omitted on both sides: each rank's rows and its K/V heads equal the
    JAX function's."""
    jcfg, jparams, tcfg, tparams = models
    specs = jattn.tp_attn_specs(jcfg, "tp")
    jp = _jshard(jparams["layers"][0]["attn"], specs, jctx)
    x = _x(8, jcfg.hidden_size)
    out, kv = jax.jit(shard_map_on(
        jctx, lambda p, xx: jattn.tp_attn_prefill(
            p, jcfg, xx, 1, 8, axis="tp", num_ranks=N),
        (specs, JP("tp")), (JP("tp"), JP(None, None, "tp"))))(
        jp, jnp.asarray(x))
    shards = shard_tree(tparams["layers"][0]["attn"], _tspecs(specs), tctx)
    got = tctx.run(lambda r: tattn.tp_attn_prefill(
        shards[r], tcfg, torch.from_numpy(x[r * 4:(r + 1) * 4]), 1, 8,
        num_ranks=N))
    np.testing.assert_allclose(torch.cat([o for o, _ in got]).numpy(),
                               np.asarray(out), **TOL)
    hk = tcfg.num_kv_heads // N
    for r, (_, slc) in enumerate(got):
        np.testing.assert_allclose(
            slc.k.numpy(), np.asarray(kv.k)[:, :, r * hk:(r + 1) * hk],
            **TOL)


def test_dense_prefill_defaults_to_overlap_vs_jax(models, jctx, tctx):
    """The whole prefill, mode omitted on both sides: the logits and each
    rank's cache shard equal the JAX function's."""
    jcfg, jparams, tcfg, tparams = models
    prompt = np.arange(8, dtype=np.int32)[None] * 7 % jcfg.vocab_size
    pspecs = jdense.dense_llm_specs(jcfg, "tp")
    jp = _jshard(jparams, pspecs, jctx)
    jcache = _jshard(jinit_kv(jcfg, 1, 16), jkv_specs("tp"), jctx)
    jlog, jcache = jax.jit(shard_map_on(
        jctx, lambda p, i, c: jdense.dense_prefill(
            p, jcfg, i, c, axis="tp", num_ranks=N),
        (pspecs, JP(), jkv_specs("tp")), (JP(), jkv_specs("tp"))))(
        jp, jnp.asarray(prompt), jcache)
    shards = shard_params(tparams, tctx, tcfg)
    got = tctx.run(lambda r: tdense.dense_prefill(
        shards[r], tcfg, torch.from_numpy(prompt),
        init_kv_cache(tcfg, 1, 16, device="cpu", num_ranks=N),
        num_ranks=N))
    hk = tcfg.num_kv_heads // N
    for r, (logits, cache) in enumerate(got):
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlog), **TOL)
        np.testing.assert_allclose(
            cache.k.numpy(),
            np.asarray(jcache.k)[..., r * hk:(r + 1) * hk, :], **TOL)


def test_build_decode_step_defaults_are_the_jax_builders():
    """A default build (no ``inkernel_append`` / ``mat_prefetch``) is the
    JAX builder's default build, word for word: no APPEND_KV rows, no
    PREFETCH_MAT warms."""
    kw = dict(hidden=256, hq_local=2, hkv_local=1, ffn_local=256,
              num_layers=2, max_seq=256, pos=100)
    jc = jbuild(num_ranks=1, **kw).mb.compile()
    tc = build_decode_step(**kw).mb.compile()
    np.testing.assert_array_equal(tc.queue, np.asarray(jc.queue))
    assert tc.task_rows == jc.task_rows and tc.used_types == jc.used_types
    from triton_distributed_tpu_torch.megakernel.tasks import TaskType

    types = set(tc.queue[:tc.num_exec, 0].tolist())
    assert int(TaskType.APPEND_KV) not in types
    assert int(TaskType.PREFETCH_MAT) not in types


@pytest.mark.parametrize("fn", ["moe_reduce_rs_local",
                                "moe_reduce_rs_overlap_local",
                                "moe_tp_fwd_local"])
def test_tp_moe_needs_num_ranks_inside_a_rank_group(fn, tctx):
    """Queue C's MoE inputs (M 8, h 16, E 8, top-2, ffn 32 cut to 16 a
    rank, fp32, generator seed 0): called without ``num_ranks`` on 2 rank
    threads, each function raises the reference's error."""
    g = torch.Generator().manual_seed(0)
    M, h, E, K, f = 8, 16, 8, 2, 16
    x = torch.randn(M, h, generator=g)
    router = torch.randn(h, E, generator=g)
    wg, wu = torch.randn(E, h, f, generator=g), torch.randn(E, h, f,
                                                            generator=g)
    wd = torch.randn(E, f, h, generator=g)
    act = torch.randn(M * K, f, generator=g)
    idx = torch.arange(M * K)
    sizes = [M * K // E] * E
    weights = torch.rand(M, K, generator=g)
    call = {
        "moe_reduce_rs_local": lambda: tmoe.moe_reduce_rs_local(
            act, idx, sizes, wd, weights, M, mode="ar"),
        "moe_reduce_rs_overlap_local":
            lambda: tmoe.moe_reduce_rs_overlap_local(act, idx, sizes, wd,
                                                     weights, M),
        "moe_tp_fwd_local": lambda: tmoe.moe_tp_fwd_local(
            x, router, wg, wu, wd, K, mode="ar")}[fn]

    def rank(r):
        with pytest.raises(ValueError,
                           match="num_ranks required inside shard_map"):
            call()
        return True

    assert tctx.run(rank) == [True] * N
