"""The port's tensor-parallel path against the JAX package at n = 4.

- ``shard_params`` against ``dense_llm_specs``: the port's specs equal
  the JAX package's, and each rank's shard is its slice;
- the TP model functions at n = 4 (``tiny_config``: 2 of the 8 q and 8 kv
  heads a rank) against the JAX package's under ``shard_map`` (Pallas
  AllReduce kernels in interpret mode): a prefill slice with its gathered
  logits (mode ``"ar"``, one-shot at these sizes), and a paged decode
  step whose reductions ride the parity stream (both parities), and the
  layers in ``"xla_rep"``; float32, atol = rtol = 1e-5 (the two
  frameworks' matmuls sum in different orders); the port's four ranks
  bit-identical;
- ``ServingEngine`` at n = 4 with a preemption against the JAX
  package's ``ServingEngine`` on a 4-device mesh: greedy tokens
  identical. The JAX reference serves with ``backend="xla"`` (its ``psum``
  path, ~13 s here): its Pallas ``"ar"`` path costs ~23 s on this CPU.
  The port serves with its default (``"ar"``: the collectives' plain
  versions through the rank threads);
- the port at n = 4 against itself at n = 1 with spec decode and over
  e4m3 pools, ``Engine.serve``, and the named refusals.
"""

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
    PagedModelCache as JPaged, init_kv_cache as jinit_kv,
    kv_cache_specs as jkv_specs, paged_cache_specs as jpaged_specs,
)
from triton_distributed_tpu.ops import allreduce as jar
from triton_distributed_tpu.runtime import shard_map_on
from triton_distributed_tpu.runtime.context import DistContext as JDistContext
from triton_distributed_tpu.serving import ServingEngine as JServingEngine
from triton_distributed_tpu_torch.megakernel.kernel import (
    MegakernelUnsupportedError,
)
from triton_distributed_tpu_torch.models import dense as tdense
from triton_distributed_tpu_torch.models.config import tiny_config
from triton_distributed_tpu_torch.models.convert import (
    params_from_numpy, shard_params,
)
from triton_distributed_tpu_torch.models.engine import Engine
from triton_distributed_tpu_torch.models.kv_cache import (
    init_kv_cache, init_paged_model_cache,
)
from triton_distributed_tpu_torch.ops import _comm
from triton_distributed_tpu_torch.ops.allreduce import ar_stream_workspace
from triton_distributed_tpu_torch.runtime.context import DistContext
from triton_distributed_tpu_torch.serving import ServingEngine

N = 4
TOL = dict(atol=1e-5, rtol=1e-5)
MAX_SEQ = 64
PAGE = 4


def _is_spec(x):
    return isinstance(x, JP)


@pytest.fixture(scope="module")
def models():
    jcfg = jtiny()
    jparams = jdense.init_dense_llm(jax.random.PRNGKey(7), jcfg)
    tcfg = tiny_config()
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def jctx():
    return JDistContext(mesh=Mesh(np.array(jax.devices()[:N]), ("tp",)))


@pytest.fixture(scope="module")
def tctx():
    ctx = DistContext([torch.device("cpu")] * N, wait_timeout_ms=60_000)
    yield ctx
    ctx.close()


def test_shard_params_vs_dense_llm_specs(models, tctx):
    jcfg, jparams, tcfg, tparams = models
    jspecs = jdense.dense_llm_specs(jcfg, "tp")
    tspecs = tdense.dense_llm_specs(tcfg, "tp")
    assert [tuple(s) for s in jax.tree.leaves(tspecs, is_leaf=lambda x:
                                               isinstance(x, tuple))] == \
        [tuple(s) for s in jax.tree.leaves(jspecs, is_leaf=_is_spec)]
    shards = shard_params(tparams, tctx, tcfg)
    assert len(shards) == N
    leaves = jax.tree.leaves(jparams)
    specs = jax.tree.leaves(jspecs, is_leaf=_is_spec)
    for r in range(N):
        got = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), shards[r]))
        for full, spec, part in zip(leaves, specs, got):
            full = np.asarray(full)
            dims = [d for d, ax in enumerate(spec) if ax is not None]
            if not dims:
                np.testing.assert_array_equal(part, full)
                continue
            d = dims[0]
            step = full.shape[d] // N
            np.testing.assert_array_equal(
                part, np.take(full, range(r * step, (r + 1) * step), axis=d))
    # Replicated leaves on one device are shared, not copied.
    assert shards[0]["embed"] is shards[1]["embed"]
    assert shards[0]["lm_head"].shape == (tcfg.hidden_size,
                                          tcfg.vocab_size // N)


def _jshard(jctx, tree, specs):
    return jax.device_put(tree, jax.tree.map(
        lambda s: NamedSharding(jctx.mesh, s), specs, is_leaf=_is_spec))


@pytest.fixture(scope="module")
def slice_runs(models, jctx, tctx):
    """A 2-slice chunked prefill (8 tokens, chunk 4, mode "ar") and its
    last logits on both sides, then one paged decode step over the
    parity stream."""
    jcfg, jparams, tcfg, tparams = models
    S, C = 16, 4
    ids = np.random.default_rng(1).integers(0, jcfg.vocab_size,
                                            (1, 8)).astype(np.int32)
    pspecs = jdense.dense_llm_specs(jcfg, "tp")
    jp = _jshard(jctx, jparams, pspecs)
    jcache = _jshard(jctx, jinit_kv(jcfg, 1, S), jkv_specs("tp"))

    def make_slice(start):
        def step(params, ids_c, cache):
            x, cache = jdense.dense_prefill_slice(
                params, jcfg, ids_c, cache, start, axis="tp", num_ranks=N,
                mode="ar")
            logits = jdense.dense_last_logits(params, jcfg, x[-1:],
                                              axis="tp", num_ranks=N)
            return logits, cache
        return jax.jit(shard_map_on(jctx, step,
                                    (pspecs, JP(), jkv_specs("tp")),
                                    (JP(), jkv_specs("tp"))))

    jlog = None
    for start in (0, C):
        jlog, jcache = make_slice(start)(jp, jnp.asarray(
            ids[:, start:start + C]), jcache)

    rank_params = shard_params(tparams, tctx, tcfg)
    caches = [init_kv_cache(tcfg, 1, S, device="cpu", num_ranks=N)
              for _ in range(N)]

    def tslices(r):
        cache, logits = caches[r], None
        for start in (0, C):
            x, cache = tdense.dense_prefill_slice(
                rank_params[r], tcfg, torch.from_numpy(
                    ids[:, start:start + C]), cache, start, axis="tp",
                num_ranks=N, mode="ar")
            logits = tdense.dense_last_logits(rank_params[r], tcfg, x[-1:],
                                              axis="tp", num_ranks=N)
        return logits, cache

    touts = tctx.run(tslices)
    # One paged decode step from the 8 prefilled positions (2 pages of 4
    # of a 4-page row), the reductions over the parity stream.
    tok = np.argmax(np.asarray(jlog), axis=-1).astype(np.int32)
    jk, jv = np.asarray(jcache.k), np.asarray(jcache.v)
    L, _, _, hkv, d = jk.shape

    def pools(x):
        return x[:, 0].reshape(L, S // PAGE, PAGE, hkv, d)

    jpaged = _jshard(jctx, JPaged(
        jnp.asarray(pools(jk)), jnp.asarray(pools(jv)),
        jnp.arange(S // PAGE, dtype=jnp.int32)[None],
        jnp.full((1,), 8, jnp.int32)), jpaged_specs("tp"))

    def dstep(params, t, cache):
        ws, idx = jar.ar_stream_workspace(N, 1, jcfg.hidden_size,
                                          jnp.float32)
        logits, cache, _ = jdense.dense_decode_step_paged(
            params, jcfg, t, cache, axis="tp", num_ranks=N, mode="ar",
            ar_state=(ws, idx))
        return logits, cache

    jdec, _ = jax.jit(shard_map_on(
        jctx, dstep, (pspecs, JP(), jpaged_specs("tp")),
        (JP(), jpaged_specs("tp"))))(jp, jnp.asarray(tok), jpaged)
    ws, idx0 = ar_stream_workspace(N, 1, tcfg.hidden_size, torch.float32,
                                   ctx=tctx, tag="test-tp")

    def tdecode(r):
        lin = touts[r][1]
        paged = init_paged_model_cache(tcfg, 1, page_size=PAGE,
                                       max_pages=S // PAGE, device="cpu",
                                       num_ranks=N)
        paged.k_pools.copy_(lin.k[:, 0].reshape(paged.k_pools.shape))
        paged.v_pools.copy_(lin.v[:, 0].reshape(paged.v_pools.shape))
        paged = paged._replace(kv_lens=torch.full((1,), 8,
                                                  dtype=torch.int32))
        logits, _, (_, idx) = tdense.dense_decode_step_paged(
            rank_params[r], tcfg, torch.from_numpy(tok), paged, axis="tp",
            num_ranks=N, mode="ar", ar_state=(ws, idx0))
        return logits, idx

    before = _comm.PARITY_KERNEL.plain_calls
    tdec = tctx.run(tdecode)
    parity_calls = _comm.PARITY_KERNEL.plain_calls - before
    return dict(jlog=jlog, jcache=jcache, touts=touts, jdec=jdec, tdec=tdec,
                parity_calls=parity_calls, L=L)


def test_prefill_slices_vs_jax(slice_runs):
    jlog, touts = slice_runs["jlog"], slice_runs["touts"]
    jk = np.asarray(slice_runs["jcache"].k)
    for r, (logits, cache) in enumerate(touts):
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlog), **TOL)
        assert torch.equal(logits, touts[0][0]), f"rank {r} differs"
        hk = cache.k.shape[3]
        np.testing.assert_allclose(cache.k.numpy(),
                                   jk[..., r * hk:(r + 1) * hk, :], **TOL)


def test_paged_decode_parity_stream_vs_jax(slice_runs):
    jdec, tdec, L = slice_runs["jdec"], slice_runs["tdec"], slice_runs["L"]
    for r, (logits, idx) in enumerate(tdec):
        np.testing.assert_allclose(logits.numpy(), np.asarray(jdec), **TOL)
        assert torch.equal(logits, tdec[0][0]), f"rank {r} differs"
        assert idx == 2 * L                 # two reductions a layer
    assert slice_runs["parity_calls"] == N * 2 * L


@pytest.mark.parametrize("mode", ["ar", "xla_rep"])
def test_tp_mlp_and_attention_layer_vs_jax(models, jctx, tctx, mode):
    """One layer's MLP and prefill attention at n = 4 in each replicated
    mode against the JAX package's under shard_map."""
    from triton_distributed_tpu.layers import tp_attn as jattn
    from triton_distributed_tpu.layers import tp_mlp as jmlp
    from triton_distributed_tpu_torch.layers import tp_attn as tattn
    from triton_distributed_tpu_torch.layers import tp_mlp as tmlp

    jcfg, jparams, tcfg, tparams = models
    x = np.random.default_rng(5).standard_normal(
        (6, jcfg.hidden_size)).astype(np.float32)
    layer = jparams["layers"][0]
    mspecs, aspecs = jmlp.tp_mlp_specs("tp"), jattn.tp_attn_specs(jcfg, "tp")

    def jstep(mp, ap, xl):
        m = jmlp.tp_mlp_fwd(mp, xl, axis="tp", num_ranks=N, mode=mode)
        a, _ = jattn.tp_attn_prefill(ap, jcfg, xl, 1, 6, axis="tp",
                                     num_ranks=N, mode=mode)
        return m, a

    jm, ja = jax.jit(shard_map_on(jctx, jstep, (mspecs, aspecs, JP()),
                                  (JP(), JP())))(
        _jshard(jctx, layer["mlp"], mspecs),
        _jshard(jctx, layer["attn"], aspecs), jnp.asarray(x))
    shards = shard_params(tparams, tctx, tcfg)

    def tstep(r):
        lp = shards[r]["layers"][0]
        xt = torch.from_numpy(x)
        m = tmlp.tp_mlp_fwd(lp["mlp"], xt, axis="tp", num_ranks=N,
                            mode=mode)
        a, _ = tattn.tp_attn_prefill(lp["attn"], tcfg, xt, 1, 6, axis="tp",
                                     num_ranks=N, mode=mode)
        return m, a

    for m, a in tctx.run(tstep):
        np.testing.assert_allclose(m.numpy(), np.asarray(jm), **TOL)
        np.testing.assert_allclose(a.numpy(), np.asarray(ja), **TOL)


SERVE_PROMPTS = [np.random.default_rng(3).integers(0, 256, n).tolist()
                 for n in (8, 12, 12, 8, 12)]
SERVE_GENS = [8, 6, 8, 6, 7]
SERVE_KW = dict(max_batch=3, num_pages=7, prefill_chunk=4)


def _serve(se, prompts, gens):
    reqs = [se.submit(p, g)[0] for p, g in zip(prompts, gens)]
    se.run(max_iters=2000)
    return reqs


def test_serving_engine_n4_vs_jax(models, jctx, tctx):
    """ServingEngine on 4 ranks, a 7-page pool forcing preemption, against
    the JAX ServingEngine on a 4-device mesh (``backend="xla"``)."""
    jcfg, jparams, tcfg, tparams = models
    jeng = JEngine(jcfg, jparams, jctx, backend="xla", max_seq=MAX_SEQ,
                   page_size=PAGE)
    want = _serve(JServingEngine(jeng, **SERVE_KW), SERVE_PROMPTS,
                  SERVE_GENS)
    eng = Engine(tcfg, tparams, tctx, max_seq=MAX_SEQ, page_size=PAGE)
    assert eng.n == N and eng._use_ar_stream()
    calls = {k.symbol: k.plain_calls for k in _comm.COLLECTIVE_KERNELS}
    got = _serve(ServingEngine(eng, **SERVE_KW), SERVE_PROMPTS, SERVE_GENS)
    assert sum(r.preemptions for r in got) >= 1
    for a, b in zip(got, want):
        assert a.tokens == b.tokens, a.req_id
    ran = {k.symbol: k.plain_calls - calls[k.symbol]
           for k in _comm.COLLECTIVE_KERNELS}
    # Slices and decode steps reduced: one-shot (small slices) and the
    # parity stream, every rank.
    assert ran["tdt_ar_parity"] > 0 and ran["tdt_ar_one_shot"] > 0


@pytest.mark.parametrize("kw", [dict(spec_k=3), dict(kv_dtype="e4m3")],
                         ids=["spec_k3", "e4m3_pools"])
def test_serving_engine_n4_vs_n1(models, tctx, kw):
    """Spec decode and e4m3 pools at n = 4: the tokens of the port at one
    rank, with a preemption."""
    _, _, tcfg, tparams = models
    ekw = ({"kv_dtype": torch.float8_e4m3fn} if "kv_dtype" in kw else {})
    skw = dict(SERVE_KW, spec_k=kw.get("spec_k", 0))
    prompts = ([([3, 9, 4] * 5)[:n] for n in (8, 12, 12, 8, 12)]
               if "spec_k" in kw else SERVE_PROMPTS)
    one = Engine(tcfg, tparams, device="cpu", max_seq=MAX_SEQ,
                 page_size=PAGE, **ekw)
    want = _serve(ServingEngine(one, **skw), prompts, SERVE_GENS)
    four = Engine(tcfg, tparams, tctx, max_seq=MAX_SEQ, page_size=PAGE,
                  **ekw)
    got = _serve(ServingEngine(four, **skw), prompts, SERVE_GENS)
    assert sum(r.preemptions for r in got) >= 1
    for a, b in zip(got, want):
        assert a.tokens == b.tokens, a.req_id
    if "spec_k" in kw:
        assert sum(r.accepted_draft_tokens for r in got) > 0


def test_engine_serve_n4(models, tctx):
    """Engine.serve on a TP group (paged decode) where the prefill's mode
    is "ar", and where it is "overlap" (2 x 16 rows: AG+GEMM and GEMM+RS,
    their plain versions here): the one-rank tokens."""
    _, _, tcfg, tparams = models
    rng = np.random.default_rng(9)
    ids = rng.integers(0, 256, (2, 5)).astype(np.int32)
    one = Engine(tcfg, tparams, device="cpu", max_seq=MAX_SEQ,
                 page_size=PAGE)
    four = Engine(tcfg, tparams, tctx, max_seq=MAX_SEQ, page_size=PAGE)
    assert four._prefill_mode(2, 5) == "ar"
    assert torch.equal(four.serve(ids, 6), one.serve(ids, 6))
    wide = rng.integers(0, 256, (2, 16)).astype(np.int32)
    assert four._prefill_mode(2, 16) == "overlap"
    before = (_comm.AG_GEMM_KERNEL.plain_calls,
              _comm.GEMM_RS_KERNEL.plain_calls)
    assert torch.equal(four.serve(wide, 6), one.serve(wide, 6))
    L = tcfg.num_layers
    assert (_comm.AG_GEMM_KERNEL.plain_calls - before[0],
            _comm.GEMM_RS_KERNEL.plain_calls - before[1]) == (
        N * 5 * L, N * 2 * L)


def test_tp_refusals(models, tctx):
    _, _, tcfg, tparams = models
    with pytest.raises(ValueError, match="ctx .* or device"):
        Engine(tcfg, tparams, tctx, device="cpu")
    # A MoE config on the TP group, once refused here, serves: its tokens
    # equal the one-rank engine's.
    mcfg = tiny_config(num_experts=4, num_experts_per_tok=2,
                       moe_intermediate_size=64, num_layers=1)
    mparams = tdense.init_dense_llm(
        mcfg, generator=torch.Generator().manual_seed(5), device="cpu")
    moe4 = Engine(mcfg, mparams, tctx, max_seq=MAX_SEQ)
    moe1 = Engine(mcfg, mparams, device="cpu", max_seq=MAX_SEQ)
    assert torch.equal(moe4.serve([[3, 1, 4, 1, 5]], 3),
                       moe1.serve([[3, 1, 4, 1, 5]], 3))
    with pytest.raises(ValueError, match="not divisible"):
        Engine(tiny_config(num_kv_heads=2, num_heads=4), tparams, tctx)
    mk = Engine(tcfg, tparams, tctx, max_seq=256, page_size=128,
                backend="megakernel")
    with pytest.raises(MegakernelUnsupportedError, match="single-rank"):
        ServingEngine(mk, max_batch=2, prefill_chunk=128)
    # The linear-cache decode is no longer refused at n = 4: one step from
    # an empty cache lands at offset 1 on every rank.
    lin = Engine(tcfg, tparams, tctx, max_seq=MAX_SEQ)
    tok, caches = lin.decode(torch.zeros(1, dtype=torch.int32),
                             lin.new_cache(1))
    assert tok.shape == (1,) and [c.offset for c in caches] == [1] * N
    x = torch.ones((4, tcfg.hidden_size))
    from triton_distributed_tpu_torch.layers.tp_mlp import tp_mlp_fwd

    def row_sharded(r):
        # "overlap2d" is ported (layers/tp_mlp over ops/hierarchical): on
        # one tier (n_inter = 1) it is the one-tier "overlap" path, bit for
        # bit (tests/test_torch_hierarchical.py runs two tiers).
        mlp = shard_params(tparams, tctx, tcfg)[r]["layers"][0]["mlp"]
        return torch.equal(
            tp_mlp_fwd(mlp, x, num_ranks=N, mode="overlap2d"),
            tp_mlp_fwd(mlp, x, num_ranks=N, mode="overlap"))

    assert all(tctx.run(row_sharded))
