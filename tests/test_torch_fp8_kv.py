"""Port's fp8 (e4m3) KV lane vs the JAX package's: the saturating cast bit
for bit, K2's plain version over e4m3 pools against the JAX kernel in
interpret mode, the saturating append, the fixed-budget pool sizing, the
eager and megakernel serving lanes over e4m3 pools (token-identical, with a
preemption), and the megakernel's kv8 program (queue word for word, one
plain step against the JAX ``run_queue`` on both workspaces).

e4m3 pool state crosses between the packages as bytes: a uint8 view on
one side, reinterpreted as ``float8_e4m3fn`` on the other, so both read
the same stored values. Tolerances: casts bit-identical; fp32 activations
at atol = rtol = 1e-5 (summation order only); tokens identical.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ml_dtypes

from triton_distributed_tpu.megakernel.models import (
    build_decode_step as jbuild,
)
from triton_distributed_tpu.megakernel.serving import (
    PagedMegakernelDecoder as JDecoder,
)
from triton_distributed_tpu.models import fp8 as jfp8
from triton_distributed_tpu.models import sampling as jsampling
from triton_distributed_tpu.models.config import ModelConfig as JConfig
from triton_distributed_tpu.models.config import tiny_config as jtiny
from triton_distributed_tpu.models.dense import (
    dense_prefill as jprefill, init_dense_llm as jinit,
)
from triton_distributed_tpu.models.engine import Engine as JEngine
from triton_distributed_tpu.models.kv_cache import (
    init_kv_cache as jkv, kv_pool_pages_for_budget as jbudget,
)
from triton_distributed_tpu.ops import paged_attention as jpa
from triton_distributed_tpu.runtime import initialize_distributed
from triton_distributed_tpu.serving.loop import ServingEngine as JServing
from triton_distributed_tpu_torch.megakernel.kernel import (
    MEGA_KERNEL, run_queue_plain,
)
from triton_distributed_tpu_torch.megakernel.models import build_decode_step
from triton_distributed_tpu_torch.megakernel.serving import (
    PagedMegakernelDecoder,
)
from triton_distributed_tpu_torch.megakernel.tasks import TILE, TaskType
from triton_distributed_tpu_torch.models.config import (
    ModelConfig, tiny_config,
)
from triton_distributed_tpu_torch.models.convert import params_from_numpy
from triton_distributed_tpu_torch.models.engine import Engine
from triton_distributed_tpu_torch.models.fp8 import E4M3, saturate_cast
from triton_distributed_tpu_torch.models.kv_cache import (
    PagePoolConfigError, kv_pool_pages_for_budget,
)
from triton_distributed_tpu_torch.ops import paged_attention as pa
from triton_distributed_tpu_torch.serving import (
    RequestState, ServingConfigError, ServingEngine,
)

J8 = jnp.float8_e4m3fn
SPECIAL = [448.0, -448.0, 464.0, -464.0, 1000.0, -1000.0, 0.0, -0.0,
           1e-9, 447.9, 449.0]


def _e4m3_to_torch(a) -> torch.Tensor:
    """A JAX e4m3 array → the torch tensor of the same bytes."""
    raw = np.ascontiguousarray(np.asarray(a)).view(np.uint8)
    return torch.from_numpy(raw.copy()).view(E4M3)


def _bytes(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.uint8).numpy()


@pytest.fixture(scope="module")
def ctx1():
    return initialize_distributed(mesh_shape=(1,), axis_names=("tp",),
                                  devices=jax.devices()[:1])


# ---------------------------------------------------------------------------
# models/fp8.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_saturate_cast_bit_identical_to_jax(dtype):
    """200 000 values (N(0,1) x 100) plus the range edges: the port's
    saturating cast stores the bytes JAX's ``_to_e4m3`` stores, and no
    value past +-448 becomes NaN."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(200_000) * 100,
                        np.asarray(SPECIAL)]).astype(np.float32)
    if dtype == "bfloat16":
        xb = x.astype(ml_dtypes.bfloat16)
        want = jfp8._to_e4m3(jnp.asarray(xb))
        src = torch.from_numpy(xb.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        want = jfp8._to_e4m3(jnp.asarray(x))
        src = torch.from_numpy(x)
    got = saturate_cast(src, E4M3)
    assert got.dtype == E4M3
    np.testing.assert_array_equal(_bytes(got),
                                  np.asarray(want).view(np.uint8))
    assert torch.isfinite(got.float()).all()
    edges = got[-len(SPECIAL):].float().tolist()
    assert edges[:6] == [448.0, -448.0, 448.0, -448.0, 448.0, -448.0]
    # saturate_cast leaves other targets to a plain cast.
    assert saturate_cast(src, torch.float32).dtype == torch.float32


# ---------------------------------------------------------------------------
# ops/paged_attention over e4m3 pools.
# ---------------------------------------------------------------------------

def _fp8_caches(seed, *, lens, page=8, hkv=2, d=128, hq=4):
    """The same e4m3 pools, tables and lengths on both sides; shuffled
    pages, -1 past each sequence's valid pages, hot V values past 448
    (saturated when the pools were cast)."""
    rng = np.random.default_rng(seed)
    B = len(lens)
    max_pages = -(-max(lens) // page)
    num_pages = B * max_pages + 1
    pool = rng.standard_normal((2, num_pages, page, hkv, d)).astype(
        np.float32)
    pool[1, :, 0, 0, :4] = [900.0, -900.0, 464.0, -1000.0]
    p8 = jfp8._to_e4m3(jnp.asarray(pool))
    table = rng.permutation(num_pages)[:B * max_pages].reshape(
        B, max_pages).astype(np.int32)
    for i, n in enumerate(lens):
        table[i, -(-n // page):] = -1
    q = rng.standard_normal((B, hq, d)).astype(np.float32)
    jcache = jpa.PagedKVCache(p8[0], p8[1], jnp.asarray(np.maximum(table, 0)),
                              jnp.asarray(lens, jnp.int32))
    kp8 = _e4m3_to_torch(p8)
    tcache = pa.PagedKVCache(kp8[0], kp8[1], torch.from_numpy(table),
                             torch.tensor(lens, dtype=torch.int32))
    return q, jcache, tcache


@pytest.mark.parametrize("normalize", [True, False])
def test_plain_k2_e4m3_pools_match_jax_interpret(normalize):
    """K2's plain version reads the e4m3 pools as stored, widened to
    fp32, like the TPU kernel (interpret mode): fp32 q at 1e-5, an empty
    slot included; the partial's (acc, m, l) too."""
    lens = [0, 1, 17, 30]
    q, jcache, tcache = _fp8_caches(1, lens=lens)
    want = jpa.paged_decode_attention(jnp.asarray(q), jcache,
                                      normalize=normalize)
    calls = pa.PAGED_KERNEL.plain_calls
    got = pa.paged_decode_attention(torch.from_numpy(q), tcache,
                                    normalize=normalize)
    assert pa.PAGED_KERNEL.plain_calls == calls + 1
    if normalize:
        want, got = (want,), (got,)
    else:
        got = (got[0], got[1], got[2])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    if normalize:
        gold = jpa.paged_decode_attention_golden(jnp.asarray(q), jcache)
        np.testing.assert_allclose(got[0].numpy(), gold, rtol=1e-5,
                                   atol=1e-5)


def test_paged_append_saturates_hot_values():
    """Hot k/v values store as +-448 through the saturating cast, the
    bytes JAX's append stores; the rest of the pool is untouched."""
    rng = np.random.default_rng(2)
    k = (rng.standard_normal((2, 2, 16)) * 300).astype(np.float32)
    v = (rng.standard_normal((2, 2, 16)) * 300).astype(np.float32)
    k[0, 0, :3] = [1000.0, -464.0, 449.0]
    jc = jpa.init_paged_kv_cache(2, num_pages=4, page_size=4, num_kv_heads=2,
                                 head_dim=16, max_pages=2, kv_dtype=J8)
    jc = jc._replace(kv_lens=jnp.asarray([3, 8], jnp.int32))   # 2nd full
    jout = jpa.paged_append(jc, jnp.asarray(k), jnp.asarray(v))
    tc = pa.init_paged_kv_cache(2, num_pages=4, page_size=4, num_kv_heads=2,
                                head_dim=16, max_pages=2, kv_dtype=E4M3,
                                device="cpu")
    tc = tc._replace(kv_lens=torch.tensor([3, 8], dtype=torch.int32))
    tout = pa.paged_append(tc, torch.from_numpy(k), torch.from_numpy(v))
    assert tout.k_pool.dtype == E4M3
    np.testing.assert_array_equal(_bytes(tout.k_pool),
                                  np.asarray(jout.k_pool).view(np.uint8))
    np.testing.assert_array_equal(_bytes(tout.v_pool),
                                  np.asarray(jout.v_pool).view(np.uint8))
    assert tout.kv_lens.tolist() == [4, 8]          # the full one dropped
    row = tout.k_pool[0, 3, 0, :3].float().tolist()
    assert row == [448.0, -448.0, 448.0]


# ---------------------------------------------------------------------------
# models/kv_cache: fixed-budget pool sizing.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv", [None, "float32", "float8_e4m3fn"])
def test_kv_pool_pages_for_budget_equals_jax(kv):
    """Pages per byte budget equal the JAX package's, at the model dtype,
    fp32 and e4m3; e4m3 buys twice the bf16 pages; a budget below one
    page is a named error."""
    jcfg = jtiny(dtype="bfloat16")
    cfg = tiny_config(dtype="bfloat16")
    jkv_dt = None if kv is None else jnp.dtype(kv)
    for budget in (1 << 20, 3_000_000, 1 << 26):
        assert kv_pool_pages_for_budget(
            cfg, page_size=4, hbm_bytes=budget, kv_dtype=kv) == jbudget(
            jcfg, page_size=4, hbm_bytes=budget, kv_dtype=jkv_dt)
    bf16 = kv_pool_pages_for_budget(cfg, page_size=4, hbm_bytes=1 << 26)
    e4m3 = kv_pool_pages_for_budget(cfg, page_size=4, hbm_bytes=1 << 26,
                                    kv_dtype=E4M3)
    assert e4m3 == 2 * bf16
    with pytest.raises(PagePoolConfigError, match="kv_hbm_budget"):
        kv_pool_pages_for_budget(cfg, page_size=4, hbm_bytes=100,
                                 kv_dtype=kv)


# ---------------------------------------------------------------------------
# Serving, eager lane: e4m3 pools against JAX's and the sequential serve.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny(ctx1):
    jcfg = jtiny()
    jparams = jinit(jax.random.key(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                tiny_config(), device="cpu")
    return jcfg, jparams, tiny_config(), tparams


def _drive(se, reqs_in, prefix):
    reqs = []
    for i, (p, g, prio) in enumerate(reqs_in):
        req, res = se.submit(p, g, priority=prio, req_id=f"{prefix}-{i}")
        assert getattr(res, "name", res) == "ADMITTED", res
        reqs.append(req)
    se.run()
    return reqs


def test_fp8_serving_matches_jax_and_sequential_serve(tiny, ctx1):
    """``ServingEngine`` over e4m3 pools (``Engine(kv_dtype=e4m3)``; a
    6-page pool forces a preemption) gives the JAX package's fp8 serving
    tokens, which equal the port's sequential fp8 ``Engine.serve`` (the
    ``tests/test_fp8_kv.py`` shape)."""
    jcfg, jparams, cfg, tparams = tiny
    rng = np.random.default_rng(2)
    reqs_in = [(rng.integers(0, cfg.vocab_size, n).tolist(), g, 0)
               for n, g in ((8, 6), (10, 5), (6, 4))]
    eng = Engine(cfg, tparams, device="cpu", max_seq=64, page_size=4,
                 kv_dtype=E4M3)
    se = ServingEngine(eng, max_batch=2, num_pages=6, prefill_chunk=4)
    assert se._cache.k_pools.dtype == E4M3
    calls = pa.PAGED_KERNEL.plain_calls
    reqs = _drive(se, reqs_in, "t8")
    assert pa.PAGED_KERNEL.plain_calls > calls
    assert sum(r.preemptions for r in reqs) > 0, \
        "pool sizing no longer exercises preemption on the fp8 pool"
    jeng = JEngine(jcfg, jparams, ctx1, backend="xla", max_seq=64,
                   page_size=4, kv_dtype=J8)
    jse = JServing(jeng, max_batch=2, num_pages=6, prefill_chunk=4)
    jreqs = _drive(jse, reqs_in, "j8")
    for r, jr, (p, g, _) in zip(reqs, jreqs, reqs_in):
        gold = eng.serve([p], g)[0].tolist()
        assert r.tokens == jr.tokens == gold, (r.tokens, jr.tokens, gold)
    assert [r.preemptions for r in reqs] == [r.preemptions for r in jreqs]


def test_fp8_engine_surface(tiny):
    """``to_paged`` quantizes through the saturating cast; ``kv_dtype``
    without ``page_size`` and ``num_pages`` with ``kv_hbm_budget`` are
    named errors; the budget sizes the serving pool at e4m3 width."""
    _, _, cfg, tparams = tiny
    with pytest.raises(ValueError, match="kv_dtype without page_size"):
        Engine(cfg, tparams, device="cpu", max_seq=64, kv_dtype=E4M3)
    eng = Engine(cfg, tparams, device="cpu", max_seq=16, page_size=4,
                 kv_dtype="float8_e4m3fn")
    lin = eng.new_cache(1)
    lin.k[0, 0, 0, 0, :2] = torch.tensor([900.0, -5000.0])
    paged = eng.to_paged(lin)
    assert paged.k_pools.dtype == E4M3
    assert paged.k_pools[0, 0, 0, 0, :2].float().tolist() == [448.0, -448.0]
    with pytest.raises(ServingConfigError, match="kv_hbm_budget"):
        ServingEngine(eng, num_pages=4, kv_hbm_budget=1 << 20)
    budget = 1 << 16
    se = ServingEngine(eng, kv_hbm_budget=budget, prefill_chunk=4)
    assert se.num_pages == kv_pool_pages_for_budget(
        cfg, page_size=4, hbm_bytes=budget, kv_dtype=E4M3)


# ---------------------------------------------------------------------------
# The megakernel's kv8 program.
# ---------------------------------------------------------------------------

MK = dict(hidden_size=256, intermediate_size=256, num_layers=2, num_heads=2,
          num_kv_heads=1, head_dim=128, vocab_size=512, qk_norm=True,
          dtype="float32")
PROMPTS = [[3, 141, 59, 26, 5], [7, 9, 23]]
PAGES = {0: [0, 1], 1: [2, 3]}
NUM_SLOTS, NUM_PAGES, MAX_PAGES = 2, 4, 2


def test_kv8_queue_word_for_word():
    """``build_decode_step(kv_fp8=True)``: the JAX builder's queue word
    for word, the e4m3 pools in their own tile space, the F8 types."""
    cap = MAX_PAGES * TILE
    kw = dict(hidden=256, hq_local=2, hkv_local=1, ffn_local=256,
              num_layers=2, max_seq=cap, pos=cap - 1, eps=1e-6,
              batch=NUM_SLOTS * TILE, head_dim=128,
              kv_pool_pages=NUM_PAGES + 1, table_pages=MAX_PAGES,
              kv_fp8=True)
    jc = jbuild(paged=True, inkernel_append=True, num_ranks=1,
                mat_prefetch=True, **kw).mb.compile(head_dim=128)
    prog = build_decode_step(**kw, inkernel_append=True, mat_prefetch=True)
    tc = prog.mb.compile(head_dim=128)
    np.testing.assert_array_equal(tc.queue, np.asarray(jc.queue))
    assert (tc.num_tiles, tc.num_tiles_kv8) == (jc.num_tiles,
                                                 jc.num_tiles_kv8)
    assert tc.hazard_edges == jc.hazard_edges
    assert tc.task_reads == jc.task_reads
    assert tc.task_writes == jc.task_writes
    assert {TaskType.ATTN_DECODE_PAGED_F8, TaskType.APPEND_KV_F8} <= set(
        tc.used_types)
    assert not {TaskType.ATTN_DECODE_PAGED, TaskType.APPEND_KV} & set(
        tc.used_types)
    assert prog.paged_meta["kv_fp8"] and prog.layers[0].kT[0].kv8


@pytest.fixture(scope="module")
def kv8_decoders():
    """(JAX decoder, port decoder) over e4m3 pools, both prompts
    prefilled (slot 0 on pages 0-1, slot 1 on 2-3), greedy first
    tokens."""
    jcfg = JConfig(**MK)
    jparams = jinit(jax.random.PRNGKey(0), jcfg)
    cfg = ModelConfig(**MK)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                device="cpu")
    jdec = JDecoder(jcfg, jparams, num_slots=NUM_SLOTS, num_pages=NUM_PAGES,
                    max_pages=MAX_PAGES, kv_dtype=J8)
    tdec = PagedMegakernelDecoder(cfg, tparams, num_slots=NUM_SLOTS,
                                  num_pages=NUM_PAGES, max_pages=MAX_PAGES,
                                  device="cpu", kv_dtype=E4M3)
    jws, tws = jdec.start(), tdec.start()
    toks = np.zeros(NUM_SLOTS, np.int32)
    for b, prompt in enumerate(PROMPTS):
        lin = jkv(jcfg, 1, 256)
        logits, lin = jprefill(jparams, jcfg, jnp.asarray([prompt], jnp.int32),
                               lin, num_ranks=1)
        lin = lin._replace(k=lin.k.at[0, 0, 1, 0, :2].set(
            jnp.asarray([700.0, -900.0])))      # hot values to saturate
        toks[b] = int(np.asarray(jsampling.greedy(logits))[0])
        jws = jdec.load_prefill(jws, lin.k, lin.v, PAGES[b])
        tws = tdec.load_prefill(tws, torch.from_numpy(np.array(lin.k)),
                                torch.from_numpy(np.array(lin.v)), PAGES[b])
    return jdec, jws, tdec, tws, toks


def test_kv8_load_prefill_equals_jax(kv8_decoders):
    """The prefill scatter quantizes into the kv8 workspace the bytes the
    JAX decoder stores; the main workspaces are equal."""
    _, (jmain, jk8), tdec, (tmain, tk8), _ = kv8_decoders
    assert tk8.dtype == E4M3
    np.testing.assert_array_equal(_bytes(tk8), np.asarray(jk8).view(np.uint8))
    np.testing.assert_array_equal(tmain.numpy(), np.asarray(jmain))
    assert float(tk8.float().abs().max()) == 448.0


def test_kv8_plain_step_equals_jax_interpret(kv8_decoders):
    """One step of ``run_queue_plain`` (types 24/25 over the kv8
    workspace) against the JAX ``run_queue`` in interpret mode on the same
    workspaces and queue: the live rows of the main workspace at fp32 1e-5
    and the kv8 workspace byte for byte."""
    jdec, (jmain, jk8), tdec, (tmain, tk8), toks = kv8_decoders
    lens, tables = [5, 3], [[0, 1], [2, 3]]
    queue = jdec._retarget(lens, tables)
    prog, comp = jdec.prog, jdec.comp
    x = np.zeros((NUM_SLOTS * TILE, MK["hidden_size"]), np.float32)
    emb = np.asarray(jdec.embed)
    cos = np.zeros((NUM_SLOTS * TILE, TILE), np.float32)
    sin = np.zeros_like(cos)
    for b in range(NUM_SLOTS):
        x[b * TILE] = emb[toks[b]]
        cos[b * TILE:(b + 1) * TILE], sin[b * TILE:(b + 1) * TILE] = \
            jdec._rope(lens[b])
    ws = comp.scatter_input(jnp.array(jmain), prog.x, jnp.asarray(x))
    ws = comp.scatter_input(ws, prog.cos, jnp.asarray(cos))
    ws = comp.scatter_input(ws, prog.sin, jnp.asarray(sin))
    before = np.asarray(ws)
    want, want8 = comp.step(ws, queue, wsm=jdec._wsm, wkv8=jnp.array(jk8))
    got8 = tk8.clone()
    got = run_queue_plain(np.asarray(queue), torch.from_numpy(before.copy()),
                          tdec._wsm, num_exec=tdec.comp.num_exec,
                          mat_specs=tdec.comp.mat_specs, head_dim=TILE,
                          wkv8=got8).numpy()
    np.testing.assert_allclose(got[:, 0, :], np.asarray(want)[:, 0, :],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(_bytes(got8),
                                  np.asarray(want8).view(np.uint8))
    assert not torch.equal(got8.view(torch.uint8), tk8.view(torch.uint8))


def test_kv8_decoder_tokens_vs_jax(kv8_decoders):
    """Three steps of the fp8 decoder (in-kernel e4m3 appends, the
    quantized current-token fold) give the JAX fp8 decoder's tokens."""
    jdec, jws, tdec, tws, toks = kv8_decoders
    jws = (jnp.array(jws[0]), jnp.array(jws[1]))
    tws = (tws[0].clone(), tws[1].clone())
    kv_lens = np.asarray([len(p) for p in PROMPTS], np.int32)
    jt, tt = toks.copy(), toks.copy()
    tables = [PAGES[b] for b in range(NUM_SLOTS)]
    for _ in range(3):
        jws, jnext = jdec.step(jws, jt, kv_lens, tables)
        tws, tnext = tdec.step(tws, tt, kv_lens, tables)
        jt, tt = np.asarray(jnext), tnext.numpy()
        np.testing.assert_array_equal(tt, jt)
        kv_lens = kv_lens + 1


def test_fp8_megakernel_serving_matches_fp8_eager(ctx1):
    """``ServingEngine`` on the megakernel lane over e4m3 pools gives the
    tokens of the sequential fp8 ``Engine.serve`` on the eager lane —
    one 25-token generation (an unquantized current-token fold diverges
    within ~6 steps) and a preemption on a 2-page pool (the
    ``tests/test_fp8_kv.py`` shape); every step is one megakernel
    step, no K2."""
    cfg = ModelConfig(**dict(MK, num_layers=1))
    jparams = jinit(jax.random.PRNGKey(1), JConfig(**dict(MK, num_layers=1)))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    rng = np.random.default_rng(9)
    reqs_in = [(rng.integers(0, 512, 126).tolist(), 25, 1),
               (rng.integers(0, 512, 100).tolist(), 4, 0)]
    eng = Engine(cfg, params, device="cpu", backend="megakernel",
                 max_seq=256, page_size=128, kv_dtype=E4M3)
    se = ServingEngine(eng, max_batch=2, num_pages=2, prefill_chunk=128)
    assert se._mk is not None and se._mk.kv_fp8
    mk_calls, k2_calls = MEGA_KERNEL.plain_calls, pa.PAGED_KERNEL.plain_calls
    reqs = _drive(se, reqs_in, "mk8")
    assert MEGA_KERNEL.plain_calls - mk_calls >= 24
    assert pa.PAGED_KERNEL.plain_calls == k2_calls
    assert all(r.state is RequestState.FINISHED for r in reqs)
    assert any(r.preemptions > 0 for r in reqs), \
        "pool sizing no longer exercises preemption on the fp8 lane"
    oracle = Engine(cfg, params, device="cpu", max_seq=256, page_size=128,
                    kv_dtype=E4M3)
    for r, (p, g, _) in zip(reqs, reqs_in):
        assert r.tokens == oracle.serve([p], g)[0].tolist()
    with pytest.raises(ValueError, match="kv_dtype"):
        PagedMegakernelDecoder(cfg, params, num_slots=1, num_pages=2,
                               max_pages=2, device="cpu",
                               kv_dtype=torch.bfloat16)
