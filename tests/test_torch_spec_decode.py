"""Port's speculative decode vs the JAX package's: the acceptance rule and
the n-gram proposer case for case, the windowed append (dropped past
capacity, never clamped), the dense verify step's logits, spec serving on
both lanes (token-identical to one-token serving and to the JAX package's
spec serving, with a preemption each), and the megakernel's spec program
(queue and host retarget word for word; one plain step of the causal
window fold and the spill append against the JAX ``run_queue`` in
interpret mode, over workspace-dtype and e4m3 pools).

Tolerances: fp32 activations at atol = rtol = 1e-5 (summation order
only); stored pools and tokens identical.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from triton_distributed_tpu.megakernel.serving import (
    PagedMegakernelDecoder as JDecoder,
)
from triton_distributed_tpu.models import sampling as jsampling
from triton_distributed_tpu.models.config import ModelConfig as JConfig
from triton_distributed_tpu.models.config import tiny_config as jtiny
from triton_distributed_tpu.models.dense import (
    dense_verify_step_paged as jverify, init_dense_llm as jinit,
)
from triton_distributed_tpu.models.engine import Engine as JEngine
from triton_distributed_tpu.models.kv_cache import (
    init_paged_model_cache as jpaged_cache,
)
from triton_distributed_tpu.ops import paged_attention as jpa
from triton_distributed_tpu.runtime import initialize_distributed
from triton_distributed_tpu.serving.loop import ServingEngine as JServing
from triton_distributed_tpu.serving.spec import NGramProposer as JProposer
from triton_distributed_tpu_torch.megakernel.kernel import (
    MEGA_KERNEL, run_queue_plain,
)
from triton_distributed_tpu_torch.megakernel.models import build_decode_step
from triton_distributed_tpu_torch.megakernel.serving import (
    MegakernelUnsupportedError, PagedMegakernelDecoder,
)
from triton_distributed_tpu_torch.megakernel.tasks import TILE, TaskType
from triton_distributed_tpu_torch.models.config import (
    ModelConfig, tiny_config,
)
from triton_distributed_tpu_torch.models.convert import params_from_numpy
from triton_distributed_tpu_torch.models.dense import (
    dense_decode_step_paged, dense_verify_step_paged,
)
from triton_distributed_tpu_torch.models.engine import Engine
from triton_distributed_tpu_torch.models.fp8 import E4M3
from triton_distributed_tpu_torch.models.kv_cache import (
    init_paged_model_cache,
)
from triton_distributed_tpu_torch.models.sampling import (
    accept_longest_prefix,
)
from triton_distributed_tpu_torch.ops import paged_attention as pa
from triton_distributed_tpu_torch.serving import (
    ServingConfigError, ServingEngine,
)
from triton_distributed_tpu_torch.serving.spec import (
    NGramProposer, SpecConfigError,
)

MK = dict(hidden_size=256, intermediate_size=256, num_layers=2, num_heads=2,
          num_kv_heads=1, head_dim=128, vocab_size=512, qk_norm=True,
          dtype="float32")


@pytest.fixture(scope="module")
def ctx1():
    return initialize_distributed(mesh_shape=(1,), axis_names=("tp",),
                                  devices=jax.devices()[:1])


# ---------------------------------------------------------------------------
# Host rules: acceptance and drafting.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("draft,verified", [
    ([], [7]), ([3, 4], [3, 4, 9]), ([5, 4], [3, 4, 9]),
    ([3, 6, 1], [3, 4, 9, 2]), ([1, 2, 3], [1, 2, 3, 4]),
])
def test_accept_longest_prefix_equals_jax(draft, verified):
    got = accept_longest_prefix(draft, verified)
    want = jsampling.accept_longest_prefix(draft, verified)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="k\\+1 positions"):
        accept_longest_prefix(draft + [1], verified)


def test_ngram_proposals_equal_jax():
    """Random repetitive histories (the traffic drafting feeds on), every
    (k, ngram, min_ngram, cap) mix: the same proposals as JAX's; the named
    configuration errors."""
    rng = np.random.default_rng(0)
    for trial in range(300):
        hist = rng.integers(0, 6, int(rng.integers(1, 40))).tolist()
        k = int(rng.integers(1, 5))
        ngram = int(rng.integers(1, 4))
        mn = int(rng.integers(1, ngram + 1))
        cap = None if trial % 3 else int(rng.integers(0, 5))
        kw = dict(ngram=ngram, min_ngram=mn, lookback=16)
        assert NGramProposer(k, **kw).propose(hist, cap) == \
            JProposer(k, **kw).propose(hist, cap), (hist, k, kw, cap)
    assert NGramProposer(2).window_tokens == JProposer(2).window_tokens
    with pytest.raises(SpecConfigError, match="spec_k=0 disables"):
        NGramProposer(0)
    with pytest.raises(SpecConfigError, match="min_ngram"):
        NGramProposer(2, ngram=1, min_ngram=3)


# ---------------------------------------------------------------------------
# The windowed append and the verify step.
# ---------------------------------------------------------------------------

def test_paged_append_window_drops_not_clamps():
    """A window of 3 at length 6 of capacity 8: rows 6 and 7 land, row 8
    is dropped — not clamped onto position 7, where it would overwrite
    the last real candidate. The stored pools equal JAX's (and three
    sequential appends); e4m3 pools too, byte for byte."""
    rng = np.random.default_rng(3)
    k = rng.standard_normal((1, 3, 1, 8)).astype(np.float32) * 300
    v = rng.standard_normal((1, 3, 1, 8)).astype(np.float32)
    for kv in (None, E4M3):
        jc = jpa.init_paged_kv_cache(1, num_pages=2, page_size=4,
                                     num_kv_heads=1, head_dim=8, max_pages=2,
                                     kv_dtype=None if kv is None
                                     else jnp.float8_e4m3fn)
        jc = jc._replace(kv_lens=jnp.asarray([6], jnp.int32))
        jout = jpa.paged_append_window(jc, jnp.asarray(k), jnp.asarray(v))
        tc = pa.init_paged_kv_cache(1, num_pages=2, page_size=4,
                                    num_kv_heads=1, head_dim=8, max_pages=2,
                                    kv_dtype=kv, device="cpu")
        tc = tc._replace(kv_lens=torch.tensor([6], dtype=torch.int32))
        seq = tc._replace(k_pool=tc.k_pool.clone(), v_pool=tc.v_pool.clone())
        tout = pa.paged_append_window(tc, torch.from_numpy(k),
                                      torch.from_numpy(v))
        assert tout.kv_lens.tolist() == [8]
        for i in range(3):
            seq = pa.paged_append(seq, torch.from_numpy(k[:, i]),
                                  torch.from_numpy(v[:, i]))
        for got, ref, want in ((tout.k_pool, seq.k_pool, jout.k_pool),
                               (tout.v_pool, seq.v_pool, jout.v_pool)):
            b = got.view(torch.uint8).numpy()
            assert (b == ref.view(torch.uint8).numpy()).all()
            assert (b == np.asarray(want).view(np.uint8)).all()
        # Position 7 holds candidate 1, not the dropped candidate 2.
        np.testing.assert_array_equal(tout.v_pool[1, 3, 0].float().numpy(),
                                      torch.from_numpy(v[0, 1, 0]).to(
                                          tout.v_pool.dtype).float().numpy())


@pytest.fixture(scope="module")
def tiny(ctx1):
    jcfg = jtiny()
    jparams = jinit(jax.random.key(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                tiny_config(), device="cpu")
    return jcfg, jparams, tiny_config(), tparams


def test_verify_step_logits_match_jax(tiny):
    """``dense_verify_step_paged`` over heterogeneous lengths: logits at
    fp32 1e-5 against the JAX verify step and against W sequential
    one-token steps of the port; the appended pools equal the sequential
    ones exactly."""
    jcfg, jparams, cfg, tparams = tiny
    B, W, page, mp = 2, 3, 4, 8
    rng = np.random.default_rng(1)
    jc = jpaged_cache(jcfg, B, page_size=page, max_pages=mp)
    kp = rng.standard_normal(jc.k_pools.shape).astype(np.float32)
    vp = rng.standard_normal(jc.v_pools.shape).astype(np.float32)
    lens = np.asarray([5, 9], np.int32)
    jc = jc._replace(k_pools=jnp.asarray(kp), v_pools=jnp.asarray(vp),
                     kv_lens=jnp.asarray(lens))
    toks = np.array([[3, 11, 7], [20, 5, 5]], np.int32)
    want, _ = jverify(jparams, jcfg, jnp.asarray(toks), jc, num_ranks=1,
                      mode="ar")

    def fresh():
        c = init_paged_model_cache(cfg, B, page_size=page, max_pages=mp,
                                   device="cpu")
        return c._replace(k_pools=torch.from_numpy(kp.copy()),
                          v_pools=torch.from_numpy(vp.copy()),
                          kv_lens=torch.from_numpy(lens))

    got, c_ver = dense_verify_step_paged(tparams, cfg, torch.from_numpy(toks),
                                         fresh())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    c_seq = fresh()
    for i in range(W):
        lg, c_seq = dense_decode_step_paged(tparams, cfg,
                                            torch.from_numpy(toks[:, i]),
                                            c_seq)
        np.testing.assert_allclose(got[:, i].numpy(), lg.numpy(),
                                   rtol=1e-5, atol=1e-5)
    assert torch.equal(c_ver.k_pools, c_seq.k_pools)
    assert torch.equal(c_ver.v_pools, c_seq.v_pools)
    assert c_ver.kv_lens.tolist() == c_seq.kv_lens.tolist() == [8, 12]


# ---------------------------------------------------------------------------
# Spec serving, both lanes.
# ---------------------------------------------------------------------------

def _serve(se, trace):
    """Submit as the trace's arrival iterations say, step to the end;
    after every step each running request must hold exactly
    ceil(kv_len / page) pages (the rollback's occupancy invariant).
    Returns {req_id: request}."""
    reqs, pending, it = {}, sorted(trace, key=lambda t: t[1]), 0
    while pending or se.sched.has_work():
        for item in [t for t in pending if t[1] <= it]:
            rid, _, prompt, n, prio = item
            req, res = se.submit(prompt, n, priority=prio, req_id=rid)
            assert getattr(res, "name", None) == "ADMITTED", res
            reqs[rid] = req
            pending.remove(item)
        se.step()
        for r in se.sched.running():
            assert len(se.sched.allocator.pages(r.req_id)) == \
                -(-r.kv_len // se.page), "rollback left pages behind"
        it += 1
        assert it < 10_000
    return reqs


# The tests/test_spec_decode.py trace: repetitive prompts, a pool that
# evicts while candidate windows are in flight.
EAGER_TRACE = [("sp-0", 0, [3, 9] * 4, 12, 1), ("sp-1", 0, [7] * 5, 8, 0),
               ("sp-2", 1, [11, 4] * 3, 8, 0)]


def test_spec_serving_eager_lane(tiny, ctx1):
    """spec_k = 2 on the eager lane: the tokens of one-token serving, of
    the JAX package's spec serving, and of the sequential serve; drafts
    accepted, a preemption, the pool drained at the end."""
    jcfg, jparams, cfg, tparams = tiny
    eng = Engine(cfg, tparams, device="cpu", max_seq=64, page_size=4)
    se = ServingEngine(eng, max_batch=3, num_pages=7, prefill_chunk=4,
                       spec_k=2)
    reqs = _serve(se, EAGER_TRACE)
    one = _serve(ServingEngine(eng, max_batch=3, num_pages=7,
                               prefill_chunk=4), EAGER_TRACE)
    jeng = JEngine(jcfg, jparams, ctx1, backend="xla", max_seq=64,
                   page_size=4)
    jreqs = _serve(JServing(jeng, max_batch=3, num_pages=7, prefill_chunk=4,
                            spec_k=2), EAGER_TRACE)
    for rid, _, prompt, n, _ in EAGER_TRACE:
        gold = eng.serve([prompt], n)[0].tolist()
        assert reqs[rid].tokens == one[rid].tokens == jreqs[rid].tokens \
            == gold, rid
        assert reqs[rid].accepted_draft_tokens == \
            jreqs[rid].accepted_draft_tokens
    assert any(r.preemptions > 0 for r in reqs.values())
    assert sum(r.accepted_draft_tokens for r in reqs.values()) > 0
    assert se.sched.allocator.free_count == se.sched.allocator.usable_pages
    with pytest.raises(ServingConfigError, match="spec_k"):
        ServingEngine(eng, spec_k=-1)


def _mk_trace():
    rng = np.random.default_rng(9)
    pat = rng.integers(0, 512, 7).tolist()
    return [("mksp-0", 0, (pat * 19)[:126], 8, 1),
            ("mksp-1", 0, (pat * 16)[:100], 6, 0)]


@pytest.mark.parametrize("kv", [None, "float8_e4m3fn"])
def test_spec_serving_megakernel_lane(kv, ctx1):
    """spec_k = 2 on the megakernel lane (W = 3 rows per slot block): the
    tokens of the sequential serve and of the JAX package's spec serving
    (its eager lane), with a preemption on a 2-page pool and slot 0's
    window crossing its page; over e4m3 pools too (spec + fp8). Every
    step is one megakernel step."""
    jcfg = JConfig(**MK)
    jparams = jinit(jax.random.PRNGKey(1), jcfg)
    cfg = ModelConfig(**MK)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    trace = _mk_trace()
    eng = Engine(cfg, params, device="cpu", backend="megakernel",
                 max_seq=256, page_size=128, kv_dtype=kv)
    se = ServingEngine(eng, max_batch=2, num_pages=2, prefill_chunk=128,
                       spec_k=2)
    assert se._mk.spec_w == 3 and se._mk.kv_fp8 == (kv is not None)
    calls = MEGA_KERNEL.plain_calls
    reqs = _serve(se, trace)
    assert MEGA_KERNEL.plain_calls > calls
    oracle = Engine(cfg, params, device="cpu", max_seq=256, page_size=128,
                    kv_dtype=kv)
    jeng = JEngine(jcfg, jparams, ctx1, backend="xla", max_seq=256,
                   page_size=128,
                   kv_dtype=None if kv is None else jnp.float8_e4m3fn)
    jreqs = _serve(JServing(jeng, max_batch=2, num_pages=2,
                            prefill_chunk=128, spec_k=2), trace)
    for rid, _, prompt, n, _ in trace:
        assert reqs[rid].tokens == jreqs[rid].tokens == \
            oracle.serve([prompt], n)[0].tolist(), rid
    assert any(r.preemptions > 0 for r in reqs.values())
    assert sum(r.accepted_draft_tokens for r in reqs.values()) > 0


def test_megakernel_lane_refuses_wide_windows():
    """A window rides the 128 rows of one slot block: spec_k >= 128 on the
    megakernel lane is a named error, as is a program window past the JAX
    builder's range; windows past the kernel's 4-row groups build."""
    cfg = ModelConfig(**dict(MK, num_layers=1))
    params = params_from_numpy(
        jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(1),
                                       JConfig(**dict(MK, num_layers=1)))),
        cfg, device="cpu")
    eng = Engine(cfg, params, device="cpu", backend="megakernel",
                 max_seq=256, page_size=128)
    with pytest.raises(MegakernelUnsupportedError, match="spec_k <= 127"):
        ServingEngine(eng, max_batch=1, prefill_chunk=128, spec_k=128)
    with pytest.raises(MegakernelUnsupportedError, match="spec_window"):
        PagedMegakernelDecoder(cfg, params, num_slots=1, num_pages=2,
                               max_pages=2, device="cpu", spec_window=129)
    assert ServingEngine(eng, max_batch=1, prefill_chunk=128,
                         spec_k=4)._mk.spec_w == 5
    with pytest.raises(ValueError, match="out of range"):
        build_decode_step(hidden=256, hq_local=2, hkv_local=1, ffn_local=256,
                          num_layers=1, max_seq=256, pos=255, batch=128,
                          kv_pool_pages=3, table_pages=2, spec_window=200,
                          inkernel_append=True, mat_prefetch=True)


# ---------------------------------------------------------------------------
# The megakernel's spec program against the JAX package's.
# ---------------------------------------------------------------------------

SLOTS, POOL, MAXP, W = 2, 4, 2, 4
# Slot 0's window spills from page 0 into page 1; slot 1's fits its page.
LENS, TABLES, WINS = [126, 3], [[1, 0], [2, 3]], [4, 2]


@pytest.fixture(scope="module", params=[None, "float8_e4m3fn"],
                ids=["fp32_pools", "e4m3_pools"])
def spec_decoders(request):
    """(JAX decoder, port decoder) of the W = 4 program, the port's
    workspaces filled with random KV and staged for one step."""
    kv = request.param
    jcfg, cfg = JConfig(**MK), ModelConfig(**MK)
    jparams = jinit(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                device="cpu")
    jdec = JDecoder(jcfg, jparams, num_slots=SLOTS, num_pages=POOL,
                    max_pages=MAXP, spec_window=W,
                    kv_dtype=None if kv is None else jnp.float8_e4m3fn)
    tdec = PagedMegakernelDecoder(cfg, tparams, num_slots=SLOTS,
                                  num_pages=POOL, max_pages=MAXP,
                                  device="cpu", spec_window=W, kv_dtype=kv)
    ws = tdec.start()
    main, pool = tdec._split(ws)
    g = torch.Generator().manual_seed(5)
    tiles = [t for h in tdec.prog.layers for p in h.kT + h.v
             for t in p.tiles()]
    pool[tiles] = (torch.randn((len(tiles), TILE, TILE), generator=g)
                   * 2).to(pool.dtype)
    toks = torch.randint(0, 512, (SLOTS, W), generator=g).numpy()
    queue = tdec.stage(ws, toks, LENS, TABLES, WINS)
    return jdec, tdec, ws, queue, kv


def test_spec_queue_and_retarget_equal_jax(spec_decoders):
    """The W = 4 program's queue word for word, and the host retarget
    with per-slot windows (words 5, 4, 7 and the spill rows, a parked
    spill at c0 = -1) equal to the JAX decoder's."""
    jdec, tdec, _, queue, _ = spec_decoders
    np.testing.assert_array_equal(tdec.comp.queue, np.asarray(jdec.comp.queue))
    np.testing.assert_array_equal(queue, np.asarray(
        jdec._retarget(LENS, TABLES, WINS)))
    for lens, tables, wins in (([0, 5], [[-1, -1], [0, 1]], [1, 4]),
                               ([127, 128], [[0, 1], [2, 3]], [2, 3])):
        np.testing.assert_array_equal(
            tdec._retarget(lens, tables, wins),
            np.asarray(jdec._retarget(lens, tables, wins)))
    q = queue[:tdec.comp.num_exec]
    app = np.isin(q[:, 0], [int(TaskType.APPEND_KV),
                            int(TaskType.APPEND_KV_F8)])
    assert (q[app, 8] == 0).any() and (q[app, 4] == 2).any()  # the spill
    with pytest.raises(ValueError, match="window"):
        tdec._retarget(LENS, TABLES, [5, 1])


def test_window_fold_and_spill_append_equal_jax_interpret(spec_decoders):
    """One plain step of the W = 4 program (the causal window fold of
    types 9/24, the primary and spill appends of 14/25) against the JAX
    ``run_queue`` in interpret mode on the same workspaces and queue: the
    window rows of every tile at fp32 1e-5, and every pool tile (fp32
    pools at 1e-5, e4m3 pools byte for byte)."""
    jdec, tdec, ws, queue, kv = spec_decoders
    main, pool = tdec._split(ws)
    comp = jdec.comp
    args = dict(wsm=jnp.asarray(tdec._wsm.numpy()))   # equal to JAX's
    if kv is not None:
        raw = pool.view(torch.uint8).numpy()
        args["wkv8"] = jnp.asarray(raw.view(jnp.float8_e4m3fn))
    out = comp.step(jnp.asarray(main.numpy()), jnp.asarray(queue), **args)
    want, want_pool = (out if kv is not None else (out, out))
    got_main = main.clone()
    got_pool = pool.clone() if kv is not None else got_main
    run_queue_plain(queue, got_main, tdec._wsm, num_exec=tdec.comp.num_exec,
                    mat_specs=tdec.comp.mat_specs, head_dim=TILE,
                    wkv8=got_pool if kv is not None else None)
    np.testing.assert_allclose(got_main.numpy()[:, :W, :],
                               np.asarray(want)[:, :W, :], rtol=1e-5,
                               atol=1e-5)
    tiles = [t for h in tdec.prog.layers for p in h.kT + h.v
             for t in p.tiles()]
    if kv is None:
        np.testing.assert_allclose(got_pool.numpy()[tiles],
                                   np.asarray(want_pool)[tiles],
                                   rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(
            got_pool.view(torch.uint8).numpy(),
            np.asarray(want_pool).view(np.uint8))
    # The spill landed: slot 0's rows 2-3 at columns 0-1 of pool page 0.
    kt0 = tdec.prog.layers[0].kT[0].tile(0, 0)
    assert not torch.equal(got_pool[kt0][:, :2].float(),
                           pool[kt0][:, :2].float())
