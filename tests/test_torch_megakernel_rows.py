"""Live rows up to TILE and the PREFETCH / PREFETCH_W8 warms, port vs the
JAX package.

* Speculative serving on the megakernel lane at ``spec_k`` 4 and 7
  (windows of 5 and 8 rows, past the CUDA kernel's 4-row groups): every
  request's tokens equal the JAX package's spec serving and its sequential
  ``Engine.serve``, with a preemption on a 2-page pool.
* The MoE decode program at batch 8 (host-fed caches) and the linear
  matrix-layout program at batch 200 (two row blocks): queues word for
  word, then one step of ``run_queue_plain`` against the JAX kernel's step
  in interpret mode, every tile at fp32 1e-5 (summation order only).
* A queue of PREFETCH -> GEMM_WIDE(c0 = 1) and PREFETCH_W8 ->
  GEMM_WIDE_W8(c0 = 1): word for word the JAX builder's, outputs the JAX
  kernel's at 1e-5, and bit for bit the port's outputs of the same program
  without the warms.

Each JAX program runs once per module (fixtures).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from triton_distributed_tpu.megakernel.builder import (
    MegaKernelBuilder as JBuilder,
)
from triton_distributed_tpu.megakernel.models import (
    build_decode_step as jbuild, feed_layer_weights as jfeed,
)
from triton_distributed_tpu.models.config import ModelConfig as JConfig
from triton_distributed_tpu.models.dense import init_dense_llm as jinit
from triton_distributed_tpu.models.engine import Engine as JEngine
from triton_distributed_tpu.runtime import initialize_distributed
from triton_distributed_tpu.serving.loop import ServingEngine as JServing
from triton_distributed_tpu_torch.megakernel.builder import MegaKernelBuilder
from triton_distributed_tpu_torch.megakernel.kernel import (
    MAX_LIVE_ROWS, MEGA_KERNEL,
)
from triton_distributed_tpu_torch.megakernel.models import (
    broadcast_rows, build_decode_step, feed_layer_weights, feed_moe_weights,
    rope_tables,
)
from triton_distributed_tpu_torch.megakernel.tasks import TILE, TaskType
from triton_distributed_tpu_torch.models.config import ModelConfig
from triton_distributed_tpu_torch.models.convert import params_from_numpy
from triton_distributed_tpu_torch.models.engine import Engine
from triton_distributed_tpu_torch.serving import ServingEngine

TOL = dict(rtol=1e-5, atol=1e-5)
MK = dict(hidden_size=256, intermediate_size=256, num_layers=2, num_heads=2,
          num_kv_heads=1, head_dim=128, vocab_size=512, qk_norm=True,
          dtype="float32")


def test_live_rows_reach_a_whole_block():
    assert MAX_LIVE_ROWS == TILE


# ---------------------------------------------------------------------------
# Spec serving on the megakernel lane, windows past 4 rows.
# ---------------------------------------------------------------------------

def _serve(se, trace):
    """Submit as the trace's arrival iterations say and step to the end;
    each running request holds ceil(kv_len / page) pages after every step.
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


def _trace():
    """Repetitive prompts (drafts get proposed); 2 pages of 128 for two
    requests force a preemption; slot 0's window crosses its page."""
    pat = np.random.default_rng(9).integers(0, 512, 7).tolist()
    return [("rows-0", 0, (pat * 19)[:124], 10, 1),
            ("rows-1", 0, (pat * 16)[:100], 8, 0)]


@pytest.fixture(scope="module")
def spec_models():
    jcfg = JConfig(**MK)
    jparams = jinit(jax.random.PRNGKey(1), jcfg)
    cfg = ModelConfig(**MK)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    ctx = initialize_distributed(mesh_shape=(1,), axis_names=("tp",),
                                 devices=jax.devices()[:1])
    jeng = JEngine(jcfg, jparams, ctx, backend="xla", max_seq=256,
                   page_size=128)
    golden = {rid: np.asarray(jeng.serve(
        jnp.asarray([prompt], jnp.int32), n))[0].tolist()
        for rid, _, prompt, n, _ in _trace()}
    return jeng, cfg, params, golden


@pytest.mark.parametrize("spec_k", [4, 7])
def test_spec_serving_megakernel_lane_wide_windows(spec_models, spec_k):
    """spec_k = 4 and 7 (W = 5 and 8 rows per slot block): the port's
    megakernel lane gives the JAX package's spec-serving tokens and its
    sequential serve's, with a preemption; drafts accepted; every step one
    megakernel run."""
    jeng, cfg, params, golden = spec_models
    trace = _trace()
    eng = Engine(cfg, params, device="cpu", backend="megakernel",
                 max_seq=256, page_size=128)
    se = ServingEngine(eng, max_batch=2, num_pages=2, prefill_chunk=128,
                       spec_k=spec_k)
    assert se._mk.spec_w == spec_k + 1
    calls = MEGA_KERNEL.plain_calls
    reqs = _serve(se, trace)
    assert MEGA_KERNEL.plain_calls > calls
    jreqs = _serve(JServing(jeng, max_batch=2, num_pages=2,
                            prefill_chunk=128, spec_k=spec_k), trace)
    for rid, *_ in trace:
        assert reqs[rid].tokens == jreqs[rid].tokens == golden[rid], rid
    assert any(r.preemptions > 0 for r in reqs.values())
    assert sum(r.accepted_draft_tokens for r in reqs.values()) > 0


# ---------------------------------------------------------------------------
# The MoE program at batch 8 and the linear program at batch 200.
# ---------------------------------------------------------------------------

HIDDEN, HQ, HKV, S, E, TOPK, FFN, POS = 256, 2, 1, 256, 8, 2, 128, 100


def _values(rng, batch, moe):
    """fp32 numpy values of one layer, its caches and ``batch`` input
    rows (padded to whole blocks)."""
    d = TILE
    f = FFN if moe else HIDDEN

    def r(*shape, s=0.05):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    w = {"attn_norm": r(HIDDEN, s=0.1) + 1, "mlp_norm": r(HIDDEN, s=0.1) + 1,
         "q_norm": r(d, s=0.1) + 1, "k_norm": r(d, s=0.1) + 1,
         "wq": r(HIDDEN, HQ * d), "wk": r(HIDDEN, HKV * d),
         "wv": r(HIDDEN, HKV * d), "wo": r(HQ * d, HIDDEN),
         "kT": r(TILE, S, s=0.3), "v": r(S, TILE, s=0.3)}
    if moe:
        w.update(router=r(HIDDEN, E, s=0.2), w_gate=r(E, HIDDEN, f),
                 w_up=r(E, HIDDEN, f), w_down=r(E, f, HIDDEN))
    else:
        w.update(w_gate=r(HIDDEN, f), w_up=r(HIDDEN, f), w_down=r(f, HIDDEN))
    blocks = -(-batch // TILE)
    x = np.zeros((blocks * TILE, HIDDEN), np.float32)
    x[:batch] = r(batch, HIDDEN, s=0.3)
    w["x"] = x
    w["cos"], w["sin"] = rope_tables(POS, d, 1e6)
    return w


def _feeds(prog, w, moe, jax_side):
    h = prog.layers[0]
    feeds = {prog.x: w["x"], prog.cos: w["cos"], prog.sin: w["sin"],
             h.attn_norm: broadcast_rows(w["attn_norm"]),
             h.mlp_norm: broadcast_rows(w["mlp_norm"]),
             h.q_norm: broadcast_rows(w["q_norm"]),
             h.k_norm: broadcast_rows(w["k_norm"]),
             h.kT[0]: w["kT"], h.v[0]: w["v"]}
    conv = jnp.asarray if jax_side else torch.from_numpy
    proj = {k: conv(w[k]) for k in ("wq", "wk", "wv", "wo")}
    if moe:
        if jax_side:
            jfeed(feeds, h, **proj)
            feeds[h.moe_router] = np.pad(w["router"],
                                         ((0, 0), (0, TILE - E)))
            feeds[h.moe_w_gate] = w["w_gate"].reshape(E * HIDDEN, FFN)
            feeds[h.moe_w_up] = w["w_up"].reshape(E * HIDDEN, FFN)
            feeds[h.moe_w_down] = w["w_down"].reshape(E * FFN, HIDDEN)
        else:
            feed_layer_weights(feeds, h, **proj)
            feed_moe_weights(feeds, h, **{k: torch.from_numpy(w[k]) for k
                                          in ("router", "w_gate", "w_up",
                                              "w_down")})
    else:
        mlp = {k: conv(w[k]) for k in ("w_gate", "w_up", "w_down")}
        (jfeed if jax_side else feed_layer_weights)(feeds, h, **proj, **mlp)
    if jax_side:
        return {k: v if isinstance(v, tuple) else jnp.asarray(v)
                for k, v in feeds.items()}
    return {k: v if isinstance(v, tuple) else torch.as_tensor(v)
            for k, v in feeds.items()}


PROGRAMS = {
    # name: (batch, MoE?)
    "moe_b8": (8, True),
    "linear_b200": (200, False),
}


@pytest.fixture(scope="module")
def row_runs():
    """{name: (port program, port compiled, values, JAX workspace after
    one interpret step)}: both builders' queues must agree word for
    word first."""
    out = {}
    for name, (batch, moe) in PROGRAMS.items():
        kw = dict(hidden=HIDDEN, hq_local=HQ, hkv_local=HKV,
                  ffn_local=FFN if moe else HIDDEN, num_layers=1,
                  max_seq=S, pos=POS, batch=batch,
                  moe_experts=E if moe else 0, moe_topk=TOPK if moe else 0)
        jp = jbuild(num_ranks=1, **kw)
        tp = build_decode_step(inkernel_append=False, mat_prefetch=False,
                               **kw)
        jc, tc = jp.mb.compile(), tp.mb.compile()
        np.testing.assert_array_equal(tc.queue, np.asarray(jc.queue))
        w = _values(np.random.default_rng(5), batch, moe)
        main, _, wm = jc.split_feeds(_feeds(jp, w, moe, True))
        jws = jc.step(jc.make_workspace(main), wsm=jc.make_workspace_mat(wm))
        out[name] = (tp, tc, w, np.asarray(jws))
    return out


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_row_programs_step_vs_jax_interpret(row_runs, name):
    """One plain step from the same feeds: every tile of the workspace
    against the JAX kernel's step at fp32 1e-5; at batch 8 the router
    selects top-2 for each of the 8 rows and nothing past them."""
    tp, tc, w, jws = row_runs[name]
    batch, moe = PROGRAMS[name]
    main, _, wm = tc.split_feeds(_feeds(tp, w, moe, False))
    ws = tc.make_workspace(main, device="cpu")
    calls = MEGA_KERNEL.plain_calls
    tc.step(ws, wsm=tc.make_workspace_mat(wm, device="cpu"),
            live_rows=min(batch, TILE))
    assert MEGA_KERNEL.plain_calls == calls + 1
    np.testing.assert_allclose(ws.numpy(), jws, **TOL)
    if moe:
        row = tc.queue[np.flatnonzero(
            tc.queue[:tc.num_exec, 0] == int(TaskType.MOE_TOPK))[0]]
        wt = ws[int(row[1])].numpy()
        assert (wt[:, :batch] > 0).sum(0).tolist() == [TOPK] * batch
        assert not wt[:, batch:].any()
    else:
        assert tp.blocks == 2
        out = np.concatenate([tc.gather_output(ws, h).numpy()
                              for h in tp.x_out_blocks])
        assert np.isfinite(out[:batch]).all() and out[:batch].any()


# ---------------------------------------------------------------------------
# PREFETCH / PREFETCH_W8.
# ---------------------------------------------------------------------------

def _warm_build(mb, warm):
    """GEMM_WIDE and GEMM_WIDE_W8 over a 3-tile contraction, each
    consuming a warm of its first weight tile when ``warm``."""
    h = {"x": mb.tensor(TILE, 3 * TILE), "w": mb.tensor(3 * TILE, 2 * TILE),
         "w8": mb.tensor(3 * TILE, 2 * TILE, fp8=True),
         "out": mb.tensor(TILE, 2 * TILE), "out8": mb.tensor(TILE, 2 * TILE)}
    if warm:
        mb.prefetch(h["w"].tile(0, 0))
    mb.gemm(h["out"], h["x"], h["w"], prefetch_first=warm)
    if warm:
        mb.prefetch(h["w8"].tile(0, 0), fp8=True)
    mb.gemm(h["out8"], h["x"], h["w8"], prefetch_first=warm)
    return h


def test_prefetch_warms_vs_jax_and_without_warms():
    rng = np.random.default_rng(11)
    vals = {"x": rng.standard_normal((TILE, 3 * TILE)).astype(np.float32),
            "w": (rng.standard_normal((3 * TILE, 2 * TILE)) * 0.1
                  ).astype(np.float32),
            "w8": (rng.standard_normal((3 * TILE, 2 * TILE)) * 0.1
                   ).astype(np.float32)}
    jmb = JBuilder()
    jh = _warm_build(jmb, True)
    jc = jmb.compile()
    jout = jc.run({jh[k]: jnp.asarray(v) for k, v in vals.items()},
                  outputs=[jh["out"], jh["out8"]])
    outs = {}
    for warm in (True, False):
        mb = MegaKernelBuilder()
        h = _warm_build(mb, warm)
        tc = mb.compile()
        types = tc.queue[:tc.num_exec, 0].tolist()
        if warm:
            np.testing.assert_array_equal(tc.queue, np.asarray(jc.queue))
            assert types.count(int(TaskType.PREFETCH)) == 1
            assert types.count(int(TaskType.PREFETCH_W8)) == 1
            wide = tc.queue[np.isin(types, [int(TaskType.GEMM_WIDE),
                                            int(TaskType.GEMM_WIDE_W8)])]
            assert wide[:, 8].tolist() == [1, 1]     # c0: consume the warm
        main, w8, _ = tc.split_feeds({h[k]: torch.from_numpy(v)
                                      for k, v in vals.items()})
        ws = tc.make_workspace(main, device="cpu")
        tc.step(ws, ws8=tc.make_workspace8(w8, device="cpu"))
        outs[warm] = [tc.gather_output(ws, h[k]) for k in ("out", "out8")]
    for got, want in zip(outs[True], jout):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for a, b in zip(outs[True], outs[False]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The MoE forms the JAX assembly builds beyond the matrix-layout linear one.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", ["paged_pools", "fp8_weights"])
def test_moe_forms_word_for_word(form):
    """MoE in the paged serving form (one slot: the JAX assembly's MoE
    router is single-block) and over e4m3 weight tiles:
    the port builds the JAX assembly's queue word for word, with the same
    workspace geometry (the e4m3 form keeps the expert stacks in the main
    workspace, as the JAX assembly allocates them)."""
    kw = dict(hidden=HIDDEN, hq_local=HQ, hkv_local=HKV, ffn_local=FFN,
              num_layers=2, max_seq=S, pos=S - 1, moe_experts=E,
              moe_topk=TOPK, inkernel_append=True)
    if form == "paged_pools":
        kw.update(batch=TILE, kv_pool_pages=3, table_pages=2,
                  mat_prefetch=True)
        jp = jbuild(num_ranks=1, paged=True, **kw)
    else:
        kw.update(fp8_weights=True, mat_prefetch=False)
        jp = jbuild(num_ranks=1, **kw)
    tp = build_decode_step(**kw)
    jc, tc = jp.mb.compile(), tp.mb.compile()
    np.testing.assert_array_equal(tc.queue, np.asarray(jc.queue))
    assert (tc.num_tiles, tc.num_tiles8, tc.num_mrows, tc.num_exec) == \
        (jc.num_tiles, jc.num_tiles8, jc.num_mrows, jc.num_exec)
    np.testing.assert_array_equal(tc.task_rows, jc.task_rows)
