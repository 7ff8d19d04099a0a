"""The port's megakernel on a TP group against the JAX package's: the
in-kernel AllReduce task types 4 (ALLREDUCE) and 22 (ALLREDUCE_ROW).

- the queues ``build_decode_step(num_ranks=n)`` + ``compile(num_ranks=n)``
  emit at n = 2 and 4 (the JAX builder's defaults and the decoder's
  flags), the MoE program at n = 2 and the ``force_ar`` program at n = 1,
  word for word against the JAX builder's; the barrier rows cover every
  hazard edge at n > 1;
- one decode step at ``tests/test_megakernel_decode.py::
  test_decode_step_tp8``'s shape (hidden 256, 8/8 heads, ffn 1024, S 128,
  pos 60, B 2, fp32) at n = 8 and 2: the port's plain multi-rank step on
  CPU rank threads against the JAX program under ``shard_map`` (Pallas
  interpret mode), atol = rtol = 1e-5 (the two frameworks' matmuls sum in
  different orders), the port's ranks bit-identical; the MoE program at
  n = 2 (``test_decode_step_moe_tp2_virtual_mesh``'s shape), the same
  tolerance and the same experts selected;
- ``Engine(backend="megakernel")`` on 2 and 4 ranks
  (``test_megakernel_serve_tp8_matches_ar``'s model) token for token
  against the JAX package's megakernel serve and the port's eager TP
  serve; ``weight_feeds`` / ``cache_feeds`` at rank r element for element
  against the JAX feeds, from the whole tree and from the rank's shard;
- types 4 and 22 alone on 2 and 4 CPU ranks against a numpy rank-order
  fp32 sum, bit for bit (and ``force_ar`` at one rank);
- a rank lost before its AllReduce: the group is spent, its epochs
  unmoved, and a new group runs a clean step;
- the refusals of ``MegakernelDecoder`` at n > 1, ``run_queue`` without
  the rank group, and mklint's ``decode_force_ar`` composition and its
  positional check of the AllReduce rows at n = 2.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as JP

from triton_distributed_tpu.megakernel.models import (
    broadcast_rows as jbroadcast, build_decode_step as jbuild,
    feed_layer_weights as jfeed_layer,
)
from triton_distributed_tpu.megakernel.serving import (
    cache_feeds as jcache_feeds, weight_feeds as jweight_feeds,
)
from triton_distributed_tpu.models.config import ModelConfig as JConfig
from triton_distributed_tpu.models.dense import init_dense_llm as jinit
from triton_distributed_tpu.models.engine import Engine as JEngine
from triton_distributed_tpu.models.kv_cache import init_kv_cache as jkv
from triton_distributed_tpu.runtime import shard_map_on
from triton_distributed_tpu.runtime.context import DistContext as JDistContext
from triton_distributed_tpu_torch.analysis import mklint
from triton_distributed_tpu_torch.megakernel import kernel as mk
from triton_distributed_tpu_torch.megakernel.builder import MegaKernelBuilder
from triton_distributed_tpu_torch.megakernel.models import (
    broadcast_rows, build_decode_step, feed_layer_weights, feed_moe_weights,
    rope_tables,
)
from triton_distributed_tpu_torch.megakernel.serving import (
    MegakernelDecoder, cache_feeds, weight_feeds,
)
from triton_distributed_tpu_torch.megakernel.tasks import (
    TILE, Task, TaskType,
)
from triton_distributed_tpu_torch.models.config import ModelConfig
from triton_distributed_tpu_torch.models.convert import (
    params_from_numpy, shard_params,
)
from triton_distributed_tpu_torch.models.engine import Engine
from triton_distributed_tpu_torch.models.kv_cache import init_kv_cache
from triton_distributed_tpu_torch.runtime.context import DistContext

TOL = dict(atol=1e-5, rtol=1e-5)
AR_TYPES = (int(TaskType.ALLREDUCE), int(TaskType.ALLREDUCE_ROW))
# test_decode_step_tp8's shape (global heads / ffn).
HIDDEN, HQ, HKV, FFN, S, POS, B = 256, 8, 8, 1024, 128, 60, 2
# test_decode_step_moe_tp2_virtual_mesh's.
MOE = dict(hidden=256, hq=2, hkv=1, S=256, pos=60, B=2, E=8, topk=2,
           ffn=256)
# test_megakernel_serve_tp8_matches_ar's model.
SERVE_CFG = dict(hidden_size=256, intermediate_size=1024, num_layers=1,
                 num_heads=8, num_kv_heads=8, head_dim=128, vocab_size=256,
                 qk_norm=True, dtype="float32")


def _dense_kw(n: int, **kw) -> dict:
    return dict(dict(hidden=HIDDEN, hq_local=HQ // n, hkv_local=HKV // n,
                     ffn_local=FFN // n, num_layers=1, max_seq=S, pos=POS),
                **kw)


def _moe_kw(n: int) -> dict:
    m = MOE
    return dict(hidden=m["hidden"], hq_local=m["hq"] // n,
                hkv_local=m["hkv"], ffn_local=m["ffn"] // n, num_layers=1,
                max_seq=m["S"], pos=m["pos"], moe_experts=m["E"],
                moe_topk=m["topk"], batch=m["B"])


def _jctx(n: int) -> JDistContext:
    return JDistContext(mesh=Mesh(np.array(jax.devices()[:n]), ("tp",)))


def _both(kw: dict, n: int, force_ar: bool = False):
    """(JAX compiled, port compiled) of one program."""
    jc = jbuild(num_ranks=n, force_ar_tasks=force_ar, **kw).mb.compile(
        num_ranks=n, axis="tp", force_ar=force_ar)
    tc = build_decode_step(num_ranks=n, force_ar_tasks=force_ar,
                           **kw).mb.compile(num_ranks=n, force_ar=force_ar)
    return jc, tc


PROGRAMS = {
    "dense_n2": (lambda: _dense_kw(2), 2, False),
    "dense_n4": (lambda: _dense_kw(4), 4, False),
    "decoder_n2": (lambda: _dense_kw(2, inkernel_append=True,
                                     mat_prefetch=True, final_norm=True,
                                     pos=S - 1), 2, False),
    "decoder_fp8_n4": (lambda: _dense_kw(4, inkernel_append=True,
                                         fp8_weights=True, pos=S - 1),
                       4, False),
    "moe_n2": (lambda: _moe_kw(2), 2, False),
    # test_force_ar_program_structure's shape.
    "force_ar_n1": (lambda: dict(hidden=256, hq_local=2, hkv_local=1,
                                 ffn_local=256, num_layers=2, max_seq=256,
                                 pos=100), 1, True),
}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_tp_queue_word_for_word(name):
    """Every word, the emission-to-row map, the type set, the hazard sets
    and edges, the AllReduce geometry and the workspace geometry of the
    JAX builder's program, at n > 1 and for the one-rank loopback."""
    make, n, force_ar = PROGRAMS[name]
    jc, tc = _both(make(), n, force_ar)
    np.testing.assert_array_equal(tc.queue, np.asarray(jc.queue))
    assert tc.num_exec == jc.num_exec
    assert tc.task_rows == jc.task_rows
    assert tc.used_types == jc.used_types
    for f in ("num_ranks", "max_ar", "force_ar", "num_tiles", "num_tiles8",
              "num_mrows", "_strip_pad", "hazard_edges", "task_reads",
              "task_writes"):
        assert getattr(tc, f) == getattr(jc, f), f
    assert [dataclasses.astuple(s) for s in tc.mat_specs] == \
        [(s.kt, s.ns, s.nt_out, s.kch, s.epi, s.warm) for s in jc.mat_specs]
    types = tc.queue[:tc.num_exec, 0]
    # Two reductions a layer, one ALLREDUCE_ROW each: hidden is one row.
    layers = make()["num_layers"]
    assert (types == int(TaskType.ALLREDUCE_ROW)).sum() == 2 * layers
    assert tc.max_ar == make()["hidden"] // TILE
    if force_ar:
        # The AR path replaces the GEMM epilogue fusion with ADD_NORM at
        # both sites of every layer but the last one's tail (plain ADD).
        assert (types == int(TaskType.ADD_NORM)).sum() == 2 * layers - 1
        assert (types == int(TaskType.ADD)).sum() == 1


@pytest.mark.parametrize("name", ["dense_n4", "decoder_n2", "moe_n2"])
def test_tp_barrier_rows_cover_hazards(name):
    """The CUDA interpreter's barrier flags at n > 1: every hazard edge has
    a barrier between its rows, so each AllReduce starts after the
    projection that stores its slab, and its readers after it. The CUDA
    AllReduce task holds no grid barrier of its own, so these carry it:
    checked for every AllReduce row by name — a barrier after each of its
    producers, one before its first reader, and one between it and the
    next AllReduce row (the two parity slot sets' reuse rests on it; the
    launcher's ``check_ar_barriers`` holds every queue to that)."""
    make, n, _ = PROGRAMS[name]
    _, tc = _both(make(), n)
    sync, rows = tc.sync_before, tc.task_rows
    assert len(sync) == tc.num_exec and sync[0] == 0
    for u, t in tc.hazard_edges:
        assert rows[u] < rows[t]
        assert sync[rows[u] + 1:rows[t] + 1].any(), (u, t)
    types = tc.queue[:tc.num_exec, 0]
    ar_rows = np.flatnonzero(np.isin(types, AR_TYPES))
    assert len(ar_rows)
    task_at = {row: t for t, row in enumerate(rows)}
    for a in ar_rows:
        t = task_at[a]
        ins = [rows[u] for u, d in tc.hazard_edges if d == t]
        outs = [rows[d] for u, d in tc.hazard_edges if u == t]
        assert ins and outs, f"AllReduce row {a}: no producer or reader"
        for p in ins:
            assert sync[p + 1:a + 1].any(), \
                f"AllReduce row {a}: no barrier after its producer {p}"
        assert sync[a + 1:min(outs) + 1].any(), \
            f"AllReduce row {a}: no barrier before its first reader"
    for a, b in zip(ar_rows, ar_rows[1:]):
        assert sync[a + 1:b + 1].any(), \
            f"AllReduce rows {a} and {b} share a barrier interval"
    mk.check_ar_barriers(tc.queue, tc.num_exec, sync)


# ---------------------------------------------------------------------------
# One decode step against the JAX program under shard_map.
# ---------------------------------------------------------------------------

def _rand_layer(rng, hidden, hq, hkv, ffn, pos):
    """test_megakernel_decode._rand_layer_weights' draws, in its order."""
    d = TILE
    cos, sin = rope_tables(pos, d, 1e6)
    return {
        "attn_norm": rng.standard_normal(hidden).astype(np.float32) * 0.1 + 1,
        "mlp_norm": rng.standard_normal(hidden).astype(np.float32) * 0.1 + 1,
        "q_norm": rng.standard_normal(d).astype(np.float32) * 0.1 + 1,
        "k_norm": rng.standard_normal(d).astype(np.float32) * 0.1 + 1,
        "wq": rng.standard_normal((hidden, hq * d)).astype(np.float32) * 0.05,
        "wk": rng.standard_normal((hidden, hkv * d)).astype(np.float32) * 0.05,
        "wv": rng.standard_normal((hidden, hkv * d)).astype(np.float32) * 0.05,
        "wo": rng.standard_normal((hq * d, hidden)).astype(np.float32) * 0.05,
        "w_gate": rng.standard_normal((hidden, ffn)).astype(np.float32) * 0.05,
        "w_up": rng.standard_normal((hidden, ffn)).astype(np.float32) * 0.05,
        "w_down": rng.standard_normal((ffn, hidden)).astype(np.float32) * 0.05,
        "cos": cos, "sin": sin}


def _layer_feeds(feed_fn, bcast, conv, h, w, kT, v, dense=True):
    feeds = {h.attn_norm: bcast(w["attn_norm"]),
             h.mlp_norm: bcast(w["mlp_norm"]),
             h.q_norm: bcast(w["q_norm"]), h.k_norm: bcast(w["k_norm"])}
    ffn = ({k: conv(w[k]) for k in ("w_gate", "w_up", "w_down")} if dense
           else {})
    feed_fn(feeds, h, wq=conv(w["wq"]), wk=conv(w["wk"]), wv=conv(w["wv"]),
            wo=conv(w["wo"]), **ffn)
    for i, (tk, tv) in enumerate(zip(h.kT, h.v)):
        feeds[tk] = conv(kT[i])
        feeds[tv] = conv(v[i])
    return {k: (tuple(conv(x) for x in val) if isinstance(val, tuple)
                else conv(val)) for k, val in feeds.items()}


def _rank_slices(w, kT, v, r, hq, hkv, ffn, moe=None):
    """Rank r's shard of the global weights (q/k/v/gate/up columns, o/down
    rows, kv heads), as the JAX test cuts it; ``moe``: the expert stacks
    cut on their ffn dim."""
    d = TILE
    wr = dict(w)
    wr["wq"] = w["wq"][:, r * hq * d:(r + 1) * hq * d]
    wr["wo"] = w["wo"][r * hq * d:(r + 1) * hq * d]
    if moe is None:
        wr["wk"] = w["wk"][:, r * hkv * d:(r + 1) * hkv * d]
        wr["wv"] = w["wv"][:, r * hkv * d:(r + 1) * hkv * d]
        wr["w_gate"] = w["w_gate"][:, r * ffn:(r + 1) * ffn]
        wr["w_up"] = w["w_up"][:, r * ffn:(r + 1) * ffn]
        wr["w_down"] = w["w_down"][r * ffn:(r + 1) * ffn]
        return wr, kT[r * hkv:(r + 1) * hkv], v[r * hkv:(r + 1) * hkv]
    return wr, kT, v


def _run_jax(jc, jprog, n, rank_feeds, outputs, jctx):
    """The JAX program under shard_map: each device's feeds are rank r's;
    returns (n, ...) stacked outputs."""
    keys = list(rank_feeds[0])
    flat = []
    for k in keys:
        vals = [rank_feeds[r][k] for r in range(n)]
        if isinstance(vals[0], tuple):
            flat.append(tuple(jnp.asarray(np.stack([np.asarray(v[i])
                                                    for v in vals]))
                              for i in range(len(vals[0]))))
        else:
            flat.append(jnp.asarray(np.stack([np.asarray(v) for v in vals])))

    def local(*per_rank):
        feeds = {k: (tuple(x[0] for x in v) if isinstance(v, tuple)
                     else v[0]) for k, v in zip(keys, per_rank)}
        outs = jc.run(feeds, outputs=outputs)
        return tuple(o[None] for o in outs)

    specs = tuple((JP("tp"), JP("tp")) if isinstance(f, tuple) else JP("tp")
                  for f in flat)
    fn = shard_map_on(jctx, local, specs,
                      tuple(JP("tp") for _ in outputs))
    return [np.asarray(o) for o in fn(*flat)]


def _run_port(tc, n, rank_feeds, outputs, live_rows):
    """The port's program on n CPU rank threads: each rank's workspaces
    from its feeds, one step; returns per output the ranks' tensors."""
    ctx = DistContext([torch.device("cpu")] * n, wait_timeout_ms=60_000)
    wss, wsms = [], []
    for r in range(n):
        main, _, wm = tc.split_feeds(rank_feeds[r])
        wss.append(tc.make_workspace(main, device="cpu"))
        wsms.append(tc.make_workspace_mat(wm, device="cpu")
                    if tc.num_mrows else None)
    ctx.run(lambda r: tc.step(wss[r], wsm=wsms[r], live_rows=live_rows))
    ctx.close()
    return [[tc.gather_output(ws, h) for ws in wss] for h in outputs], wss


def _step_case(n, rng):
    hq, hkv, ffn = HQ // n, HKV // n, FFN // n
    w = _rand_layer(rng, HIDDEN, HQ, HKV, FFN, POS)
    kT = [rng.standard_normal((TILE, S)).astype(np.float32) * 0.3
          for _ in range(HKV)]
    v = [rng.standard_normal((S, TILE)).astype(np.float32) * 0.3
         for _ in range(HKV)]
    x = np.zeros((TILE, HIDDEN), np.float32)
    x[:B] = rng.standard_normal((B, HIDDEN)).astype(np.float32) * 0.3
    return w, kT, v, x, (hq, hkv, ffn)


@pytest.mark.parametrize("n", [8, 2])
def test_decode_step_tp_vs_jax(n, ctx):
    """test_decode_step_tp8's step at n ranks: the port's plain multi-rank
    step (its AllReduce rows meeting through the CPU rank threads) equals
    the JAX program's under shard_map, and every rank's rows are
    bit-identical."""
    jprog = jbuild(num_ranks=n, **_dense_kw(n))
    jc = jprog.mb.compile(num_ranks=n, axis="tp")
    tprog = build_decode_step(num_ranks=n, **_dense_kw(n))
    tc = tprog.mb.compile(num_ranks=n)
    w, kT, v, x, (hq, hkv, ffn) = _step_case(n, np.random.default_rng(1))

    def feeds(prog, feed_fn, bcast, conv, r):
        wr, kr, vr = _rank_slices(w, kT, v, r, hq, hkv, ffn)
        f = _layer_feeds(feed_fn, bcast, conv, prog.layers[0], wr, kr, vr)
        f.update({prog.x: conv(x), prog.cos: conv(w["cos"]),
                  prog.sin: conv(w["sin"])})
        return f

    jfeeds = [feeds(jprog, jfeed_layer, jbroadcast, np.asarray, r)
              for r in range(n)]
    tfeeds = [feeds(tprog, feed_layer_weights, broadcast_rows,
                    torch.as_tensor, r) for r in range(n)]
    jctx = ctx if n == 8 else _jctx(n)
    (want,) = _run_jax(jc, jprog, n, jfeeds, [jprog.x_out], jctx)
    (got,), _ = _run_port(tc, n, tfeeds, [tprog.x_out], TILE)
    for r in range(n):
        np.testing.assert_allclose(got[r][:B].numpy(), want[r][:B], **TOL)
        assert torch.equal(got[r], got[0])


def test_moe_step_tp2_vs_jax():
    """test_decode_step_moe_tp2_virtual_mesh's program at n = 2 (q heads
    and expert ffn sharded, the combine reduced by ALLREDUCE_ROW): the
    port's step equals the JAX program's, the ranks' rows bit-identical,
    and MOE_TOPK selects the same experts."""
    m, n = MOE, 2
    jprog = jbuild(num_ranks=n, **_moe_kw(n))
    jc = jprog.mb.compile(num_ranks=n, axis="tp")
    tprog = build_decode_step(num_ranks=n, **_moe_kw(n))
    tc = tprog.mb.compile(num_ranks=n)
    rng = np.random.default_rng(4)
    w = _rand_layer(rng, m["hidden"], m["hq"], m["hkv"], m["ffn"], m["pos"])
    router = rng.standard_normal((m["hidden"], m["E"])).astype(
        np.float32) * 0.2
    E, hdn, f = m["E"], m["hidden"], m["ffn"] // n
    wg = rng.standard_normal((E, hdn, m["ffn"])).astype(np.float32) * 0.05
    wu = rng.standard_normal((E, hdn, m["ffn"])).astype(np.float32) * 0.05
    wd = rng.standard_normal((E, m["ffn"], hdn)).astype(np.float32) * 0.05
    kT = [rng.standard_normal((TILE, m["S"])).astype(np.float32) * 0.3]
    v = [rng.standard_normal((m["S"], TILE)).astype(np.float32) * 0.3]
    x = np.zeros((TILE, hdn), np.float32)
    x[:m["B"]] = rng.standard_normal((m["B"], hdn)).astype(np.float32) * 0.3
    topk_rows = np.flatnonzero(tc.queue[:tc.num_exec, 0]
                               == int(TaskType.MOE_TOPK))
    wt = int(tc.queue[topk_rows[0], 1])

    def feeds(prog, feed_fn, bcast, conv, moe_fn, r):
        h = prog.layers[0]
        wr, kr, vr = _rank_slices(w, kT, v, r, m["hq"] // n, 1, f, moe=True)
        fd = _layer_feeds(feed_fn, bcast, conv, h, wr, kr, vr, dense=False)
        fd.update({prog.x: conv(x), prog.cos: conv(w["cos"]),
                   prog.sin: conv(w["sin"])})
        cut = slice(r * f, (r + 1) * f)
        moe = dict(router=conv(router), w_gate=conv(wg[:, :, cut]),
                   w_up=conv(wu[:, :, cut]), w_down=conv(wd[:, cut]))
        if moe_fn is None:       # the JAX test's feeding, by hand
            fd[h.moe_router] = np.pad(router, ((0, 0), (0, TILE - E)))
            fd[h.moe_w_gate] = moe["w_gate"].reshape(E * hdn, f)
            fd[h.moe_w_up] = moe["w_up"].reshape(E * hdn, f)
            fd[h.moe_w_down] = moe["w_down"].reshape(E * f, hdn)
        else:
            moe_fn(fd, h, **moe)
        return fd

    jfeeds = [feeds(jprog, jfeed_layer, jbroadcast, np.asarray, None, r)
              for r in range(n)]
    tfeeds = [feeds(tprog, feed_layer_weights, broadcast_rows,
                    torch.as_tensor, feed_moe_weights, r) for r in range(n)]
    from triton_distributed_tpu.megakernel.tasks import TensorHandle as JT

    want_out, want_wt = _run_jax(jc, jprog, n, jfeeds,
                                 [jprog.x_out, JT(wt, TILE, TILE)], _jctx(n))
    (got_out, _), wss = _run_port(tc, n, tfeeds, [tprog.x_out, tprog.x_out],
                                  TILE)
    for r in range(n):
        np.testing.assert_allclose(got_out[r][:m["B"]].numpy(),
                                   want_out[r][:m["B"]], **TOL)
        assert torch.equal(got_out[r], got_out[0])
        sel = wss[r][wt][:E, :m["B"]].numpy() > 0
        np.testing.assert_array_equal(sel, want_wt[r][:E, :m["B"]] > 0)
        assert (sel.sum(0) == m["topk"]).all()


# ---------------------------------------------------------------------------
# The decoder and the engine.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def serve_model():
    jcfg = JConfig(**SERVE_CFG)
    jparams = jinit(jax.random.PRNGKey(1), jcfg)
    tcfg = ModelConfig(**SERVE_CFG)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


def _key(h):
    return (type(h).__name__, h.base)


def _feeds_equal(got: dict, want: dict) -> None:
    g = {_key(h): val for h, val in got.items()}
    w = {_key(h): val for h, val in want.items()}
    assert sorted(g) == sorted(w)
    for k, val in w.items():
        if isinstance(val, tuple):
            for a, b in zip(g[k], val):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        else:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(val))


@pytest.mark.parametrize("n", [2, 4])
def test_weight_and_cache_feeds_per_rank_vs_jax(serve_model, n):
    """``weight_feeds`` / ``cache_feeds`` at rank r: element for element the
    JAX feeds of rank r, from the whole tree and cache and from the rank's
    own shard (the TP engine's ``rank_params`` and prefilled caches)."""
    jcfg, jparams, tcfg, tparams = serve_model
    kw = dict(hidden=256, hq_local=8 // n, hkv_local=8 // n,
              ffn_local=1024 // n, num_layers=1, max_seq=128, pos=127,
              inkernel_append=True, mat_prefetch=True, num_ranks=n)
    jprog, tprog = jbuild(**kw), build_decode_step(**kw)
    tctx = DistContext([torch.device("cpu")] * n)
    shards = shard_params(tparams, tctx, tcfg)
    rng = np.random.default_rng(3)
    k = rng.standard_normal((1, 1, 128, 8, 128)).astype(np.float32)
    v = rng.standard_normal((1, 1, 128, 8, 128)).astype(np.float32)
    jc = jkv(jcfg, 1, 128, dtype=jnp.float32)._replace(
        k=jnp.asarray(k), v=jnp.asarray(v))
    tc = init_kv_cache(tcfg, 1, 128, device="cpu")._replace(
        k=torch.from_numpy(k), v=torch.from_numpy(v))
    hl = 8 // n
    for r in range(n):
        want = jweight_feeds(jprog, jcfg, jparams, rank=r, num_ranks=n)
        _feeds_equal(weight_feeds(tprog, tcfg, tparams, rank=r,
                                  num_ranks=n), want)
        _feeds_equal(weight_feeds(tprog, tcfg, shards[r], rank=r,
                                  num_ranks=n, sharded=True), want)
        want = jcache_feeds(jprog, jc, rank=r, num_ranks=n)
        _feeds_equal(cache_feeds(tprog, tc, rank=r, num_ranks=n), want)
        own = tc._replace(k=tc.k[:, :, :, r * hl:(r + 1) * hl],
                          v=tc.v[:, :, :, r * hl:(r + 1) * hl])
        _feeds_equal(cache_feeds(tprog, own, rank=r, num_ranks=n,
                                 sharded=True), want)
    tctx.close()


@pytest.mark.parametrize("n", [2, 4])
def test_engine_serve_megakernel_tp_vs_jax(serve_model, n):
    """``Engine(backend="megakernel")`` on n ranks: the JAX package's
    megakernel serve's tokens = the port's = the port's eager TP serve's
    (``backend="auto"``); the port's megakernel decoder runs one launch a
    rank a step, and its ranks' final rows are bit-identical."""
    jcfg, jparams, tcfg, tparams = serve_model
    ids = np.array([[7, 101, 33, 5, 250, 17, 64, 3, 99, 12, 40, 200, 1, 77,
                     150, 8]], np.int32)
    gen = 4
    want = np.asarray(JEngine(jcfg, jparams, _jctx(n), backend="megakernel",
                              max_seq=128).serve(jnp.asarray(ids),
                                                 gen_len=gen))
    tctx = DistContext([torch.device("cpu")] * n, wait_timeout_ms=60_000)
    eng = Engine(tcfg, tparams, tctx, backend="megakernel", max_seq=128)
    before = mk.MEGA_KERNEL.plain_calls
    got = eng.serve(torch.from_numpy(ids), gen)
    assert mk.MEGA_KERNEL.plain_calls - before == n * (gen - 1)
    eager = Engine(tcfg, tparams, tctx, max_seq=128).serve(
        torch.from_numpy(ids), gen)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(eager.numpy(), want)
    dec = eng._mk
    assert dec.n == n and dec.comp.num_ranks == n
    logits, caches = eng.prefill(torch.from_numpy(ids))
    ws = dec.start(caches)
    ws, tok = dec.step(ws, logits.argmax(-1).to(torch.int32),
                       int(caches[0].offset))
    rows = dec.rank_rows(ws)
    assert all(torch.equal(rows[0], x) for x in rows[1:])
    assert int(tok[0]) == int(want[0, 1])
    tctx.close()


# ---------------------------------------------------------------------------
# Types 4 and 22 alone.
# ---------------------------------------------------------------------------

def _ar_program(dtype, n, force_ar=False):
    mb = MegaKernelBuilder()
    mb.all_reduce(mb.tensor(TILE, 3 * TILE))
    t = mb.tensor(TILE, TILE).tile(0, 0)
    mb._emit(Task(TaskType.ALLREDUCE, t), [t], [t])
    return mb.compile(dtype=dtype, num_ranks=n, force_ar=force_ar)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_allreduce_types_alone_vs_numpy(n, dtype):
    """A hand-built program of ALLREDUCE_ROW (3 tiles) and ALLREDUCE (one
    tile) on n CPU ranks, each rank's tiles drawn from a seed: every rank
    ends with the numpy rank-order fp32 sum rounded once, bit for bit (at
    n = 1 with ``force_ar``: the rank's own tiles)."""
    comp = _ar_program(dtype, n, force_ar=n == 1)
    assert comp.max_ar == 3
    rng = np.random.default_rng(10 + n)
    X = rng.standard_normal((n, comp.num_tiles, TILE, TILE)).astype(
        np.float32)
    xs = [torch.from_numpy(x).to(dtype) for x in X]
    acc = np.zeros_like(X[0])
    for x in xs:
        acc = acc + x.float().numpy()
    want = torch.from_numpy(acc).to(dtype)
    ctx = DistContext([torch.device("cpu")] * n, wait_timeout_ms=60_000)
    ws = [x.clone() for x in xs]
    ctx.run(lambda r: comp.step(ws[r], ar_tag="alone"))
    ctx.close()
    for w in ws:
        assert torch.equal(w, want)
    if n == 1:
        assert torch.equal(ws[0], xs[0])


def test_failed_meeting_spends_the_group_and_a_new_one_runs_clean():
    """A rank that fails before its AllReduce meets its peer: the step
    raises, the group refuses every later run (RankGroupError, not a wait
    on flags its peers will never set), and a step on a new group is the
    rank-order sum. At the meeting a launch's arguments, the epochs among
    them, are made only once every rank has arrived: the failed meeting
    moved no rank's epoch counter."""
    from triton_distributed_tpu_torch.ops import _comm
    from triton_distributed_tpu_torch.runtime.context import RankGroupError

    comp = _ar_program(torch.float32, 2)
    xs = [torch.full((comp.num_tiles, TILE, TILE), float(r + 1))
          for r in range(2)]

    def step(lost):
        def body(r):
            if r == lost:
                raise RuntimeError("rank lost before its launch")
            comp.step(ws[r], ar_tag="lost")
        return body

    ctx = DistContext([torch.device("cpu")] * 2, wait_timeout_ms=60_000)
    ws = [x.clone() for x in xs]
    with pytest.raises(RuntimeError, match="rank lost"):
        ctx.run(step(1))
    with pytest.raises(RankGroupError):
        ctx.run(step(None))
    ctx.close()
    ctx = DistContext([torch.device("cpu")] * 2, wait_timeout_ms=60_000)
    ws = [x.clone() for x in xs]
    ctx.run(step(None))
    ctx.close()
    for w in ws:
        assert torch.equal(w, torch.full_like(w, 3.0))

    class Kernel:
        launched: list = []

        def library(self):
            pass

        def launch(self, *args, variants=()):
            self.launched.append(args)

    ctx = DistContext([torch.device("cpu")] * 2, wait_timeout_ms=60_000)
    slots = mk.ar_slots(ctx, 2, 1, torch.float32, "meeting")
    groups = [mk.ArGroup(ctx, r, 2, slots, sites=3) for r in range(2)]
    kernel = Kernel()

    def meet(lost):
        def body(r):
            if r == lost:
                raise RuntimeError("rank lost before the meeting")
            _comm._launch_at_meeting(
                kernel, slots, r, ctx.devices[r], "megakernel.launch",
                lambda: (r, groups[r].next_epochs()))
        return body

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
        with pytest.raises(RuntimeError, match="before the meeting"):
            ctx.run(meet(1))
        assert slots.epochs == [0, 0] and kernel.launched == []
        ctx.close()
        ctx = DistContext([torch.device("cpu")] * 2, wait_timeout_ms=60_000)
        slots = mk.ar_slots(ctx, 2, 1, torch.float32, "meeting")
        groups = [mk.ArGroup(ctx, r, 2, slots, sites=3) for r in range(2)]
        ctx.run(meet(None))
        ctx.run(meet(None))
    ctx.close()
    assert kernel.launched == [(0, 1), (1, 1), (0, 4), (1, 4)]
    assert slots.epochs == [6, 6]


def test_allreduce_does_nothing_at_one_rank_without_force_ar():
    comp = _ar_program(torch.float32, 1)
    x = torch.randn((comp.num_tiles, TILE, TILE),
                    generator=torch.Generator().manual_seed(0))
    assert torch.equal(comp.step(x.clone()), x)


# ---------------------------------------------------------------------------
# Refusals, mklint.
# ---------------------------------------------------------------------------

def test_tp_megakernel_refusals(serve_model):
    """``MegakernelDecoder`` at n > 1 refuses as the reference's does; a
    multi-rank program's ``run_queue`` outside the rank runner raises;
    the TP engine keeps the one-rank refusal of a page size."""
    _, _, tcfg, tparams = serve_model
    ctx2 = DistContext([torch.device("cpu")] * 2)
    with pytest.raises(ValueError, match="profile"):
        MegakernelDecoder(tcfg, tparams, max_seq=128, ctx=ctx2, num_ranks=2,
                          profile=True)
    for kw, n in ((dict(num_heads=6, num_kv_heads=2), 4),
                  (dict(num_kv_heads=2), 4),
                  (dict(num_heads=6, num_kv_heads=3,
                        intermediate_size=256), 3)):
        with pytest.raises(ValueError, match="not divisible by TP degree"):
            MegakernelDecoder(dataclasses.replace(tcfg, **kw), tparams,
                              max_seq=128, num_ranks=n)
    with pytest.raises(ValueError, match="TILE multiple"):
        MegakernelDecoder(dataclasses.replace(tcfg, intermediate_size=640),
                          tparams, max_seq=128, ctx=ctx2, num_ranks=2)
    with pytest.raises(ValueError, match="requires ctx"):
        MegakernelDecoder(tcfg, tparams, max_seq=128, num_ranks=2)
    sp = DistContext([torch.device("cpu")] * 2, tp_axis="sp")
    with pytest.raises(ValueError, match="one-axis group"):
        MegakernelDecoder(tcfg, tparams, max_seq=128, ctx=sp, num_ranks=2)
    with pytest.raises(ValueError, match="one-axis group"):
        MegakernelDecoder(tcfg, tparams, max_seq=128, ctx=ctx2, num_ranks=4)
    comp = _ar_program(torch.float32, 2)
    with pytest.raises(ValueError, match="rank group's runner"):
        comp.step(torch.zeros((comp.num_tiles, TILE, TILE)))
    with pytest.raises(mk.MegakernelUnsupportedError, match="page_size"):
        Engine(tcfg, tparams, ctx2, backend="megakernel", max_seq=128,
               page_size=16).serve(torch.tensor([[1, 2, 3]]), 2)
    ctx2.close()


def test_mklint_force_ar_and_ar_order():
    """``decode_force_ar`` lints clean; an n = 2 program whose AllReduce
    rows trade places is flagged by the positional check (``ar-order``:
    every rank must dispatch them in emission order)."""
    rep = mklint.COMPOSITIONS["decode_force_ar"]()
    assert rep.ok and rep.n_tasks > 0
    make, n, _ = PROGRAMS["dense_n2"]
    _, tc = _both(make(), n)
    assert mklint.check_compiled(tc, name="tp2").ok
    ar = [t for t in range(tc.num_exec)
          if tc.queue[tc.task_rows[t], 0] in AR_TYPES]
    a, b = ar[0], ar[1]
    rows = list(tc.task_rows)
    rows[a], rows[b] = rows[b], rows[a]
    q = tc.queue.copy()
    q[[rows[a], rows[b]]] = q[[rows[b], rows[a]]]
    bad = dataclasses.replace(tc, queue=q, task_rows=tuple(rows))
    kinds = {v.kind for v in mklint.check_compiled(bad, name="tp2").violations}
    assert "ar-order" in kinds
