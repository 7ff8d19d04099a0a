"""Port's MoE megakernel program vs the JAX package's: the compiled queues
(the JAX MoE test's host-fed batch-4 form, the batch-1 in-kernel-append
form, and both at Qwen3-30B-A3B widths cut to 2 layers) word for word,
their workspaces element for element, one ``run_queue_plain`` step against
the JAX kernel in interpret mode and against the numpy golden of
``tests/test_megakernel_decode.py::test_decode_step_moe_single_device``,
the MOE_TOPK / MOE_FFN handlers alone on their edge cases (a padded row, an
expert no row selects, tied logits, top-k = E), the barrier flags, and the
refusals.

Shapes: hidden 256, 2/1 heads of 128, 8 experts, top-2, expert ffn 128,
max_seq 256, 1 layer. Tolerances: fp32 atol = rtol = 1e-5 (summation order
only); bf16 workspaces atol 4e-3, rtol 1.6e-2 (two bf16 units: a store may
round one unit apart); the numpy golden 2e-3, the JAX test's. Selections
(which experts carry weight) must be identical.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from triton_distributed_tpu.megakernel.builder import (
    MegaKernelBuilder as JBuilder,
)
from triton_distributed_tpu.megakernel.models import (
    advance_queue_pos as jadvance, build_decode_step as jbuild,
)
from triton_distributed_tpu_torch.megakernel import kernel as mk
from triton_distributed_tpu_torch.megakernel.builder import (
    MegaKernelBuilder,
)
from triton_distributed_tpu_torch.megakernel.kernel import (
    MAX_LIVE_ROWS, MEGA_KERNEL, PORTED_TYPES, MegakernelUnsupportedError,
)
from triton_distributed_tpu_torch.megakernel.models import (
    advance_queue_pos, broadcast_rows, build_decode_step, feed_moe_weights,
    rope_tables,
)
from triton_distributed_tpu_torch.megakernel.tasks import TILE, TaskType

HIDDEN, HQ, HKV, S, E, TOPK, FFN = 256, 2, 1, 256, 8, 2, 128
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=1.6e-2, atol=4e-3)}
MOE_TYPES = {int(TaskType.MOE_TOPK), int(TaskType.MOE_FFN)}

# (build_decode_step kwargs, the JAX-only flags): the JAX MoE test's form
# (host-fed caches, batch 4, no warms) and the batch-1 in-kernel-append
# form the linear decoder builds.
TINY = dict(hidden=HIDDEN, hq_local=HQ, hkv_local=HKV, ffn_local=FFN,
            num_layers=1, max_seq=S, moe_experts=E, moe_topk=TOPK)
QWEN_2L = dict(hidden=2048, hq_local=32, hkv_local=4, ffn_local=768,
               num_layers=2, max_seq=2048, moe_experts=128, moe_topk=8)
FORMS = {
    "host_fed_b4": dict(batch=4, pos=100, inkernel_append=False,
                        mat_prefetch=False),
    "inkernel_b1": dict(batch=1, pos=S - 1, inkernel_append=True,
                        mat_prefetch=True),
}


def _both(shape, form):
    """(JAX program, port program) of one shape and form."""
    kw = dict(shape, **FORMS[form])
    if form == "inkernel_b1":
        kw["pos"] = kw["max_seq"] - 1
    return jbuild(num_ranks=1, **kw), build_decode_step(**kw)


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("shape", ["tiny", "qwen3_30b_a3b_2layers"])
def test_moe_queue_word_for_word(shape, form):
    """The port's builder emits the JAX builder's MoE program: every word,
    the emission-to-row map, the type set, the hazard sets and edges, and
    the geometry the workspaces are sized from (the MoE strip pad
    included); MOE_FFN always starts after a grid barrier."""
    jp, tp = _both(TINY if shape == "tiny" else QWEN_2L, form)
    jc, tc = jp.mb.compile(), tp.mb.compile()
    np.testing.assert_array_equal(tc.queue, np.asarray(jc.queue))
    assert tc.num_exec == jc.num_exec == len(tc.queue)
    assert tc.task_rows == jc.task_rows
    assert tc.used_types == jc.used_types
    assert MOE_TYPES <= set(tc.used_types)
    assert set(tc.used_types) <= {int(t) for t in PORTED_TYPES}
    for f in ("num_tiles", "num_mrows", "max_gqa", "max_gemm_width",
              "max_row", "max_strip", "max_moe_h", "max_moe_f",
              "_strip_pad", "head_dim", "hazard_edges", "task_reads",
              "task_writes"):
        assert getattr(tc, f) == getattr(jc, f), f
    assert [dataclasses.astuple(s) for s in tc.mat_specs] == \
        [(s.kt, s.ns, s.nt_out, s.kch, s.epi, s.warm) for s in jc.mat_specs]
    types = tc.queue[:tc.num_exec, 0]
    appends = (types == int(TaskType.APPEND_KV)).sum()
    assert appends == (tp.layers[0].kT.__len__() * len(tp.layers)
                       if form == "inkernel_b1" else 0)
    sync, rows = tc.sync_before, tc.task_rows
    assert sync[types == int(TaskType.MOE_FFN)].all()
    for u, t in tc.hazard_edges:
        assert rows[u] < rows[t] and sync[rows[u] + 1:rows[t] + 1].any()
    topk = tc.queue[types == int(TaskType.MOE_TOPK)]
    assert (topk[:, 9] == FORMS[form]["batch"]).all()
    # The MoE types run in their own full instantiation.
    assert mk._full_kernel(tc.queue, tc.num_exec)
    assert mk._kernel_body(tc.queue, tc.num_exec) == 2
    # The launch's fp32 scratch holds every expert's activations.
    for live in (1, 4):
        need = (int(topk[0, 6]) * live * tp.layers[0].moe_w_gate.cols)
        assert mk._scratch_floats(tc.queue, tc.num_exec, tc.mat_specs,
                                  live) >= need


def test_moe_advance_queue_pos_word_for_word():
    """The in-kernel-append form retargets per position as the JAX
    function does (attention words and appends; MoE rows untouched)."""
    jp, tp = _both(TINY, "inkernel_b1")
    jc, tc = jp.mb.compile(), tp.mb.compile()
    for pos in (0, 1, 127, S - 1):
        got = advance_queue_pos(tc, pos)
        np.testing.assert_array_equal(got, np.asarray(jadvance(jc, pos)))
        moe = np.isin(got[:, 0], list(MOE_TYPES))
        np.testing.assert_array_equal(got[moe], tc.queue[moe])


# ---------------------------------------------------------------------------
# Workspaces and one step against the JAX kernel (interpret mode).
# ---------------------------------------------------------------------------

def _layer_values(rng, pos):
    """The JAX MoE test's values: attention weights, norms, router,
    expert stacks, caches and a batch of 4 input rows (fp32 numpy)."""
    d = TILE
    w = {
        "attn_norm": rng.standard_normal(HIDDEN) * 0.1 + 1,
        "mlp_norm": rng.standard_normal(HIDDEN) * 0.1 + 1,
        "q_norm": rng.standard_normal(d) * 0.1 + 1,
        "k_norm": rng.standard_normal(d) * 0.1 + 1,
        "wq": rng.standard_normal((HIDDEN, HQ * d)) * 0.05,
        "wk": rng.standard_normal((HIDDEN, HKV * d)) * 0.05,
        "wv": rng.standard_normal((HIDDEN, HKV * d)) * 0.05,
        "wo": rng.standard_normal((HQ * d, HIDDEN)) * 0.05,
        "router": rng.standard_normal((HIDDEN, E)) * 0.2,
        "w_gate": rng.standard_normal((E, HIDDEN, FFN)) * 0.05,
        "w_up": rng.standard_normal((E, HIDDEN, FFN)) * 0.05,
        "w_down": rng.standard_normal((E, FFN, HIDDEN)) * 0.05,
        "kT": rng.standard_normal((TILE, S)) * 0.3,
        "v": rng.standard_normal((S, TILE)) * 0.3,
    }
    w = {k: np.asarray(v, np.float32) for k, v in w.items()}
    x = np.zeros((TILE, HIDDEN), np.float32)
    x[:4] = rng.standard_normal((4, HIDDEN)) * 0.3
    w["x"] = x
    w["cos"], w["sin"] = rope_tables(pos, d, 1e6)
    return w


def _feeds(prog, w, moe_feed):
    """Handle → value feeds of one program (either package's handles)."""
    h = prog.layers[0]
    feeds = {prog.x: w["x"], prog.cos: w["cos"], prog.sin: w["sin"],
             h.attn_norm: broadcast_rows(w["attn_norm"]),
             h.mlp_norm: broadcast_rows(w["mlp_norm"]),
             h.q_norm: broadcast_rows(w["q_norm"]),
             h.k_norm: broadcast_rows(w["k_norm"]),
             h.kT[0]: w["kT"], h.v[0]: w["v"]}
    feeds[h.wqkv] = np.concatenate([w["wq"], w["wk"], w["wv"]], axis=1)
    feeds[h.wo] = w["wo"]
    moe_feed(feeds, h)
    return feeds


def _jax_moe_feed(w):
    def feed(feeds, h):
        feeds[h.moe_router] = np.pad(w["router"], ((0, 0), (0, TILE - E)))
        feeds[h.moe_w_gate] = w["w_gate"].reshape(E * HIDDEN, FFN)
        feeds[h.moe_w_up] = w["w_up"].reshape(E * HIDDEN, FFN)
        feeds[h.moe_w_down] = w["w_down"].reshape(E * FFN, HIDDEN)
    return feed


def _port_moe_feed(w):
    def feed(feeds, h):
        feed_moe_weights(feeds, h, **{k: torch.from_numpy(w[k]) for k in
                                      ("router", "w_gate", "w_up",
                                       "w_down")})
    return feed


def _port_workspaces(tc, prog, w, dtype=torch.float32):
    feeds = {k: torch.as_tensor(v) for k, v in
             _feeds(prog, w, _port_moe_feed(w)).items()}
    main, _, wm = tc.split_feeds(feeds)
    return (tc.make_workspace(main, device="cpu"),
            tc.make_workspace_mat(wm, device="cpu"))


@pytest.fixture(scope="module")
def moe_runs():
    """Each form built by both packages, its workspaces, and ONE JAX step
    in interpret mode: {form: (port prog, port compiled, values, JAX
    compiled, JAX ws, JAX wsm, JAX output x_out (TILE, hidden), the JAX
    step's final workspace)}."""
    out = {}
    for form in sorted(FORMS):
        pos = FORMS[form]["pos"]
        w = _layer_values(np.random.default_rng(3), pos)
        jp, tp = _both(TINY, form)
        jc, tc = jp.mb.compile(), tp.mb.compile()
        main, _, wm = jc.split_feeds(
            {h: jnp.asarray(v) for h, v in
             _feeds(jp, w, _jax_moe_feed(w)).items()})
        jws, jwsm = jc.make_workspace(main), jc.make_workspace_mat(wm)
        jws_out = jc.step(jws, wsm=jwsm)
        out[form] = (tp, tc, w, jc, np.asarray(jws), np.asarray(jwsm),
                     np.asarray(jc.gather_output(jws_out, jp.x_out)),
                     np.asarray(jws_out))
    return out


@pytest.mark.parametrize("form", sorted(FORMS))
def test_moe_workspace_element_for_element(moe_runs, form):
    """The same feeds give the JAX builder's main and matrix workspaces,
    every element (router padding and expert stacking included)."""
    tp, tc, w, _, jws, jwsm, _, _ = moe_runs[form]
    ws, wsm = _port_workspaces(tc, tp, w)
    assert tuple(ws.shape) == jws.shape and tuple(wsm.shape) == jwsm.shape
    np.testing.assert_array_equal(ws.numpy(), jws)
    np.testing.assert_array_equal(wsm.numpy(), jwsm)


def _golden(w, pos, batch=4, eps=1e-6):
    """numpy golden of the layer: attention over cache[:pos] + the current
    token, then the MoE FFN with the fp32 router (top-k, softmax over the
    selected, expert SwiGLU) — ``tests/test_megakernel_decode.py``."""
    d = TILE
    x = w["x"][:batch].astype(np.float64)

    def rms(a, g):
        return (a / np.sqrt((a ** 2).mean(-1, keepdims=True) + eps)) * g

    def rope(a):
        c, s = w["cos"][0, :d // 2], w["sin"][0, :d // 2]
        a1, a2 = a[:, :d // 2], a[:, d // 2:]
        return np.concatenate([a1 * c - a2 * s, a2 * c + a1 * s], axis=1)

    xn = rms(x, w["attn_norm"])
    q, k_new, v_new = xn @ w["wq"], xn @ w["wk"], xn @ w["wv"]
    attn = np.zeros_like(q)
    kj = rope(rms(k_new, w["k_norm"]))
    for j in range(HQ):
        qj = rope(rms(q[:, j * d:(j + 1) * d], w["q_norm"]))
        s = np.concatenate([(qj @ w["kT"][:, :pos]) * d ** -0.5,
                            (qj * kj).sum(-1, keepdims=True) * d ** -0.5], 1)
        p = np.exp(s - s.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        attn[:, j * d:(j + 1) * d] = p[:, :pos] @ w["v"][:pos] \
            + p[:, pos:] * v_new
    x1 = x + attn @ w["wo"]
    x1n = rms(x1, w["mlp_norm"])
    logits = x1n @ w["router"]
    ffn = np.zeros_like(x1)
    for t in range(batch):
        order = np.argsort(-logits[t], kind="stable")[:TOPK]
        sel = np.exp(logits[t, order] - logits[t, order].max())
        sel /= sel.sum()
        for wt, e in zip(sel, order):
            g = x1n[t] @ w["w_gate"][e]
            act = g / (1 + np.exp(-g)) * (x1n[t] @ w["w_up"][e])
            ffn[t] += wt * (act @ w["w_down"][e])
    return x1 + ffn


@pytest.mark.parametrize("form", sorted(FORMS))
def test_moe_step_vs_jax_interpret_and_golden(moe_runs, form):
    """One ``run_queue_plain`` step from the same workspaces: every tile
    against the JAX kernel's step (fp32 1e-5 — activations, the routing
    weight tile with the same selection, the appended caches), the output
    rows against the numpy golden (2e-3)."""
    tp, tc, w, _, _, _, jout, jws_out = moe_runs[form]
    ws, wsm = _port_workspaces(tc, tp, w)
    calls = MEGA_KERNEL.plain_calls
    tc.step(ws, wsm=wsm)
    assert MEGA_KERNEL.plain_calls == calls + 1
    got = ws.numpy()
    np.testing.assert_allclose(got, jws_out, **TOL["float32"])
    topk = tc.queue[tc.queue[:tc.num_exec, 0] == int(TaskType.MOE_TOPK)][0]
    wt, jwt = got[topk[1]], jws_out[topk[1]]
    np.testing.assert_array_equal(wt > 0, jwt > 0)
    batch = FORMS[form]["batch"]
    assert (wt[:, :batch] > 0).sum(0).tolist() == [TOPK] * batch
    assert not wt[:, batch:].any() and not wt[E:].any()
    out = tc.gather_output(ws, tp.x_out).numpy()
    np.testing.assert_allclose(out, jout, **TOL["float32"])
    np.testing.assert_allclose(out[:batch],
                               _golden(w, FORMS[form]["pos"], batch),
                               rtol=2e-3, atol=2e-3)


# ---------------------------------------------------------------------------
# The two handlers alone, against the JAX kernel.
# ---------------------------------------------------------------------------

def _run_both(build, feeds, outputs, dtype="float32"):
    """One program built by both builders (``build(mb)`` returns handles
    by name), the same numpy feeds, one step each; {name: (port, JAX)}."""
    jmb, tmb = JBuilder(), MegaKernelBuilder()
    jh, th = build(jmb), build(tmb)
    jc = jmb.compile(dtype=jnp.dtype(dtype))
    tc = tmb.compile(dtype=dtype)
    np.testing.assert_array_equal(tc.queue, np.asarray(jc.queue))
    jouts = jc.run({jh[k]: jnp.asarray(v) for k, v in feeds.items()},
                   outputs=[jh[k] for k in outputs])
    ws = tc.make_workspace({th[k]: torch.from_numpy(v)
                            for k, v in feeds.items()}, device="cpu")
    tc.step(ws)
    return {k: (tc.gather_output(ws, th[k]).float().numpy(),
                np.asarray(j.astype(jnp.float32)))
            for k, j in zip(outputs, jouts)}


TOPK_CASES = {
    # (experts, top-k, batch, tie columns): a padded row past the batch,
    # ties at the top, top-k equal to E.
    "e8_top2_b3": (8, 2, 3, ()),
    "tied_e16_top2": (16, 2, 4, (2, 5, 11)),
    "topk_eq_e": (6, 6, 2, ()),
    "e128_top8_b4": (128, 8, 4, (0, 127)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(TOPK_CASES))
def test_moe_topk_task_vs_jax(case, dtype):
    """MOE_TOPK: the masked, transposed weight tile — the same experts
    selected (ties to the leftmost), rows past the batch and experts past
    E zero, each selected column's weights summing to one."""
    num_e, k, batch, ties = TOPK_CASES[case]
    rng = np.random.default_rng(7)
    lg = rng.standard_normal((TILE, TILE)).astype(np.float32)
    if ties:
        lg[:, list(ties)] = 9.0          # the row max, three (or two) times
    lg[batch:] = 50.0                    # padded rows: must elect nothing
    lg[:, num_e:] = 60.0                 # columns past E: never elected

    def build(mb):
        logits, wt = mb.tensor(TILE, TILE), mb.tensor(TILE, TILE)
        mb.moe_topk(wt, logits, k, num_e, batch)
        return dict(logits=logits, wt=wt)

    got, want = _run_both(build, dict(logits=lg), ["wt"], dtype)["wt"]
    np.testing.assert_allclose(got, want, **TOL[dtype])
    np.testing.assert_array_equal(got > 0, want > 0)
    assert (got[:, :batch] > 0).sum(0).tolist() == [k] * batch
    assert not got[:, batch:].any() and not got[num_e:].any()
    np.testing.assert_allclose(got[:, :batch].sum(0), 1.0,
                               atol=2e-2 if dtype == "bfloat16" else 1e-6)
    chosen = set(np.flatnonzero(got[:, 0] > 0).tolist())
    assert set(ties[:k]) <= chosen            # the leftmost of the ties
    if len(ties) >= k:
        assert chosen == set(ties[:k])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_task_vs_jax(dtype):
    """MOE_FFN from a hand-made weight tile: experts 1 and 4 shared by the
    rows, expert 6 by row 2 alone, the rest selected by no row — their
    weights are NaN, and the output stays finite (skipped before any of
    their weights is read) and equal to the JAX kernel's; padded rows'
    outputs are zero."""
    rng = np.random.default_rng(11)
    batch = 3
    wt = np.zeros((TILE, TILE), np.float32)
    wt[1, :batch] = [0.7, 0.2, 0.5]
    wt[4, :batch] = [0.3, 0.8, 0.0]
    wt[6, 2] = 0.5
    xn = np.zeros((TILE, HIDDEN), np.float32)
    xn[:batch] = rng.standard_normal((batch, HIDDEN)) * 0.5
    wg = rng.standard_normal((E, HIDDEN, FFN)).astype(np.float32) * 0.05
    wu = rng.standard_normal((E, HIDDEN, FFN)).astype(np.float32) * 0.05
    wd = rng.standard_normal((E, FFN, HIDDEN)).astype(np.float32) * 0.05
    idle = [e for e in range(E) if e not in (1, 4, 6)]
    for a in (wg, wu, wd):
        a[idle] = np.nan

    def build(mb):
        x, out, t = (mb.tensor(TILE, HIDDEN), mb.tensor(TILE, HIDDEN),
                     mb.tensor(TILE, TILE))
        g, u = mb.tensor(E * HIDDEN, FFN), mb.tensor(E * HIDDEN, FFN)
        d = mb.tensor(E * FFN, HIDDEN)
        mb.moe_ffn(out, x, t, g, u, d, E)
        return dict(x=x, out=out, t=t, g=g, u=u, d=d)

    feeds = dict(x=xn, t=wt, g=wg.reshape(E * HIDDEN, FFN),
                 u=wu.reshape(E * HIDDEN, FFN), d=wd.reshape(E * FFN, HIDDEN))
    got, want = _run_both(build, feeds, ["out"], dtype)["out"]
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, **TOL[dtype])
    assert not got[batch:].any()
    if dtype == "float32":
        ref = np.zeros((batch, HIDDEN))
        for e in (1, 4, 6):
            g = xn[:batch] @ wg[e]
            act = g / (1 + np.exp(-g)) * (xn[:batch] @ wu[e])
            ref += (act * wt[e, :batch, None]) @ wd[e]
        np.testing.assert_allclose(got[:batch], ref, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Refusals.
# ---------------------------------------------------------------------------

def test_moe_refusals():
    """A MOE_TOPK batch past one logits tile (both interpreters), a launch
    with fewer live rows than the batch, and the config checks, all by
    name. A batch past the kernel's 4-row groups and the paged and e4m3
    weight-tile MoE forms build (the JAX assembly's)."""
    kw = dict(TINY, pos=S - 1, inkernel_append=False, mat_prefetch=False)
    prog = build_decode_step(batch=MAX_LIVE_ROWS, **kw)
    tc = prog.mb.compile()
    ws = torch.zeros((tc.num_tiles + tc._strip_pad, TILE, TILE))
    wsm = torch.zeros((tc.num_mrows, 1024))
    q = tc.queue.copy()
    q[np.flatnonzero(q[:tc.num_exec, 0] == int(TaskType.MOE_TOPK)), 9] = \
        MAX_LIVE_ROWS + 1
    with pytest.raises(MegakernelUnsupportedError, match="MOE_TOPK"):
        tc.step(ws, q, wsm=wsm)
    tc4 = build_decode_step(batch=4, **kw).mb.compile()
    with pytest.raises(MegakernelUnsupportedError, match="live_rows"):
        mk.cuda_launcher(tc4.queue, ws, wsm, num_exec=tc4.num_exec,
                         mat_specs=tc4.mat_specs, head_dim=TILE,
                         sync_before=tc4.sync_before, live_rows=2)
    build_decode_step(batch=1, kv_pool_pages=3, table_pages=2,
                      **dict(TINY, pos=S - 1), inkernel_append=True, mat_prefetch=True)
    build_decode_step(batch=1, fp8_weights=True, **dict(TINY, pos=S - 1),
                      inkernel_append=True)
    with pytest.raises(ValueError, match="num_experts"):
        build_decode_step(batch=TILE + 1, **kw)
    with pytest.raises(ValueError, match="moe_topk"):
        build_decode_step(batch=1, **dict(kw, moe_topk=E + 1))
    mb = MegaKernelBuilder()
    x, out, t = (mb.tensor(TILE, HIDDEN), mb.tensor(TILE, HIDDEN),
                 mb.tensor(TILE, TILE))
    with pytest.raises(ValueError, match="E\\*hidden"):
        mb.moe_ffn(out, x, t, mb.tensor(E * TILE, FFN),
                   mb.tensor(E * TILE, FFN), mb.tensor(E * FFN, HIDDEN), E)
    with pytest.raises(ValueError, match="topk"):
        mb.moe_topk(t, t, 0, E, 1)
