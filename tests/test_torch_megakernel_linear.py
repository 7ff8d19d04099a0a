"""Port's linear megakernel decoder vs the JAX package's: the compiled
queues of both weight layouts (matrix, and the fp8-weight tile layout) word
for word, ``advance_queue_pos`` at the page edges, each linear-program
handler's plain version against the JAX kernel in interpret mode on a
one-op program, one ``MegakernelDecoder.step`` (workspace and token), and
``Engine.serve(backend="megakernel")`` token for token against the JAX
package's and the port's eager serve; then the refusals the port keeps.

The tiny model is ``tests/test_megakernel_serving.py``'s (hidden 256, 2
layers, 2/1 heads, head_dim 128, fp32); the JAX weights cross through
``params_from_numpy``. Tolerances: fp32 workspaces atol = rtol = 1e-5
(summation order only); bf16 workspaces atol 4e-3, rtol 1.6e-2 per task
(two bf16 units: the two sides may round a store one unit apart).
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
    advance_queue_pos as jadvance, broadcast_rows,
    build_decode_step as jbuild,
)
from triton_distributed_tpu.megakernel.serving import (
    MegakernelDecoder as JDecoder,
)
from triton_distributed_tpu.models.config import ModelConfig as JConfig
from triton_distributed_tpu.models.dense import (
    dense_prefill as jprefill, init_dense_llm as jinit,
)
from triton_distributed_tpu.models.engine import Engine as JEngine
from triton_distributed_tpu.models.kv_cache import init_kv_cache as jkv
from triton_distributed_tpu.runtime import initialize_distributed
from triton_distributed_tpu_torch.megakernel.builder import (
    MegaKernelBuilder,
)
from triton_distributed_tpu_torch.megakernel.kernel import (
    MEGA_KERNEL, PORTED_TYPES, MegakernelUnsupportedError,
)
from triton_distributed_tpu_torch.megakernel.models import (
    advance_queue_pos, build_decode_step,
)
from triton_distributed_tpu_torch.megakernel.serving import (
    MegakernelDecoder, cache_feeds,
)
from triton_distributed_tpu_torch.megakernel.tasks import (
    TILE, Task, TaskType,
)
from triton_distributed_tpu_torch.models.config import ModelConfig
from triton_distributed_tpu_torch.models.convert import params_from_numpy
from triton_distributed_tpu_torch.models.dense import dense_prefill
from triton_distributed_tpu_torch.models.engine import Engine
from triton_distributed_tpu_torch.models.kv_cache import init_kv_cache
from triton_distributed_tpu_torch.ops.paged_attention import PAGED_KERNEL

TINY = dict(hidden_size=256, intermediate_size=256, num_layers=2,
            num_heads=2, num_kv_heads=1, head_dim=128, vocab_size=512,
            qk_norm=True, dtype="float32")
TINY_D64 = dict(TINY, head_dim=64, num_heads=4, num_kv_heads=2)
QWEN3_8B_2L = dict(hidden_size=4096, intermediate_size=12288, num_layers=2,
                   num_heads=32, num_kv_heads=8, head_dim=128)
MAX_SEQ = 256
IDS = [[3, 141, 59, 26, 5]]
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=1.6e-2, atol=4e-3)}
MATRIX_TYPES = {TaskType.RMS_NORM, TaskType.ATTN_DECODE_GQA,
                TaskType.APPEND_KV, TaskType.GEMM_MAT,
                TaskType.NORM_ROPE_QKV, TaskType.PREFETCH_MAT}
TILE_TYPES = {TaskType.SILU_MUL, TaskType.RMS_NORM,
              TaskType.ATTN_DECODE_GQA, TaskType.NORM_ROPE,
              TaskType.APPEND_KV, TaskType.GEMM_WIDE_W8, TaskType.ADD_NORM}


def _program_kw(cfg, max_seq):
    return dict(hidden=cfg["hidden_size"], hq_local=cfg["num_heads"],
                hkv_local=cfg["num_kv_heads"],
                ffn_local=cfg["intermediate_size"],
                num_layers=cfg["num_layers"], max_seq=max_seq,
                pos=max_seq - 1, eps=1e-6, head_dim=cfg["head_dim"])


def _both(cfg, max_seq, fp8, final_norm):
    """(JAX compiled, port compiled) linear program, as the decoders build
    it."""
    kw = _program_kw(cfg, max_seq)
    jc = jbuild(num_ranks=1, inkernel_append=True, fp8_weights=fp8,
                final_norm=final_norm, mat_prefetch=not fp8,
                **kw).mb.compile(head_dim=kw["head_dim"])
    tc = build_decode_step(inkernel_append=True, mat_prefetch=not fp8,
                           fp8_weights=fp8, final_norm=final_norm,
                           **kw).mb.compile(head_dim=kw["head_dim"])
    return jc, tc


@pytest.mark.parametrize("final_norm", [False, True],
                         ids=["host_norm", "final_norm"])
@pytest.mark.parametrize("fp8", [False, True], ids=["matrix", "fp8_tiles"])
@pytest.mark.parametrize("shape", [(TINY, MAX_SEQ), (TINY_D64, MAX_SEQ),
                                   (QWEN3_8B_2L, 2048)],
                         ids=["tiny", "tiny_d64", "qwen3_8b_2layers"])
def test_linear_queue_word_for_word(shape, fp8, final_norm):
    """The port's builder emits the JAX builder's linear queue: every
    word, the emission-to-row map, the type set, the hazard sets and
    edges, and the geometry the workspaces are sized from."""
    cfg, max_seq = shape
    jc, tc = _both(cfg, max_seq, fp8, final_norm)
    np.testing.assert_array_equal(tc.queue, np.asarray(jc.queue))
    assert tc.num_exec == jc.num_exec == len(tc.queue)
    assert tc.task_rows == jc.task_rows
    assert tc.used_types == jc.used_types
    want = TILE_TYPES if fp8 else MATRIX_TYPES
    # The tile layout's last layer ends in a plain ADD unless the final
    # norm is fused into it (ADD_NORM).
    if fp8 and not final_norm:
        want = want | {TaskType.ADD}
    assert set(tc.used_types) == {int(t) for t in want}
    assert set(tc.used_types) <= {int(t) for t in PORTED_TYPES}
    for f in ("num_tiles", "num_tiles8", "num_tiles_kv8", "num_mrows",
              "max_gqa", "max_gemm_width", "max_row", "max_strip",
              "_strip_pad", "head_dim", "hazard_edges", "task_reads",
              "task_writes"):
        assert getattr(tc, f) == getattr(jc, f), f
    assert [dataclasses.astuple(s) for s in tc.mat_specs] == \
        [(s.kt, s.ns, s.nt_out, s.kch, s.epi, s.warm) for s in jc.mat_specs]
    if fp8:
        w8 = MegaKernelBuilder._W8_HAZARD
        assert any(t >= w8 for r in tc.task_reads for t in r)
        assert not any(t >= w8 for ws in tc.task_writes for t in ws)


@pytest.mark.parametrize("fp8", [False, True], ids=["matrix", "fp8_tiles"])
def test_advance_queue_pos_word_for_word(fp8):
    """The per-step retarget at the page edges: valid length, visited
    tiles and the append's tile and column equal the JAX function's; then
    its three named errors."""
    jc, tc = _both(TINY, MAX_SEQ, fp8, False)
    for pos in (0, 1, 127, 128, MAX_SEQ - 1):
        got = advance_queue_pos(tc, pos)
        np.testing.assert_array_equal(got, np.asarray(jadvance(jc, pos)))
        assert got.dtype == np.int32 and got is not tc.queue
        gqa = got[got[:, 0] == int(TaskType.ATTN_DECODE_GQA)]
        assert (gqa[:, 6] == pos).all()
        assert (gqa[:, 4] == -(-pos // TILE)).all()
        app = got[got[:, 0] == int(TaskType.APPEND_KV)]
        assert (app[:, 1] == app[:, 5] + pos // TILE).all()
        assert (app[:, 8] == pos % TILE).all()
    np.testing.assert_array_equal(
        advance_queue_pos(tc.queue, 5, num_exec=tc.num_exec),
        advance_queue_pos(tc, 5))
    # A program built at a small pos visits too few tiles for a later one.
    kw = dict(_program_kw(TINY, MAX_SEQ), pos=5)
    short = build_decode_step(inkernel_append=True, mat_prefetch=not fp8,
                              fp8_weights=fp8, **kw).mb.compile()
    with pytest.raises(ValueError, match="build the program at"):
        advance_queue_pos(short, 200)
    # pos 0 with a cache-only attention task is an all-masked softmax.
    mb = MegaKernelBuilder()
    q, o = mb.tensor(TILE, TILE), mb.tensor(TILE, TILE)
    kT, v = mb.tensor(TILE, MAX_SEQ), mb.tensor(MAX_SEQ, TILE)
    mb.attn_decode_gqa(o, 0, q, 0, 1, kT, v, valid_len=MAX_SEQ - 1,
                       scale=0.5)
    with pytest.raises(ValueError, match="all-masked"):
        advance_queue_pos(mb.compile(), 0)
    # Page-table data rows must not be misread as tasks.
    paged = build_decode_step(**dict(_program_kw(TINY, MAX_SEQ),
                                     batch=TILE, kv_pool_pages=3,
                                     table_pages=2), inkernel_append=True, mat_prefetch=True).mb.compile()
    with pytest.raises(ValueError, match="num_exec"):
        advance_queue_pos(paged.queue, 5)


@pytest.mark.parametrize("fp8", [False, True], ids=["matrix", "fp8_tiles"])
@pytest.mark.parametrize("shape", [(TINY, MAX_SEQ), (QWEN3_8B_2L, 2048)],
                         ids=["tiny", "qwen3_8b_2layers"])
def test_barrier_rows_cover_linear_hazards(shape, fp8):
    """The CUDA interpreter's barrier flags on the linear programs: every
    hazard edge has a barrier between its rows — so each head's append
    waits for the GQA task that reads the head's cache, whichever tile
    ``advance_queue_pos`` moves the append to (built at max_seq - 1 the
    GQA task lists every tile) — and a layer's GQA tasks, and its GEMM
    strips of one projection group, share a barrier interval."""
    cfg, max_seq = shape
    _, tc = _both(cfg, max_seq, fp8, False)
    sync, rows = tc.sync_before, tc.task_rows
    assert len(sync) == tc.num_exec and sync[0] == 0
    for u, t in tc.hazard_edges:
        assert rows[u] < rows[t]
        assert sync[rows[u] + 1:rows[t] + 1].any(), (u, t)
    types = tc.queue[:tc.num_exec, 0]
    gqa = types == int(TaskType.ATTN_DECODE_GQA)
    assert not sync[1:][gqa[1:] & gqa[:-1]].any()
    # Every cache tile an append may target is in a GQA task's read set.
    inv = {r: t for t, r in enumerate(rows)}
    q = tc.queue
    for r in np.flatnonzero(types == int(TaskType.APPEND_KV)):
        kt0, v0 = int(q[r, 5]), int(q[r, 6])
        readers = [u for u, t in tc.hazard_edges if t == inv[r]
                   and q[rows[u], 0] == int(TaskType.ATTN_DECODE_GQA)]
        assert readers
        reads = set(tc.task_reads[readers[0]])
        n = max_seq // TILE
        assert {kt0 + i for i in range(n)} <= reads
        assert {v0 + i for i in range(n)} <= reads
    if fp8:
        wide = types == int(TaskType.GEMM_WIDE_W8)
        assert sync[wide].sum() < wide.sum() // 2


# ---------------------------------------------------------------------------
# Each handler's plain version against the JAX kernel (interpret mode).
# ---------------------------------------------------------------------------

def _run_both(build, feeds, outputs, dtype="float32", head_dim=TILE):
    """Build the same program with both builders (``build(mb)`` returns
    the handles by name), feed both the same numpy values, run one step
    and return {name: (port, JAX)} fp32 arrays of ``outputs``."""
    jmb, tmb = JBuilder(), MegaKernelBuilder()
    jmb.head_dim = tmb.head_dim = head_dim
    jh, th = build(jmb), build(tmb)
    jc = jmb.compile(dtype=jnp.dtype(dtype))
    tc = tmb.compile(dtype=dtype)
    np.testing.assert_array_equal(tc.queue, np.asarray(jc.queue))
    jouts = jc.run({jh[k]: jnp.asarray(v) for k, v in feeds.items()},
                   outputs=[jh[k] for k in outputs])
    main, w8, _ = tc.split_feeds({th[k]: torch.from_numpy(v)
                                  for k, v in feeds.items()})
    ws = tc.make_workspace(main, device="cpu")
    ws8 = tc.make_workspace8(w8, device="cpu") if w8 else None
    calls = MEGA_KERNEL.plain_calls
    tc.step(ws, ws8=ws8)
    assert MEGA_KERNEL.plain_calls == calls + 1
    return {k: (tc.gather_output(ws, th[k]).float().numpy(),
                np.asarray(j.astype(jnp.float32)))
            for k, j in zip(outputs, jouts)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", ["copy", "add", "silu_mul", "scale"])
def test_elementwise_tasks_vs_jax(op, dtype):
    """COPY, ADD, SILU_MUL, SCALE over a 3-tile row: fp32 inside, stored
    in the workspace type; SCALE's factor decoded from its fixed-point
    word."""
    rng = np.random.default_rng(1)
    a_v = rng.standard_normal((TILE, 3 * TILE)).astype(np.float32)
    b_v = rng.standard_normal((TILE, 3 * TILE)).astype(np.float32)

    def build(mb):
        a, b, o = (mb.tensor(TILE, 3 * TILE) for _ in range(3))
        if op == "copy":
            mb.copy(o, a)
        elif op == "scale":
            mb.scale(o, a, 0.3337)
        else:
            getattr(mb, op)(o, a, b)
        return dict(a=a, b=b, o=o)

    got, want = _run_both(build, dict(a=a_v, b=b_v), ["o"], dtype)["o"]
    np.testing.assert_allclose(got, want, **TOL[dtype])
    if op == "copy" and dtype == "float32":
        np.testing.assert_array_equal(got, a_v)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fp8", [False, True], ids=["gemm_wide", "w8"])
def test_gemm_wide_vs_jax(fp8, dtype):
    """GEMM_WIDE / GEMM_WIDE_W8: K = 4 tiles, N = 3 column tiles as a
    2-wide and a 1-wide strip (width=2), and as one full-width task with
    the super-strip flag; B from the main or the e4m3 weight workspace."""
    rng = np.random.default_rng(2)
    a_v = rng.standard_normal((TILE, 4 * TILE)).astype(np.float32) * 0.3
    b_v = rng.standard_normal((4 * TILE, 3 * TILE)).astype(np.float32) * 0.3

    def build(mb):
        a = mb.tensor(TILE, 4 * TILE)
        b = mb.tensor(4 * TILE, 3 * TILE, fp8=fp8)
        strips, full = mb.tensor(TILE, 3 * TILE), mb.tensor(TILE, 3 * TILE)
        mb.gemm(strips, a, b, width=2)
        mb.gemm(full, a, b)
        return dict(a=a, b=b, strips=strips, full=full)

    mb = MegaKernelBuilder()
    h = build(mb)
    q = mb.compile().queue
    want_type = TaskType.GEMM_WIDE_W8 if fp8 else TaskType.GEMM_WIDE
    assert (q[:, 0] == int(want_type)).all()
    assert q[:, 7].tolist() == [2, 1, 3] and q[:, 9].tolist() == [0, 0, 4]
    res = _run_both(build, dict(a=a_v, b=b_v), ["strips", "full"], dtype)
    for name in ("strips", "full"):
        got, want = res[name]
        np.testing.assert_allclose(got, want, **TOL[dtype])
    np.testing.assert_allclose(res["strips"][0], res["full"][0],
                               **TOL[dtype])


def test_gemm_wide_w8_equals_gemm_wide_on_quantized_weights():
    """Widening e4m3 is exact: GEMM_WIDE_W8 over the e4m3 workspace and
    GEMM_WIDE over the same weights pre-quantized in the main workspace
    give the same row bit for bit (one summation order in the plain
    version); a weight past +-448 saturates instead of becoming NaN."""
    from triton_distributed_tpu_torch.models.fp8 import to_e4m3

    rng = np.random.default_rng(3)
    a_v = torch.from_numpy(rng.standard_normal((TILE, 2 * TILE)
                                               ).astype(np.float32))
    b_v = torch.from_numpy(rng.standard_normal((2 * TILE, 2 * TILE)
                                               ).astype(np.float32))
    b_v[0, :3] = torch.tensor([900.0, -1e4, 464.0])
    outs = []
    for fp8 in (True, False):
        mb = MegaKernelBuilder()
        a = mb.tensor(TILE, 2 * TILE)
        b = mb.tensor(2 * TILE, 2 * TILE, fp8=fp8)
        o = mb.tensor(TILE, 2 * TILE)
        mb.gemm(o, a, b)
        tc = mb.compile()
        feeds = {a: a_v, b: b_v if fp8 else to_e4m3(b_v).float()}
        main, w8, _ = tc.split_feeds(feeds)
        ws = tc.make_workspace(main, device="cpu")
        ws8 = tc.make_workspace8(w8, device="cpu") if fp8 else None
        if fp8:
            stored = tc.gather_output(
                ws8, dataclasses.replace(b, fp8=False)).float()
            assert stored[0, :3].tolist() == [448.0, -448.0, 448.0]
            with pytest.raises(ValueError, match="no ws8"):
                tc.step(ws)
        outs.append(tc.gather_output(tc.step(ws, ws8=ws8), o))
    assert torch.isfinite(outs[0]).all()
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("head_dim", [128, 64])
def test_norm_rope_task_vs_jax(head_dim, dtype):
    """NORM_ROPE on one head tile, in place and into a second tile, at
    head_dim 128 and in the padded-head layout (norm and rotation inside
    the low 64 lanes, pad lanes stay zero)."""
    from triton_distributed_tpu.megakernel.models import rope_tables

    rng = np.random.default_rng(4)
    x_v = rng.standard_normal((TILE, TILE)).astype(np.float32)
    w_v = rng.standard_normal((TILE,)).astype(np.float32) * 0.1 + 1
    if head_dim < TILE:
        x_v[:, head_dim:] = 0
        w_v[head_dim:] = 0
    cos_v, sin_v = rope_tables(37, head_dim, 1e6)

    def build(mb):
        x, y, w, cos, sin = (mb.tensor(TILE, TILE) for _ in range(5))
        mb.norm_rope(y, x, w, cos, sin)
        mb.norm_rope(x, x, w, cos, sin)
        return dict(x=x, y=y, w=w, cos=cos, sin=sin)

    res = _run_both(build, dict(x=x_v, w=broadcast_rows(w_v), cos=cos_v,
                                sin=sin_v), ["x", "y"], dtype, head_dim)
    for name in ("x", "y"):
        got, want = res[name]
        np.testing.assert_allclose(got, want, **TOL[dtype])
        assert not got[:, head_dim:].any()
    np.testing.assert_array_equal(res["x"][0], res["y"][0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_add_norm_task_vs_jax_and_unfused_pair(dtype):
    """ADD_NORM against the JAX kernel, and bit-equal to the ADD +
    RMS_NORM pair in the same program (the norm reads the stored, rounded
    x2 — ``tests/test_megakernel_decode.py``'s fusion contract)."""
    rng = np.random.default_rng(14)
    cols = 4 * TILE
    a_v = rng.standard_normal((TILE, cols)).astype(np.float32) * 0.3
    b_v = rng.standard_normal((TILE, cols)).astype(np.float32) * 0.3
    w_v = rng.standard_normal((cols,)).astype(np.float32) * 0.1 + 1

    def build(mb):
        a, b, w, fx2, fxn, ux2, uxn = (mb.tensor(TILE, cols)
                                       for _ in range(7))
        mb.add_norm(fx2, a, b, w, fxn)
        mb.add(ux2, a, b)
        mb.rms_norm(uxn, ux2, w)
        return dict(a=a, b=b, w=w, fx2=fx2, fxn=fxn, ux2=ux2, uxn=uxn)

    res = _run_both(build, dict(a=a_v, b=b_v, w=broadcast_rows(w_v)),
                    ["fx2", "fxn", "ux2", "uxn"], dtype)
    for name in ("fx2", "fxn"):
        got, want = res[name]
        np.testing.assert_allclose(got, want, **TOL[dtype])
    np.testing.assert_array_equal(res["fx2"][0], res["ux2"][0])
    np.testing.assert_array_equal(res["fxn"][0], res["uxn"][0])


def _attn_feeds(rng, s_tiles, g):
    q_v = rng.standard_normal((TILE, g * TILE)).astype(np.float32)
    kT_v = rng.standard_normal((TILE, s_tiles * TILE)).astype(np.float32)
    v_v = rng.standard_normal((s_tiles * TILE, TILE)).astype(np.float32)
    kn_v = rng.standard_normal((TILE, TILE)).astype(np.float32)
    vn_v = rng.standard_normal((TILE, TILE)).astype(np.float32)
    return dict(q=q_v, kT=kT_v, v=v_v, kn=kn_v, vn=vn_v)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("valid", [0, 1, 127, 129])
def test_attn_decode_gqa_task_vs_jax(valid, dtype):
    """ATTN_DECODE_GQA, a group of 2 q heads over a 2-tile linear cache
    whose every position holds data (columns at or past ``valid`` must be
    masked; ``valid`` 0 visits no tile and returns the current token's
    v), the current token folded row-wise; g and the scale decoded from
    the packed word."""
    rng = np.random.default_rng(10 + valid)
    feeds = _attn_feeds(rng, 2, 2)

    def build(mb):
        q, o = mb.tensor(TILE, 2 * TILE), mb.tensor(TILE, 2 * TILE)
        kT, v = mb.tensor(TILE, 2 * TILE), mb.tensor(2 * TILE, TILE)
        kn, vn = mb.tensor(TILE, TILE), mb.tensor(TILE, TILE)
        mb.attn_decode_gqa(o, 0, q, 0, 2, kT, v, valid_len=valid,
                           scale=TILE ** -0.5, k_new=kn, v_new=vn)
        return dict(q=q, o=o, kT=kT, v=v, kn=kn, vn=vn)

    mb = MegaKernelBuilder()
    build(mb)
    row = mb.compile().queue[0]
    assert row[7] >> 24 == 2 and row[7] & 0xFFFFFF == 88388
    assert row[4] == -(-valid // TILE) and row[6] == valid
    got, want = _run_both(build, feeds, ["o"], dtype)["o"]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL[dtype])
    if valid == 0:
        stored = torch.from_numpy(feeds["vn"]).to(
            getattr(torch, dtype)).float().numpy()
        np.testing.assert_allclose(got[:, :TILE], stored, **TOL[dtype])


@pytest.mark.parametrize("cache_only", [False, True],
                         ids=["with_current", "cache_only"])
def test_attn_decode_task_vs_jax(cache_only):
    """ATTN_DECODE (one head, the g = 1 case of the same body) with and
    without the current token's fold."""
    rng = np.random.default_rng(20)
    feeds = _attn_feeds(rng, 2, 1)

    def build(mb):
        q, o = mb.tensor(TILE, TILE), mb.tensor(TILE, TILE)
        kT, v = mb.tensor(TILE, 2 * TILE), mb.tensor(2 * TILE, TILE)
        kn, vn = mb.tensor(TILE, TILE), mb.tensor(TILE, TILE)
        if cache_only:
            mb.attn_decode(o, q, kT, v, valid_len=200, scale=0.11)
        else:
            mb.attn_decode(o, q, kT, v, valid_len=200, scale=0.11,
                           k_new=kn, v_new=vn)
        return dict(q=q, o=o, kT=kT, v=v, kn=kn, vn=vn)

    got, want = _run_both(build, feeds, ["o"])["o"]
    np.testing.assert_allclose(got, want, **TOL["float32"])


@pytest.mark.parametrize("pos", [0, 127, 128, 255])
def test_linear_append_task_vs_jax(pos):
    """The linear APPEND_KV, built at the last position and retargeted to
    ``pos`` by advance_queue_pos: k_new's row 0 lands in column pos of
    kT, v_new's row 0 in row pos of v, nothing else changes — equal to
    the JAX kernel bit for bit."""
    rng = np.random.default_rng(30 + pos)
    feeds = _attn_feeds(rng, 2, 1)
    jmb, tmb = JBuilder(), MegaKernelBuilder()
    handles = []
    for mb in (jmb, tmb):
        kT, v = mb.tensor(TILE, 2 * TILE), mb.tensor(2 * TILE, TILE)
        kn, vn = mb.tensor(TILE, TILE), mb.tensor(TILE, TILE)
        mb.append_kv(kT, v, 2 * TILE - 1, kn, vn)
        handles.append(dict(kT=kT, v=v, kn=kn, vn=vn))
    jc, tc = jmb.compile(), tmb.compile()
    jh, th = handles
    keys = ("kT", "v", "kn", "vn")
    jws = jc.make_workspace({jh[k]: jnp.asarray(feeds[k]) for k in keys})
    jws = jc.step(jws, jadvance(jc, pos))
    ws = tc.make_workspace({th[k]: torch.from_numpy(feeds[k])
                            for k in keys}, device="cpu")
    tc.step(ws, advance_queue_pos(tc, pos))
    np.testing.assert_array_equal(ws.numpy(), np.asarray(jws))
    kT_got = tc.gather_output(ws, th["kT"]).numpy()
    v_got = tc.gather_output(ws, th["v"]).numpy()
    want_kT, want_v = feeds["kT"].copy(), feeds["v"].copy()
    want_kT[:, pos] = feeds["kn"][0]
    want_v[pos] = feeds["vn"][0]
    np.testing.assert_array_equal(kT_got, want_kT)
    np.testing.assert_array_equal(v_got, want_v)


# ---------------------------------------------------------------------------
# The decoder and the engine.
# ---------------------------------------------------------------------------

def _model(shape, seed=0):
    jcfg = JConfig(**shape)
    jparams = jinit(jax.random.PRNGKey(seed), jcfg)
    cfg = ModelConfig(**shape)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                device="cpu")
    return jcfg, jparams, cfg, tparams


@pytest.fixture(scope="module")
def tiny():
    return _model(TINY)


@pytest.fixture(scope="module")
def tiny_d64():
    return _model(TINY_D64, seed=2)


@pytest.fixture(scope="module")
def ctx1():
    return initialize_distributed(mesh_shape=(1,), axis_names=("tp",),
                                  devices=jax.devices()[:1])


def _prefilled(jcfg, jparams, ids, max_seq):
    """(JAX cache, port cache, first greedy token) after the JAX prefill
    of ``ids``: the port's cache holds the same values."""
    logits, jcache = jprefill(jparams, jcfg, jnp.asarray(ids, jnp.int32),
                              jkv(jcfg, 1, max_seq, dtype=jnp.float32),
                              num_ranks=1)
    from triton_distributed_tpu_torch.models.kv_cache import KVCache

    tcache = KVCache(k=torch.from_numpy(np.array(jcache.k)),
                     v=torch.from_numpy(np.array(jcache.v)),
                     offset=int(jcache.offset))
    tok = np.asarray(jnp.argmax(logits, -1).astype(jnp.int32))
    return jcache, tcache, tok


@pytest.mark.parametrize("form", ["matrix", "fp8_tiles",
                                  "matrix_final_norm", "fp8_tiles_d64"])
def test_decoder_step_vs_jax(form, request):
    """One ``MegakernelDecoder.step`` on the same prefilled cache: the
    loaded workspaces equal element for element (weights, norm rows, the
    transposed caches, head_dim 64 padded), then the stepped workspace's
    live row of every tile and the whole KV region at fp32 1e-5, and the
    next token."""
    model = "tiny_d64" if form.endswith("d64") else "tiny"
    jcfg, jparams, cfg, tparams = request.getfixturevalue(model)
    kw = dict(fp8_weights=form.startswith("fp8"),
              final_norm=form.endswith("final_norm"))
    jdec = JDecoder(jcfg, jparams, max_seq=MAX_SEQ, **kw)
    tdec = MegakernelDecoder(cfg, tparams, max_seq=MAX_SEQ, device="cpu",
                             **kw)
    assert tdec.dtype == torch.float32
    jcache, tcache, tok = _prefilled(jcfg, jparams, IDS, MAX_SEQ)
    jws, tws = jdec.start(jcache), tdec.start(tcache)
    np.testing.assert_array_equal(tws.numpy(), np.asarray(jws))
    if kw["fp8_weights"]:
        wsm, ws8 = tdec.weights()
        assert wsm is None and ws8.dtype == torch.float8_e4m3fn
        np.testing.assert_array_equal(
            ws8.view(torch.uint8).numpy(),
            np.asarray(jdec._ws8).view(np.uint8))
    else:
        np.testing.assert_array_equal(tdec.weights()[0].numpy(),
                                      np.asarray(jdec._wsm))
    pos = len(IDS[0])
    assert tdec.warm is False
    calls = MEGA_KERNEL.plain_calls
    jws, jtok = jdec.step(jws, jnp.asarray(tok), pos)
    tws, ttok = tdec.step(tws, torch.from_numpy(tok.copy()), pos)
    assert MEGA_KERNEL.plain_calls == calls + 1
    assert tdec.warm and tdec.last_step_cold
    got, want = tws.numpy(), np.asarray(jws)
    np.testing.assert_allclose(got[:, 0, :], want[:, 0, :], rtol=1e-5,
                               atol=1e-5)
    caches = [t for h in tdec.prog.layers for c in h.kT + h.v
              for t in c.tiles()]
    np.testing.assert_allclose(got[caches], want[caches], rtol=1e-5,
                               atol=1e-5)
    assert ttok.dtype == torch.int32
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    # A second start() reuses the weight workspace and reloads the cache.
    w_before = tdec.weights()[1 if kw["fp8_weights"] else 0]
    tws2 = tdec.start(tcache)
    assert tdec.weights()[1 if kw["fp8_weights"] else 0] is w_before
    np.testing.assert_array_equal(tws2.numpy(),
                                  np.asarray(jdec.start(jcache)))
    tdec.step(tws2, torch.from_numpy(tok.copy()), pos)
    assert not tdec.last_step_cold


def test_cache_feeds_pad_head_dim_64(tiny_d64):
    """cache_feeds: kT is the (d, S) transpose, v the (S, d) rows; at
    head_dim 64 both are zero-padded to the 128-wide tile."""
    _, _, cfg, tparams = tiny_d64
    prog = build_decode_step(**_program_kw(TINY_D64, MAX_SEQ), inkernel_append=True, mat_prefetch=True)
    cache = init_kv_cache(cfg, 1, MAX_SEQ, device="cpu")
    g = torch.Generator().manual_seed(0)
    cache = cache._replace(k=torch.randn(cache.k.shape, generator=g),
                           v=torch.randn(cache.v.shape, generator=g))
    feeds = cache_feeds(prog, cache)
    h = prog.layers[1]
    kT, v = feeds[h.kT[1]], feeds[h.v[1]]
    assert tuple(kT.shape) == (TILE, MAX_SEQ)
    assert tuple(v.shape) == (MAX_SEQ, TILE)
    assert torch.equal(kT[:64], cache.k[1, 0, :, 1, :].T)
    assert torch.equal(v[:, :64], cache.v[1, 0, :, 1, :])
    assert not kT[64:].any() and not v[:, 64:].any()


@pytest.mark.parametrize("model", ["tiny", "tiny_d64"])
def test_engine_serve_megakernel_token_identical(model, request, ctx1):
    """``Engine.serve(backend="megakernel")``: token-identical to the JAX
    package's megakernel serve and to the port's eager serve; one
    megakernel run (its plain version here) per generated token after the
    first, K2 never; a second serve reuses the cached decoder."""
    jcfg, jparams, cfg, tparams = request.getfixturevalue(model)
    gen = 6
    ids = np.asarray(IDS, np.int32)
    jout = np.asarray(JEngine(jcfg, jparams, ctx1, backend="megakernel",
                              max_seq=MAX_SEQ).serve(jnp.asarray(ids),
                                                     gen_len=gen))
    eng = Engine(cfg, tparams, device="cpu", backend="megakernel",
                 max_seq=MAX_SEQ)
    assert eng.page_size is None
    mk_calls, k2_calls = MEGA_KERNEL.plain_calls, PAGED_KERNEL.plain_calls
    out = eng.serve(ids, gen)
    assert MEGA_KERNEL.plain_calls - mk_calls == gen - 1
    assert PAGED_KERNEL.plain_calls == k2_calls
    assert out.dtype == torch.int32 and tuple(out.shape) == (1, gen)
    np.testing.assert_array_equal(out.numpy(), jout)
    eager = Engine(cfg, tparams, device="cpu", max_seq=MAX_SEQ,
                   page_size=16).serve(ids, gen)
    np.testing.assert_array_equal(out.numpy(), eager.numpy())
    dec = eng._mk
    assert dec.dtype == torch.float32 and not dec.fp8_weights
    np.testing.assert_array_equal(eng.serve([[7, 9, 23]], 3).numpy(),
                                  Engine(cfg, tparams, device="cpu",
                                         max_seq=MAX_SEQ, page_size=16
                                         ).serve([[7, 9, 23]], 3).numpy())
    assert eng._mk is dec


def test_fp8_weight_decoder_matches_quantized_golden(tiny):
    """The fp8-weight decoder == the eager engine on e4m3 pre-quantized
    weights (prefill on the quantized weights too), and == the JAX
    fp8-weight decoder: the e4m3 weight workspace changes the weight
    quantization only (``tests/test_megakernel_serving.py``)."""
    from triton_distributed_tpu_torch.models.fp8 import to_e4m3

    jcfg, jparams, cfg, tparams = tiny
    gen = 5
    ids = torch.tensor(IDS, dtype=torch.int32)
    names = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")

    def quant(tree):
        if isinstance(tree, dict):
            return {k: (to_e4m3(v).to(v.dtype) if k in names else quant(v))
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [quant(v) for v in tree]
        return tree

    params_q = quant(tparams)
    golden = Engine(cfg, params_q, device="cpu", max_seq=MAX_SEQ,
                    page_size=16).serve(ids, gen)
    dec = MegakernelDecoder(cfg, tparams, max_seq=MAX_SEQ, device="cpu",
                            fp8_weights=True)
    cache = init_kv_cache(cfg, 1, MAX_SEQ, dtype=torch.float32,
                          device="cpu")
    logits, cache = dense_prefill(params_q, cfg, ids, cache)
    tok = torch.argmax(logits, -1).to(torch.int32)
    ws = dec.start(cache)
    toks, pos = [int(tok[0])], int(cache.offset)
    # The JAX decoder from the same cache and first token.
    jdec = JDecoder(jcfg, jparams, max_seq=MAX_SEQ, fp8_weights=True)
    jcache = jkv(jcfg, 1, MAX_SEQ, dtype=jnp.float32)._replace(
        k=jnp.asarray(cache.k.numpy()), v=jnp.asarray(cache.v.numpy()),
        offset=pos)
    jws, jtok, jtoks = jdec.start(jcache), jnp.asarray(tok.numpy()), []
    for _ in range(gen - 1):
        ws, tok = dec.step(ws, tok, pos)
        jws, jtok = jdec.step(jws, jtok, pos)
        toks.append(int(tok[0]))
        jtoks.append(int(jtok[0]))
        pos += 1
    assert [toks] == golden.tolist()
    assert toks[1:] == jtoks


# ---------------------------------------------------------------------------
# Refusals and defaults.
# ---------------------------------------------------------------------------

def test_linear_serve_refusals(tiny):
    """What the port refuses by name on the sequential megakernel path:
    a page_size with Engine.serve, Engine.decode, a batch of 2, a prompt
    that cannot fit, pos >= max_seq, a cache of another max_seq,
    num_ranks > 1; and the serving tier refuses an engine without a paged
    cache. profile=True builds (the stamp is ported)."""
    _, _, cfg, tparams = tiny
    eng = Engine(cfg, tparams, device="cpu", backend="megakernel",
                 max_seq=MAX_SEQ, page_size=128)
    with pytest.raises(MegakernelUnsupportedError, match="linear workspace"):
        eng.serve(IDS, 2)
    eng = Engine(cfg, tparams, device="cpu", backend="megakernel",
                 max_seq=MAX_SEQ)
    with pytest.raises(MegakernelUnsupportedError, match="Engine.decode"):
        eng.decode(torch.tensor([1]), eng.new_cache(1))
    calls = MEGA_KERNEL.plain_calls
    with pytest.raises(ValueError, match="batch-1"):
        eng.serve([[1, 2, 3], [4, 5, 6]], 2)
    with pytest.raises(ValueError, match="exceeds max_seq"):
        eng.serve([list(range(250))], 10)
    assert MEGA_KERNEL.plain_calls == calls
    from triton_distributed_tpu_torch.serving import (
        ServingConfigError, ServingEngine,
    )
    with pytest.raises(ServingConfigError, match="no paged cache"):
        ServingEngine(eng)
    with pytest.raises(ServingConfigError, match="no paged cache"):
        ServingEngine(Engine(cfg, tparams, device="cpu", max_seq=MAX_SEQ))
    dec = MegakernelDecoder(cfg, tparams, max_seq=MAX_SEQ, device="cpu")
    with pytest.raises(ValueError, match="start"):
        dec.step(torch.zeros(1), torch.tensor([1]), 3)
    ws = dec.start(eng.new_cache(1))
    with pytest.raises(ValueError, match=">= max_seq"):
        dec.step(ws, torch.tensor([1]), MAX_SEQ)
    with pytest.raises(ValueError, match="max_seq"):
        dec.start(init_kv_cache(cfg, 1, 128, device="cpu"))
    # TP decode is ported (tests/test_torch_megakernel_tp.py); this
    # model's one kv head does not split over 2 ranks, as the reference
    # refuses it.
    with pytest.raises(ValueError, match="not divisible by TP degree 2"):
        MegakernelDecoder(cfg, tparams, max_seq=MAX_SEQ, device="cpu",
                          num_ranks=2)
    assert MegakernelDecoder(cfg, tparams, max_seq=MAX_SEQ, device="cpu",
                             profile=True).profile
    with pytest.raises(ValueError, match="TILE multiple"):
        MegakernelDecoder(cfg, tparams, max_seq=100, device="cpu")


def test_builder_refusals():
    """The builder's one-outstanding-warm rules (a second PREFETCH before
    the first is consumed, a consumer whose first weight tile is not the
    warmed one, a warm never consumed) and the multi-rank types in a
    hand-made queue are refused by name; fp8 handles are GEMM B operands
    only."""
    mb = MegaKernelBuilder()
    a, o = mb.tensor(TILE, TILE), mb.tensor(TILE, TILE)
    w8 = mb.tensor(TILE, TILE, fp8=True)
    with pytest.raises(ValueError, match="pending prefetch None"):
        mb.gemm(o, a, w8, prefetch_first=True)
    mb.prefetch(w8.tile(0, 0))
    with pytest.raises(ValueError, match="not yet consumed"):
        mb.prefetch(w8.tile(0, 0), fp8=True)
    with pytest.raises(ValueError, match="does not match"):
        mb.gemm(o, a, w8, prefetch_first=True)     # warmed unfp8
    with pytest.raises(ValueError, match="never consumed"):
        mb.compile()
    for bad in (lambda: mb.add(o, a, w8), lambda: mb.copy(w8, a),
                lambda: mb.norm_rope(o, w8, a, a, a),
                lambda: mb.add_norm(o, a, a, w8, o),
                lambda: mb.attn_decode(o, a, w8, w8, 1, 0.5)):
        with pytest.raises(ValueError, match="fp8 weight-workspace"):
            bad()
    with pytest.raises(ValueError, match="fp8 space holds weights"):
        mb.gemm(w8, a, w8)
    with pytest.raises(ValueError, match="distinct"):
        mb.tensor(TILE, TILE, fp8=True, kv8=True)
    # The AllReduce types are ported: at one rank without force_ar they
    # do nothing, as the reference's do (tests/test_torch_megakernel_tp.py
    # runs them on rank groups); the retired slots stay refused by name.
    for tt in (TaskType.ALLREDUCE, TaskType.ALLREDUCE_ROW, TaskType.GEMM,
               TaskType.ROPE):
        mb2 = MegaKernelBuilder()
        t = mb2.tensor(TILE, TILE)
        mb2._emit(Task(tt, t.tile(0, 0), a0=t.tile(0, 0), k_tiles=1), [],
                  [])
        comp = mb2.compile()
        ws = comp.make_workspace({}, device="cpu")
        ws.normal_(generator=torch.Generator().manual_seed(int(tt)))
        if tt in PORTED_TYPES:
            assert torch.equal(comp.step(ws.clone()), ws)
            continue
        with pytest.raises(MegakernelUnsupportedError, match=tt.name):
            comp.step(ws)


def test_kernel_instantiation_follows_the_queue_types():
    """The CUDA kernel has a lean body for the paged serving program's
    task types and full ones for every ported type (as the JAX kernel
    compiles only the branches a program uses; the MoE types in a body of
    their own): the launcher picks by the queue's executable rows, never
    by its page-table data rows."""
    from triton_distributed_tpu_torch.megakernel.kernel import (
        _full_kernel, _kernel_body,
    )

    paged = build_decode_step(**dict(_program_kw(TINY, MAX_SEQ), batch=TILE,
                                     kv_pool_pages=3, table_pages=2,
                                     kv_fp8=True, spec_window=2),
                              inkernel_append=True, mat_prefetch=True).mb.compile()
    assert len(paged.queue) > paged.num_exec
    assert not _full_kernel(paged.queue, paged.num_exec)
    assert _kernel_body(paged.queue, paged.num_exec) == 0
    # Only the full bodies carry the profile stamp.
    assert _kernel_body(paged.queue, paged.num_exec, profile=True) == 1
    for fp8 in (False, True):
        _, tc = _both(TINY, MAX_SEQ, fp8, False)
        assert _full_kernel(tc.queue, tc.num_exec)
        assert _kernel_body(tc.queue, tc.num_exec) == 1
    mb = MegaKernelBuilder()
    a, o = mb.tensor(TILE, TILE), mb.tensor(TILE, TILE)
    mb.copy(o, a)
    comp = mb.compile()
    assert _full_kernel(comp.queue, comp.num_exec)
    assert _kernel_body(comp.queue, comp.num_exec) == 1


def test_linear_decoder_defaults_to_cuda(tiny, monkeypatch):
    """The decoder, its workspaces and the sequential megakernel engine
    run on the card unless given device="cpu": without CUDA, device=None
    raises instead of dropping to the CPU; a non-CPU workspace never
    reaches the plain version."""
    _, _, cfg, tparams = tiny
    dec = MegakernelDecoder(cfg, tparams, max_seq=MAX_SEQ, device="cpu",
                            fp8_weights=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        MegakernelDecoder(cfg, tparams, max_seq=MAX_SEQ)
    with pytest.raises(RuntimeError, match="is_available"):
        Engine(cfg, tparams, backend="megakernel", max_seq=MAX_SEQ)
    with pytest.raises(RuntimeError, match="is_available"):
        dec.comp.make_workspace8({})
    ws = dec.comp.make_workspace({}, device="meta")
    ws8 = dec.comp.make_workspace8({}, device="meta")
    calls = MEGA_KERNEL.plain_calls
    with pytest.raises(ValueError, match="no kernel for device"):
        dec.comp.step(ws, ws8=ws8)
    assert MEGA_KERNEL.plain_calls == calls
