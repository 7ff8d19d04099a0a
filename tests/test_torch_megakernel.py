"""Port's megakernel vs the JAX package's: the compiled queue word for
word, the workspaces element for element, one interpreted step of the
plain version against the JAX kernel in interpret mode, the paged decoder's
tokens over three steps, and the refusal of what the CUDA interpreter has
not ported.

The tiny model is ``tests/test_megakernel_paged_serving.py``'s (hidden
256, 2 layers, 2/1 heads, head_dim 128, fp32); the JAX weights cross
through ``params_from_numpy``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from triton_distributed_tpu.megakernel import kernel as jkernel
from triton_distributed_tpu.megakernel.models import (
    build_decode_step as jbuild,
)
from triton_distributed_tpu.megakernel.serving import (
    PagedMegakernelDecoder as JDecoder, weight_feeds as jweight_feeds,
)
from triton_distributed_tpu.models import sampling as jsampling
from triton_distributed_tpu.models.config import ModelConfig as JConfig
from triton_distributed_tpu.models.dense import (
    dense_prefill as jprefill, init_dense_llm as jinit,
)
from triton_distributed_tpu.models.kv_cache import init_kv_cache as jkv
from triton_distributed_tpu_torch.megakernel.builder import (
    MegaKernelBuilder,
)
from triton_distributed_tpu_torch.megakernel.kernel import (
    MAX_LIVE_ROWS, MEGA_KERNEL, PORTED_TYPES, MegakernelUnsupportedError,
    run_queue, run_queue_plain,
)
from triton_distributed_tpu_torch.megakernel.models import build_decode_step
from triton_distributed_tpu_torch.megakernel.serving import (
    PagedMegakernelDecoder, weight_feeds,
)
from triton_distributed_tpu_torch.megakernel.tasks import TILE, TaskType
from triton_distributed_tpu_torch.models.config import ModelConfig
from triton_distributed_tpu_torch.models.convert import params_from_numpy

TINY = dict(hidden_size=256, intermediate_size=256, num_layers=2,
            num_heads=2, num_kv_heads=1, head_dim=128, vocab_size=512,
            qk_norm=True, dtype="float32")
PROMPTS = [[3, 141, 59, 26, 5], [7, 9, 23]]
PAGES = {0: [0, 1], 1: [2, 3]}
NUM_SLOTS, NUM_PAGES, MAX_PAGES = 2, 4, 2


def _program_kw(cfg, slots, num_pages, max_pages):
    cap = max_pages * TILE
    return dict(hidden=cfg["hidden_size"], hq_local=cfg["num_heads"],
                hkv_local=cfg["num_kv_heads"],
                ffn_local=cfg["intermediate_size"],
                num_layers=cfg["num_layers"], max_seq=cap, pos=cap - 1,
                eps=1e-6, batch=slots * TILE, head_dim=cfg["head_dim"],
                kv_pool_pages=num_pages + 1, table_pages=max_pages)


def _jax_program(kw):
    """The JAX package's build of the same program (the serving lane's
    form: paged pools, in-kernel appends, o-proj weight warms)."""
    return jbuild(paged=True, inkernel_append=True, num_ranks=1,
                  mat_prefetch=True, **kw)


QWEN3_8B_2L = dict(hidden_size=4096, intermediate_size=12288, num_layers=2,
                   num_heads=32, num_kv_heads=8, head_dim=128)


FORMS = {"bf16_pools": {}, "fp8_pools_spec4": dict(kv_fp8=True,
                                                   spec_window=4)}
POOL_TYPES = {"bf16_pools": {TaskType.ATTN_DECODE_PAGED, TaskType.APPEND_KV},
              "fp8_pools_spec4": {TaskType.ATTN_DECODE_PAGED_F8,
                                  TaskType.APPEND_KV_F8}}


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("shape", [
    (TINY, 2, 4, 2),
    (QWEN3_8B_2L, 4, 64, 16),
], ids=["tiny", "qwen3_8b_2layers_4slots"])
def test_compiled_queue_word_for_word(shape, form):
    """(a) The port's builder emits the JAX builder's queue: every word,
    the emission-to-row map, the type set, the GEMM_MAT specs and the
    hazard edges — with pools in the workspace dtype, and with e4m3 pools
    and a 4-row speculative window (the kv8 hazard ids, the spill
    appends)."""
    cfg, slots, num_pages, max_pages = shape
    kw = dict(_program_kw(cfg, slots, num_pages, max_pages), **FORMS[form])
    jc = _jax_program(kw).mb.compile(head_dim=kw["head_dim"])
    tc = build_decode_step(**kw, inkernel_append=True, mat_prefetch=True).mb.compile(
        head_dim=kw["head_dim"])
    np.testing.assert_array_equal(tc.queue, np.asarray(jc.queue))
    assert tc.num_exec == jc.num_exec
    assert tc.task_rows == jc.task_rows
    assert tc.used_types == jc.used_types
    assert tc.num_tiles == jc.num_tiles
    assert tc.num_tiles_kv8 == jc.num_tiles_kv8
    common = {TaskType.RMS_NORM, TaskType.GEMM_MAT, TaskType.NORM_ROPE_QKV,
              TaskType.PREFETCH_MAT}
    assert set(tc.used_types) == {int(t) for t in common | POOL_TYPES[form]}
    assert set(tc.used_types) <= {int(t) for t in PORTED_TYPES}
    assert [dataclasses.astuple(s) for s in tc.mat_specs] == \
        [(s.kt, s.ns, s.nt_out, s.kch, s.epi, s.warm) for s in jc.mat_specs]
    assert tc.hazard_edges == jc.hazard_edges
    assert tc.task_reads == jc.task_reads
    assert tc.task_writes == jc.task_writes


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("shape", [(TINY, 2, 4, 2),
                                   (QWEN3_8B_2L, 4, 64, 16)],
                         ids=["tiny", "qwen3_8b_2layers_4slots"])
def test_barrier_rows_cover_every_hazard_edge(shape, form):
    """The CUDA interpreter's barrier flags: every hazard edge u -> t has a
    barrier between u's row and t's row (the kv8 pool edges included:
    an e4m3 append waits for the attention reads of its tile), and every
    GEMM_MAT row is preceded by one (its partial-sum scratch is
    shared)."""
    cfg, slots, num_pages, max_pages = shape
    tc = build_decode_step(**_program_kw(cfg, slots, num_pages, max_pages),
                           **FORMS[form], inkernel_append=True, mat_prefetch=True).mb.compile()
    if FORMS[form].get("kv_fp8"):
        k8 = MegaKernelBuilder._K8_HAZARD
        assert any(t >= k8 and t < MegaKernelBuilder._WM_HAZARD
                   for ws in tc.task_writes for t in ws)
    sync = tc.sync_before
    assert len(sync) == tc.num_exec and sync[0] == 0
    rows = tc.task_rows
    for u, t in tc.hazard_edges:
        assert rows[u] < rows[t]
        assert sync[rows[u] + 1:rows[t] + 1].any(), (u, t)
    types = tc.queue[:tc.num_exec, 0]
    gemm = types == int(TaskType.GEMM_MAT)
    assert sync[1:][gemm[1:]].all()
    # A slot-layer's attention rows (32 at Qwen3-8B widths) share one
    # barrier interval: no barrier between consecutive attention rows.
    attn = np.isin(types, [int(TaskType.ATTN_DECODE_PAGED),
                           int(TaskType.ATTN_DECODE_PAGED_F8)])
    assert not sync[1:][attn[1:] & attn[:-1]].any()
    if cfg is QWEN3_8B_2L and not FORMS[form]:
        assert sync.sum() < tc.num_exec // 4


@pytest.fixture(scope="module")
def tiny():
    jcfg = JConfig(**TINY)
    jparams = jinit(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                ModelConfig(**TINY), device="cpu")
    return jcfg, jparams, ModelConfig(**TINY), tparams


def test_workspaces_equal_jax(tiny):
    """(b) make_workspace and make_workspace_mat from the port's
    weight_feeds equal the JAX package's, element for element (norm
    broadcast rows, the fused qkv, the gate|up interleave, strip
    padding)."""
    jcfg, jparams, cfg, tparams = tiny
    kw = _program_kw(TINY, NUM_SLOTS, NUM_PAGES, MAX_PAGES)
    jprog = _jax_program(kw)
    jc = jprog.mb.compile()
    jmain, _, jwm = jc.split_feeds(jweight_feeds(jprog, jcfg, jparams))
    prog = build_decode_step(**kw, inkernel_append=True, mat_prefetch=True)
    tc = prog.mb.compile()
    main, _, wm = tc.split_feeds(weight_feeds(prog, cfg, tparams))
    ws = tc.make_workspace(main, device="cpu")
    wsm = tc.make_workspace_mat(wm, device="cpu")
    np.testing.assert_array_equal(ws.numpy(),
                                  np.asarray(jc.make_workspace(jmain)))
    np.testing.assert_array_equal(wsm.numpy(),
                                  np.asarray(jc.make_workspace_mat(jwm)))


@pytest.fixture(scope="module")
def decoders(tiny):
    """(JAX decoder, port decoder) with both prompts prefilled into pages
    0-1 (slot 0) and 2-3 (slot 1), plus the greedy first tokens."""
    jcfg, jparams, cfg, tparams = tiny
    jdec = JDecoder(jcfg, jparams, num_slots=NUM_SLOTS,
                    num_pages=NUM_PAGES, max_pages=MAX_PAGES)
    tdec = PagedMegakernelDecoder(cfg, tparams, num_slots=NUM_SLOTS,
                                  num_pages=NUM_PAGES, max_pages=MAX_PAGES,
                                  device="cpu")
    jws, tws = jdec.start(), tdec.start()
    toks = np.zeros(NUM_SLOTS, np.int32)
    for b, prompt in enumerate(PROMPTS):
        lin = jkv(jcfg, 1, 256)
        logits, lin = jprefill(jparams, jcfg,
                               jnp.asarray([prompt], jnp.int32), lin,
                               num_ranks=1)
        toks[b] = int(np.asarray(jsampling.greedy(logits))[0])
        jws = jdec.load_prefill(jws, lin.k, lin.v, PAGES[b])
        tws = tdec.load_prefill(tws, torch.from_numpy(np.array(lin.k)),
                                torch.from_numpy(np.array(lin.v)),
                                PAGES[b])
    return jdec, jws, tdec, tws, toks


def test_load_prefill_equals_jax(decoders):
    jdec, jws, tdec, tws, _ = decoders
    np.testing.assert_array_equal(tws.numpy(), np.asarray(jws))


def test_retarget_equals_jax(decoders):
    """The host queue rewrite (valid lengths, visited pages, table DATA
    rows, append targets) equals the JAX decoder's word for word, idle
    slots on the scratch page included."""
    jdec, _, tdec, _, _ = decoders
    for lens, tables in (([5, 3], [[0, 1], [2, 3]]),
                         ([128, 0], [[0, 1], [-1, -1]]),
                         ([200, 127], [[1, 0], [3, -1]]),
                         ([0, 0], [[-1, -1], [-1, -1]])):
        np.testing.assert_array_equal(
            tdec._retarget(lens, tables),
            np.asarray(jdec._retarget(lens, tables)))


def test_plain_step_equals_jax_interpret(decoders):
    """(c) One step: run_queue_plain against the JAX run_queue (Pallas
    interpret mode) on the same workspace and queue — the slots' live
    rows of every activation, and the KV pools, at fp32 atol = rtol =
    1e-5."""
    jdec, jws, tdec, tws, toks = decoders
    lens, tables = [5, 3], [[0, 1], [2, 3]]
    queue = jdec._retarget(lens, tables)
    prog, comp = jdec.prog, jdec.comp
    x = np.zeros((NUM_SLOTS * TILE, TINY["hidden_size"]), np.float32)
    emb = np.asarray(jdec.embed)
    cos = np.zeros((NUM_SLOTS * TILE, TILE), np.float32)
    sin = np.zeros_like(cos)
    for b in range(NUM_SLOTS):
        x[b * TILE] = emb[toks[b]]
        c, s = jdec._rope(lens[b])
        cos[b * TILE:(b + 1) * TILE] = c
        sin[b * TILE:(b + 1) * TILE] = s
    ws = comp.scatter_input(jnp.array(jws), prog.x, jnp.asarray(x))
    ws = comp.scatter_input(ws, prog.cos, jnp.asarray(cos))
    ws = comp.scatter_input(ws, prog.sin, jnp.asarray(sin))
    before = np.asarray(ws)
    want = np.asarray(comp.step(ws, queue, wsm=jdec._wsm))
    got = run_queue_plain(np.asarray(queue), torch.from_numpy(before.copy()),
                          tdec._wsm, num_exec=tdec.comp.num_exec,
                          mat_specs=tdec.comp.mat_specs,
                          head_dim=TILE).numpy()
    live = got[:, 0, :]                  # row 0 of every tile
    np.testing.assert_allclose(live, want[:, 0, :], rtol=1e-5, atol=1e-5)
    pools = [t for h in tdec.prog.layers for p in h.kT + h.v
             for t in p.tiles()]
    np.testing.assert_allclose(got[pools], want[pools], rtol=1e-5,
                               atol=1e-5)
    assert not np.array_equal(got[pools], before[pools])   # appends landed


def test_paged_decoder_tokens_vs_jax(decoders):
    """(d) The JAX test_paged_megakernel_decode_parity_heterogeneous, held
    against the JAX decoder: two slots at different lengths, three steps
    of in-kernel appends, identical tokens; then the three retarget
    refusals."""
    jdec, jws, tdec, tws, toks = decoders
    jws, tws = jnp.array(jws), tws.clone()
    kv_lens = np.asarray([len(p) for p in PROMPTS], np.int32)
    jt, tt = toks.copy(), toks.copy()
    tables = [PAGES[b] for b in range(NUM_SLOTS)]
    for _ in range(3):
        jws, jnext = jdec.step(jws, jt, kv_lens, tables)
        tws, tnext = tdec.step(tws, tt, kv_lens, tables)
        jt, tt = np.asarray(jnext), tnext.numpy()
        np.testing.assert_array_equal(tt, jt)
        kv_lens = kv_lens + 1
    with pytest.raises(ValueError, match="mapped pages"):
        tdec._retarget([TILE + 1, 0], [[0], []])
    with pytest.raises(ValueError, match="at capacity"):
        tdec._retarget([tdec.capacity, 0], [[0, 1], []])
    with pytest.raises(ValueError, match="page growth"):
        tdec._retarget([TILE, 0], [[0], []])


def test_run_queue_refuses_unported_types():
    """(f) A program naming a type outside the ported set (here the
    retired GEMM slot; the in-kernel AllReduce, refused here before it was
    ported, is tests/test_torch_megakernel_tp.py's) is refused before any
    launch, by name; so is a speculative window wider than the rows the
    CUDA kernel computes per slot block."""
    mb = MegaKernelBuilder()
    a, out = mb.tensor(TILE, TILE), mb.tensor(TILE, TILE)
    from triton_distributed_tpu_torch.megakernel.tasks import Task
    mb._emit(Task(TaskType.GEMM, out.tile(0, 0), a0=a.tile(0, 0),
                  b0=a.tile(0, 0), k_tiles=1), [a.tile(0, 0)],
             [out.tile(0, 0)])
    comp = mb.compile()
    ws = comp.make_workspace({}, device="cpu")
    calls = MEGA_KERNEL.plain_calls
    with pytest.raises(MegakernelUnsupportedError, match="GEMM"):
        comp.step(ws)
    with pytest.raises(MegakernelUnsupportedError, match="GEMM"):
        run_queue(comp.queue, ws, None, num_exec=comp.num_exec,
                  mat_specs=())
    assert MEGA_KERNEL.plain_calls == calls        # nothing ran

    kw = _program_kw(TINY, 1, 2, 1)
    prog = build_decode_step(**kw, inkernel_append=True, mat_prefetch=True)
    tc = prog.mb.compile()
    q = tc.queue.copy()
    attn = q[:tc.num_exec, 0] == int(TaskType.ATTN_DECODE_PAGED)
    q[np.flatnonzero(attn)[0], 5] = MAX_LIVE_ROWS + 1
    ws = tc.make_workspace({}, device="cpu")
    with pytest.raises(MegakernelUnsupportedError, match="window"):
        tc.step(ws, q, tc.make_workspace_mat({}, device="cpu"))
    assert MEGA_KERNEL.plain_calls == calls


def test_cuda_wrapper_rejects_without_fallback():
    """A non-CPU workspace never reaches the plain version: run_queue
    launches the kernel (on CUDA) or raises."""
    tc = build_decode_step(**_program_kw(TINY, 1, 2, 1),
                           inkernel_append=True, mat_prefetch=True).mb.compile()
    ws = tc.make_workspace({}, device="meta")
    before = MEGA_KERNEL.plain_calls
    with pytest.raises(ValueError, match="no kernel for device"):
        tc.step(ws, None, tc.make_workspace_mat({}, device="meta"))
    assert MEGA_KERNEL.plain_calls == before
