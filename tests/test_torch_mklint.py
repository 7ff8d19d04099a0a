"""Port's mklint vs the JAX package's: the same violation kinds at the same
sites on every composition of the port's ``COMPOSITIONS`` (the JAX
package's matrix, ``decode_force_ar`` with its AllReduce tasks included),
on the seeded compiled-artifact violations of
``tests/test_mklint.py`` (synthetic artifacts fed to both checkers), and on
its seeded paged-step violations (each mutation applied to the port's and
the JAX package's decoder after the same retarget: the queues are word for
word the same, so the rows and sites must be too). The refcount rules run
on ``{page: count}`` dicts, which both checkers take; the port's allocator
shares no page (``owned_ref_counts``). Also the CLI's ``--all`` exit code.
"""

import copy
import types

import numpy as np
import pytest
import torch

import jax

from triton_distributed_tpu.analysis import mklint as jlint
from triton_distributed_tpu.megakernel.serving import (
    PagedMegakernelDecoder as JDecoder,
)
from triton_distributed_tpu.models.config import ModelConfig as JConfig
from triton_distributed_tpu.models.dense import init_dense_llm as jinit
from triton_distributed_tpu_torch.analysis import mklint
from triton_distributed_tpu_torch.megakernel.builder import MegaKernelBuilder
from triton_distributed_tpu_torch.megakernel.serving import (
    PagedMegakernelDecoder,
)
from triton_distributed_tpu_torch.megakernel.tasks import TILE, TaskType
from triton_distributed_tpu_torch.models.dense import init_dense_llm
from triton_distributed_tpu_torch.models.kv_cache import PageAllocator

K8 = MegaKernelBuilder._K8_HAZARD
GEMM = int(TaskType.GEMM)


def _sites(report):
    return [(v.kind, v.site) for v in report.violations]


def _same(got, want):
    assert _sites(got) == _sites(want)
    assert [v.message for v in got.violations] == \
        [v.message for v in want.violations]
    assert (got.n_tasks, got.n_edges, got.ok) == \
        (want.n_tasks, want.n_edges, want.ok)


@pytest.mark.parametrize("name", sorted(mklint.COMPOSITIONS))
def test_compositions_match_jax(name):
    """Every port composition lints clean, with the JAX composition's
    task and edge counts (the queues are the JAX builder's)."""
    got = mklint.COMPOSITIONS[name]()
    _same(got, jlint.COMPOSITIONS[name]())
    assert got.ok and got.n_tasks > 0 and got.n_edges > 0


def test_compositions_are_the_jax_matrix_less_force_ar():
    # The AllReduce tasks are ported: the matrix now has decode_force_ar.
    assert set(mklint.COMPOSITIONS) == set(jlint.COMPOSITIONS)


def test_cli_all_exits_zero(capsys):
    assert mklint.main(["--all"]) == 0
    out = capsys.readouterr().out
    assert f"mklint: {len(mklint.COMPOSITIONS)}/" in out
    assert mklint.main(["--list"]) == 0


# ---------------------------------------------------------------------------
# Seeded compiled-artifact violations (tests/test_mklint.py's).
# ---------------------------------------------------------------------------

def synth(rows, *, task_rows=None, reads=None, writes=None, edges=(),
          mat_specs=()):
    """A minimal compiled-artifact stand-in: ``rows`` is the queue's
    word-0 type column; hazard metadata defaults to empty per task."""
    n = len(rows)
    q = np.zeros((n, 10), np.int32)
    for i, r in enumerate(rows):
        q[i] = r if isinstance(r, (list, tuple)) else [r] + [0] * 9
    return types.SimpleNamespace(
        queue=q, num_exec=n,
        task_rows=list(task_rows if task_rows is not None else range(n)),
        task_reads=tuple(reads or [()] * n),
        task_writes=tuple(writes or [()] * n),
        hazard_edges=tuple(edges), mat_specs=tuple(mat_specs))


SEEDED = {
    "missing_producer": (dict(rows=[GEMM, GEMM], task_rows=[1, 0],
                              writes=[(7,), ()], reads=[(), (7,)],
                              edges=[(0, 1)]),
                         {"missing-producer", "edge-order"}),
    "waw": (dict(rows=[GEMM, GEMM], task_rows=[1, 0], writes=[(7,), (7,)]),
            {"waw-hazard"}),
    "kv8_war": (dict(rows=[int(TaskType.ATTN_DECODE_PAGED_F8),
                           int(TaskType.APPEND_KV_F8)], task_rows=[1, 0],
                     reads=[(K8 | 5,), ()], writes=[(), (K8 | 5,)]),
                {"kv8-war-hazard"}),
    "divergence": (dict(rows=[GEMM, GEMM], task_rows=[1, 0]),
                   {"schedule-divergence"}),
    "cycle": (dict(rows=[GEMM, GEMM], edges=[(0, 1), (1, 0)]),
              {"schedule-cycle"}),
    "prefetch_retarget": (dict(rows=[int(TaskType.PREFETCH)] * 2),
                          {"prefetch-retarget", "prefetch-unconsumed"}),
    "prefetch_w8_retarget": (dict(rows=[int(TaskType.PREFETCH_W8)] * 2),
                             {"prefetch-retarget", "prefetch-unconsumed"}),
    "prefetch_missing": (dict(rows=[[int(TaskType.GEMM_WIDE)] + [0] * 7
                                    + [1, 0]]), {"prefetch-missing"}),
    "prefetch_w8_missing": (dict(rows=[[int(TaskType.GEMM_WIDE_W8)]
                                       + [0] * 7 + [1, 0]]),
                            {"prefetch-missing"}),
    "prefetch_consumed": (dict(rows=[int(TaskType.PREFETCH),
                                     [int(TaskType.GEMM_WIDE)] + [0] * 7
                                     + [1, 0]]), set()),
    "clean": (dict(rows=[GEMM, GEMM], writes=[(7,), ()], reads=[(), (7,)],
                   edges=[(0, 1)]), set()),
}


@pytest.mark.parametrize("case", sorted(SEEDED))
def test_seeded_compiled_violations_match_jax(case):
    kw, kinds = SEEDED[case]
    got = mklint.check_compiled(synth(**kw))
    _same(got, jlint.check_compiled(synth(**kw)))
    assert kinds <= {v.kind for v in got.violations}
    assert got.ok == (not kinds)


def test_no_hazard_metadata_matches_jax():
    comp = synth([GEMM])
    comp.task_reads = None
    got = mklint.check_compiled(comp)
    _same(got, jlint.check_compiled(comp))
    assert [v.kind for v in got.violations] == ["no-hazard-metadata"]


def test_real_builder_warm_program_is_clean():
    """A hand-built program with both warms lints clean on both
    builders (the one-outstanding-warm rules hold by construction)."""
    from triton_distributed_tpu.megakernel.builder import (
        MegaKernelBuilder as JBuilder,
    )

    reps = []
    for B in (MegaKernelBuilder, JBuilder):
        mb = B()
        x, out = mb.tensor(TILE, 2 * TILE), mb.tensor(TILE, 2 * TILE)
        w, w8 = mb.tensor(2 * TILE, 2 * TILE), mb.tensor(
            2 * TILE, 2 * TILE, fp8=True)
        mb.prefetch(w.tile(0, 0))
        mb.gemm(out, x, w, prefetch_first=True)
        mb.prefetch(w8.tile(0, 0), fp8=True)
        mb.gemm(out, x, w8, prefetch_first=True)
        reps.append((mklint if B is MegaKernelBuilder else jlint)
                    .check_compiled(mb.compile()))
    _same(*reps)
    assert reps[0].ok


# ---------------------------------------------------------------------------
# Seeded paged-step violations: the same mutation on both decoders.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def paged():
    """Both packages' PagedMegakernelDecoder (the mklint tiny config) after
    the same retarget of tests/test_mklint.py, plain and spec (W = 3):
    {"plain" | "spec": (port decoder, JAX decoder, pages_a, pages_b)}."""
    cfg = mklint._tiny_cfg()
    params = init_dense_llm(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    jcfg = JConfig(hidden_size=256, intermediate_size=256, num_layers=1,
                   num_heads=2, num_kv_heads=1, head_dim=128,
                   vocab_size=512, qk_norm=True, dtype="float32")
    jparams = jinit(jax.random.PRNGKey(0), jcfg)
    out = {}
    for name, w in (("plain", 1), ("spec", 3)):
        dec = PagedMegakernelDecoder(cfg, params, num_slots=2, num_pages=4,
                                     max_pages=2, device="cpu",
                                     spec_window=w)
        jdec = JDecoder(jcfg, jparams, num_slots=2, num_pages=4,
                        max_pages=2, spec_window=w)
        alloc = PageAllocator(dec.num_pages + 1, dec.max_pages,
                              reserved=(dec.scratch,))
        pages_a = alloc.alloc_pages("a", 2)
        pages_b = alloc.alloc_pages("b", 1)
        lens = [TILE + 1, 5] if w == 1 else [TILE - 1, 5]
        wins = None if w == 1 else [2, 1]
        for d in (dec, jdec):
            d._retarget(lens, [pages_a, pages_b + [-1]], wins)
        np.testing.assert_array_equal(dec.last_retarget["queue"],
                                      np.asarray(jdec.last_retarget["queue"]))
        out[name] = (dec, jdec, pages_a, pages_b)
    return out


def _mutate(dec, jdec, edit):
    states = []
    for d, attn, app in ((dec, [list(zip(*(a.tolist() for a in r)))
                                for r in dec._attn],
                          [list(zip(*(a.tolist() for a in r)))
                           for r in dec._append]),
                         (jdec, jdec._attn_rows, jdec._append_rows)):
        state = copy.deepcopy(d.last_retarget)
        state["queue"] = np.array(state["queue"])
        edit(state["queue"], attn, app, d)
        states.append(state)
    return states


def _edit_append(target):
    def edit(q, attn, app, d):
        row, kt0, v0 = app[0][0]
        page = target(d)
        q[row, 1], q[row, 3] = kt0 + page, v0 + page
    return edit


def _edit_table(fn):
    def edit(q, attn, app, d):
        _row, kt0, v0, trow = attn[0][0]
        fn(q[trow:trow + d._table_rows].reshape(-1), kt0, v0, d)
    return edit


def _edit_valid(q, attn, app, d):
    q[attn[0][0][0], 6] += 3


def _edit_window(q, attn, app, d):
    q[attn[0][0][0], 5] += 1


PAGED_SEEDED = {
    "append_scratch": ("plain", _edit_append(lambda d: d.scratch),
                       "append-scratch"),
    "append_out_of_bounds": ("plain", _edit_append(lambda d: d.scratch + 3),
                             "append-out-of-bounds"),
    "append_retarget": ("plain", "retarget", "append-retarget"),
    "table_row_skew": ("plain", _edit_table(
        lambda f, kt0, v0, d: f.__setitem__(1, f[1] + 1)), "table-row-skew"),
    "table_scratch_read": ("plain", _edit_table(
        lambda f, kt0, v0, d: (f.__setitem__(0, kt0 + d.scratch),
                               f.__setitem__(1, v0 + d.scratch))),
        "table-scratch-read"),
    "kv_state_mismatch": ("plain", _edit_valid, "kv-state-mismatch"),
    "spec_window_mismatch": ("spec", _edit_window, "spec-window-mismatch"),
}


@pytest.mark.parametrize("case", sorted(PAGED_SEEDED))
def test_seeded_paged_violations_match_jax(paged, case):
    form, edit, kind = PAGED_SEEDED[case]
    dec, jdec, pages_a, _ = paged[form]
    if edit == "retarget":      # kv_len's page is pages_a[1]
        edit = _edit_append(lambda d: pages_a[0])
    state, jstate = _mutate(dec, jdec, edit)
    got = mklint.check_paged_step(dec, state, ref_counts=None)
    _same(got, jlint.check_paged_step(jdec, jstate, ref_counts=None))
    assert kind in {v.kind for v in got.violations}, case


@pytest.mark.parametrize("form", ["plain", "spec"])
def test_paged_clean_and_refcount_rules_match_jax(paged, form):
    """The unmutated steps lint clean with the owned pages' counts; a
    shared append page (count 2) and a table page with no reference
    (count 0) are caught, on both checkers, at the same sites."""
    dec, jdec, pages_a, pages_b = paged[form]
    alloc = PageAllocator(dec.num_pages + 1, dec.max_pages,
                          reserved=(dec.scratch,))
    alloc.alloc_pages("a", 2)
    alloc.alloc_pages("b", 1)
    rc = mklint.owned_ref_counts(alloc)
    assert rc == {p: 1 for p in pages_a + pages_b}
    got = mklint.check_paged_step(dec, ref_counts=rc)
    _same(got, jlint.check_paged_step(jdec, ref_counts=rc))
    assert got.ok
    target = pages_a[(dec.last_retarget["kv_lens"][0]) // TILE]
    for counts, kind in (({**rc, target: 2}, "append-shared-page"),
                         ({**rc, pages_a[0]: 0}, "table-freed-page")):
        got = mklint.check_paged_step(dec, ref_counts=counts)
        _same(got, jlint.check_paged_step(jdec, ref_counts=counts))
        assert kind in {v.kind for v in got.violations}
