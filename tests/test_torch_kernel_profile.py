"""The port's profile stamp and ``obs/kernel_profile.py`` vs the JAX
package's: ``CompiledMegaKernel.step(profile=True)`` dumps word for word the
JAX kernel's (one step of the same program in interpret mode), over the
linear decode program and a hand-built program with both warms; a profiled
``MegakernelDecoder`` step keeps the dump of its own retargeted queue on
``last_profile``; and the decoded records, estimates, summaries, chrome
events and accounting equal the JAX module's under one explicit chip spec
(the same HBM rate and link model on both sides).
"""

import numpy as np
import pytest
import torch

from triton_distributed_tpu.megakernel.builder import (
    MegaKernelBuilder as JBuilder,
)
from triton_distributed_tpu.megakernel.models import (
    build_decode_step as jbuild,
)
from triton_distributed_tpu.obs import kernel_profile as jkp
from triton_distributed_tpu.runtime.perf_model import ChipSpec as JChipSpec
from triton_distributed_tpu_torch.megakernel.builder import MegaKernelBuilder
from triton_distributed_tpu_torch.megakernel.kernel import (
    MEGA_KERNEL, profile_dump, run_queue_plain,
)
from triton_distributed_tpu_torch.megakernel.models import (
    advance_queue_pos, build_decode_step,
)
from triton_distributed_tpu_torch.megakernel.serving import MegakernelDecoder
from triton_distributed_tpu_torch.megakernel.tasks import TILE, TaskType
from triton_distributed_tpu_torch.models.config import ModelConfig
from triton_distributed_tpu_torch.models.dense import init_dense_llm
from triton_distributed_tpu_torch.models.kv_cache import KVCache
from triton_distributed_tpu_torch.obs import kernel_profile as kp
from triton_distributed_tpu_torch.runtime.perf_model import ChipSpec

# The JAX builder's defaults (host-fed appends, no matrix warm).
PROG = dict(hidden=256, hq_local=2, hkv_local=1, ffn_local=256,
            num_layers=1, max_seq=256, pos=100)

# One chip spec on both sides: the port's H100 numbers, the JAX spec's link
# model set to one 450 GB/s link with the port's latency.
SPEC = ChipSpec("h100", 989.0, 1979.0, 67.0, 3350.0, 232448, 132)
JSPEC = JChipSpec("h100", 989.0, 3350.0, 128 << 20, SPEC.link_gbps, 1, 1,
                  25.0, ici_hop_latency_s=SPEC.link_latency_s)


def _warm_program(B):
    mb = B()
    x, out = mb.tensor(TILE, 2 * TILE), mb.tensor(TILE, 2 * TILE)
    out8 = mb.tensor(TILE, 2 * TILE)
    w, w8 = mb.tensor(2 * TILE, 2 * TILE), mb.tensor(2 * TILE, 2 * TILE,
                                                     fp8=True)
    mb.prefetch(w.tile(0, 0))
    mb.gemm(out, x, w, prefetch_first=True)
    mb.prefetch(w8.tile(0, 0), fp8=True)
    mb.gemm(out8, x, w8, prefetch_first=True)
    return mb


@pytest.fixture(scope="module")
def dumps():
    """{program: (port compiled, port dump, JAX dump)}: one profiled step of
    each program in both packages over zeroed workspaces (the dump is the
    dispatch record; it does not depend on the values)."""
    out = {}
    for name in ("decode", "warms"):
        if name == "decode":
            tc = build_decode_step(inkernel_append=False, mat_prefetch=False,
                                   **PROG).mb.compile()
            jc = jbuild(**PROG).mb.compile()
        else:
            tc = _warm_program(MegaKernelBuilder).compile()
            jc = _warm_program(JBuilder).compile()
        np.testing.assert_array_equal(tc.queue, np.asarray(jc.queue))
        kw = {}
        jkw = {}
        if tc.num_mrows:
            kw["wsm"] = tc.make_workspace_mat({}, device="cpu")
            jkw["wsm"] = jc.make_workspace_mat({})
        if tc.num_tiles8:
            kw["ws8"] = tc.make_workspace8({}, device="cpu")
            jkw["ws8"] = jc.make_workspace8({})
        _, got = tc.step(tc.make_workspace({}, device="cpu"), profile=True,
                         **kw)
        _, want = jc.step(jc.make_workspace({}), profile=True, **jkw)
        out[name] = (tc, got.numpy(), np.asarray(want))
    return out


@pytest.mark.parametrize("name", ["decode", "warms"])
def test_step_profile_dump_word_for_word(dumps, name):
    tc, got, want = dumps[name]
    assert got.dtype == np.int32 and got.shape == (tc.num_exec, 128)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, profile_dump(tc.queue, tc.num_exec))
    assert (got[:, 1 + 10:] == -1).all()
    if name == "warms":
        assert {int(TaskType.PREFETCH), int(TaskType.PREFETCH_W8)} <= \
            set(got[:, 1].tolist())


def test_profile_leaves_the_step_unchanged():
    """A profiled run updates the workspace exactly as an unprofiled one
    (the stamp writes only the dump)."""
    tc = build_decode_step(inkernel_append=False, mat_prefetch=False,
                           **PROG).mb.compile()
    g = torch.Generator().manual_seed(0)
    ws0 = torch.randn((tc.num_tiles + tc._strip_pad, TILE, TILE),
                      generator=g) * 0.1
    wsm = torch.randn((tc.num_mrows, 1024), generator=g) * 0.05
    kw = dict(num_exec=tc.num_exec, mat_specs=tc.mat_specs)
    a = run_queue_plain(tc.queue, ws0.clone(), wsm, **kw)
    b, dump = run_queue_plain(tc.queue, ws0.clone(), wsm, profile=True, **kw)
    assert torch.equal(a, b)
    np.testing.assert_array_equal(dump.numpy(),
                                  profile_dump(tc.queue, tc.num_exec))


def test_decoder_profile_keeps_the_step_dump():
    """MegakernelDecoder(profile=True): each step's dump is the dispatch
    record of that step's retargeted queue, kept on ``last_profile``; the
    tokens are the unprofiled decoder's."""
    cfg = ModelConfig(hidden_size=256, intermediate_size=256, num_layers=1,
                      num_heads=2, num_kv_heads=1, head_dim=128,
                      vocab_size=512, dtype="float32")
    params = init_dense_llm(cfg, generator=torch.Generator().manual_seed(1),
                            device="cpu")
    cache = KVCache(k=torch.zeros((1, 1, 256, 1, 128)),
                    v=torch.zeros((1, 1, 256, 1, 128)), offset=0)
    toks = {}
    for profile in (False, True):
        dec = MegakernelDecoder(cfg, params, max_seq=256, device="cpu",
                                profile=profile)
        ws, tok, out = dec.start(cache), torch.tensor([7]), []
        for pos in (0, 1):
            ws, tok = dec.step(ws, tok, pos)
            out.append(int(tok[0]))
            if profile:
                q = advance_queue_pos(dec.comp.queue, pos,
                                      num_exec=dec.comp.num_exec)
                dump = dec.last_profile.numpy()
                np.testing.assert_array_equal(
                    dump, profile_dump(q, dec.comp.num_exec))
                assert [r.to_json() for r in kp.decode_records(dump)] == \
                    [r.to_json() for r in
                     kp.records_from_queue(q, dec.comp.num_exec)]
            else:
                assert dec.last_profile is None
        toks[profile] = out
    assert toks[True] == toks[False]


# ---------------------------------------------------------------------------
# obs/kernel_profile against the JAX module.
# ---------------------------------------------------------------------------

def _json(records):
    return [r.to_json() for r in records]


@pytest.mark.parametrize("name", ["decode", "warms"])
def test_records_and_profiles_equal_jax(dumps, name, tmp_path):
    tc, got, want = dumps[name]
    assert _json(kp.decode_records(got)) == _json(jkp.decode_records(want))
    assert _json(kp.records_from_queue(tc.queue, tc.num_exec)) == \
        _json(jkp.records_from_queue(np.asarray(tc.queue), tc.num_exec))
    for itemsize in (2, 4):
        recs = kp.attach_durations(kp.decode_records(got), itemsize=itemsize,
                                   spec=SPEC)
        jrecs = jkp.attach_durations(jkp.decode_records(want),
                                     itemsize=itemsize, spec=JSPEC)
        assert _json(recs) == _json(jrecs)
    measured = {"GEMM_MAT": 1.5e-5, "GEMM_WIDE": 2e-6}
    prof = kp.KernelProfile(
        records=kp.attach_durations(kp.decode_records(got), spec=SPEC,
                                    measured=measured),
        rank=0, step_index=3, measured_step_s=1e-3)
    jprof = jkp.KernelProfile(
        records=jkp.attach_durations(jkp.decode_records(want), spec=JSPEC,
                                     measured=measured),
        rank=0, step_index=3, measured_step_s=1e-3)
    assert prof.summary() == jprof.summary()
    # The stall slice's note names the JAX kernel's history; the rest of
    # every event is the same.
    events = prof.to_chrome_events(t0_us=5.0)
    jevents = jprof.to_chrome_events(t0_us=5.0)
    for e in events + jevents:
        e.get("args", {}).pop("note", None)
    assert events == jevents
    assert prof.accounting(host_s=2e-4) == jprof.accounting(host_s=2e-4)
    assert prof.accounting()["unclassified"] == 0
    path = prof.save(str(tmp_path))
    back = kp.load_profile(path)
    assert _json(back.records) == _json(prof.records)
    assert back.summary() == prof.summary()


def test_estimates_equal_jax_for_every_type():
    """Every task type's estimate (the AllReduce pair on the one-link
    model) is the JAX module's under the shared spec."""
    for tt in TaskType:
        words = [int(tt), 5, 6, 7, 3, 1, 2, (2 << 24) | 4, 0, 0]
        rec = kp.records_from_queue(np.asarray([words], np.int32))[0]
        jrec = jkp.records_from_queue(np.asarray([words], np.int32))[0]
        assert rec.task_class == jrec.task_class != "other", tt
        for itemsize in (1, 2, 4):
            assert kp.estimate_task_seconds(rec, itemsize, SPEC) == \
                jkp.estimate_task_seconds(jrec, itemsize, JSPEC), tt


def test_decode_errors_and_from_dump(dumps):
    with pytest.raises(ValueError, match="stamp dump"):
        kp.decode_records(np.zeros((3, 5), np.int32))
    with pytest.raises(ValueError, match="packed"):
        kp.records_from_queue(np.zeros((3,), np.int32))
    tc, got, _ = dumps["decode"]
    prof = kp.KernelProfile.from_dump(got, itemsize=4)
    assert [r.seq for r in prof.records] == list(range(tc.num_exec))
    assert all(r.duration_kind == "estimated" for r in prof.records)
    assert MEGA_KERNEL.plain_calls > 0
