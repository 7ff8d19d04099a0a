"""Port's ``ServingEngine(backend="megakernel")`` — the persistent-kernel
decode lane — against the port's eager lane on the same weights: the
slot-reuse and preempt/resume shapes of
``tests/test_megakernel_paged_serving.py``, per-request tokens identical.
Also the lane's named refusals (no demotion ladder in the port) and its
reserved scratch page.
"""

import numpy as np
import pytest
import torch

import jax

from triton_distributed_tpu.models.config import ModelConfig as JConfig
from triton_distributed_tpu.models.dense import init_dense_llm as jinit
from triton_distributed_tpu_torch.megakernel.kernel import (
    MEGA_KERNEL, MegakernelUnsupportedError,
)
from triton_distributed_tpu_torch.models.config import ModelConfig
from triton_distributed_tpu_torch.models.convert import params_from_numpy
from triton_distributed_tpu_torch.models.engine import Engine
from triton_distributed_tpu_torch.ops.paged_attention import PAGED_KERNEL
from triton_distributed_tpu_torch.serving import (
    AdmitResult, RequestState, ServingEngine,
)

SHAPE = dict(hidden_size=256, intermediate_size=256, num_heads=2,
             num_kv_heads=1, head_dim=128, vocab_size=512, qk_norm=True,
             dtype="float32")


def _params(layers, seed, **over):
    shape = dict(SHAPE, **over)
    jcfg = JConfig(num_layers=layers, **shape)
    cfg = ModelConfig(num_layers=layers, **shape)
    jparams = jinit(jax.random.PRNGKey(seed), jcfg)
    return cfg, params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                  device="cpu")


@pytest.fixture(scope="module")
def two_layer():
    return _params(2, 0)


@pytest.fixture(scope="module")
def one_layer():
    return _params(1, 1)


@pytest.fixture(scope="module")
def head_dim_64():
    """The padded-head layout: each 64-wide head in the low half of its
    128-wide tile (the Qwen3-0.6B/1.7B head size)."""
    return _params(2, 2, head_dim=64, num_heads=4, num_kv_heads=2)


def _serve(cfg, params, backend, reqs, **kw):
    eng = Engine(cfg, params, device="cpu", backend=backend, max_seq=256,
                 page_size=128)
    se = ServingEngine(eng, prefill_chunk=128, **kw)
    out = []
    for i, (prompt, n, prio) in enumerate(reqs):
        req, res = se.submit(prompt, n, priority=prio, req_id=f"r{i}")
        assert res is AdmitResult.ADMITTED
        out.append(req)
    se.run(max_iters=500)
    assert all(r.state is RequestState.FINISHED for r in out)
    return out, se


@pytest.mark.parametrize("model", ["two_layer", "head_dim_64"])
def test_megakernel_lane_matches_eager_slot_reuse(model, request):
    """(e) 3 requests through 2 slots (slot reuse): tokens identical to
    the eager lane's, and every decode step went through the megakernel
    (its plain version here, on the CPU) — never through K2's."""
    cfg, params = request.getfixturevalue(model)
    reqs = [([3, 141, 59, 26, 5], 4, 0), ([7, 9, 23], 5, 0),
            ([100, 4], 3, 0)]
    mk_calls, k2_calls = MEGA_KERNEL.plain_calls, PAGED_KERNEL.plain_calls
    mk, se = _serve(cfg, params, "megakernel", reqs, max_batch=2,
                    num_pages=4)
    steps = MEGA_KERNEL.plain_calls - mk_calls
    assert steps >= max(n for _, n, _ in reqs) - 1
    assert PAGED_KERNEL.plain_calls == k2_calls
    assert se._mk is not None and se._cache is None
    eager, _ = _serve(cfg, params, "xla", reqs, max_batch=2, num_pages=4)
    assert [r.tokens for r in mk] == [r.tokens for r in eager]


def test_megakernel_lane_matches_eager_preempt_resume(one_layer):
    """(e) Under page pressure a request is preempted ON the megakernel
    workspace and resumes by recompute into its pool pages; tokens still
    equal the eager lane's."""
    cfg, params = one_layer
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, 512, 126).tolist(), 6, 1),
            (rng.integers(0, 512, 100).tolist(), 4, 0)]
    mk, _ = _serve(cfg, params, "megakernel", reqs, max_batch=2,
                   num_pages=2)
    eager, _ = _serve(cfg, params, "xla", reqs, max_batch=2, num_pages=2)
    assert any(r.preemptions > 0 for r in mk), \
        "pool sizing no longer exercises preemption on the megakernel lane"
    assert [r.tokens for r in mk] == [r.tokens for r in eager]
    assert [r.preemptions for r in mk] == [r.preemptions for r in eager]


def test_megakernel_lane_refuses_by_name(two_layer):
    """Where the JAX package demotes down its backend ladder, the port
    raises MegakernelUnsupportedError (a ValueError): a page size that is
    not the tile, a head_dim the assembly cannot tile, and eager decode
    on a megakernel engine. The overlap backend is not the megakernel:
    at one rank it serves the eager path."""
    cfg, params = two_layer
    eng = Engine(cfg, params, device="cpu", backend="megakernel",
                 max_seq=256, page_size=16)
    with pytest.raises(MegakernelUnsupportedError, match="page_size"):
        ServingEngine(eng, max_batch=2, prefill_chunk=16)
    odd = ModelConfig(num_layers=1, **dict(SHAPE, head_dim=32,
                                           num_heads=8, num_kv_heads=8))
    from triton_distributed_tpu_torch.models.dense import init_dense_llm

    p_odd = init_dense_llm(odd, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    eng = Engine(odd, p_odd, device="cpu", backend="megakernel",
                 max_seq=256, page_size=128)
    with pytest.raises(MegakernelUnsupportedError, match="head_dim"):
        ServingEngine(eng, max_batch=2, prefill_chunk=128)
    eng = Engine(cfg, params, device="cpu", backend="megakernel",
                 max_seq=256, page_size=128)
    with pytest.raises(MegakernelUnsupportedError, match="ServingEngine"):
        eng.serve([[1, 2, 3]], 2)
    overlap = Engine(cfg, params, device="cpu", backend="overlap",
                     max_seq=256, page_size=128)
    eager = Engine(cfg, params, device="cpu", backend="xla", max_seq=256,
                   page_size=128)
    assert torch.equal(overlap.serve([[1, 2, 3]], 2),
                       eager.serve([[1, 2, 3]], 2))


def test_megakernel_lane_defaults_to_cuda(two_layer, monkeypatch):
    """The lane's decoder runs on the card unless given device="cpu":
    without CUDA, device=None raises instead of dropping to the CPU."""
    from triton_distributed_tpu_torch.megakernel.serving import (
        PagedMegakernelDecoder,
    )

    cfg, params = two_layer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        PagedMegakernelDecoder(cfg, params, num_slots=1, num_pages=2,
                               max_pages=2)
    with pytest.raises(RuntimeError, match="is_available"):
        Engine(cfg, params, backend="megakernel", max_seq=256,
               page_size=128)


def test_megakernel_lane_reserves_its_scratch_page(two_layer):
    """The allocator accounts the workspace's scratch page as reserved:
    it is never handed out, and the usable budget is the pool."""
    cfg, params = two_layer
    eng = Engine(cfg, params, device="cpu", backend="megakernel",
                 max_seq=256, page_size=128)
    se = ServingEngine(eng, max_batch=2, num_pages=3, prefill_chunk=128)
    alloc = se.sched.allocator
    assert alloc.reserved == (se.scratch_page,) and se.scratch_page == 3
    assert alloc.usable_pages == 3 and se._mk.scratch == 3
    got = alloc.alloc_pages("a", 2) + alloc.alloc_pages("b", 1)
    assert sorted(got) == [0, 1, 2]
    assert alloc.alloc_pages("b", 1) is None
