"""Port's continuous-batching tier vs the JAX package: per-request greedy
tokens through the port's ``ServingEngine`` must be identical to the JAX
package's sequential ``Engine.serve`` (the ``tests/test_serving.py``
shapes: 4 requests through 2 slots; preempt/resume under a 7-page pool),
and the port's host allocator / scheduler must replay the JAX package's
state op for op.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from triton_distributed_tpu.models.config import tiny_config as jtiny
from triton_distributed_tpu.models.dense import init_dense_llm as jinit
from triton_distributed_tpu.models.engine import Engine as JEngine
from triton_distributed_tpu.models.kv_cache import (
    PageAllocator as JPageAllocator, PageBudgetError as JPageBudgetError,
)
from triton_distributed_tpu.runtime import initialize_distributed
from triton_distributed_tpu.serving.request import Request as JRequest
from triton_distributed_tpu.serving.scheduler import Scheduler as JScheduler
from triton_distributed_tpu_torch.models.config import tiny_config
from triton_distributed_tpu_torch.models.convert import params_from_numpy
from triton_distributed_tpu_torch.models.engine import Engine
from triton_distributed_tpu_torch.models.kv_cache import (
    PageAllocator, PageBudgetError,
)
from triton_distributed_tpu_torch.serving import (
    AdmitResult, Request, RequestState, ServingConfigError, ServingEngine,
)
from triton_distributed_tpu_torch.serving.scheduler import Scheduler


@pytest.fixture(scope="module")
def engines():
    """(port engine, JAX engine) over the same tiny weights."""
    ctx1 = initialize_distributed(mesh_shape=(1,), axis_names=("tp",),
                                  devices=jax.devices()[:1])
    jcfg = jtiny()
    jparams = jinit(jax.random.PRNGKey(7), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                tiny_config(), device="cpu")
    jeng = JEngine(jcfg, jparams, ctx1, backend="xla", max_seq=64,
                   page_size=4)
    teng = Engine(tiny_config(), tparams, device="cpu", max_seq=64,
                  page_size=4)
    return teng, jeng


def _prompts(seed, n, lengths=(6, 9), vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.choice(lengths))).tolist()
            for _ in range(n)]


def _golden(jeng, prompts, gens):
    return [np.asarray(jeng.serve(jnp.asarray([p], jnp.int32),
                                  gen_len=g))[0].tolist()
            for p, g in zip(prompts, gens)]


def _serve_all(se, prompts, gens, priorities=None):
    reqs = []
    for i, (p, g) in enumerate(zip(prompts, gens)):
        req, res = se.submit(p, g, priority=priorities[i] if priorities
                             else 0)
        assert res is AdmitResult.ADMITTED
        reqs.append(req)
    se.run(max_iters=2000)
    assert all(r.state is RequestState.FINISHED for r in reqs)
    return reqs


# Each scenario: (ServingEngine kwargs, prompts, gens, priorities).
SCENARIOS = {
    # 4 heterogeneous requests through 2 slots: admission queues, slices
    # interleave with decode.
    "parity_2_slots": (dict(max_batch=2, prefill_chunk=4),
                       _prompts(0, 4), [5, 3, 7, 4], None),
    # A pool far smaller than the aggregate demand: eviction mid-decode,
    # recompute on resume.
    "preempt_resume": (dict(max_batch=3, num_pages=7, prefill_chunk=4),
                       _prompts(3, 5, lengths=(8, 12)), [8, 6, 8, 6, 7],
                       None),
    # Under pressure the high-priority request is never the victim.
    "priority_shield": (dict(max_batch=2, num_pages=5, prefill_chunk=4),
                        [[1, 2, 3, 4, 5, 6], [7, 8, 9, 10, 11, 12]], [8, 8],
                        [1, 0]),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_serving_tokens_vs_jax_sequential(engines, scenario):
    teng, jeng = engines
    kw, prompts, gens, prio = SCENARIOS[scenario]
    reqs = _serve_all(ServingEngine(teng, **kw), prompts, gens, prio)
    assert all(r.t_first_token is not None and r.t_finish is not None
               for r in reqs)
    if scenario == "preempt_resume":
        assert sum(r.preemptions for r in reqs) >= 1, \
            "pool sizing no longer forces a preemption"
    if scenario == "priority_shield":
        assert reqs[0].preemptions == 0 and reqs[1].preemptions >= 1
    for r, exp in zip(reqs, _golden(jeng, prompts, gens)):
        assert r.tokens == exp, \
            f"{r.req_id} diverged (preemptions={r.preemptions})"


def test_serving_config_errors(engines):
    teng, _ = engines
    with pytest.raises(ServingConfigError, match="prefill_chunk"):
        ServingEngine(teng, prefill_chunk=6)      # not a page multiple
    with pytest.raises(ServingConfigError, match="max_batch"):
        ServingEngine(teng, max_batch=0)


def _alloc_ops(seed, n_ops=200, owners=5):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n_ops):
        kind = rng.choice(["alloc", "alloc", "free", "free_tail"])
        owner = f"r{rng.integers(owners)}"
        ops.append((str(kind), owner, int(rng.integers(0, 4))))
    return ops


def _apply(alloc, op, budget_error):
    kind, owner, n = op
    if kind == "alloc":
        try:
            return alloc.alloc_pages(owner, n)
        except budget_error:
            return "budget"
    if kind == "free":
        return alloc.free_pages(owner)
    return alloc.free_tail(owner, n)


@pytest.mark.parametrize("seed,reserved", [(0, ()), (1, (3,)), (2, (0, 7))])
def test_page_allocator_replay_vs_jax(seed, reserved):
    """The same op sequence on both allocators: identical return values
    and identical state after every op."""
    port = PageAllocator(10, 4, reserved=reserved)
    ref = JPageAllocator(10, 4, reserved=reserved)
    assert port.usable_pages == ref.usable_pages
    for op in _alloc_ops(seed):
        assert (_apply(port, op, PageBudgetError)
                == _apply(ref, op, JPageBudgetError)), op
        assert port.free_count == ref.free_count
        assert port._free == ref._free
        for o in (f"r{i}" for i in range(5)):
            assert port.pages(o) == ref.pages(o)


@pytest.mark.parametrize("seed", [0, 1])
def test_scheduler_replay_vs_jax(seed):
    """Admissions, page growth and preemption victims replay identically:
    random prompts over an undersized pool, with tokens and KV lengths
    advanced by hand as the loop would."""
    rng = np.random.default_rng(seed)

    def make(sched_cls, alloc_cls):
        return sched_cls(num_slots=3, allocator=alloc_cls(6, 4),
                         page_size=4, capacity_tokens=16, max_waiting=8)

    port, ref = make(Scheduler, PageAllocator), make(JScheduler,
                                                     JPageAllocator)
    specs = [(rng.integers(0, 9, int(rng.integers(5, 10))).tolist(),
              int(rng.integers(4, 8)), int(rng.integers(0, 2)))
             for _ in range(6)]
    preqs = [Request(prompt=p, max_new_tokens=g, priority=pr,
                     req_id=f"q{i}") for i, (p, g, pr) in enumerate(specs)]
    jreqs = [JRequest(prompt=p, max_new_tokens=g, priority=pr,
                      req_id=f"q{i}") for i, (p, g, pr) in enumerate(specs)]
    for pr, jr in zip(preqs, jreqs):
        assert port.admit(pr, 0.0).value == ref.admit(jr, 0.0).value
    for _ in range(30):
        got = [r.req_id for r in port.schedule_admissions()]
        assert got == [r.req_id for r in ref.schedule_admissions()]
        for sched, reqs in ((port, preqs), (ref, jreqs)):
            head = sched.prefill_head()
            if head is not None:          # the whole text prefills at once
                head.tokens.append(1)
                head.kv_len = len(head.text) - 1
                head.advance(type(head.state).RUNNING)
        ready, pre = port.ensure_decode_pages()
        jready, jpre = ref.ensure_decode_pages()
        assert [r.req_id for r in ready] == [r.req_id for r in jready]
        assert [r.req_id for r in pre] == [r.req_id for r in jpre]
        for sched, rs in ((port, ready), (ref, jready)):
            for r in rs:
                r.tokens.append(1)
                r.kv_len += 1
                if r.done:
                    sched.finish(r, 0.0)
        assert ([(r.req_id, r.state.value, r.slot, r.kv_len, r.preemptions)
                 for r in preqs]
                == [(r.req_id, r.state.value, r.slot, r.kv_len, r.preemptions)
                    for r in jreqs])
        assert port.allocator._free == ref.allocator._free
    assert not port.has_work() and not ref.has_work()
    assert sum(r.preemptions for r in preqs) >= 1, \
        "pool sizing no longer forces a preemption"
