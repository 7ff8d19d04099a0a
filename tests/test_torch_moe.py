"""Port's eager Qwen3-MoE path vs the JAX package's: ``ops/moe`` piece by
piece (routing, the grouped products, the combine, the whole n = 1 FFN),
the MoE parameters and their conversion, ``Engine.serve`` on a tiny MoE
model (``tests/test_model_engine.py``'s shapes) and ``ServingEngine`` over
it (4 requests through 2 slots; a pool small enough to preempt) against
the JAX package's sequential serve and serving loop; then the refusals.

Inputs come from numpy with a seed (or the JAX initialiser, crossed with
``params_from_numpy``). Tolerance: float32 throughout, atol = rtol = 1e-5
(summation order only); routing ids, sort order, group sizes and greedy
tokens must be identical.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from triton_distributed_tpu.models.config import tiny_config as jtiny
from triton_distributed_tpu.models.dense import init_dense_llm as jinit
from triton_distributed_tpu.models.engine import Engine as JEngine
from triton_distributed_tpu.ops import moe as jmoe
from triton_distributed_tpu.runtime import initialize_distributed
from triton_distributed_tpu.serving.loop import (
    ServingEngine as JServingEngine,
)
from triton_distributed_tpu_torch.layers.ep_moe import init_ep_moe
from triton_distributed_tpu_torch.megakernel.kernel import (
    MegakernelUnsupportedError,
)
from triton_distributed_tpu_torch.models.config import (
    QWEN3_30B_A3B, tiny_config,
)
from triton_distributed_tpu_torch.models.convert import params_from_numpy
from triton_distributed_tpu_torch.models.dense import init_dense_llm
from triton_distributed_tpu_torch.models.engine import Engine
from triton_distributed_tpu_torch.ops import moe
from triton_distributed_tpu_torch.runtime.context import DistContext
from triton_distributed_tpu_torch.serving import (
    AdmitResult, RequestState, ServingEngine,
)

TOL = dict(atol=1e-5, rtol=1e-5)
MOE = dict(num_experts=16, num_experts_per_tok=2, moe_intermediate_size=64)
M, H, E, F, K = 24, 128, 16, 64, 2


@pytest.fixture(scope="module")
def layer():
    """One MoE FFN's inputs: tokens, router, expert stacks (fp32)."""
    rng = np.random.default_rng(0)
    return dict(
        x=rng.standard_normal((M, H)).astype(np.float32),
        gate_w=rng.standard_normal((H, E)).astype(np.float32) * 0.3,
        w_gate=rng.standard_normal((E, H, F)).astype(np.float32) * 0.1,
        w_up=rng.standard_normal((E, H, F)).astype(np.float32) * 0.1,
        w_down=rng.standard_normal((E, F, H)).astype(np.float32) * 0.1)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_route_and_sort_vs_jax(layer):
    """fp32 router → top-k → softmax over the selected → stable sort:
    identical ids, sort order and group sizes; the same sorted rows and
    weights."""
    jx, jidx, jgs, jtok, jw = jmoe.route_and_sort(
        jnp.asarray(layer["x"]), jnp.asarray(layer["gate_w"]), K)
    tx, tidx, tgs, ttok, tw = moe.route_and_sort(
        _t(layer["x"]), _t(layer["gate_w"]), K)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tgs.numpy(), np.asarray(jgs))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    assert tgs.dtype == torch.int32 and int(tgs.sum()) == M * K
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **TOL)


def test_route_and_sort_ties_go_to_the_lower_expert():
    """Equal router logits select the lower expert ids first, as
    ``jax.lax.top_k`` does."""
    x = torch.ones((3, 4))
    gate_w = torch.zeros((4, 6))
    gate_w[:, [1, 4, 5]] = 0.25               # logits: 1 at experts 1, 4, 5
    _, sort_idx, gs, tok, w = moe.route_and_sort(x, gate_w, 2)
    assert gs.tolist() == [0, 3, 0, 0, 3, 0]
    jout = jmoe.route_and_sort(jnp.ones((3, 4)), jnp.asarray(gate_w.numpy()),
                               2)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(jout[2]))
    np.testing.assert_array_equal(sort_idx.numpy(), np.asarray(jout[1]))
    np.testing.assert_allclose(w.numpy(), 0.5)


def test_grouped_products_and_combine_vs_jax(layer):
    """``ragged_dot_dtype_aware``, ``grouped_mlp(_gate_up)`` and
    ``moe_reduce_rs_local`` (n = 1) on the same expert-sorted rows, with
    empty expert groups among them."""
    x_sorted, sort_idx, gs, _, topk_w = jmoe.route_and_sort(
        jnp.asarray(layer["x"]), jnp.asarray(layer["gate_w"]), K)
    assert (np.asarray(gs) == 0).any(), "want an empty group in the case"
    tx, tidx, tgs = (_t(x_sorted), _t(sort_idx).long(), _t(gs))
    for name in ("w_gate", "w_up"):
        np.testing.assert_allclose(
            moe.ragged_dot_dtype_aware(tx, _t(layer[name]), tgs).numpy(),
            np.asarray(jmoe.ragged_dot_dtype_aware(
                x_sorted, jnp.asarray(layer[name]), gs)), **TOL)
    w = [layer[n] for n in ("w_gate", "w_up", "w_down")]
    np.testing.assert_allclose(
        moe.grouped_mlp(tx, tgs.tolist(), *map(_t, w)).numpy(),
        np.asarray(jmoe.grouped_mlp(x_sorted, gs, *map(jnp.asarray, w))),
        **TOL)
    jact = jmoe.grouped_mlp_gate_up(x_sorted, gs, jnp.asarray(w[0]),
                                    jnp.asarray(w[1]))
    tact = moe.grouped_mlp_gate_up(tx, tgs, _t(w[0]), _t(w[1]))
    np.testing.assert_allclose(tact.numpy(), np.asarray(jact), **TOL)
    jout = jmoe.moe_reduce_rs_local(jact, sort_idx, gs, jnp.asarray(w[2]),
                                    topk_w, M, num_ranks=1)
    tout = moe.moe_reduce_rs_local(tact, tidx, tgs, _t(w[2]),
                                   _t(topk_w), M, num_ranks=1)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)


def test_moe_tp_fwd_local_vs_jax(layer):
    """The whole FFN at n = 1 (the path ``_mlp_or_moe`` runs)."""
    args = [layer[n] for n in ("x", "gate_w", "w_gate", "w_up", "w_down")]
    want = jmoe.moe_tp_fwd_local(*map(jnp.asarray, args), K, num_ranks=1,
                                 mode="overlap")
    got = moe.moe_tp_fwd_local(*map(_t, args), K, num_ranks=1)
    assert got.shape == (M, H) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_sort_by_expert_vs_jax():
    ids = np.random.default_rng(5).integers(0, 7, 40).astype(np.int32)
    jidx, jgs = jmoe.sort_by_expert(jnp.asarray(ids), 9)
    tidx, tgs = moe.sort_by_expert(_t(ids), 9)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tgs.numpy(), np.asarray(jgs))


# ---------------------------------------------------------------------------
# Parameters.
# ---------------------------------------------------------------------------

def test_init_dense_llm_moe_shapes():
    """A MoE config's layers carry ``moe`` (router + stacked experts with
    the JAX shapes) instead of ``mlp``; the JAX tree's leaves match."""
    cfg = tiny_config(**MOE)
    params = init_dense_llm(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    jparams = jinit(jax.random.PRNGKey(0), jtiny(**MOE))
    for lay, jlay in zip(params["layers"], jparams["layers"]):
        assert "mlp" not in lay and set(lay) == set(jlay)
        for k, v in lay["moe"].items():
            assert tuple(v.shape) == tuple(jlay["moe"][k].shape), k
            assert v.dtype == torch.float32
    p = init_ep_moe(256, 192, 32, torch.bfloat16,
                    generator=torch.Generator().manual_seed(1), device="cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "router": (256, 32), "w_gate": (32, 256, 192),
        "w_up": (32, 256, 192), "w_down": (32, 192, 256)}
    assert all(v.dtype == torch.bfloat16 for v in p.values())
    assert abs(float(p["w_down"].float().std()) - 192 ** -0.5) < 2e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_params_cross_bit_for_bit(dtype):
    """The ``moe`` subtree crosses ``params_from_numpy`` with the same
    bits, bf16 included."""
    jcfg = jtiny(dtype=dtype, **MOE)
    jparams = jinit(jax.random.PRNGKey(3), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                tiny_config(dtype=dtype, **MOE), device="cpu")
    for lay, jlay in zip(tparams["layers"], jparams["layers"]):
        for k, v in jlay["moe"].items():
            t = lay["moe"][k]
            assert t.dtype == getattr(torch, dtype)
            want = np.asarray(v)
            if dtype == "bfloat16":
                np.testing.assert_array_equal(
                    t.view(torch.int16).numpy(), want.view(np.int16))
            else:
                np.testing.assert_array_equal(t.numpy(), want)


# ---------------------------------------------------------------------------
# Engine and ServingEngine.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engines():
    """(port engine, JAX engine) over the same tiny MoE weights, page 4."""
    ctx1 = initialize_distributed(mesh_shape=(1,), axis_names=("tp",),
                                  devices=jax.devices()[:1])
    jcfg = jtiny(**MOE)
    jparams = jinit(jax.random.PRNGKey(7), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                tiny_config(**MOE), device="cpu")
    jeng = JEngine(jcfg, jparams, ctx1, backend="xla", max_seq=64,
                   page_size=4)
    teng = Engine(tiny_config(**MOE), tparams, device="cpu", max_seq=64,
                  page_size=4)
    return teng, jeng, ctx1


def test_engine_serve_moe_vs_jax(engines):
    """``Engine.serve`` of 2 x 16-token prompts for 3 tokens (the JAX
    package's MoE engine test) token for token, then 8 tokens; the
    prefill logits within fp32 tolerance."""
    teng, jeng, _ = engines
    ids = np.asarray(jax.random.randint(jax.random.key(8), (2, 16), 0,
                                        teng.cfg.vocab_size), np.int32)
    for gen in (3, 8):
        want = np.asarray(jeng.serve(jnp.asarray(ids), gen))
        got = teng.serve(ids, gen)
        assert got.dtype == torch.int32 and tuple(got.shape) == (2, gen)
        np.testing.assert_array_equal(got.numpy(), want)
    tl, _ = teng.prefill(torch.from_numpy(ids))
    jl, _ = jeng.prefill(jnp.asarray(ids))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def _prompts(seed, n, lengths, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.choice(lengths))).tolist()
            for _ in range(n)]


# (ServingEngine kwargs, prompts, gens): 4 requests through 2 slots; a pool
# of 7 pages under 5 requests (preemption, recompute on resume).
SCENARIOS = {
    "two_slots": (dict(max_batch=2, prefill_chunk=4), _prompts(0, 4, (6, 9)),
                  [5, 3, 7, 4]),
    "preempt": (dict(max_batch=3, num_pages=7, prefill_chunk=4),
                _prompts(3, 5, (8, 12)), [8, 6, 8, 6, 7]),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_serving_engine_moe_vs_jax(engines, scenario):
    """``ServingEngine`` over the MoE engine: every request's tokens equal
    the JAX package's sequential ``Engine.serve`` and its ``ServingEngine``
    run, and the port's own sequential serve."""
    teng, jeng, _ = engines
    kw, prompts, gens = SCENARIOS[scenario]
    se = ServingEngine(teng, **kw)
    jse = JServingEngine(jeng, **kw)
    reqs, jreqs = [], []
    for p, g in zip(prompts, gens):
        req, res = se.submit(p, g)
        assert res is AdmitResult.ADMITTED
        reqs.append(req)
        jreqs.append(jse.submit(p, g)[0])
    se.run(max_iters=2000)
    jse.run(max_iters=2000)
    assert all(r.state is RequestState.FINISHED for r in reqs)
    if scenario == "preempt":
        assert sum(r.preemptions for r in reqs) >= 1, \
            "pool sizing no longer forces a preemption"
        assert [r.preemptions for r in reqs] == \
            [r.preemptions for r in jreqs]
    for r, jr, p, g in zip(reqs, jreqs, prompts, gens):
        golden = np.asarray(jeng.serve(jnp.asarray([p], jnp.int32),
                                       g))[0].tolist()
        assert r.tokens == golden, f"{r.req_id} vs JAX sequential serve"
        assert r.tokens == list(jr.tokens), f"{r.req_id} vs JAX loop"
        assert r.tokens == teng.serve([p], g)[0].tolist()


def test_serving_engine_moe_spec_decode_vs_sequential(engines):
    """``spec_k`` on the MoE engine: the verify step's MoE FFN runs over
    every candidate row, and the accepted tokens equal the one-token
    serve."""
    teng, jeng, _ = engines
    prompts = [[3, 9, 4] * 3, [7, 1] * 5]
    se = ServingEngine(teng, max_batch=2, prefill_chunk=4, spec_k=2)
    reqs = [se.submit(p, 10)[0] for p in prompts]
    se.run(max_iters=2000)
    for r, p in zip(reqs, prompts):
        assert r.tokens == np.asarray(jeng.serve(
            jnp.asarray([p], jnp.int32), 10))[0].tolist()
    assert sum(r.accepted_draft_tokens for r in reqs) > 0


# ---------------------------------------------------------------------------
# Refusals.
# ---------------------------------------------------------------------------

def test_moe_refusals(layer):
    """Two ranks and the ring mode run; the megakernel lanes on a MoE
    model raise by name. (e4m3 expert stacks, once refused here, run B3's
    e4m3 lane: tests/test_torch_fp8_decode.py.)"""
    args = [_t(layer[n]) for n in ("x", "gate_w", "w_gate", "w_up",
                                   "w_down")]
    # Two ranks and mode 'ring', once refused here, now run: at n = 2 (CPU
    # rank threads) the ranks' row halves put together equal the one-rank
    # FFN; mode 'ring' at n = 1 is the one-rank FFN itself.
    one = moe.moe_tp_fwd_local(*args, K, num_ranks=1)
    ctx = DistContext([torch.device("cpu")] * 2, wait_timeout_ms=60_000)
    two = moe.moe_tp_fwd(*args, K, ctx, mode="ring")
    ctx.close()
    np.testing.assert_allclose(torch.cat(two).numpy(), one.numpy(), **TOL)
    assert torch.equal(moe.moe_tp_fwd_local(*args, K, num_ranks=1,
                                            mode="ring"), one)
    # A MoE geometry the megakernel could tile (head_dim 128): refused for
    # being MoE, as the JAX package's validate_megakernel_cfg refuses it.
    cfg = tiny_config(hidden_size=256, num_heads=2, num_kv_heads=1,
                      head_dim=128, **MOE)
    params = init_dense_llm(cfg, generator=torch.Generator().manual_seed(2),
                            device="cpu")
    mk = Engine(cfg, params, device="cpu", max_seq=128, backend="megakernel")
    with pytest.raises(ValueError, match="dense stack"):
        mk.serve([[1, 2, 3]], 2)
    mk_paged = Engine(cfg, params, device="cpu", max_seq=128, page_size=128,
                      backend="megakernel")
    with pytest.raises(MegakernelUnsupportedError, match="dense stack"):
        ServingEngine(mk_paged, max_batch=2, prefill_chunk=128)
    assert QWEN3_30B_A3B.is_moe and QWEN3_30B_A3B.num_experts == 128
