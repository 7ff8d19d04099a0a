"""Qwen3-MoE over ranks in the port against the JAX package on the
conftest's CPU mesh, at n = 2 and 4 (the port's ranks are CPU threads,
its kernels' plain versions run):

- ``moe_tp_fwd`` in every mode (``ring``, ``overlap``, ``xla``, ``ar``,
  ``xla_rep``) on ``tests/test_moe.py``'s ``moe_case`` shapes (m 64,
  h 64, ffn 128, 16 experts, top-2): float32 at atol = rtol = 1e-5 (the
  two frameworks' matmuls sum in different orders), bfloat16 at atol =
  rtol = 2^-6 (a few bf16 roundings of the products apart: the combine
  keeps the reference's order of adds, the matmuls do not); the
  sequential ``overlap`` form at n = 2 gathers through B4's full-mesh
  push (its plain version counted);
- the pieces the modes share (``ag_group_gemm_local`` and its ring form,
  ``moe_reduce_rs_overlap_local``) against the JAX package's;
- ``ep_moe_fwd`` at n = 1, 2 and 4, barrier and stream (the parity
  AllToAll threaded through three calls), with ``return_overflow``, and a
  capacity that drops copies: float32 at 1e-5, bfloat16 at 2^-6 (the
  top-k combine is a reduce in both, added in another order);
- ``Engine.serve`` on ``tiny_config(num_experts=8, ...)`` (one layer) at
  n = 2 and 4 with the defaults (an ``"overlap"`` prefill: the ring
  TP-MoE) and on ``backend="xla"``: tokens identical to the JAX
  package's Engine on the mesh (``backend="xla"``: its Pallas overlap
  prefill costs ~20 s a layer here) and to the port at one rank;
  ``ServingEngine`` at n = 4 with a preemption, and with ``spec_k=2``:
  tokens identical to one rank;
- ``shard_params(consume=True)``: the MoE tree sharded leaf by leaf, the
  source emptied.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as JP

from triton_distributed_tpu.layers import ep_moe as jep
from triton_distributed_tpu.models.config import tiny_config as jtiny
from triton_distributed_tpu.models.dense import init_dense_llm as jinit
from triton_distributed_tpu.models.engine import Engine as JEngine
from triton_distributed_tpu.ops import all_to_all as ja2a
from triton_distributed_tpu.ops import moe as jmoe
from triton_distributed_tpu.runtime import shard_map_on
from triton_distributed_tpu.runtime.context import DistContext as JDistContext
from triton_distributed_tpu_torch.layers import ep_moe as tep
from triton_distributed_tpu_torch.models import dense as tdense
from triton_distributed_tpu_torch.models.config import tiny_config
from triton_distributed_tpu_torch.models.convert import (
    params_from_numpy, shard_params,
)
from triton_distributed_tpu_torch.models.engine import Engine
from triton_distributed_tpu_torch.ops import _comm
from triton_distributed_tpu_torch.ops import all_to_all as ta2a
from triton_distributed_tpu_torch.ops import moe as tmoe
from triton_distributed_tpu_torch.runtime.context import DistContext
from triton_distributed_tpu_torch.serving import ServingEngine

F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=2.0 ** -6, rtol=2.0 ** -6)
TYPES = {"float32": (jnp.float32, torch.float32),
         "bfloat16": (jnp.bfloat16, torch.bfloat16)}
REPLICATED = ("ar", "xla_rep")
_CTX: dict = {}


def jctx(n: int) -> JDistContext:
    return JDistContext(mesh=Mesh(np.array(jax.devices()[:n]), ("tp",)))


def tctx(n: int) -> DistContext:
    if n not in _CTX:
        _CTX[n] = DistContext([torch.device("cpu")] * n,
                              wait_timeout_ms=60_000)
    return _CTX[n]


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.fixture(scope="module")
def case():
    """``tests/test_moe.py``'s moe_case: m 64, h 64, ffn 128, E 16, top-2."""
    E, topk, m, h, ffn = 16, 2, 64, 64, 128
    rng = np.random.default_rng(0)
    return dict(
        E=E, topk=topk,
        x=rng.standard_normal((m, h)).astype(np.float32) * 0.5,
        router=rng.standard_normal((h, E)).astype(np.float32) * 0.2,
        wg=rng.standard_normal((E, h, ffn)).astype(np.float32) * h ** -0.5,
        wu=rng.standard_normal((E, h, ffn)).astype(np.float32) * h ** -0.5,
        wd=rng.standard_normal((E, ffn, h)).astype(np.float32)
        * ffn ** -0.5)


def _args(case, framework: str, dtype: str):
    jdt, tdt = TYPES[dtype]
    keys = ("x", "router", "wg", "wu", "wd")
    if framework == "jax":
        return [jnp.asarray(case[k], jdt) for k in keys]
    return [torch.from_numpy(case[k]).to(tdt) for k in keys]


def _jax_moe_tp(case, n: int, mode: str, dtype: str) -> np.ndarray:
    """The JAX package's moe_tp_fwd_local under shard_map; the replicated
    modes get every row on every device. Returns (n, rows, h) per
    device."""
    x, g, wg, wu, wd = _args(case, "jax", dtype)
    xs = JP() if mode in REPLICATED else JP("tp")

    def body(xl, gl, a, b, c):
        return jmoe.moe_tp_fwd_local(xl, gl, a, b, c, case["topk"],
                                     axis="tp", num_ranks=n, mode=mode)[None]

    fn = shard_map_on(jctx(n), body,
                      (xs, JP(), JP(None, None, "tp"), JP(None, None, "tp"),
                       JP(None, "tp", None)), JP("tp"))
    return _f32(fn(x, g, wg, wu, wd))


@pytest.mark.parametrize("mode", ["ring", "overlap", "xla", "ar", "xla_rep"])
@pytest.mark.parametrize("n", [2, 4])
def test_moe_tp_fwd_vs_jax(case, n, mode):
    want = _jax_moe_tp(case, n, mode, "float32")
    mesh0 = _comm.AG_FULL_MESH_KERNEL.plain_calls
    got = tmoe.moe_tp_fwd(*_args(case, "torch", "float32"), case["topk"],
                          tctx(n), mode=mode)
    for r, out in enumerate(got):
        np.testing.assert_allclose(_f32(out), want[r], **F32_TOL,
                                   err_msg=f"rank {r}")
    if mode in REPLICATED:       # the replicas bit-identical
        assert all(torch.equal(got[0], o) for o in got[1:])
    if mode == "overlap" and n == 2:
        assert _comm.AG_FULL_MESH_KERNEL.plain_calls - mesh0 == n


@pytest.mark.parametrize("mode", ["ring", "ar"])
def test_moe_tp_fwd_bf16_vs_jax(case, mode):
    n = 4
    want = _jax_moe_tp(case, n, mode, "bfloat16")
    got = tmoe.moe_tp_fwd(*_args(case, "torch", "bfloat16"), case["topk"],
                          tctx(n), mode=mode)
    for r, out in enumerate(got):
        assert out.dtype == torch.bfloat16
        np.testing.assert_allclose(_f32(out), want[r], **BF16_TOL,
                                   err_msg=f"rank {r}")


def test_moe_pieces_vs_jax(case):
    """AG + grouped GEMM, sequential and per-source ring, at n = 2 against
    the JAX package's ring form (its own test holds the two equal; its
    interpret-mode AG is the slow part), the two in one global sort
    order; the overlapped RS tail against the sequential combine + RS."""
    n, topk = 2, case["topk"]
    x, g, wg, _, _ = _args(case, "jax", "float32")
    m = case["x"].shape[0]
    _, _, _, _, tw = jmoe.route_and_sort(x, g, topk)
    ids = np.asarray(jax.lax.top_k(x @ g, topk)[1]).reshape(-1)

    def jbody(xl, a):
        return jmoe.ag_group_gemm_ring_local(xl, jnp.asarray(ids), a, tw,
                                             num_ranks=n)[0][None]

    jy = _f32(shard_map_on(jctx(n), jbody, (JP("tp"), JP(None, None, "tp")),
                           JP("tp"))(x, wg))
    tx, _, twg, _, twd = _args(case, "torch", "float32")
    ttw = torch.from_numpy(np.array(tw))
    tids = torch.from_numpy(ids.astype(np.int32))
    rows, f = m // n, twg.shape[2] // n

    def body(r):
        xl = tx[r * rows:(r + 1) * rows]
        a = twg[:, :, r * f:(r + 1) * f]
        c = twd[:, r * f:(r + 1) * f]
        y0, s0, g0 = tmoe.ag_group_gemm_local(xl, tids, a, ttw, num_ranks=n)
        y1, s1, _ = tmoe.ag_group_gemm_ring_local(xl, tids, a, ttw,
                                                  num_ranks=n)
        assert torch.equal(s0, s1)
        tail = tmoe.moe_reduce_rs_overlap_local(y0, s0, g0, c, ttw, m,
                                                num_ranks=n)
        seq = tmoe.moe_reduce_rs_local(y0, s0, g0, c, ttw, m, num_ranks=n)
        return y0, y1, tail, seq

    for r, (y0, y1, tail, seq) in enumerate(tctx(n).run(body)):
        np.testing.assert_allclose(_f32(y0), jy[r], **F32_TOL)
        np.testing.assert_allclose(_f32(y1), jy[r], **F32_TOL)
        np.testing.assert_allclose(_f32(tail), _f32(seq), **F32_TOL)


def _ep_params(case, framework: str, dtype: str):
    _, g, wg, wu, wd = _args(case, framework, dtype)
    return {"router": g, "w_gate": wg, "w_up": wu, "w_down": wd}


_JAX_EP: dict = {}


def _jax_ep(case, n: int, dtype: str) -> tuple:
    """The JAX package's ep_moe_fwd (the barrier form: its own test holds
    the stream form equal to it), each device routing its m/n rows, once
    per (n, dtype). Returns (out (1, m, h), overflow per device)."""
    if (n, dtype) in _JAX_EP:
        return _JAX_EP[n, dtype]
    topk = case["topk"]
    x = _args(case, "jax", dtype)[0]
    params = _ep_params(case, "jax", dtype)
    if n == 1:
        y, ovf = jep.ep_moe_fwd(params, x, topk, num_ranks=1,
                                return_overflow=True)
        out = _f32(y)[None], np.asarray([ovf])
    else:
        def body(p, xl):
            y, ovf = jep.ep_moe_fwd(p, xl, topk, num_ranks=n,
                                    return_overflow=True)
            return y[None], ovf[None]

        fn = shard_map_on(jctx(n), body, (jep.ep_moe_specs("tp"), JP("tp")),
                          (JP(None, "tp"), JP("tp")))
        y, ovf = fn(params, x)
        out = _f32(y), np.asarray(ovf)
    _JAX_EP[n, dtype] = out
    return out


def _torch_ep(case, n: int, dtype: str, *, stream: bool, capacity=None,
              tag: str = ""):
    topk = case["topk"]
    x = _args(case, "torch", dtype)[0]
    params = _ep_params(case, "torch", dtype)
    if n == 1:
        y, ovf = tep.ep_moe_fwd(params, x, topk, return_overflow=True)
        return _f32(y)[None], np.asarray([int(ovf)])
    m, h = case["x"].shape
    rows, epr = m // n, case["E"] // n
    cap = capacity or -(-(rows * topk) // 16) * 16
    ctx = tctx(n)
    ws, idx0 = ta2a.a2a_stream_workspace(n, cap, h, x.dtype, ctx=ctx,
                                         tag=f"ep-{dtype}-{tag}")

    def body(r):
        p = {k: (v if k == "router" else v[r * epr:(r + 1) * epr])
             for k, v in params.items()}
        xl = x[r * rows:(r + 1) * rows]
        if not stream:
            return tep.ep_moe_fwd(p, xl, topk, num_ranks=n,
                                  capacity=capacity, return_overflow=True)
        state, ys = (ws, idx0), []
        for _ in range(3):
            y, state, ovf = tep.ep_moe_fwd(p, xl, topk, num_ranks=n,
                                           capacity=capacity,
                                           a2a_state=state,
                                           return_overflow=True)
            ys.append(y)
        assert state[1] == idx0 + 6
        return torch.stack(ys), ovf

    outs = ctx.run(body)
    ys = [o[0] if stream else o[0][None] for o in outs]
    return (np.concatenate([_f32(y) for y in ys], axis=1),
            np.asarray([int(o[1]) for o in outs]))


@pytest.mark.parametrize("n,stream", [(1, False), (2, False), (2, True),
                                      (4, False), (4, True)],
                         ids=["n1", "n2_barrier", "n2_stream", "n4_barrier",
                              "n4_stream"])
def test_ep_moe_fwd_vs_jax(case, n, stream):
    # The JAX package's layer at n = 1 and 2 (the AllToAll moves bits, so
    # n = 4 must give the same rows; its interpret-mode kernel is slow).
    want, jovf = _jax_ep(case, min(n, 2), "float32")
    if n > 1:
        np.testing.assert_allclose(want, _jax_ep(case, 1, "float32")[0],
                                   **F32_TOL)
        jovf = np.zeros(n, np.int32)
    a2a = (_comm.A2A_KERNEL.plain_calls, _comm.A2A_PARITY_KERNEL.plain_calls)
    got, ovf = _torch_ep(case, n, "float32", stream=stream, tag=str(n))
    for call in got:          # each call of the stream alike
        np.testing.assert_allclose(call, want[0], **F32_TOL)
    np.testing.assert_array_equal(ovf, jovf)
    assert not ovf.any()
    if n > 1:   # dispatch + combine, every rank (three calls: stream)
        ran = (_comm.A2A_KERNEL.plain_calls - a2a[0],
               _comm.A2A_PARITY_KERNEL.plain_calls - a2a[1])
        assert ran == ((0, 6 * n) if stream else (2 * n, 0))


def test_ep_moe_fwd_bf16_and_overflow_vs_jax(case):
    """bf16 at n = 4 (stream) against the JAX package's bf16 layer (at
    n = 1: the AllToAll moves bits, so only the rounding of the products
    and the combine's order can differ); and at n = 2 a capacity of 16
    rows a slot — below the ~32 copies a rank sends each peer — whose
    drop counts equal the JAX package's dispatch layout's, every token
    with no dropped copy keeping its lossless output."""
    want, _ = _jax_ep(case, 1, "bfloat16")
    got, _ = _torch_ep(case, 4, "bfloat16", stream=True, tag="bf16")
    for call in got:
        np.testing.assert_allclose(call, want[0], **BF16_TOL)
    n, topk, cap = 2, case["topk"], 16
    full, _ = _torch_ep(case, n, "float32", stream=False)
    got, ovf = _torch_ep(case, n, "float32", stream=False, capacity=cap)
    x = jnp.asarray(case["x"])
    m = x.shape[0] // n
    jovf, kept = [], []
    for r in range(n):
        xr = x[r * m:(r + 1) * m]
        ids, _ = jep.router_topk(xr, jnp.asarray(case["router"]), topk)
        lay = ja2a.dispatch_layout(jnp.repeat(xr, topk, axis=0),
                                   ids.reshape(-1), case["E"], n, cap)
        jovf.append(int(lay.overflow))
        dropped = np.zeros(m * topk, bool)
        dropped[np.asarray(lay.sort_idx)] = np.asarray(lay.pos_in_slot) >= cap
        kept.append(~dropped.reshape(m, topk).any(1))
    assert sum(jovf) > 0
    np.testing.assert_array_equal(ovf, jovf)
    kept = np.concatenate(kept)
    assert kept.any()
    np.testing.assert_allclose(got[0][kept], full[0][kept], **F32_TOL)
    assert tep.ep_moe_specs("tp") == {
        k: tuple(v) for k, v in jep.ep_moe_specs("tp").items()}


# ---------------------------------------------------------------------------
# The engine and the serving loop on a TP group.
# ---------------------------------------------------------------------------

MOE = dict(num_experts=8, num_experts_per_tok=2, moe_intermediate_size=64,
           num_layers=1)


@pytest.fixture(scope="module")
def models():
    jcfg = jtiny(**MOE)
    jparams = jinit(jax.random.PRNGKey(11), jcfg)
    tcfg = tiny_config(**MOE)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.mark.parametrize("n", [2, 4])
def test_engine_serve_moe_tp_vs_jax(models, n):
    """Defaults (the 2 x 16 prompt's prefill in "overlap": the ring
    TP-MoE, then the linear decode's parity AR) and backend="xla", both
    against the JAX package's Engine on an n-device mesh and the port at
    one rank."""
    jcfg, jparams, tcfg, tparams = models
    ids = np.random.default_rng(4).integers(0, 256, (2, 16)).astype(np.int32)
    want = np.asarray(JEngine(jcfg, jparams, jctx(n), backend="xla",
                              max_seq=64).serve(jnp.asarray(ids), 6))
    one = Engine(tcfg, tparams, device="cpu", max_seq=64).serve(ids, 6)
    np.testing.assert_array_equal(one.numpy(), want)
    ring0 = (_comm.RS_RING_KERNEL.plain_calls,
             _comm.PARITY_KERNEL.plain_calls)
    eng = Engine(tcfg, tparams, tctx(n), max_seq=64)
    assert eng._prefill_mode(2, 16) == "overlap"
    np.testing.assert_array_equal(eng.serve(ids, 6).numpy(), want)
    # The ring TP-MoE's tail (one RS a layer), the decode's MoE and
    # attention reductions through the parity stream (two a layer a step).
    L = tcfg.num_layers
    assert (_comm.RS_RING_KERNEL.plain_calls - ring0[0],
            _comm.PARITY_KERNEL.plain_calls - ring0[1]) == (
        n * L, n * 2 * L * 5)
    xla = Engine(tcfg, tparams, tctx(n), max_seq=64, backend="xla")
    np.testing.assert_array_equal(xla.serve(ids, 6).numpy(), want)


SERVE_PROMPTS = [np.random.default_rng(3).integers(0, 256, k).tolist()
                 for k in (8, 12, 12, 8, 12)]
SERVE_GENS = [8, 6, 8, 6, 7]
SERVE_KW = dict(max_batch=3, num_pages=7, prefill_chunk=4)


def _serve(se, prompts, gens):
    reqs = [se.submit(p, g)[0] for p, g in zip(prompts, gens)]
    se.run(max_iters=2000)
    return reqs


@pytest.mark.parametrize("spec_k", [0, 2])
def test_serving_moe_tp_vs_one_rank(models, spec_k):
    """ServingEngine at n = 4 with a preemption (slices, paged decode,
    resume), and with speculative decode: one rank's tokens."""
    _, _, tcfg, tparams = models
    prompts = ([([3, 9, 4] * 5)[:k] for k in (8, 12, 12, 8, 12)]
               if spec_k else SERVE_PROMPTS)
    kw = dict(SERVE_KW, spec_k=spec_k)
    one = Engine(tcfg, tparams, device="cpu", max_seq=64, page_size=4)
    want = _serve(ServingEngine(one, **kw), prompts, SERVE_GENS)
    four = Engine(tcfg, tparams, tctx(4), max_seq=64, page_size=4)
    got = _serve(ServingEngine(four, **kw), prompts, SERVE_GENS)
    assert sum(r.preemptions for r in got) >= 1
    for a, b in zip(got, want):
        assert a.tokens == b.tokens, a.req_id
    if spec_k:
        assert sum(r.accepted_draft_tokens for r in got) > 0


def test_shard_params_moe_consume(models):
    """The MoE tree per dense_llm_specs (experts on their ffn dim, the
    router replicated), leaf by leaf; with consume=True the source tree
    ends empty and the shards are the same."""
    _, _, tcfg, tparams = models
    n = 4
    ctx = tctx(n)
    keep = shard_params(tparams, ctx, tcfg)
    moe0 = keep[1]["layers"][0]["moe"]
    full = tparams["layers"][0]["moe"]
    f = tcfg.moe_intermediate_size // n
    assert torch.equal(moe0["w_gate"], full["w_gate"][:, :, f:2 * f])
    assert torch.equal(moe0["w_down"], full["w_down"][:, f:2 * f])
    assert moe0["router"] is full["router"]

    def copy(node):      # the containers, not the tensors
        if isinstance(node, dict):
            return {k: copy(v) for k, v in node.items()}
        if isinstance(node, list):
            return [copy(v) for v in node]
        return node

    tree = copy(tparams)
    got = shard_params(tree, ctx, tcfg, consume=True)
    assert tree == {}
    for r in range(n):
        for a, b in zip(jax.tree.leaves(jax.tree.map(lambda t: t.numpy(),
                                                     got[r])),
                        jax.tree.leaves(jax.tree.map(lambda t: t.numpy(),
                                                     keep[r]))):
            np.testing.assert_array_equal(a, b)
    specs = tdense.dense_llm_specs(tcfg)["layers"][0]["moe"]
    assert specs["router"] == () and specs["w_gate"] == (None, None, "tp")
