"""The port in bfloat16 against the JAX package in bfloat16.

``layers/common.swiglu`` computes silu as ``x * (1 / (1 + exp(-x)))`` op
by op, the ops ``jax.nn.silu`` lowers to, and is bit-identical to it; the
MoE combine adds each token's rows in expert-sorted order with bf16
rounding, as ``jax.ops.segment_sum``. What still differs is the order of
the fp32 sums inside bf16 matmuls (torch's CPU kernels vs XLA's), which
flips an output's last bit now and then. Per layer (measured on the CPU,
jax 0.9.0 / torch 2.13.0):

- ``tp_mlp_fwd``: no element differs at these shapes; held to one bf16
  unit (atol 1e-5, rtol 8e-3) with at most 1% of elements differing;
- ``tp_attn_prefill``: 0.9% of outputs differ, by at most 3.9e-3 (one
  unit at |x| < 1) — atol 4e-3, rtol 8e-3, at most 3% differing;
- ``moe_tp_fwd_local``: 5 of 16384 differ, by at most 3.9e-3 — atol 4e-3,
  rtol 8e-3, at most 0.5% differing;
- ``dense_decode_step_paged`` (2 layers): logits atol 1.6e-2, rtol 1.6e-2
  (two units), at most 3% differing;
- greedy tokens of ``Engine.serve`` on ``tiny_config`` in bf16: identical
  to JAX's on both decode lanes (2 seeds x 2 prompts x 16 tokens).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from triton_distributed_tpu.layers import common as jcommon
from triton_distributed_tpu.layers import tp_attn as jattn
from triton_distributed_tpu.layers import tp_mlp as jmlp
from triton_distributed_tpu.models import dense as jdense
from triton_distributed_tpu.models.config import tiny_config as jtiny
from triton_distributed_tpu.models.engine import Engine as JEngine
from triton_distributed_tpu.models.kv_cache import (
    PagedModelCache as JPaged, init_kv_cache as jinit,
)
from triton_distributed_tpu.ops import moe as jmoe
from triton_distributed_tpu.runtime import initialize_distributed
from triton_distributed_tpu_torch.layers import common as tcommon
from triton_distributed_tpu_torch.layers import tp_attn as tattn
from triton_distributed_tpu_torch.layers import tp_mlp as tmlp
from triton_distributed_tpu_torch.models import dense as tdense
from triton_distributed_tpu_torch.models.config import tiny_config
from triton_distributed_tpu_torch.models.convert import (
    array_to_tensor, params_from_numpy,
)
from triton_distributed_tpu_torch.models.engine import Engine
from triton_distributed_tpu_torch.models.kv_cache import PagedModelCache
from triton_distributed_tpu_torch.ops import moe as tmoe

BF = jnp.bfloat16


def _t(a):
    return array_to_tensor(np.asarray(a))


def _f(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _hold(port, ref, atol, rtol, max_share):
    got, want = _f(port), _f(ref)
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)
    share = float(np.mean(got != want))
    assert share <= max_share, share
    return share


def _bf(seed, *shape, scale=1.0):
    return jnp.asarray(np.random.default_rng(seed).standard_normal(shape)
                       * scale, BF)


def test_swiglu_bit_identical_to_jax():
    g = _bf(0, 100_000, scale=3.0)
    u = _bf(1, 100_000)
    ref = jcommon.swiglu(g, u)
    got = tcommon.swiglu(_t(g), _t(u))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f(got), _f(ref))
    np.testing.assert_array_equal(_f(tcommon.silu(_t(g))),
                                  _f(jax.nn.silu(g)))


def test_tp_mlp_bf16_vs_jax():
    p = jmlp.init_tp_mlp(jax.random.PRNGKey(5), 128, 256, BF)
    x = _bf(2, 16, 128)
    _hold(tmlp.tp_mlp_fwd({k: _t(v) for k, v in p.items()}, _t(x)),
          jmlp.tp_mlp_fwd(p, x), 1e-5, 8e-3, 0.01)


def test_tp_attn_prefill_bf16_vs_jax():
    jcfg = jtiny(num_kv_heads=4, dtype="bfloat16")
    tcfg = tiny_config(num_kv_heads=4, dtype="bfloat16")
    p = jattn.init_tp_attn(jax.random.PRNGKey(3), jcfg, BF)
    tp = params_from_numpy(jax.tree.map(np.asarray, p), tcfg, device="cpu")
    x = _bf(1, 2 * 12, 128)
    jout, _ = jattn.tp_attn_prefill(p, jcfg, x, 2, 12, None, mode="ar")
    tout, _ = tattn.tp_attn_prefill(tp, tcfg, _t(x), 2, 12)
    _hold(tout, jout, 4e-3, 8e-3, 0.03)


def test_moe_bf16_vs_jax():
    """The case that found the fault: M=64, h=256, E=32, ffn=96, top-8."""
    M, H, E, F, K = 64, 256, 32, 96, 8
    x, gw = _bf(10, M, H), _bf(11, H, E, scale=H ** -0.5)
    wg, wu = _bf(12, E, H, F, scale=H ** -0.5), _bf(13, E, H, F,
                                                   scale=H ** -0.5)
    wd = _bf(14, E, F, H, scale=F ** -0.5)
    ref = jmoe.moe_tp_fwd_local(x, gw, wg, wu, wd, K, num_ranks=1)
    got = tmoe.moe_tp_fwd_local(_t(x), _t(gw), _t(wg), _t(wu), _t(wd), K,
                                num_ranks=1)
    assert got.dtype == torch.bfloat16
    _hold(got, ref, 4e-3, 8e-3, 0.005)


@pytest.fixture(scope="module")
def bf16_models():
    jcfg, tcfg = jtiny(dtype="bfloat16"), tiny_config(dtype="bfloat16")
    jp = jdense.init_dense_llm(jax.random.PRNGKey(7), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


def test_dense_decode_step_paged_bf16_vs_jax(bf16_models):
    """Prefill, then one paged decode step from the same cache, in bf16."""
    jcfg, jp, tcfg, tp = bf16_models
    ids = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 9))
    jlog, jcache = jdense.dense_prefill(jp, jcfg, jnp.asarray(ids),
                                        jinit(jcfg, 2, 16))
    _hold(tdense.dense_prefill(
        tp, tcfg, torch.from_numpy(ids),
        tdense.KVCache(_t(jcache.k) * 0, _t(jcache.v) * 0, 0))[0], jlog,
        1.6e-2, 1.6e-2, 0.03)
    # One decode step from the reference's cache, mirrored into pages of 4.
    k, v = np.asarray(jcache.k), np.asarray(jcache.v)
    L, B, S, hkv, d = k.shape

    def pools(a):
        return a.reshape(L, B * (S // 4), 4, hkv, d)

    table = np.arange(B * (S // 4), dtype=np.int32).reshape(B, S // 4)
    lens = np.full((B,), 9, np.int32)
    tok = np.asarray(jnp.argmax(jlog, -1), np.int32)
    jl, _ = jdense.dense_decode_step_paged(
        jp, jcfg, jnp.asarray(tok),
        JPaged(jnp.asarray(pools(k)), jnp.asarray(pools(v)),
               jnp.asarray(table), jnp.asarray(lens)))
    tl, _ = tdense.dense_decode_step_paged(
        tp, tcfg, torch.from_numpy(tok),
        PagedModelCache(_t(pools(k)), _t(pools(v)), torch.from_numpy(table),
                        torch.from_numpy(lens)))
    _hold(tl, jl, 1.6e-2, 1.6e-2, 0.03)


@pytest.mark.parametrize("seed", [7, 8])
def test_bf16_greedy_tokens_vs_jax(seed):
    """Greedy bf16 streams: 2 prompts x 16 tokens, paged and linear decode,
    identical to the reference's."""
    jcfg, tcfg = jtiny(dtype="bfloat16"), tiny_config(dtype="bfloat16")
    jp = jdense.init_dense_llm(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    ctx1 = initialize_distributed(mesh_shape=(1,), axis_names=("tp",),
                                  devices=jax.devices()[:1])
    ids = np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, (2, 10)).astype(np.int32)
    for page in (4, None):
        ref = np.asarray(JEngine(jcfg, jp, ctx1, backend="xla", max_seq=64,
                                 page_size=page).serve(jnp.asarray(ids),
                                                       gen_len=16))
        out = Engine(tcfg, tp, device="cpu", max_seq=64,
                     page_size=page).serve(ids, 16)
        np.testing.assert_array_equal(out.numpy(), ref)
