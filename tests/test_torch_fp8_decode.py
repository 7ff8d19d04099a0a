"""Port's fp8 weight lane (``models/fp8.quantize_dense_weights``,
``fp8_dot``, ``fp8_emulated_dot``; the e4m3 expert stacks of
``ops/moe.ragged_dot_dtype_aware``) vs the JAX package's — the eight cases
of ``tests/test_fp8_decode.py``, each held against JAX, with weights from
the JAX initialisers converted by ``params_from_numpy``.

On the CPU ``fp8_dot`` runs kernel B3's plain version (the e4m3 x e4m3
product in fp32, then the output cast), so the port's dot is the JAX dot
up to fp32 summation order. Tolerances: e4m3 leaves bit-identical; the
bf16 outputs of ``fp8_dot`` and of a decode step within one bf16 unit
(rtol 8e-3, atol 1e-5); fp32 expert products atol = rtol = 1e-5; greedy
tokens identical.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from triton_distributed_tpu.models import dense as jdense
from triton_distributed_tpu.models import fp8 as jfp8
from triton_distributed_tpu.models.config import ModelConfig as JConfig
from triton_distributed_tpu.models.kv_cache import init_kv_cache as jinit
from triton_distributed_tpu.ops import moe as jmoe
from triton_distributed_tpu_torch.models import dense as tdense
from triton_distributed_tpu_torch.models import fp8 as tfp8
from triton_distributed_tpu_torch.models.config import ModelConfig
from triton_distributed_tpu_torch.models.convert import (
    array_to_tensor, params_from_numpy,
)
from triton_distributed_tpu_torch.models.kv_cache import init_kv_cache
from triton_distributed_tpu_torch.ops import gemm
from triton_distributed_tpu_torch.ops import moe as tmoe

E4M3 = torch.float8_e4m3fn
BF16_TOL = dict(atol=1e-5, rtol=8e-3)
F32_TOL = dict(atol=1e-5, rtol=1e-5)
DENSE = dict(hidden_size=256, intermediate_size=256, num_layers=2,
             num_heads=2, num_kv_heads=1, head_dim=128, vocab_size=512,
             qk_norm=True)
MOE = dict(DENSE, num_layers=1, num_experts=4, num_experts_per_tok=2,
           moe_intermediate_size=128)


def _models(shape):
    jcfg = JConfig(**shape)
    jparams = jdense.init_dense_llm(jax.random.PRNGKey(0), jcfg)
    tcfg = ModelConfig(**shape)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def dense_models():
    return _models(DENSE)


@pytest.fixture(scope="module")
def moe_models():
    return _models(MOE)


def _e4m3_bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        jnp.asarray(t).astype(jnp.float32))


def test_quantize_scope(dense_models):
    """Projections and MLP weights become e4m3, bit for bit the reference's
    quantization; norms, embed and lm_head keep the model dtype."""
    _, jparams, _, tparams = dense_models
    j8, t8 = jfp8.quantize_dense_weights(jparams), \
        tfp8.quantize_dense_weights(tparams)
    for part, keys in (("attn", ("wq", "wk", "wv", "wo")),
                       ("mlp", ("w_gate", "w_up", "w_down"))):
        for k in keys:
            got = t8["layers"][0][part][k]
            assert got.dtype == E4M3
            np.testing.assert_array_equal(
                _e4m3_bits(got), _e4m3_bits(j8["layers"][0][part][k]))
    assert t8["embed"] is tparams["embed"]
    assert t8["layers"][0]["attn_norm"].dtype == torch.bfloat16
    assert t8["layers"][0]["attn"]["q_norm"].dtype != E4M3


def test_fp8_dot_vs_jax():
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((8, 64)) * 0.3, jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((64, 32)) * 0.1, jnp.bfloat16)
    tx, tw = array_to_tensor(np.asarray(x)), array_to_tensor(np.asarray(w))
    got = tfp8.fp8_dot(tx, tw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(jfp8.fp8_dot(x, w)), **BF16_TOL)
    np.testing.assert_allclose(_np(tfp8.fp8_emulated_dot(tx, tw)),
                               _np(jfp8.fp8_emulated_dot(x, w)), **BF16_TOL)
    calls = gemm.GEMM_KERNEL.plain_calls
    tfp8.fp8_dot(tx, tw)
    assert gemm.GEMM_KERNEL.plain_calls == calls + 1   # B3's e4m3 lane


def _jax_decode(cfg, params, dot_fn, steps):
    cache = jinit(cfg, 1, 128)._replace(offset=jnp.int32(16))
    tok, toks, logits = jnp.zeros((1,), jnp.int32), [], []
    for _ in range(steps):
        lg, cache = jdense.dense_decode_step(params, cfg, tok, cache,
                                             num_ranks=1, mode="ar",
                                             dot_fn=dot_fn)
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
        toks.append(int(tok[0]))
        logits.append(_np(lg))
    return toks, logits


def _port_decode(cfg, params, dot_fn, steps):
    cache = init_kv_cache(cfg, 1, 128, device="cpu")._replace(offset=16)
    tok, toks, logits = torch.zeros((1,), dtype=torch.int32), [], []
    for _ in range(steps):
        lg, cache = tdense.dense_decode_step(params, cfg, tok, cache,
                                             dot_fn=dot_fn)
        tok = torch.argmax(lg, -1).to(torch.int32)
        toks.append(int(tok[0]))
        logits.append(_np(lg))
    return toks, logits


def test_fp8_decode_token_parity(dense_models):
    """The port's fp8 decode chain gives the reference's tokens (and its
    logits within a bf16 unit), and the tokens of its own fp32-emulated
    golden."""
    jcfg, jparams, tcfg, tparams = dense_models
    t8 = tfp8.quantize_dense_weights(tparams)
    jtoks, jlog = _jax_decode(jcfg, jfp8.quantize_dense_weights(jparams),
                              jfp8.fp8_dot, 6)
    ttoks, tlog = _port_decode(tcfg, t8, tfp8.fp8_dot, 6)
    assert ttoks == jtoks
    for a, b in zip(tlog, jlog):
        np.testing.assert_allclose(a, b, **BF16_TOL)
    assert _port_decode(tcfg, t8, tfp8.fp8_emulated_dot, 6)[0] == ttoks


def test_fp8_decode_differs_from_bf16_only_by_quantization(dense_models):
    _, _, tcfg, tparams = dense_models
    t8 = tfp8.quantize_dense_weights(tparams)
    l8 = _port_decode(tcfg, t8, tfp8.fp8_dot, 1)[1][0]
    lb = _port_decode(tcfg, tparams, None, 1)[1][0]
    np.testing.assert_allclose(l8, lb, rtol=0.35, atol=0.35)


def test_fp8_dot_saturates_instead_of_nan():
    x = np.asarray([[500.0, -1000.0, 2.0, 0.5]], np.float32)
    w = np.eye(4, dtype=np.float32)
    for tfn, jfn in ((tfp8.fp8_dot, jfp8.fp8_dot),
                     (tfp8.fp8_emulated_dot, jfp8.fp8_emulated_dot)):
        out = _np(tfn(torch.from_numpy(x), torch.from_numpy(w)))
        assert np.isfinite(out).all(), tfn.__name__
        np.testing.assert_array_equal(out, _np(jfn(jnp.asarray(x),
                                                   jnp.asarray(w))))
        np.testing.assert_allclose(out[0, :2], [448.0, -448.0])


def test_quantize_covers_moe_experts(moe_models):
    _, jparams, _, tparams = moe_models
    j8 = jfp8.quantize_dense_weights(jparams)
    t8 = tfp8.quantize_dense_weights(tparams)
    moe = t8["layers"][0]["moe"]
    for k in ("w_gate", "w_up", "w_down"):
        assert moe[k].dtype == E4M3, k
        np.testing.assert_array_equal(_e4m3_bits(moe[k]),
                                      _e4m3_bits(j8["layers"][0]["moe"][k]))
    assert moe["router"].dtype != E4M3
    assert t8["layers"][0]["attn"]["wo"].dtype == E4M3


def test_fp8_moe_forward_vs_jax():
    """The e4m3 expert product (one B3 product per non-empty group) against
    JAX's ``ragged_dot`` over the same quantized operands."""
    rng = np.random.default_rng(1)
    E, h, f, T = 4, 64, 32, 12
    x = np.asarray(rng.standard_normal((T, h)) * 0.4, np.float32)
    w = jfp8._to_e4m3(jnp.asarray(rng.standard_normal((E, h, f)) * 0.1,
                                  jnp.float32))
    ids = np.asarray(rng.integers(0, E, T), np.int32)
    sidx, gsz = jmoe.sort_by_expert(jnp.asarray(ids), E)
    ref = jmoe.ragged_dot_dtype_aware(jnp.asarray(x)[sidx], w, gsz)
    tw = torch.from_numpy(np.asarray(w).view(np.uint8).copy()).view(E4M3)
    tsidx, tgsz = tmoe.sort_by_expert(torch.from_numpy(ids), E)
    np.testing.assert_array_equal(tsidx.numpy(), np.asarray(sidx))
    calls = gemm.GEMM_KERNEL.plain_calls
    got = tmoe.ragged_dot_dtype_aware(torch.from_numpy(x)[tsidx], tw, tgsz)
    assert got.dtype == torch.float32
    assert gemm.GEMM_KERNEL.plain_calls - calls == int((tgsz > 0).sum())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_TOL)


def test_fp8_moe_decode_vs_jax(moe_models):
    """A quantized MoE model through the port's ``dense_decode_step``
    (dense projections by ``fp8_dot``, experts by the e4m3 lane): finite
    logits within a bf16 unit of JAX's."""
    jcfg, jparams, tcfg, tparams = moe_models
    j8 = jfp8.quantize_dense_weights(jparams)
    t8 = tfp8.quantize_dense_weights(tparams)
    jl, _ = jdense.dense_decode_step(j8, jcfg, jnp.zeros((1,), jnp.int32),
                                     jinit(jcfg, 1, 16), num_ranks=1,
                                     mode="ar", dot_fn=jfp8.fp8_dot)
    tl, cache = tdense.dense_decode_step(
        t8, tcfg, torch.zeros((1,), dtype=torch.int32),
        init_kv_cache(tcfg, 1, 16, device="cpu"), dot_fn=tfp8.fp8_dot)
    assert tl.shape == (1, tcfg.vocab_size) and cache.offset == 1
    assert np.isfinite(_np(tl)).all()
    np.testing.assert_allclose(_np(tl), _np(jl), **BF16_TOL)


def test_quantized_tree_refused_off_the_fp8_lane(dense_models):
    """torch has no mixed bf16 x e4m3 matmul: a quantized tree reaching a
    plain projection (prefill, or decode without ``dot_fn``) is refused by
    name. The parity-stream hook is no longer refused: at one rank without
    ``force_ar_kernel`` an ``ar_state`` passes through untouched (the
    reference's contract), beside the step's usual outputs."""
    _, _, tcfg, tparams = dense_models
    t8 = tfp8.quantize_dense_weights(tparams)
    tok = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="e4m3 weight without dot_fn"):
        tdense.dense_decode_step(t8, tcfg, tok,
                                 init_kv_cache(tcfg, 1, 16, device="cpu"))
    want, _ = tdense.dense_decode_step(
        tparams, tcfg, tok, init_kv_cache(tcfg, 1, 16, device="cpu"))
    got, cache, state = tdense.dense_decode_step(
        tparams, tcfg, tok, init_kv_cache(tcfg, 1, 16, device="cpu"),
        ar_state=(0, 0))
    assert state == (0, 0) and cache.offset == 1
    assert torch.equal(got, want)
