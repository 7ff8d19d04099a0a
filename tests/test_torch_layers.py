"""Port's layers at tensor-parallel degree 1 vs the JAX package's
(``layers/common.py``, ``layers/tp_attn.py``, ``layers/tp_mlp.py``), with
weights from the JAX initialisers converted by ``params_from_numpy``.

Tolerance: float32 throughout, atol = rtol = 1e-5; KV written into the
caches must agree to the same tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from triton_distributed_tpu.layers import common as jcommon
from triton_distributed_tpu.layers import tp_attn as jattn
from triton_distributed_tpu.layers import tp_mlp as jmlp
from triton_distributed_tpu.models.config import tiny_config as jtiny
from triton_distributed_tpu.ops.paged_attention import PagedKVCache as JPaged
from triton_distributed_tpu_torch.layers import common as tcommon
from triton_distributed_tpu_torch.layers import tp_attn as tattn
from triton_distributed_tpu_torch.layers import tp_mlp as tmlp
from triton_distributed_tpu_torch.models.config import tiny_config
from triton_distributed_tpu_torch.models.convert import params_from_numpy
from triton_distributed_tpu_torch.ops.paged_attention import PagedKVCache

TOL = dict(atol=1e-5, rtol=1e-5)
KV_HEADS = 4          # GQA: 8 query heads over 4 KV heads


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **TOL)


def _t(a):
    return torch.from_numpy(np.array(a))


def _attn_params():
    cfg = jtiny(num_kv_heads=KV_HEADS)
    p = jattn.init_tp_attn(jax.random.PRNGKey(3), cfg, jnp.float32)
    # Non-trivial qk-norm weights, so the norm's weight path is exercised.
    p["q_norm"] = p["q_norm"] * 1.5
    p["k_norm"] = p["k_norm"] * 0.75
    tcfg = tiny_config(num_kv_heads=KV_HEADS)
    return cfg, p, tcfg, params_from_numpy(jax.tree.map(np.asarray, p),
                                           tcfg, device="cpu")


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def check_rms_norm():
    x, w = _rand(0, 5, 7, 16), _rand(1, 16)
    _close(tcommon.rms_norm(_t(x), _t(w), 1e-6),
           jcommon.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))


def check_rope():
    pos = np.arange(40, 52, dtype=np.int32)
    cos, sin = tcommon.rope_cos_sin(_t(pos), 16, 1_000_000.0)
    jcos, jsin = jcommon.rope_cos_sin(jnp.asarray(pos), 16, 1_000_000.0)
    _close(cos, jcos)
    _close(sin, jsin)
    x = _rand(2, 2, 12, 4, 16)
    _close(tcommon.apply_rope(_t(x), cos[None], sin[None]),
           jcommon.apply_rope(jnp.asarray(x), jcos[None], jsin[None]))


def check_swiglu():
    g, u = _rand(3, 6, 32), _rand(4, 6, 32)
    _close(tcommon.swiglu(_t(g), _t(u)),
           jcommon.swiglu(jnp.asarray(g), jnp.asarray(u)))


def check_mlp():
    p = jmlp.init_tp_mlp(jax.random.PRNGKey(5), 128, 256, jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, p), tiny_config(),
                           device="cpu")
    x = _rand(6, 10, 128)
    _close(tmlp.tp_mlp_fwd(tp, _t(x)),
           jmlp.tp_mlp_fwd(p, jnp.asarray(x), num_ranks=1))


def check_attn_prefill():
    cfg, p, tcfg, tp = _attn_params()
    b, s, cap = 2, 12, 20
    x = _rand(7, b * s, cfg.hidden_size)
    kv = np.zeros((b, cap, KV_HEADS, cfg.head_dim), np.float32)
    out, new_kv = tattn.tp_attn_prefill(
        tp, tcfg, _t(x), b, s, tcommon.KVSlice(_t(kv), _t(kv)))
    jout, jkv = jattn.tp_attn_prefill(
        p, cfg, jnp.asarray(x), b, s,
        jcommon.KVSlice(jnp.asarray(kv), jnp.asarray(kv)), num_ranks=1)
    _close(out, jout)
    _close(new_kv.k, jkv.k)
    _close(new_kv.v, jkv.v)


def check_attn_prefill_chunk():
    """A chunk at start 8 over a 24-position buffer whose tail holds
    stale values — hidden by causality on both sides."""
    cfg, p, tcfg, tp = _attn_params()
    chunk, start, cap = 8, 8, 24
    x = _rand(8, chunk, cfg.hidden_size)
    k0 = _rand(9, 1, cap, KV_HEADS, cfg.head_dim)
    v0 = _rand(10, 1, cap, KV_HEADS, cfg.head_dim)
    out, kv = tattn.tp_attn_prefill_chunk(
        tp, tcfg, _t(x), tcommon.KVSlice(_t(k0), _t(v0)), start, chunk)
    jout, jkv = jattn.tp_attn_prefill_chunk(
        p, cfg, jnp.asarray(x), jcommon.KVSlice(jnp.asarray(k0),
                                                jnp.asarray(v0)),
        jnp.int32(start), chunk, num_ranks=1)
    _close(out, jout)
    _close(kv.k, jkv.k)
    _close(kv.v, jkv.v)


def check_attn_decode_paged():
    cfg, p, tcfg, tp = _attn_params()
    b, page, max_pages = 3, 4, 3
    rng = np.random.default_rng(11)
    kp = (rng.standard_normal((b * max_pages + 1, page, KV_HEADS,
                               cfg.head_dim)) * 0.5).astype(np.float32)
    vp = (rng.standard_normal(kp.shape) * 0.5).astype(np.float32)
    table = np.arange(b * max_pages, dtype=np.int32).reshape(b, max_pages)
    lens = np.asarray([0, 5, 11], np.int32)
    x = _rand(12, b, cfg.hidden_size)
    out, cache = tattn.tp_attn_decode_paged(
        tp, tcfg, _t(x), PagedKVCache(*(_t(a) for a in (kp, vp, table,
                                                        lens))))
    jout, jcache = jattn.tp_attn_decode_paged(
        p, cfg, jnp.asarray(x),
        JPaged(*(jnp.asarray(a) for a in (kp, vp, table, lens))),
        num_ranks=1)
    _close(out, jout)
    _close(cache.k_pool, jcache.k_pool)
    _close(cache.v_pool, jcache.v_pool)
    assert cache.kv_lens.tolist() == np.asarray(jcache.kv_lens).tolist()


CHECKS = {name[len("check_"):]: fn for name, fn in globals().items()
          if name.startswith("check_")}


@pytest.mark.parametrize("layer", sorted(CHECKS))
def test_layer_vs_jax(layer):
    CHECKS[layer]()
