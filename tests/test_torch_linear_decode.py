"""Port's linear-cache decode path vs the JAX package's: ``tp_attn_decode``,
``dense_decode_step``, ``dense_prefill_chunked``, ``sampling.sample``, and
the default ``Engine(cfg, params)`` (backend "auto", ``page_size=None``),
on ``tiny_config()`` with weights from the JAX initialisers converted by
``params_from_numpy``.

Tolerance: float32 throughout, atol = rtol = 1e-5 on activations, caches
and logits (both sides fed the same tokens); greedy tokens identical.
``sample`` draws from a ``torch.Generator``, whose bits are not
``jax.random``'s: its greedy limit and top-k masking are held against
JAX, its distribution against the softmax (4-sigma binomial bounds over
20000 draws).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from triton_distributed_tpu.layers import tp_attn as jattn
from triton_distributed_tpu.layers.common import KVSlice as JKVSlice
from triton_distributed_tpu.models import dense as jdense
from triton_distributed_tpu.models import sampling as jsampling
from triton_distributed_tpu.models.config import tiny_config as jtiny
from triton_distributed_tpu.models.engine import Engine as JEngine
from triton_distributed_tpu.models.kv_cache import init_kv_cache as jinit
from triton_distributed_tpu.runtime import initialize_distributed
from triton_distributed_tpu_torch.layers import tp_attn as tattn
from triton_distributed_tpu_torch.layers.common import KVSlice
from triton_distributed_tpu_torch.models import dense as tdense
from triton_distributed_tpu_torch.models import sampling as tsampling
from triton_distributed_tpu_torch.models.config import tiny_config
from triton_distributed_tpu_torch.models.convert import params_from_numpy
from triton_distributed_tpu_torch.models.engine import Engine
from triton_distributed_tpu_torch.models.kv_cache import init_kv_cache

TOL = dict(atol=1e-5, rtol=1e-5)
MAX_SEQ = 32


@pytest.fixture(scope="module")
def models():
    jcfg = jtiny()
    jparams = jdense.init_dense_llm(jax.random.PRNGKey(7), jcfg)
    tcfg = tiny_config()
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def ctx1():
    return initialize_distributed(mesh_shape=(1,), axis_names=("tp",),
                                  devices=jax.devices()[:1])


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(port, ref):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), **TOL)


@pytest.mark.parametrize("pos", [0, 5, MAX_SEQ - 1])
def test_tp_attn_decode_vs_jax(models, pos):
    jcfg, jparams, tcfg, tparams = models
    jp, tp = jparams["layers"][0]["attn"], tparams["layers"][0]["attn"]
    x = _rand(1, 2, jcfg.hidden_size)
    shape = (2, MAX_SEQ, jcfg.num_kv_heads, jcfg.head_dim)
    k0, v0 = _rand(2, *shape), _rand(3, *shape)
    jout, jkv = jattn.tp_attn_decode(
        jp, jcfg, jnp.asarray(x), JKVSlice(jnp.asarray(k0), jnp.asarray(v0)),
        jnp.int32(pos))
    kv = KVSlice(torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy()))
    out, kv2 = tattn.tp_attn_decode(tp, tcfg, torch.from_numpy(x), kv, pos)
    assert kv2 is kv
    _close(out, jout)
    _close(kv.k, jkv.k)
    _close(kv.v, jkv.v)
    with pytest.raises(ValueError, match="outside the linear cache"):
        tattn.tp_attn_decode(tp, tcfg, torch.from_numpy(x), kv, MAX_SEQ)


def test_sdpa_causal_vs_jax():
    q = _rand(4, 2, 5, 4, 16)
    k, v = _rand(5, 2, 9, 2, 16), _rand(6, 2, 9, 2, 16)
    ref = jattn._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      causal=True, kv_len=jnp.int32(7))
    _close(tattn._sdpa(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), causal=True, kv_len=7), ref)


def test_dense_decode_step_vs_jax(models):
    """Prefill, then four linear decode steps: logits and the cache, step
    by step, both sides fed the reference's tokens."""
    jcfg, jparams, tcfg, tparams = models
    ids = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 7))
    jlog, jcache = jdense.dense_prefill(jparams, jcfg, jnp.asarray(ids),
                                        jinit(jcfg, 2, MAX_SEQ))
    tlog, tcache = tdense.dense_prefill(
        tparams, tcfg, torch.from_numpy(ids),
        init_kv_cache(tcfg, 2, MAX_SEQ, device="cpu"))
    _close(tlog, jlog)
    for _ in range(4):
        tok = jnp.argmax(jlog, -1).astype(jnp.int32)
        jlog, jcache = jdense.dense_decode_step(jparams, jcfg, tok, jcache)
        tlog, tcache = tdense.dense_decode_step(
            tparams, tcfg, torch.from_numpy(np.array(tok)), tcache)
        _close(tlog, jlog)
        assert tcache.offset == int(jcache.offset)
    _close(tcache.k, jcache.k)
    _close(tcache.v, jcache.v)


def test_dense_prefill_chunked_vs_jax(models):
    jcfg, jparams, tcfg, tparams = models
    ids = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 12))
    jlog, jcache = jdense.dense_prefill_chunked(
        jparams, jcfg, jnp.asarray(ids), jinit(jcfg, 2, MAX_SEQ), chunk=4)
    tlog, tcache = tdense.dense_prefill_chunked(
        tparams, tcfg, torch.from_numpy(ids),
        init_kv_cache(tcfg, 2, MAX_SEQ, device="cpu"), chunk=4)
    _close(tlog, jlog)
    _close(tcache.k, jcache.k)
    assert tcache.offset == 12
    with pytest.raises(ValueError, match="multiple of"):
        tdense.dense_prefill_chunked(
            tparams, tcfg, torch.from_numpy(ids),
            init_kv_cache(tcfg, 2, MAX_SEQ, device="cpu"), chunk=5)


def test_sample_greedy_and_top_k_vs_jax():
    logits = _rand(7, 6, 50)
    g = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    tl = torch.from_numpy(logits)
    for temp in (0.0, -1.0):
        np.testing.assert_array_equal(
            tsampling.sample(tl, g, temperature=temp).numpy(),
            np.asarray(jsampling.sample(jnp.asarray(logits), key,
                                        temperature=temp)))
    # top_k = 1 leaves one finite logit: every draw is the argmax, as JAX's.
    np.testing.assert_array_equal(
        tsampling.sample(tl, g, temperature=0.7, top_k=1).numpy(),
        np.asarray(jsampling.sample(jnp.asarray(logits), key,
                                    temperature=0.7, top_k=1)))
    draws = tsampling.sample(tl.repeat(200, 1), g, temperature=1.5, top_k=3)
    top3 = np.argsort(logits, -1)[:, -3:]
    assert draws.dtype == torch.int32
    for row, d in zip(np.tile(top3, (200, 1)), draws.numpy()):
        assert d in row


def test_sample_distribution():
    logits = np.asarray([[2.0, 1.0, 0.5, -1.0, 0.0]], np.float32)
    n, temp = 20000, 1.3
    g = torch.Generator().manual_seed(1)
    draws = tsampling.sample(torch.from_numpy(logits).repeat(n, 1), g,
                             temperature=temp).numpy()
    p = np.exp(logits[0] / temp)
    p /= p.sum()
    freq = np.bincount(draws, minlength=5) / n
    np.testing.assert_array_less(np.abs(freq - p),
                                 4 * np.sqrt(p * (1 - p) / n) + 1e-9)


@pytest.mark.parametrize("batch,prompt,gen", [(1, 7, 6), (2, 10, 5)])
def test_default_engine_serve_vs_jax(models, ctx1, batch, prompt, gen):
    """The reference's defaults (backend "auto", page_size None) on both
    sides, and the port's paged eager serve: the same tokens."""
    jcfg, jparams, tcfg, tparams = models
    ids = np.random.default_rng(10 + batch).integers(
        0, jcfg.vocab_size, (batch, prompt)).astype(np.int32)
    ref = np.asarray(JEngine(jcfg, jparams, ctx1, max_seq=64).serve(
        jnp.asarray(ids), gen_len=gen))
    eng = Engine(tcfg, tparams, device="cpu", max_seq=64)
    assert eng.backend == "auto" and eng.page_size is None
    out = eng.serve(ids, gen)
    assert out.dtype == torch.int32 and out.shape == (batch, gen)
    np.testing.assert_array_equal(out.numpy(), ref)
    paged = Engine(tcfg, tparams, device="cpu", max_seq=64, page_size=4,
                   backend="xla").serve(ids, gen)
    np.testing.assert_array_equal(paged.numpy(), ref)


def test_engine_linear_decode_hooks_and_refusals(models):
    """``Engine.decode`` takes the linear cache; ``decode_fn`` /
    ``prefill_fn`` replace the forward; a serve past max_seq is refused by
    name; the overlap backend is, at one rank, the eager path."""
    _, _, tcfg, tparams = models
    ids = torch.from_numpy(np.random.default_rng(4).integers(
        0, tcfg.vocab_size, (1, 8)))
    eng = Engine(tcfg, tparams, device="cpu", max_seq=16)
    logits, cache = eng.prefill(ids)
    tok, cache = eng.decode(torch.argmax(logits, -1).to(torch.int32), cache)
    assert cache.offset == 9 and tok.shape == (1,)
    seen = []

    def decode_fn(params, cfg, tokens, cache):
        seen.append(cache.offset)
        return tdense.dense_decode_step(params, cfg, tokens, cache)

    def prefill_fn(params, cfg, ids, cache):
        seen.append("prefill")
        return tdense.dense_prefill_chunked(params, cfg, ids, cache, chunk=4)

    hooked = Engine(tcfg, tparams, device="cpu", max_seq=16,
                    prefill_fn=prefill_fn, decode_fn=decode_fn)
    np.testing.assert_array_equal(hooked.serve(ids, 4).numpy(),
                                  eng.serve(ids, 4).numpy())
    assert seen == ["prefill", 8, 9, 10]
    with pytest.raises(ValueError, match="exceeds max_seq"):
        eng.serve(ids, 10)
    overlap = Engine(tcfg, tparams, device="cpu", max_seq=16,
                     backend="overlap")
    np.testing.assert_array_equal(overlap.serve(ids, 4).numpy(),
                                  eng.serve(ids, 4).numpy())
