"""Port's dense model and Engine vs the JAX package's, on ``tiny_config()``
(2 layers) with weights from the JAX ``init_dense_llm(PRNGKey(7))``
converted by ``params_from_numpy``.

Tolerance: float32 throughout, atol = rtol = 1e-5 on the prefill logits
and on the logits of each decode step (both sides are fed the same
tokens, so a near-tie cannot desynchronise the comparison). Greedy token
streams from ``Engine.serve`` must be identical.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from triton_distributed_tpu.models import dense as jdense
from triton_distributed_tpu.models.config import tiny_config as jtiny
from triton_distributed_tpu.models.engine import Engine as JEngine
from triton_distributed_tpu.models.kv_cache import (
    PagedModelCache as JPagedModelCache, init_kv_cache as jinit_kv_cache,
)
from triton_distributed_tpu.runtime import initialize_distributed
from triton_distributed_tpu_torch.models import dense as tdense
from triton_distributed_tpu_torch.models.config import tiny_config
from triton_distributed_tpu_torch.models.convert import params_from_numpy
from triton_distributed_tpu_torch.models.engine import Engine
from triton_distributed_tpu_torch.models.kv_cache import init_kv_cache

TOL = dict(atol=1e-5, rtol=1e-5)
BATCH, PROMPT, MAX_SEQ, PAGE, STEPS = 2, 9, 24, 4, 4


@pytest.fixture(scope="module")
def models():
    jcfg = jtiny()
    jparams = jdense.init_dense_llm(jax.random.PRNGKey(7), jcfg)
    tcfg = tiny_config()
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


def _jax_to_paged(cache, page, batch):
    """The JAX Engine.to_paged layout, built host-side."""
    k, v = np.asarray(cache.k), np.asarray(cache.v)
    L, _, s, hkv, d = k.shape
    mp = -(-s // page)

    def pools(x):
        x = np.pad(x, ((0, 0), (0, 0), (0, mp * page - s), (0, 0), (0, 0)))
        return jnp.asarray(x.reshape(L, batch * mp, page, hkv, d))

    return JPagedModelCache(
        pools(k), pools(v),
        jnp.arange(batch * mp, dtype=jnp.int32).reshape(batch, mp),
        jnp.full((batch,), int(cache.offset), jnp.int32))


@pytest.fixture(scope="module")
def runs(models):
    """Prefill + STEPS paged decode steps on both sides; returns
    [(port logits, jax logits)] — entry 0 is the prefill."""
    jcfg, jparams, tcfg, tparams = models
    ids = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    jlogits, jcache = jdense.dense_prefill(
        jparams, jcfg, jnp.asarray(ids),
        jinit_kv_cache(jcfg, BATCH, MAX_SEQ), num_ranks=1)
    tlogits, tcache = tdense.dense_prefill(
        tparams, tcfg, torch.from_numpy(ids),
        init_kv_cache(tcfg, BATCH, MAX_SEQ, device="cpu"))
    out = [(tlogits, jlogits)]
    jcache = _jax_to_paged(jcache, PAGE, BATCH)
    tcache = Engine(tcfg, tparams, device="cpu", max_seq=MAX_SEQ,
                    page_size=PAGE).to_paged(tcache)
    for _ in range(STEPS):
        tok = np.argmax(np.asarray(jlogits), axis=-1).astype(np.int32)
        jlogits, jcache = jdense.dense_decode_step_paged(
            jparams, jcfg, jnp.asarray(tok), jcache, num_ranks=1)
        tlogits, tcache = tdense.dense_decode_step_paged(
            tparams, tcfg, torch.from_numpy(tok), tcache)
        out.append((tlogits, jlogits))
    assert tcache.kv_lens.tolist() == [PROMPT + STEPS] * BATCH
    return out


@pytest.mark.parametrize("step", range(STEPS + 1),
                         ids=["prefill"] + [f"decode{i}"
                                            for i in range(STEPS)])
def test_logits_per_step_vs_jax(runs, step):
    port, ref = runs[step]
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **TOL)


@pytest.fixture(scope="module")
def ctx1():
    return initialize_distributed(mesh_shape=(1,), axis_names=("tp",),
                                  devices=jax.devices()[:1])


@pytest.mark.parametrize("batch,prompt,gen", [(1, 7, 6), (2, 10, 5)])
def test_engine_serve_tokens_vs_jax(models, ctx1, batch, prompt, gen):
    jcfg, jparams, tcfg, tparams = models
    ids = np.random.default_rng(batch).integers(
        0, jcfg.vocab_size, (batch, prompt)).astype(np.int32)
    jeng = JEngine(jcfg, jparams, ctx1, backend="xla", max_seq=64,
                   page_size=PAGE)
    teng = Engine(tcfg, tparams, device="cpu", max_seq=64, page_size=PAGE)
    ref = np.asarray(jeng.serve(jnp.asarray(ids), gen_len=gen))
    out = teng.serve(ids, gen)
    assert out.dtype == torch.int32 and out.shape == (batch, gen)
    np.testing.assert_array_equal(out.numpy(), ref)
