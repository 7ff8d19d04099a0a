"""Port's paged KV cache (append + K2's plain version on the CPU) vs the
JAX package's paged append, paged decode kernel (Pallas interpret mode)
and numpy golden.

Tolerance: float32 throughout, atol = rtol = 1e-5 for attention outputs;
the appends are copies and must be exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from triton_distributed_tpu.ops import paged_attention as jpa
from triton_distributed_tpu_torch.ops import paged_attention as tpa

TOL = dict(atol=1e-5, rtol=1e-5)
PAGE, MAX_PAGES, HQ, D = 4, 3, 8, 32
# Ragged lengths: an empty slot, one token, a partial page, a page
# multiple plus one, and a full allotment.
LENS = [0, 1, 6, 9, 12]


def _cache_np(g, lens, seed):
    """Pools filled with random values (stale data everywhere, as in a
    live pool), a shuffled page assignment, and -1 past each sequence's
    valid pages."""
    rng = np.random.default_rng(seed)
    b, hkv = len(lens), HQ // g
    num_pages = b * MAX_PAGES + 1
    kp = rng.standard_normal((num_pages, PAGE, hkv, D)).astype(np.float32)
    vp = rng.standard_normal((num_pages, PAGE, hkv, D)).astype(np.float32)
    order = rng.permutation(num_pages)[:b * MAX_PAGES]
    table = order.reshape(b, MAX_PAGES).astype(np.int32)
    for i, n in enumerate(lens):
        table[i, -(-n // PAGE):] = -1
    q = rng.standard_normal((b, HQ, D)).astype(np.float32)
    return q, kp, vp, table, np.asarray(lens, np.int32)


def _port(q, kp, vp, table, lens):
    return (torch.from_numpy(q),
            tpa.PagedKVCache(*(torch.from_numpy(a.copy())
                               for a in (kp, vp, table, lens))))


def _jax(q, kp, vp, table, lens):
    return (jnp.asarray(q),
            jpa.PagedKVCache(*(jnp.asarray(a) for a in (kp, vp, table, lens))))


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("normalize", [True, False])
def test_paged_decode_vs_jax_kernel(normalize, g):
    arrays = _cache_np(g, LENS, seed=g)
    q, cache = _port(*arrays)
    jq, jcache = _jax(*arrays)
    out = tpa.paged_decode_attention(q, cache, normalize=normalize)
    ref = jpa.paged_decode_attention(jq, jcache, normalize=normalize)
    if normalize:
        out, ref = (out,), (ref,)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    first = out[0]
    assert torch.isfinite(first).all()
    assert torch.all(first[0] == 0)            # kv_len = 0: zeros, not NaN
    if not normalize:
        assert torch.all(out[1][0] == -1e30) and torch.all(out[2][0] == 0)


@pytest.mark.parametrize("g", [1, 4])
def test_paged_decode_vs_golden(g):
    arrays = _cache_np(g, LENS, seed=10 + g)
    q, cache = _port(*arrays)
    out = tpa.paged_decode_attention(q, cache)
    gold = tpa.paged_decode_attention_golden(q, cache)
    jgold = jpa.paged_decode_attention_golden(*_jax(*arrays))
    np.testing.assert_allclose(out.numpy(), gold, **TOL)
    np.testing.assert_allclose(gold, np.asarray(jgold, np.float64), **TOL)


@pytest.mark.parametrize("steps", [1, 5])
def test_paged_append_vs_jax(steps):
    """Identity tables, lengths [0, 5, 11, 12]: the last sequence is at
    capacity (3 pages x 4), so its writes are DROPPED (its length stays,
    its pool bytes stay); the others cross page boundaries."""
    rng = np.random.default_rng(steps)
    b, hkv = 4, 2
    lens = np.asarray([0, 5, 11, 12], np.int32)
    kp = rng.standard_normal((b * MAX_PAGES, PAGE, hkv, D)).astype(np.float32)
    vp = rng.standard_normal((b * MAX_PAGES, PAGE, hkv, D)).astype(np.float32)
    table = np.arange(b * MAX_PAGES, dtype=np.int32).reshape(b, MAX_PAGES)
    port = tpa.PagedKVCache(*(torch.from_numpy(a.copy())
                              for a in (kp, vp, table, lens)))
    jax_cache = jpa.PagedKVCache(*(jnp.asarray(a)
                                   for a in (kp, vp, table, lens)))
    for _ in range(steps):
        k_new = rng.standard_normal((b, hkv, D)).astype(np.float32)
        v_new = rng.standard_normal((b, hkv, D)).astype(np.float32)
        port = tpa.paged_append(port, torch.from_numpy(k_new),
                                torch.from_numpy(v_new))
        jax_cache = jpa.paged_append(jax_cache, jnp.asarray(k_new),
                                     jnp.asarray(v_new))
    np.testing.assert_array_equal(port.kv_lens.numpy(),
                                  np.asarray(jax_cache.kv_lens))
    np.testing.assert_array_equal(port.k_pool.numpy(),
                                  np.asarray(jax_cache.k_pool))
    np.testing.assert_array_equal(port.v_pool.numpy(),
                                  np.asarray(jax_cache.v_pool))
    assert int(port.kv_lens[3]) == 12                     # saturated
    np.testing.assert_array_equal(port.k_pool[9:12].numpy(), kp[9:12])


def test_paged_append_duplicate_scratch_targets():
    """Empty decode slots all point at one scratch page with kv_lens 0:
    their appends collide on one row, which must not raise and must leave
    the live sequence's write intact."""
    hkv = 2
    cache = tpa.init_paged_kv_cache(3, num_pages=4, page_size=PAGE,
                                    num_kv_heads=hkv, head_dim=D,
                                    max_pages=3, device="cpu")
    assert cache.page_table.tolist() == [[0, 1, 2], [3, 0, 1], [2, 3, 0]]
    table = torch.tensor([[0, 1, 3], [3, 3, 3], [3, 3, 3]], dtype=torch.int32)
    lens = torch.tensor([5, 0, 0], dtype=torch.int32)
    cache = cache._replace(page_table=table, kv_lens=lens)
    k_new = torch.arange(3 * hkv * D, dtype=torch.float32).reshape(3, hkv, D)
    cache = tpa.paged_append(cache, k_new, k_new)
    assert cache.kv_lens.tolist() == [6, 1, 1]
    torch.testing.assert_close(cache.k_pool[1, 1], k_new[0])


def test_paged_cuda_wrapper_rejects_without_fallback():
    q, cache = _port(*_cache_np(2, LENS, seed=0))
    meta = tpa.PagedKVCache(*(t.to("meta") for t in cache))
    before = tpa.PAGED_KERNEL.plain_calls
    with pytest.raises(ValueError, match="no kernel for device"):
        tpa.paged_decode_attention(q.to("meta"), meta)
    assert tpa.PAGED_KERNEL.plain_calls == before
