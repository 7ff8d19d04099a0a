"""Port's flash attention (K1's plain version on the CPU) vs the JAX
package's flash kernel (Pallas interpret mode) and dense golden.

Tolerance: float32 throughout, atol = rtol = 1e-5 — both sides run the
same fp32 arithmetic, differing only in summation order.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

# ``ops/__init__`` re-exports a function under the module's name, so the
# modules are taken from the import system, not by attribute.
jfa = importlib.import_module("triton_distributed_tpu.ops.flash_attention")
tfa = importlib.import_module(
    "triton_distributed_tpu_torch.ops.flash_attention")

TOL = dict(atol=1e-5, rtol=1e-5)
HQ, D = 4, 32

# (sq, sk, q_offset, k_offset): a whole causal prompt; a chunk at a
# positive offset attending a longer capacity (the chunked-prefill shape:
# keys past the causal frontier are stale buffer positions); a block whose
# every row is hidden (keys all after the queries) — the dead-row contract.
CASES = {
    "prompt": (24, 24, 0, 0),
    "chunk": (8, 40, 16, 0),
    "dead": (8, 16, 0, 8),
}


def _inputs(case, g, seed=0):
    sq, sk, _, _ = CASES[case]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, sq, HQ, D)).astype(np.float32)
    k = rng.standard_normal((2, sk, HQ // g, D)).astype(np.float32)
    v = rng.standard_normal((2, sk, HQ // g, D)).astype(np.float32)
    return q, k, v


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_partial_vs_jax_kernel(case, g):
    q, k, v = _inputs(case, g)
    _, _, qo, ko = CASES[case]
    acc, m, l = tfa.flash_attention_partial(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_offset=qo, k_offset=ko)
    jacc, jm, jl = jfa.flash_attention_partial(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_offset=qo,
        k_offset=ko)
    _close(acc, jacc)
    _close(m, jm)
    _close(l, jl)
    if case == "dead":
        # The kernel's contract for a fully hidden row: l = 0, m = -1e30.
        assert torch.all(l == 0) and torch.all(m == -1e30)


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_normalized_vs_jax_kernel(case, g):
    q, k, v = _inputs(case, g, seed=1)
    _, _, qo, ko = CASES[case]
    out = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), q_offset=qo, k_offset=ko)
    ref = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), q_offset=qo, k_offset=ko)
    _close(out, ref)
    assert torch.isfinite(out).all()
    if case == "dead":
        assert torch.all(out == 0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_block_attn_and_merge_vs_jax(case):
    """The dense golden keeps its own dead-row report (m = 0), and the
    online merge of two key halves reproduces the whole."""
    q, k, v = _inputs(case, 2, seed=2)
    sq, sk, qo, ko = CASES[case]
    mask = (qo + np.arange(sq))[:, None] >= (ko + np.arange(sk))[None, :]
    port = tfa._block_attn(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), torch.from_numpy(mask))
    ref = jfa._block_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(mask))
    for a, b in zip(port, ref):
        _close(a, b)
    half = sk // 2
    parts = [tfa.flash_attention_partial(
        torch.from_numpy(q), torch.from_numpy(k[:, sl]),
        torch.from_numpy(v[:, sl]), q_offset=qo, k_offset=ko + sl.start)
        for sl in (slice(0, half), slice(half, sk))]
    acc, m, l = tfa._merge(parts[0], parts[1])
    jacc, jm, jl = jfa._merge(*[tuple(jnp.asarray(x.numpy()) for x in p)
                                for p in parts])
    _close(acc, jacc)
    _close(l, jl)
    whole = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), q_offset=qo,
                                k_offset=ko)
    merged = acc / torch.clamp(l, min=1e-30)[..., None]
    np.testing.assert_allclose(merged.numpy(), whole.numpy(), **TOL)


def test_flash_plain_rounds_p_to_v_dtype():
    """In bf16 the plain version, like K1 and the TPU kernel, rounds p to
    V's dtype before the PV product (and keeps l in fp32)."""
    q, k, v = _inputs("prompt", 2, seed=3)
    qb, kb, vb = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    acc, m, l = tfa.flash_attention_partial(qb, kb, vb)
    ref = jfa.flash_attention_partial(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16))
    # bf16 operands, fp32 accumulation: p's rounding to bf16 happens at the
    # running max on the JAX side and the row max here — 2e-2 absolute.
    np.testing.assert_allclose(acc.numpy(), np.asarray(ref[0]), atol=2e-2,
                               rtol=2e-2)
    _close(l, ref[2])
    assert acc.dtype == torch.float32 and l.dtype == torch.float32


def test_flash_cuda_wrapper_rejects_without_fallback():
    """A non-CPU tensor never reaches the plain version: the wrapper
    launches K1 (on CUDA) or raises."""
    q = torch.zeros((1, 4, HQ, D), device="meta")
    before = tfa.FLASH_KERNEL.plain_calls
    with pytest.raises(ValueError, match="no kernel for device"):
        tfa.flash_attention(q, q, q)
    assert tfa.FLASH_KERNEL.plain_calls == before
