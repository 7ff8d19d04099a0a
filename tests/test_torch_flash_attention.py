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


# ---------------------------------------------------------------------------
# K1's launch geometry (``flash_launch_plan``) and the wrapper's refusals:
# what the CUDA lanes are launched with, checked here where no card is.
# ---------------------------------------------------------------------------

# (b, sq, sk, q_offset, k_offset, causal, frontier): a whole prompt; a
# chunk at an offset into a longer buffer; a frontier off every key-tile
# edge (900); a key offset past the queries' start; every row hidden (the
# frontier <= 0); non-causal shards, whatever the offsets.
FRONTIERS = {
    "prompt": (2, 1024, 1024, 0, 0, True, 1024),
    "chunk": (1, 256, 2048, 768, 0, True, 1024),
    "off_edge": (1, 200, 2048, 700, 0, True, 900),
    "k_offset": (1, 300, 300, 0, 100, True, 200),
    "dead": (1, 64, 256, 0, 512, True, -448),
    "noncausal": (1, 512, 512, 1024, 512, False, 512),
    "noncausal_ragged": (2, 200, 333, 0, 0, False, 333),
}
LANES = {torch.bfloat16: ("wgmma", 128, 128),
         torch.float32: ("fma", 64, 32)}
SMEM_LIMIT = 227 * 1024


@pytest.mark.parametrize("case", sorted(FRONTIERS))
def test_key_frontier(case):
    b, sq, sk, qo, ko, causal, want = FRONTIERS[case]
    assert tfa.key_frontier(sq, sk, qo, ko, causal=causal) == want
    for dt in LANES:
        plan = tfa.flash_launch_plan(b, sq, sk, 32, 128, qo, ko,
                                     causal=causal, dtype=dt)
        assert plan["key_frontier"] == want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("case", sorted(FRONTIERS))
def test_key_tiles_never_past_frontier(case, dtype):
    """Each query tile loads exactly the key tiles that hold a key one of
    its rows sees: none past the frontier, none short of its last row."""
    b, sq, sk, qo, ko, causal, frontier = FRONTIERS[case]
    plan = tfa.flash_launch_plan(b, sq, sk, 32, 128, qo, ko, causal=causal,
                                 dtype=dtype)
    _, tq, tk = LANES[dtype]
    assert plan["key_tile"] == tk
    assert len(plan["key_tiles"]) == -(-sq // tq)
    for qt, n in enumerate(plan["key_tiles"]):
        rows = range(qt * tq, min(sq, (qt + 1) * tq))
        seen = max(min(sk, max(0, qo + i + 1 - ko)) if causal else sk
                   for i in rows)
        assert n == -(-seen // tk)
        assert n * tk < max(frontier, 0) + tk
        if n:
            assert (n - 1) * tk < frontier


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_lane_grid_and_smem(dtype, d):
    lane, tq, _ = LANES[dtype]
    plan = tfa.flash_launch_plan(2, 1000, 1000, 32, d, 0, 0, causal=True,
                                 dtype=dtype)
    assert plan["lane"] == lane
    assert 0 < plan["smem_bytes"] < SMEM_LIMIT
    n_qt = -(-1000 // tq)
    assert plan["work_tiles"] == n_qt * 32 * 2
    if lane == "wgmma":
        # One persistent block an SM (the H100's 132), at most one a work
        # tile; a producer warpgroup and two consumers.
        assert plan["grid"] == (132, 1, 1)
        assert tfa.flash_launch_plan(1, 100, 100, 4, d, 0, 0, causal=True,
                                     dtype=dtype)["grid"] == (4, 1, 1)
        assert plan["threads"] == 384
        # Q and two stages of K and V, 128 rows each, 1024-byte aligned,
        # and the mbarriers.
        assert plan["smem_bytes"] == 1024 + 5 * 128 * d * 2 + 128
    else:
        assert plan["grid"] == (n_qt, 32, 2)
        assert plan["threads"] == 256


@pytest.mark.parametrize("shape", [(2, 1024, 32), (8, 1024, 32),
                                   (1, 256, 32), (1, 300, 4)],
                         ids=["2x1024", "8x1024", "slice256", "small"])
def test_wgmma_schedule_covers_every_tile_once_and_balances(shape):
    """The persistent blocks walk every work tile exactly once, and (the
    tiles longest first, rounds alternating direction) no block's sum of
    causal key tiles exceeds the mean by more than one tile's length."""
    b, sq, hq = shape
    plan = tfa.flash_launch_plan(b, sq, sq, hq, 128, 0, 0, causal=True,
                                 dtype=torch.bfloat16)
    grid, total = plan["grid"][0], plan["work_tiles"]
    blocks = tfa.wgmma_schedule(grid, total)
    assert sorted(w for blk in blocks for w in blk) == list(range(total))
    n_qt = len(plan["key_tiles"])
    # Work tile w is head w % hq of query-tile row w // hq, longest first.
    size = [plan["key_tiles"][n_qt - 1 - (w // hq) // b]
            for w in range(total)]
    assert size == sorted(size, reverse=True)
    sums = [sum(size[w] for w in blk) for blk in blocks]
    assert max(sums) <= sum(sums) / grid + max(size)


def test_plan_refuses_other_dtypes():
    with pytest.raises(ValueError, match="dtype"):
        tfa.flash_launch_plan(1, 8, 8, 4, 64, 0, 0, causal=True,
                              dtype=torch.float16)


def _bf16(shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("refusal", ["head_dim", "row_stride", "dtype",
                                     "aligned", "device_dtype_f16"])
def test_cuda_wrapper_refusals_raise_by_name(refusal):
    """What K1 or TMA refuses raises a ValueError naming it, before any
    launch (no fallback)."""
    q = k = v = _bf16((1, 8, 4, 64))
    match = {"head_dim": "head_dim", "row_stride": "row stride",
             "dtype": "K1 takes one dtype", "aligned": "16-byte aligned",
             "device_dtype_f16": "unsupported"}[refusal]
    if refusal == "head_dim":
        q = k = v = _bf16((1, 8, 4, 96))
    elif refusal == "row_stride":
        # One head of 64 with 68 elements (136 bytes) between rows.
        k = torch.zeros(2048, dtype=torch.bfloat16).as_strided(
            (1, 8, 1, 64), (544, 68, 64, 1))
        q = v = k
    elif refusal == "dtype":
        k = torch.zeros((1, 8, 4, 64), dtype=torch.float32)
    elif refusal == "aligned":
        v = torch.zeros(8 * 4 * 64 + 1, dtype=torch.bfloat16)[1:].view(
            1, 8, 4, 64)
    else:
        q = k = v = torch.zeros((1, 8, 4, 64), dtype=torch.float16)
    with pytest.raises(ValueError, match=match):
        tfa._check_cuda_inputs(q, k, v)


def test_cuda_wrapper_accepts_the_main_shapes():
    for d in (64, 128):
        for dt in (torch.bfloat16, torch.float32):
            q = torch.zeros((2, 16, 32, d), dtype=dt)
            kv = torch.zeros((2, 16, 8, d), dtype=dt)
            tfa._check_cuda_inputs(q, kv, kv)
