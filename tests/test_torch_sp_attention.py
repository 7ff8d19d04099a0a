"""The port's sequence-parallel attention (``ops/ring_attention``,
``ops/sp_ag_attention``, ``ops/ulysses``, ``ops/flash_decode``,
``layers/decode_layers``, ``ops/low_latency_allgather``) against the JAX
package's on the conftest's CPU mesh (Pallas interpret mode), at n = 2
and 4, with one case at n = 8, on ``tests/test_sp_attention.py``'s
shapes.

The port's ranks are CPU threads of a group whose axis is named ``"sp"``
(the JAX side's mesh axis is ``"tp"``); K1 and K2 run their plain
versions, the AllGathers theirs. Tolerances: attention outputs
atol = rtol = 2e-5 in fp32 (the two frameworks' flash kernels and
einsums sum in different orders); byte moves (the gathered rows, the
bucketed AllGather) bit for bit.
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as JP

from triton_distributed_tpu.layers import decode_layers as jdl
from triton_distributed_tpu.ops import low_latency_allgather as jll
from triton_distributed_tpu.ops.ring_attention import (
    ring_attention as jring,
)
from triton_distributed_tpu.ops.sp_ag_attention import (
    sp_ag_attention as jsp_ag,
)
from triton_distributed_tpu.ops.ulysses import ulysses_attention as julysses
from triton_distributed_tpu.runtime import shard_map_on
from triton_distributed_tpu.runtime.context import DistContext as JDistContext
from triton_distributed_tpu_torch.layers import decode_layers as tdl
from triton_distributed_tpu_torch.ops import flash_decode as tfd
from triton_distributed_tpu_torch.ops import low_latency_allgather as tll
from triton_distributed_tpu_torch.ops import ring_attention as tring
from triton_distributed_tpu_torch.ops import sp_ag_attention as tsp_ag
from triton_distributed_tpu_torch.ops import ulysses as tulysses
from triton_distributed_tpu_torch.ops._comm import AG_PARITY_KERNEL
from triton_distributed_tpu_torch.ops.flash_attention import FLASH_KERNEL
from triton_distributed_tpu_torch.ops.paged_attention import PAGED_KERNEL
from triton_distributed_tpu_torch.runtime.context import DistContext

# The JAX package's ops/__init__ binds ``flash_decode`` to the function.
jfd = importlib.import_module("triton_distributed_tpu.ops.flash_decode")
TOL = dict(rtol=2e-5, atol=2e-5)
_CTX: dict = {}


def jctx(n: int) -> JDistContext:
    """An n-device JAX mesh (not installed as the global context)."""
    return JDistContext(mesh=Mesh(np.array(jax.devices()[:n]), ("tp",)))


def tctx(n: int) -> DistContext:
    """The port's group of n CPU rank threads on the axis "sp"."""
    if n not in _CTX:
        _CTX[n] = DistContext([torch.device("cpu")] * n, tp_axis="sp",
                              wait_timeout_ms=60_000)
    return _CTX[n]


def _inputs(seed: int, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _dense_attn(q, k, v, causal, kv_valid=None):
    """Float64 GQA attention. q: (B,Sq,hq,d); k/v (B,Sk,hkv,d)."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.astype(np.float64).reshape(b, sq, hkv, g, d)
    logits = np.einsum("bqhgd,bkhd->bqhgk", qf, k.astype(np.float64))
    logits /= math.sqrt(d)
    if causal:
        mask = np.tril(np.ones((sq, sk), bool))
        logits = np.where(mask[None, :, None, None, :], logits, -np.inf)
    logits -= logits.max(-1, keepdims=True)
    p = np.exp(logits)
    p /= p.sum(-1, keepdims=True)
    out = np.einsum("bqhgk,bkhd->bqhgd", p, v.astype(np.float64))
    return out.reshape(b, sq, hq, d)


def _host(fn_t, fn_j, n, q, k, v, causal):
    """The port's host-level op (its rank shards concatenated) and the
    JAX package's on the same inputs."""
    got = fn_t(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
               tctx(n), axis="sp", causal=causal)
    assert len(got) == n
    want = np.asarray(fn_j(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jctx(n), causal=causal))
    return torch.cat(got, dim=1).numpy(), want


@pytest.mark.parametrize("n,hq,hkv,causal", [
    (2, 8, 8, True), (2, 8, 8, False), (2, 16, 8, True), (2, 16, 8, False),
    (4, 16, 8, True), (4, 8, 8, False)],
    ids=["2-mha-causal", "2-mha-full", "2-gqa-causal", "2-gqa-full",
         "4-gqa-causal", "4-mha-full"])
def test_ring_attention_vs_jax(n, hq, hkv, causal):
    b, s, d = 2, 64, 32
    q, k, v = _inputs(0, (b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d))
    before = FLASH_KERNEL.plain_calls
    got, want = _host(tring.ring_attention, jring, n, q, k, v, causal)
    # n partials a rank: the diagonal, n - 2 in the loop, the last after.
    assert FLASH_KERNEL.plain_calls - before == n * n
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, _dense_attn(q, k, v, causal), **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n", [2, 4])
def test_sp_ag_attention_vs_jax(n, causal):
    b, s, hq, hkv, d = 1, 64, 16, 8, 32
    q, k, v = _inputs(1, (b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d))
    before = FLASH_KERNEL.plain_calls
    got, want = _host(tsp_ag.sp_ag_attention, jsp_ag, n, q, k, v, causal)
    # The diagonal, then every chunk (the diagonal's masked): n + 1.
    assert FLASH_KERNEL.plain_calls - before == n * (n + 1)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, _dense_attn(q, k, v, causal), **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n", [2, 4])
def test_ulysses_attention_vs_jax(n, causal):
    b, s, hq, hkv, d = 1, 64, 16, 8, 32
    q, k, v = _inputs(7, (b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d))
    got, want = _host(tulysses.ulysses_attention, julysses, n, q, k, v,
                      causal)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, _dense_attn(q, k, v, causal), **TOL)


def test_ulysses_refuses_indivisible_heads():
    ctx = DistContext([torch.device("cpu")] * 4, tp_axis="sp")
    x = torch.zeros((1, 4, 6, 32))
    with pytest.raises(ValueError, match="not divisible"):
        tulysses.ulysses_attention(x, x, x, ctx, axis="sp")
    ctx.close()


# Shard r holds FD_LENS[n][r] valid rows of 16 (an empty shard in each).
FD_LENS = {2: [11, 0], 4: [16, 7, 0, 12],
           8: [16, 7, 12, 0, 16, 1, 9, 4]}


@pytest.mark.parametrize("method", ["xla", "pallas"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_flash_decode_vs_jax(n, method):
    """Split-KV decode with ragged per-shard lengths, one shard empty."""
    b, hq, hkv, d, s_shard = 2, 16, 8, 32, 16
    q, k, v = _inputs(2, (b, hq, d), (b, n * s_shard, hkv, d),
                      (b, n * s_shard, hkv, d))
    lens = np.asarray(FD_LENS[n], np.int32)
    before = PAGED_KERNEL.plain_calls
    got = tfd.flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), lens, tctx(n), axis="sp",
                           method=method)
    assert PAGED_KERNEL.plain_calls - before == n
    want = np.asarray(jfd.flash_decode(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), jnp.asarray(lens),
                                       jctx(n), method=method))
    sel = np.concatenate([np.arange(r * s_shard, r * s_shard + lens[r])
                          for r in range(n)])
    gold = _dense_attn(q[:, None], k[:, sel], v[:, sel], causal=False)[:, 0]
    for r, out in enumerate(got):
        np.testing.assert_array_equal(out.numpy(), got[0].numpy(),
                                      err_msg=f"rank {r}")
    np.testing.assert_allclose(got[0].numpy(), want, **TOL)
    np.testing.assert_allclose(got[0].numpy(), gold, **TOL)


@pytest.mark.parametrize("kv_len", [0, 5, 16])
def test_partial_decode_dead_shard_contract(kv_len):
    """A shard's partial through K2's plain version against the JAX
    package's split-KV kernel (d = 128, s = 16: its Pallas path, not the
    dense fallback) in interpret mode: a dead shard reports acc = 0,
    m = 0, l = 0; a live one agrees in all three."""
    b, hq, hkv, d, s = 2, 4, 2, 128, 16
    q, k, v = _inputs(3, (b, hq, d), (b, s, hkv, d), (b, s, hkv, d))
    acc, m, l = tfd._partial_decode_attn(torch.from_numpy(q),
                                         torch.from_numpy(k),
                                         torch.from_numpy(v), kv_len)
    ja, jm, jl = jfd._partial_decode_attn(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), jnp.int32(kv_len))
    if kv_len == 0:
        for t in (acc, m, l):
            assert not t.any()
    for got, want in ((acc, ja), (m, jm), (l, jl)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_combine_partials_vs_jax():
    """The LSE combine with a dead split among live ones."""
    accs, ms, ls = _inputs(4, (4, 2, 8, 16), (4, 2, 8), (4, 2, 8))
    ls = np.abs(ls)
    ls[1] = 0.0
    ms[1] = 0.0
    got = tfd.combine_partials(*(torch.from_numpy(a) for a in (accs, ms, ls)))
    want = jfd.combine_partials(jnp.asarray(accs), jnp.asarray(ms),
                                jnp.asarray(ls))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _ag_stream_decode_jax(n, q, k, v, s_shard, steps):
    """The JAX package's SpFlashDecodeAttention over ``steps`` steps, and
    its one-shot ``xla`` decode of the same inputs."""
    b, hq, d = q.shape

    def run(ql, kl, vl):
        kl, vl = kl[0], vl[0]
        layer = jdl.SpFlashDecodeAttention(axis="tp", num_ranks=n)
        state = layer.init_state(b, hq, d)
        outs = []
        for _ in range(steps):
            out, state = layer(ql, kl, vl, jnp.int32(s_shard), state)
            outs.append(out)
        ref = jfd.flash_decode_local(ql, kl, vl, jnp.int32(s_shard),
                                     axis="tp", num_ranks=n, method="xla")
        return jnp.stack(outs), ref

    fn = shard_map_on(jctx(n), run, (JP(), JP("tp"), JP("tp")), (JP(), JP()))
    outs, ref = fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(outs), np.asarray(ref)


@pytest.mark.parametrize("n", [2, 4])
def test_flash_decode_ag_stream_repeated(n):
    """SP decode steady state: ``SpFlashDecodeAttention`` threads the
    parity AllGather's state over 3 steps (both parities and a reuse);
    each step equals the JAX package's layer (at n = 2; at n = 4 its
    host-level ``xla`` decode, the layer's interpret-mode run costing
    ~15 s), and the port's one-shot ``xla`` and ``pallas`` forms bit for
    bit."""
    b, hq, hkv, d, s_shard, steps = 2, 4, 2, 64, 32, 3
    q, k, v = _inputs(11, (b, hq, d), (n, b, s_shard, hkv, d),
                      (n, b, s_shard, hkv, d))
    if n == 2:
        want, want_ref = _ag_stream_decode_jax(n, q, k, v, s_shard, steps)
    else:
        kf, vf = (np.concatenate(list(a), axis=1) for a in (k, v))
        want_ref = np.asarray(jfd.flash_decode(
            jnp.asarray(q), jnp.asarray(kf), jnp.asarray(vf),
            jnp.full((n,), s_shard, jnp.int32), jctx(n), method="xla"))
        want = [want_ref] * steps
    ctx = tctx(n)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    layer = tdl.SpFlashDecodeAttention(axis="sp", num_ranks=n)
    before = AG_PARITY_KERNEL.plain_calls

    def body(r):
        state = layer.init_state(b, hq, d, tag="test-repeated")
        outs = []
        for _ in range(steps):
            out, state = layer(tq, tk[r], tv[r], s_shard, state)
            outs.append(out)
        one = [tfd.flash_decode_local(tq, tk[r], tv[r], s_shard, axis="sp",
                                      num_ranks=n, method=m)
               for m in ("xla", "pallas")]
        return torch.stack(outs), one, state[1]

    got = ctx.run(body)
    assert AG_PARITY_KERNEL.plain_calls - before == n * steps
    for r, (outs, one, idx) in enumerate(got):
        assert idx == steps
        np.testing.assert_array_equal(outs.numpy(), got[0][0].numpy())
        for t in range(steps):
            np.testing.assert_allclose(outs[t].numpy(), want[t], **TOL)
            np.testing.assert_array_equal(outs[t].numpy(),
                                          one[0].numpy())
        np.testing.assert_array_equal(one[0].numpy(), one[1].numpy())
        np.testing.assert_allclose(one[0].numpy(), want_ref, **TOL)


def test_sp_flash_decode_layer_n1_and_state():
    """At n = 1 the layer normalizes its own partial and hands its state
    back; the state is an fp32 (2, B·hq, d + 2) parity workspace."""
    b, hq, hkv, d, s = 2, 4, 2, 64, 32
    q, k, v = _inputs(12, (b, hq, d), (b, s, hkv, d), (b, s, hkv, d))
    ctx = DistContext([torch.device("cpu")], tp_axis="sp")
    layer = tdl.SpFlashDecodeAttention(axis="sp", num_ranks=1)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))

    def body(r):
        state = layer.init_state(b, hq, d)
        out, state2 = layer(tq, tk, tv, 20, state)
        return out, state, state2

    out, state, state2 = ctx.run(body)[0]
    assert state2 is state
    ws = state[0].tensors[0]
    assert ws.shape == (2, b * hq, d + 2) and ws.dtype == torch.float32
    want = jfd.flash_decode_local(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.int32(20), axis="tp",
                                  num_ranks=1)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    ctx.close()


@pytest.mark.parametrize("stream", [False, True], ids=["one_shot", "stream"])
@pytest.mark.parametrize("n", [2, 4])
def test_gemm_ar_layer_vs_jax(n, stream):
    """``GemmARLayer``: the local projection, then the parity stream (with
    a state, 3 calls) or ``all_reduce_local`` (without): the JAX package's
    layer's sums, every rank alike."""
    m, k_local, cols, calls = 4, 32, 128, 3
    x, w = _inputs(13, (n, m, k_local), (n, k_local, cols))

    def run(xl, wl):
        xl, wl = xl[0], wl[0]
        layer = jdl.GemmARLayer(axis="tp", num_ranks=n, method="one_shot")
        state = layer.init_state(m, cols) if stream else None
        outs = []
        for t in range(calls):
            if stream:
                out, state = layer(xl * (t + 1.0), wl, state)
            else:
                out = layer(xl * (t + 1.0), wl)
            outs.append(out)
        return jnp.stack(outs)[None]

    want = np.asarray(jax.jit(shard_map_on(
        jctx(n), run, (JP("tp"), JP("tp")), JP("tp")))(
        jnp.asarray(x), jnp.asarray(w)))
    ctx = tctx(n)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    layer = tdl.GemmARLayer(axis="sp", num_ranks=n, method="one_shot")

    def body(r):
        state = layer.init_state(m, cols, tag=f"test-{stream}") \
            if stream else None
        outs = []
        for t in range(calls):
            if stream:
                out, state = layer(tx[r] * (t + 1.0), tw[r], state)
            else:
                out = layer(tx[r] * (t + 1.0), tw[r])
            outs.append(out)
        return torch.stack(outs)

    got = ctx.run(body)
    for r, outs in enumerate(got):
        np.testing.assert_array_equal(outs.numpy(), got[0].numpy())
        np.testing.assert_allclose(outs.numpy(), want[r], **TOL)


@pytest.mark.parametrize("m_local", [1, 3, 8, 9])
def test_allgather_layer_bucket_vs_jax(m_local):
    """``AllGatherLayer`` pads each rank's rows to the bucket (8, 8, 8, 16
    fp32 rows) and drops the pad: the gathered rows bit for bit equal the
    JAX package's layer's, on every rank; the push keeps no payload
    buffer for a bucket (it writes the ranks' own outputs)."""
    n, cols = 4, 128
    (x,) = _inputs(14, (n * m_local, cols))
    want = np.asarray(jll.AllGatherLayer(jctx(n))(jnp.asarray(x)))
    ctx = tctx(n)
    got = tll.AllGatherLayer(ctx, axis="sp")(torch.from_numpy(x))
    for out in got:
        np.testing.assert_array_equal(out.numpy(), want)
    bucket = tll._bucket(m_local, 8)
    assert bucket == (8 if m_local <= 8 else 16)
    assert not [k for k in ctx._symm
                if k[0] == "symm" and k[3] == "ag_full_mesh"]
    assert [tll._bucket(m, 16) for m in (1, 16, 17, 33)] == [16, 16, 32, 64]
    np.testing.assert_array_equal(
        tll.fast_allgather(torch.from_numpy(x), ctx, axis="sp")[1].numpy(),
        want)


def test_sp_refusals():
    """A stream state with another method raises, as the reference's; the
    exchange method is checked by name."""
    ctx = DistContext([torch.device("cpu")] * 2, tp_axis="sp")
    q, k = torch.zeros((1, 2, 64)), torch.zeros((1, 16, 1, 64))

    def body(r):
        ws = tdl.SpFlashDecodeAttention(axis="sp", num_ranks=2).init_state(
            1, 2, 64, tag="refuse")
        with pytest.raises(ValueError, match="shadow"):
            tfd.flash_decode_local(q, k, k, 4, axis="sp", num_ranks=2,
                                   method="xla", ag_state=ws)
        with pytest.raises(ValueError, match="unknown method"):
            tfd.flash_decode_local(q, k, k, 4, axis="sp", num_ranks=2,
                                   method="nccl")
        return True

    assert all(ctx.run(body))
    ctx.close()
