"""Port's ``ops/gemm.pallas_matmul`` (kernel B3's plain version on CPU
tensors) vs the JAX package's ``pallas_matmul`` in Pallas interpret mode,
on the same numpy-made operands, in every lane the kernel compiles.

Tolerances: fp32 output atol = rtol = 1e-5 (the fp32 sums differ only in
order); bf16 output one bf16 unit, rtol 8e-3 (2^-7) plus atol 1e-5; e4m3
output one e4m3 unit, rtol 0.125 plus atol 2^-9 (the subnormal step), in
range. Out of range the port saturates to ±448 where the reference's
``astype`` gives NaN (jax 0.9 on the CPU): the port keeps the saturation
the reference's fp8 casts promise.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from triton_distributed_tpu.ops.gemm import pallas_matmul as jmatmul
from triton_distributed_tpu_torch.models.convert import array_to_tensor
from triton_distributed_tpu_torch.ops import gemm
from triton_distributed_tpu_torch.runtime.perf_model import (
    WGMMA_TILE_TIME, chip_spec,
)

F32, BF16, E4M3 = torch.float32, torch.bfloat16, torch.float8_e4m3fn
JDT = {F32: jnp.float32, BF16: jnp.bfloat16, E4M3: jnp.float8_e4m3fn}
TOL = {F32: dict(atol=1e-5, rtol=1e-5), BF16: dict(atol=1e-5, rtol=8e-3),
       E4M3: dict(atol=2.0 ** -9, rtol=0.125)}


def _operand(seed, shape, dtype, scale):
    """One operand, rounded to ``dtype`` once in numpy (JAX's casts): the
    port gets the same bits."""
    x = np.random.default_rng(seed).standard_normal(shape) * scale
    if dtype == E4M3:
        x = np.clip(x, -448, 448)
    return np.asarray(jnp.asarray(x, jnp.float32).astype(JDT[dtype]))


def _t(a):
    if a.dtype == ml_dtypes.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(E4M3)
    return array_to_tensor(a)


def _pair(m, k, n, a_dt, b_dt, seed=0):
    a = _operand(seed, (m, k), a_dt, 1.0)
    b = _operand(seed + 1, (k, n), b_dt, 1.0 if b_dt == E4M3 and
                 a_dt == E4M3 else k ** -0.5)
    return a, b


def _check(port, ref, out_dt):
    got = port.float().numpy()
    want = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **TOL[out_dt])
    return float(np.mean(got[fin] != want[fin]))


LANES = [(F32, F32, F32), (F32, BF16, F32), (F32, E4M3, F32),
         (BF16, BF16, BF16), (BF16, BF16, F32), (BF16, E4M3, BF16),
         (BF16, E4M3, F32), (E4M3, E4M3, E4M3), (E4M3, E4M3, BF16),
         (E4M3, E4M3, F32)]


@pytest.mark.parametrize("a_dt,b_dt,out_dt", LANES,
                         ids=[f"{str(a)[6:]}x{str(b)[6:]}->{str(o)[6:]}"
                              for a, b, o in LANES])
def test_lane_vs_jax(a_dt, b_dt, out_dt):
    a, b = _pair(32, 256, 256, a_dt, b_dt)
    ref = jmatmul(jnp.asarray(a), jnp.asarray(b), out_dtype=JDT[out_dt])
    out = gemm.pallas_matmul(_t(a), _t(b), out_dtype=out_dt)
    assert out.dtype == out_dt and out.shape == (32, 256)
    share = _check(out, ref, out_dt)
    print(f"share of elements not identical to JAX: {share:.4f}")


@pytest.mark.parametrize("m,k,n", [(20, 256, 384), (8, 136, 128),
                                   (24, 128, 136)])
@pytest.mark.parametrize("dt", [F32, BF16])
def test_odd_shapes_vs_jax(m, k, n, dt):
    """The reference's pick_tile fallback shapes; B3 masks their edges."""
    a, b = _pair(m, k, n, dt, dt, seed=2)
    ref = jmatmul(jnp.asarray(a), jnp.asarray(b))
    out = gemm.pallas_matmul(_t(a), _t(b))
    assert out.dtype == dt
    _check(out, ref, dt)


def test_out_dtype_defaults_to_a():
    a, b = _pair(16, 64, 32, E4M3, E4M3)
    assert gemm.pallas_matmul(_t(a), _t(b)).dtype == E4M3
    a, b = _pair(16, 64, 32, BF16, E4M3)
    assert gemm.pallas_matmul(_t(a), _t(b)).dtype == BF16


@pytest.mark.parametrize("a_dt,b_dt", [(BF16, F32), (E4M3, BF16),
                                       (E4M3, F32)])
def test_wider_b_refused_as_reference(a_dt, b_dt):
    a, b = _pair(16, 64, 32, a_dt, b_dt)
    with pytest.raises(ValueError, match="narrower"):
        jmatmul(jnp.asarray(a), jnp.asarray(b))
    with pytest.raises(ValueError, match="narrower"):
        gemm.pallas_matmul(_t(a), _t(b))


def test_e4m3_store_saturates():
    """Products past ±448: the port stores ±448 (jax 0.9's ``astype``
    keeps 456 -> 448 but gives NaN for ±480); in range it matches JAX
    exactly."""
    x = np.asarray([[1.0, 2.0, 0.5, 0.25]], np.float32)
    w = np.asarray([[460.0, 448.0, -448.0, 1.0],
                    [4.0, 16.0, -16.0, 1.0],
                    [0.0, 0.0, 0.0, 1.0],
                    [0.0, 0.0, 0.0, 1.0]], np.float32)
    a = np.asarray(jnp.asarray(x).astype(jnp.float8_e4m3fn))
    b = np.asarray(jnp.asarray(w).astype(jnp.float8_e4m3fn))
    out = gemm.pallas_matmul(_t(a), _t(b)).float().numpy()[0]
    np.testing.assert_array_equal(out, [448.0, 448.0, -448.0, 3.75])
    ref = np.asarray(jmatmul(jnp.asarray(a), jnp.asarray(b))
                     .astype(jnp.float32))[0]
    assert ref[3] == out[3]


def test_tile_selection():
    """Default caps pick the wgmma route at large M and the split-K route
    at decode (aligned operands); exact caps pick that tile where its route
    takes the operands; the mma.sync tiles keep the register-staged
    budget, the wgmma tiles the ring's shared memory; caps under every
    tile, a lane or an output type the kernel does not compile raise by
    name."""
    h100 = chip_spec("NVIDIA H100 80GB HBM3")

    def pick(lane, m, n):
        return gemm.select_tile(lane, m, n, 512, 1024, 512, spec=h100)

    assert pick("bf16", 2048, 5120).route == "wgmma"
    assert pick("e4m3", 2048, 5120).tiles == (128, 128, 128)
    # Decode: the split-K strip (a warp's 128 e4m3 / 64 bf16 columns).
    assert pick("e4m3", 1, 12288).tiles == (16, 128, 32)
    assert pick("e4m3", 1, 4096).tiles == (16, 128, 32)
    assert pick("e4m3", 8, 1024).route == "splitk"
    assert pick("bf16", 8, 5120).tiles == (16, 64, 32)
    assert pick("fp32", 2048, 5120).tiles == (128, 128, 8)
    assert pick("fp32", 1, 512).tiles == (16, 64, 32)
    assert pick("mixed", 2048, 5120).tiles == (128, 128, 32)
    for t in gemm.lane_tiles("bf16") + gemm.lane_tiles("e4m3"):
        lane = "bf16" if t in gemm.lane_tiles("bf16") else "e4m3"
        m = 16 if t.route == "splitk" else 2048
        assert gemm.select_tile(lane, m, 5120, *t.tiles) == t
        if t.route == "mma":
            assert t.smem_bytes <= 48 << 10
        elif t.route == "wgmma":
            assert t.smem_bytes == gemm.WGMMA_SMEM_BYTES == 197760
        assert t.smem_bytes <= 232448
    with pytest.raises(gemm.GemmConfigError, match="tile_m"):
        gemm.select_tile("bf16", 64, 64, 8, 1024, 512)
    a, b = _pair(16, 64, 32, F32, F32)
    with pytest.raises(gemm.GemmConfigError, match="out_dtype"):
        gemm.pallas_matmul(_t(a), _t(b), out_dtype=BF16)
    with pytest.raises(gemm.GemmConfigError, match="no B3 lane"):
        gemm.pallas_matmul(_t(a).half(), _t(b).half())


H100 = chip_spec("NVIDIA H100 80GB HBM3")
# (lane, m, n, aligned, caps, expected route, expected tile or None)
ROUTE_CASES = [
    ("bf16", 2048, 5120, True, None, "wgmma", None),
    ("bf16", 2048, 5120, False, None, "mma", (128, 128, 32)),
    ("e4m3", 2048, 5120, False, None, "mma", (128, 128, 64)),
    ("bf16", 64, 4096, True, None, "wgmma", None),
    ("bf16", 63, 4096, True, None, "mma", None),
    ("e4m3", 17, 4096, True, None, "mma", None),
    ("e4m3", 16, 4096, True, None, "splitk", (16, 128, 32)),
    ("e4m3", 1, 4096, False, None, "mma", (16, 32, 512)),
    ("bf16", 4, 768, True, None, "splitk", (16, 64, 32)),
    # Caps that exclude the new routes: a tile_k of 32 leaves the bf16
    # wgmma tiles out, a tile_n of 64 the e4m3 split-K strip.
    ("bf16", 2048, 5120, True, (512, 1024, 32), "mma", (128, 128, 32)),
    ("e4m3", 1, 4096, True, (512, 64, 512), "mma", (16, 32, 512)),
    # AGGemmConfig's caps admit the new tiles.
    ("bf16", 512, 4096, True, (512, 1024, 1024), "wgmma", None),
]


@pytest.mark.parametrize("lane,m,n,aligned,caps,route,tile", ROUTE_CASES,
                         ids=[f"{c[0]}-m{c[1]}-n{c[2]}-"
                              f"{'al' if c[3] else 'unal'}-"
                              f"{'caps' if c[4] else 'dflt'}"
                              for c in ROUTE_CASES])
def test_route_picker(lane, m, n, aligned, caps, route, tile):
    t = gemm.select_tile(lane, m, n, *(caps or (512, 1024, 512)),
                         spec=H100, aligned=aligned)
    assert t.route == route
    if tile is not None:
        assert t.tiles == tile


def test_wgmma_width_weighs_last_wave():
    """At the headline 128 x 256 makes 160 pair tiles over 66 clusters
    (3 waves), 128 x 128 320 (5 waves): the picker takes the smaller
    modeled time. Where both fit one wave the narrow tile spreads wider;
    at 4096 x 4096 (4 waves against 8) the wide one wins."""
    wide, narrow = (t for t in gemm.lane_tiles("bf16")
                    if t.route == "wgmma")
    assert gemm.wgmma_wave_cost(wide, 2048, 5120, H100) == pytest.approx(
        3 * WGMMA_TILE_TIME[256])
    assert gemm.wgmma_wave_cost(narrow, 2048, 5120, H100) == pytest.approx(
        5 * WGMMA_TILE_TIME[128])
    best = min((wide, narrow), key=lambda t: gemm.wgmma_wave_cost(
        t, 2048, 5120, H100))
    assert gemm.select_tile("bf16", 2048, 5120, 512, 1024, 512,
                            spec=H100) == best
    assert gemm.select_tile("bf16", 256, 2048, 512, 1024, 512,
                            spec=H100) == narrow
    assert gemm.select_tile("bf16", 4096, 4096, 512, 1024, 512,
                            spec=H100) == wide


# (k, n) of the Qwen3-8B decode products and the 4-row expert products:
# the split count (one cluster a 128-column strip), k-steps a CTA.
SPLIT_CASES = [((4096, 1024), (8, 16)), ((12288, 4096), (6, 64)),
               ((4096, 12288), (2, 64)), ((4096, 4096), (6, 22)),
               ((2048, 768), (8, 8)), ((768, 2048), (3, 8))]


@pytest.mark.parametrize("kn,plan", SPLIT_CASES,
                         ids=[f"k{k}-n{n}" for (k, n), _ in SPLIT_CASES])
def test_splitk_plan(kn, plan):
    k, n = kn
    splits, per, chunk = gemm.splitk_plan("e4m3", 1, n, k, spec=H100)
    assert (splits, per) == plan
    steps = -(-k // gemm.SPLITK_STEP)
    # Every CTA has k-steps, none past K; the cluster is portable; the
    # grid is one wave at 1.5 CTAs a SM.
    assert (splits - 1) * per < steps <= splits * per
    assert 1 <= splits <= 8 and 1 <= chunk <= per
    assert splits * -(-n // 128) <= 1.5 * H100.sm_count
    # A's staged rows fit the route's shared memory at 16 rows too.
    s16 = gemm.splitk_plan("e4m3", 16, n, k, spec=H100)
    assert 16 * (s16[2] * gemm.SPLITK_STEP + 16) <= gemm.SPLITK_SMEM_BYTES


def test_out_argument_written_in_place():
    """``out=``: the product lands in the caller's tensor (the card's
    harness passes a NaN-filled one); a wrong shape or type is refused by
    name."""
    a, b = _pair(8, 64, 32, BF16, BF16)
    want = gemm.pallas_matmul(_t(a), _t(b), out_dtype=F32)
    out = torch.full((8, 32), float("nan"))
    got = gemm.pallas_matmul(_t(a), _t(b), out_dtype=F32, out=out)
    assert got is out and torch.equal(out, want)
    with pytest.raises(ValueError, match="argument out"):
        gemm.pallas_matmul(_t(a), _t(b), out=torch.empty((8, 32)))


def test_plain_version_counts_and_other_devices_refused():
    a, b = _pair(16, 64, 32, BF16, BF16)
    calls, launches = gemm.GEMM_KERNEL.plain_calls, gemm.GEMM_KERNEL.launches
    gemm.pallas_matmul(_t(a), _t(b))
    assert gemm.GEMM_KERNEL.plain_calls == calls + 1
    assert gemm.GEMM_KERNEL.launches == launches
    with pytest.raises(ValueError, match="no kernel for device meta"):
        gemm.pallas_matmul(_t(a).to("meta"), _t(b).to("meta"))
