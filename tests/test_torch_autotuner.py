"""Port's contextual autotuner, GEMM perf model and runtime helpers
(``runtime/autotuner.py``, ``runtime/perf_model.py``, ``runtime/utils.py``)
— the reference's ``tests/test_autotuner.py`` and the GEMM cases of
``tests/test_perf_model.py`` as ports, over the H100 spec, with the
helpers held against the JAX package's where both compute the same thing.
Off the card the tuner measures with the host clock and ``pallas_matmul``
runs its plain version; the on-card measurement is ``chip_smoke.py``'s
``gemm_tuned`` phase."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from triton_distributed_tpu.runtime import utils as jutils
from triton_distributed_tpu_torch.ops.gemm import (
    lane_tiles, pallas_matmul, pallas_matmul_tuned, tile_routes,
)
from triton_distributed_tpu_torch.runtime import autotuner as at
from triton_distributed_tpu_torch.runtime import perf_model as pm
from triton_distributed_tpu_torch.runtime import utils

SPEC = pm.chip_spec("NVIDIA H100 80GB HBM3")


def test_autotune_picks_fastest_and_caches(tmp_path, monkeypatch):
    """Each candidate's time is scripted (2 / 4 / 6 ms for configs 1 / 2 /
    3, through a stubbed ``measure``), so the ranking and the caches are
    tested, not the host's clock under load."""
    monkeypatch.setenv("TDTPU_AUTOTUNE_CACHE", str(tmp_path / "cache.json"))
    calls = []

    def build(cfg):
        calls.append(cfg)

        def fn(x):
            return x
        fn.cfg = cfg
        return fn

    monkeypatch.setattr(at, "measure",
                        lambda fn, args, warmup=1, iters=3: 0.002 * fn.cfg)
    best, report = at.contextual_autotune(
        "sleepy", "k1", [3, 1, 2], build, (torch.zeros(4),), iters=2)
    assert best == 1 and report.best_index == 1
    assert report.timings == pytest.approx((0.006, 0.002, 0.004))
    before = len(calls)
    best2, report2 = at.contextual_autotune(
        "sleepy", "k1", [3, 1, 2], build, (torch.zeros(4),), iters=2)
    assert best2 == 1 and report2 is None and len(calls) == before
    # A fresh process reads the disk entry, which carries the config's repr.
    at._memory_cache.clear()
    assert at.contextual_autotune("sleepy", "k1", [3, 1, 2], build,
                                  (torch.zeros(4),))[1] is None
    at._memory_cache.clear()
    assert at.contextual_autotune("sleepy", "k1", [3, 2, 1], build,
                                  (torch.zeros(4),), iters=1)[1] is not None


@pytest.mark.parametrize("itemsize,lane", [(2, "bf16"), (1, "e4m3")])
def test_tuner_top4_holds_wgmma(itemsize, lane):
    """At the headline 2048 x 5120 x 5120 the card's candidate space holds
    the wgmma tiles, and the route-aware ranking puts one in the four the
    tuner measures; at decode the split-K tile leads."""
    cands = at.gemm_tile_candidates(2048, 5120, 5120, itemsize,
                                    smem_budget=SPEC.smem_bytes)
    routes = tile_routes(lane)
    assert {routes[c] for c in cands} == {"wgmma", "mma"}
    top4 = pm.rank_gemm_tiles(cands, 2048, 5120, 5120, itemsize, SPEC,
                              top=4, routes=routes)
    assert routes[top4[0]] == "wgmma"
    dec = at.gemm_tile_candidates(1, 4096, 12288, itemsize,
                                  smem_budget=SPEC.smem_bytes)
    assert routes[pm.rank_gemm_tiles(dec, 1, 12288, 4096, itemsize, SPEC,
                                     routes=routes)[0]] == "splitk"


def test_autotune_prunes_failing_candidates(tmp_path, monkeypatch):
    monkeypatch.setenv("TDTPU_AUTOTUNE_CACHE", str(tmp_path / "c.json"))

    def build(cfg):
        if cfg == "bad":
            raise RuntimeError("does not compile")
        return lambda x: x

    best, report = at.contextual_autotune(
        "pruney", "k", ["bad", "good"], build, (torch.zeros(2),))
    assert best == "good" and report.timings[0] is None
    with pytest.raises(RuntimeError, match="every candidate failed"):
        at.contextual_autotune("pruney", "k2", ["bad"], build,
                               (torch.zeros(2),))


@pytest.mark.parametrize("itemsize,lane", [(4, "fp32"), (2, "bf16"),
                                           (1, "e4m3")])
def test_gemm_tile_candidates_fit(itemsize, lane):
    compiled = {t.tiles for t in lane_tiles(lane)}
    cands = at.gemm_tile_candidates(256, 512, 1024, itemsize)
    assert cands and set(cands) <= compiled
    for tm, tn, tk in cands:
        assert tm <= 256 and tn <= 1024 and tk <= 512
    # At 2048 rows: every compiled tile that fits a block's shared memory
    # on this machine's spec, less the split-K tile (<= 16 rows).
    budget = pm.chip_spec().smem_bytes
    assert set(at.gemm_tile_candidates(2048, 5120, 5120, itemsize)) == {
        t.tiles for t in lane_tiles(lane)
        if t.smem_bytes <= budget and t.route != "splitk"}
    assert at.gemm_tile_candidates(8, 64, 32, itemsize)  # never empty
    assert at.gemm_tile_candidates(2048, 5120, 5120, itemsize,
                                   smem_budget=0) == [
        min(lane_tiles(lane), key=lambda t: t.tile_m * t.tile_n).tiles]


def test_default_path_off_card(tmp_path, monkeypatch):
    """With tuning off (or a CPU device) the tuner returns None and
    ``pallas_matmul_tuned`` runs the static tiles."""
    monkeypatch.setenv("TDTPU_AUTOTUNE_CACHE", str(tmp_path / "c.json"))
    monkeypatch.setenv("TDTPU_AUTOTUNE", "0")
    assert not at.autotune_enabled("cuda")
    monkeypatch.delenv("TDTPU_AUTOTUNE")
    assert at.autotune_enabled("cuda") and not at.autotune_enabled("cpu")
    assert at.tuned_matmul_tiles(32, 64, 128, torch.float32,
                                 device="cpu") is None
    assert at.last_tune_report(32, 64, 128, torch.float32) is None
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal((32, 64)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32))
    np.testing.assert_allclose(pallas_matmul_tuned(a, b).numpy(),
                               a.numpy() @ b.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(pallas_matmul_tuned(a, b).numpy(),
                                  pallas_matmul(a, b).numpy())


def test_chip_spec_detection():
    assert SPEC.name == "h100" and SPEC.sm_count == 132
    assert SPEC.peak_tflops(2) == 989.0 and SPEC.peak_tflops(1) == 1979.0
    assert SPEC.peak_tflops(4) == 67.0 and SPEC.smem_bytes == 232448
    assert pm.chip_spec("NVIDIA H100 PCIe").name == "h100"
    assert pm.chip_spec("cpu").name == "generic"


def test_gemm_time_monotone_and_quantized():
    t1 = pm.gemm_time_s(1024, 1024, 1024, 2, SPEC)
    t2 = pm.gemm_time_s(2048, 1024, 1024, 2, SPEC)
    assert t2 > t1 > 0
    # Tile quantization: 65 rows cost the compute of 128.
    assert pm.gemm_time_s(65, 4096, 4096, 2, SPEC) == pytest.approx(
        pm.gemm_time_s(128, 4096, 4096, 2, SPEC), rel=0.2)
    # fp8 runs at twice bf16's peak, fp32 at a fifteenth of it.
    t_bf16 = pm.gemm_time_s(4096, 4096, 4096, 2, SPEC)
    assert pm.gemm_time_s(4096, 4096, 4096, 1, SPEC) == pytest.approx(
        t_bf16 / 2, rel=0.01)
    assert pm.gemm_time_s(4096, 4096, 4096, 4, SPEC) > 10 * t_bf16


def test_gemm_tflops_below_peak():
    tf = pm.gemm_tflops(4096, 4096, 4096, 2, SPEC)
    assert 0 < tf <= SPEC.bf16_tflops


def test_rank_gemm_tiles_prefers_large_tiles():
    cands = [t.tiles for t in lane_tiles("bf16")]
    routes = tile_routes("bf16")
    ranked = pm.rank_gemm_tiles(cands, 2048, 5120, 5120, 2, SPEC,
                                routes=routes)
    assert routes[ranked[0]] == "wgmma" and set(ranked) == set(cands)
    top2 = pm.rank_gemm_tiles(cands, 2048, 5120, 5120, 2, SPEC, top=2,
                              routes=routes)
    assert top2 == ranked[:2]
    # Among the mma.sync tiles the large one leads at the headline.
    mma = [c for c in cands if routes[c] == "mma"]
    assert pm.rank_gemm_tiles(mma, 2048, 5120, 5120, 2, SPEC,
                              routes=routes)[0] == (128, 128, 32)
    # At decode the 16-row tiles waste nothing on padding rows.
    assert pm.rank_gemm_tiles(cands, 8, 4096, 4096, 2, SPEC,
                              routes=routes)[0][0] == 16


def test_autotuner_pruning_keeps_modeled_winner():
    for itemsize in (4, 2, 1):
        cands = at.gemm_tile_candidates(2048, 4096, 4096, itemsize)
        ranked = pm.rank_gemm_tiles(cands, 2048, 4096, 4096, itemsize, SPEC)
        assert ranked[0] in pm.rank_gemm_tiles(cands, 2048, 4096, 4096,
                                               itemsize, SPEC, top=4)


def test_ranking_deterministic():
    cands = [(128, 128, 32), (64, 128, 32), (16, 64, 256)]
    assert pm.rank_gemm_tiles(cands, 1024, 1024, 1024, 2, SPEC) == \
        pm.rank_gemm_tiles(cands, 1024, 1024, 1024, 2, SPEC)


def test_gemm_small_batch_far_from_peak():
    assert pm.gemm_tflops(8, 4096, 4096, 2, SPEC) < 0.1 * SPEC.bf16_tflops
    t = pm.gemm_time_s(8, 4096, 4096, 2, SPEC)
    assert t >= (4096 * 4096 * 2) / (SPEC.hbm_gbps * 1e9)


def test_numpy_ints_accepted():
    assert pm.gemm_time_s(np.int64(512), np.int64(512), np.int64(512), 2,
                          SPEC) > 0


def test_utils_vs_jax():
    for a, b in ((7, 3), (8, 4), (0, 5), (129, 64)):
        assert utils.cdiv(a, b) == jutils.cdiv(a, b)
        assert utils.round_up(a, b) == jutils.round_up(a, b)
    samples = [3.0, 1.0, 2.0, 10.0, 4.0]
    s, js = utils.PerfStats(samples), jutils.PerfStats(samples)
    assert float(s) == float(js)
    assert (s.p50, s.p95, s.min, s.max) == (js.p50, js.p95, js.min, js.max)
    import pickle

    assert pickle.loads(pickle.dumps(s)).samples == s.samples
    with pytest.raises(ValueError):
        utils.PerfStats([])


def test_perf_func_assert_allclose_and_profile(tmp_path):
    out, stats = utils.perf_func(lambda: torch.ones(3) * 2, iters=4,
                                 warmup_iters=1)
    assert torch.equal(out, torch.full((3,), 2.0))
    assert len(stats.samples) == 4 and stats.min >= 0
    x = torch.tensor([1.0, 2.0])
    utils.assert_allclose(x, jnp.asarray([1.0, 2.0]), verbose=False)
    with pytest.raises(AssertionError, match="1/2 mismatches"):
        utils.assert_allclose(x, np.asarray([1.0, 3.0]), verbose=False)
    with pytest.raises(AssertionError, match="shape mismatch"):
        utils.assert_allclose(x, np.zeros(3), verbose=False)
    with utils.group_profile("p", do_prof=True, log_dir=str(tmp_path)):
        torch.ones(4).sum()
    assert (tmp_path / "p" / "trace.json").exists()
    with utils.group_profile("q", do_prof=False, log_dir=str(tmp_path)):
        pass
    assert not (tmp_path / "q").exists()
