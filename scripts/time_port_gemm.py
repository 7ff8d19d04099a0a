#!/usr/bin/env python3
"""Time the port's kernel B3 (the tiled GEMM, ``ops/gemm.py``) of one tree
at the main path's shapes on one CUDA card.

Builds the tree's ``csrc/gemm.cu``, prints ptxas's register, spill and
shared-memory report for it, then times B3 with CUDA events, the L2 cache
flushed before each launch (as ``chip_smoke.Timer``), median of 20: the
headline M=2048, K=N=5120 in bf16 and in e4m3 with bf16 out, the four
Qwen3-8B decode products at M=1 in e4m3 (fp32 out, as ``fp8_dot`` runs
them), m=8 in bf16 and e4m3, and the Qwen3-30B-A3B expert products at 4
rows; where the tree compiles more than one wgmma width, the headline at
each. Each case is printed as one JSON line with the route it launched on
(``variant_launches``; none for a tree without routes), the SHA-256 of its
output (inputs drawn from one seed, so two trees whose B3 computes the same
bits print the same digests), its error against the tree's plain version,
its kernels' device time alone (``torch.profiler``), the host's time to
enqueue one call (the wrapper, the tensor maps, the launch), the one-call
PyTorch yardstick (``torch.matmul`` in bf16,
``torch._scaled_mm`` with unit scales in e4m3) and the bound; then the
card's name and power limit.

``--sweep-splits`` also times, for a tree with the split-K route, each
M <= 16 case's kernel at every cluster size of 1-8 CTAs (the profiler's
kernel time; the plan's own size marked), the measurement behind
``ops/gemm.SPLITK_CTAS_PER_SM``.

To compare two commits on one card, unpack the other one's tree with
``git archive`` into a git-ignored directory and run, in one call, parent,
change, change, parent:

    python3 scripts/time_port_gemm.py [--tree DIR] [--label NAME]
        [--sweep-splits]
"""
import argparse
import hashlib
import importlib
import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12
PEAK = {"bf16": 989e12, "e4m3": 1979e12}
# (name, m, k, n, lane, out, caps or None)
CASES = [
    ("headline_bf16", 2048, 5120, 5120, "bf16", "bf16", None),
    ("headline_e4m3_bf16_out", 2048, 5120, 5120, "e4m3", "bf16", None),
    ("decode_m1_gate_up_e4m3", 1, 4096, 12288, "e4m3", "fp32", None),
    ("decode_m1_down_e4m3", 1, 12288, 4096, "e4m3", "fp32", None),
    ("decode_m1_wq_wo_e4m3", 1, 4096, 4096, "e4m3", "fp32", None),
    ("decode_m1_wk_wv_e4m3", 1, 4096, 1024, "e4m3", "fp32", None),
    ("m8_bf16", 8, 5120, 5120, "bf16", "bf16", None),
    ("m8_e4m3", 8, 5120, 5120, "e4m3", "fp32", None),
    ("expert_m4_gate_up_e4m3", 4, 2048, 768, "e4m3", "fp32", None),
    ("expert_m4_down_e4m3", 4, 768, 2048, "e4m3", "fp32", None),
]


def timed_ms(torch, flush, fn, iters: int = 20) -> float:
    """Median CUDA-event time of ``fn`` over ``iters`` launches, the L2
    cache flushed before each."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_us(torch, flush, fn, iters: int = 10) -> float:
    """Device microseconds of ``fn``'s kernels a call (``torch.profiler``'s
    CUDA activity), the L2 flushed before each call and its fill kernel
    left out: the kernel alone, without the launch's latency."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        name = ev.key.lower()
        if ev.key.startswith("cuda") or "fill" in name or "elementwise" in \
                name or "memset" in name or "activity" in name:
            continue
        total += (getattr(ev, "device_time_total", None)
                  or getattr(ev, "cuda_time_total", 0))
    return total / iters


def host_us(torch, fn, iters: int = 50) -> float:
    """Host microseconds to enqueue one call, over ``iters`` calls without
    a synchronize between them."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / iters * 1e6


def sweep_splits(torch, flush, gemm, a, b, out_dt) -> dict:
    """Kernel microseconds of the split-K route at (a, b) for each cluster
    size that leaves no CTA empty, the plan's own marked with a star."""
    from triton_distributed_tpu_torch.runtime.build import (
        current_stream, ptr,
    )

    m, k = a.shape
    n = b.shape[1]
    lane = gemm.gemm_lane(a.dtype, b.dtype)
    tile = next(t for t in gemm.lane_tiles(lane) if t.route == "splitk")
    out = torch.empty((m, n), dtype=out_dt, device=a.device)
    code = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}
    steps = -(-k // gemm.SPLITK_STEP)
    own = gemm.splitk_plan(lane, m, n, k)
    res = {}
    for splits in range(1, gemm.SPLITK_MAX_CLUSTER + 1):
        per = -(-steps // splits)
        if (splits - 1) * per >= steps:
            continue
        chunk = min(per, (gemm.SPLITK_SMEM_BYTES // m - 16)
                    // (gemm.SPLITK_STEP * a.element_size()))

        def launch():
            gemm.GEMM_KERNEL.launch(
                ptr(a), ptr(b), ptr(out), ptr(None), m, n, k,
                code[a.dtype], code[b.dtype], code[out_dt], tile.index, 1,
                1, splits, per, chunk, current_stream(a.device))
        key = f"{splits}{'*' if splits == own[0] else ''}"
        res[key] = kernel_us(torch, flush, launch)
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=".", help="root of the tree to time")
    ap.add_argument("--label", default=None)
    ap.add_argument("--sweep-splits", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.tree)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("time_port_gemm: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    gemm = importlib.import_module("triton_distributed_tpu_torch.ops.gemm")
    if not gemm.__file__.startswith(root):
        print(f"time_port_gemm: imported {gemm.__file__}, not {root}'s",
              file=sys.stderr)
        return 1
    from triton_distributed_tpu_torch.models.fp8 import saturate_cast
    from triton_distributed_tpu_torch.runtime import build

    label = args.label or root
    src = gemm.GEMM_KERNEL.source_path
    t0 = time.perf_counter()
    build.build([src])
    log = build.library_path(src).with_suffix(".log").read_text()
    print(json.dumps({"tree": label, "build_s": time.perf_counter() - t0,
                      "ptxas": [ln.strip() for ln in log.splitlines()
                                if "registers" in ln or "spill" in ln
                                or "smem" in ln]}), flush=True)
    dts = {"bf16": torch.bfloat16, "e4m3": torch.float8_e4m3fn,
           "fp32": torch.float32}
    cases = list(CASES)
    wg = [t for t in gemm.lane_tiles("bf16")
          if getattr(t, "route", None) == "wgmma"]
    if len(wg) > 1:
        cases += [(f"headline_bf16_wgmma_{t.tile_m}x{t.tile_n}", 2048, 5120,
                   5120, "bf16", "bf16", t.tiles) for t in wg]
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    one = torch.ones((), device="cuda")
    failed = []
    for name, m, k, n, lane, out_name, caps in cases:
        g = torch.Generator(device="cuda").manual_seed(k * 7 + n + m)
        dt, out_dt = dts[lane], dts[out_name]
        b_scale = 1.0 if lane == "e4m3" else k ** -0.5
        a = saturate_cast(torch.randn((m, k), generator=g, device="cuda"),
                          dt)
        b = saturate_cast(torch.randn((k, n), generator=g, device="cuda")
                          * b_scale, dt)
        kw = {"out_dtype": out_dt}
        if caps:
            kw.update(tile_m=caps[0], tile_n=caps[1], tile_k=caps[2])
        before = dict(gemm.GEMM_KERNEL.variant_launches)
        got = gemm.pallas_matmul(a, b, **kw)
        routes = [r for r in getattr(gemm, "ROUTES", ())
                  if gemm.GEMM_KERNEL.variant_launches.get(r, 0)
                  > before.get(r, 0)]
        want = gemm.matmul_plain(a, b, out_dt)
        torch.cuda.synchronize()
        spread = (k ** 0.5) * a.float().pow(2).mean().sqrt().item() \
            * b.float().pow(2).mean().sqrt().item()
        err = (got.float() - want.float()).abs()
        # chip_smoke's GEMM_TOL / GEMM_ROUND for this lane and output.
        atol = (2.0 ** -10 if lane == "e4m3" else 2.0 ** -13) * spread
        rtol = 2.0 ** -7 if out_dt == torch.bfloat16 else 0.0
        ok = bool(torch.isfinite(got.float()).all()
                  and (err <= atol + rtol * want.float().abs()).all())
        nbytes = m * k * a.element_size() + k * n * b.element_size() \
            + m * n * got.element_size()
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2.0 * m * n * k / PEAK[lane]
        rec = {"tree": label, "case": name, "m": m, "k": k, "n": n,
               "lane": lane, "out": out_name, "routes": routes,
               "max_abs_err": err.max().item(), "ok": ok,
               "sha256": hashlib.sha256(got.contiguous().view(torch.uint8)
                                        .cpu().numpy().tobytes()).hexdigest(),
               "ms": timed_ms(torch, flush,
                              lambda: gemm.pallas_matmul(a, b, **kw)),
               "kernel_us": kernel_us(torch, flush,
                                      lambda: gemm.pallas_matmul(a, b, **kw)),
               "host_us": host_us(torch,
                                  lambda: gemm.pallas_matmul(a, b, **kw)),
               "bound_ms": max(t_bytes, t_ops) * 1e3,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        if lane == "bf16" and out_name == "bf16":
            rec["library"] = "torch.matmul"
            lib = lambda: torch.matmul(a, b)            # noqa: E731
        else:
            bt = b.t().contiguous().t()
            rec["library"] = "torch._scaled_mm"
            lib = lambda: torch._scaled_mm(             # noqa: E731
                a, bt, scale_a=one, scale_b=one, out_dtype=out_dt)
        try:
            rec["library_ms"] = timed_ms(torch, flush, lib)
            rec["library_kernel_us"] = kernel_us(torch, flush, lib)
        except RuntimeError as e:        # the yardstick only
            rec["library_refused"] = str(e)[:200]
        if args.sweep_splits and routes == ["splitk"]:
            rec["splits_kernel_us"] = sweep_splits(torch, flush, gemm, a, b,
                                                   out_dt)
        print(json.dumps(rec), flush=True)
        if not ok:
            failed.append(name)
    if wg:
        # The wgmma route encodes two tensor maps on the host every call:
        # a small product on it and on the mma.sync tile, host-bound, the
        # difference their cost (and the occupancy query's, made once).
        a = torch.randn((64, 256), device="cuda").bfloat16()
        b = torch.randn((256, 256), device="cuda").bfloat16()
        mma = next(t for t in gemm.lane_tiles("bf16") if t.route == "mma")
        rec = {"tree": label, "case": "host_tensor_maps", "m": 64, "k": 256,
               "n": 256}
        for t in (wg[-1], mma):
            rec[f"host_us_{t.route}"] = host_us(
                torch, lambda: gemm.pallas_matmul(a, b, *t.tiles), 400)
        print(json.dumps(rec), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
