#!/usr/bin/env python3
"""Time the port's fused kernels B9 (AG+GEMM, ``ops/allgather_gemm.py``),
B10 (GEMM+RS, ``ops/gemm_reduce_scatter.py``) and B11 (GEMM+AR,
``ops/gemm_allreduce.py`` ``gemm_ar_stream``) of one tree at the main
path's shapes on one CUDA card.

Four virtual ranks on ``cuda:0``, bf16, the shapes of ``chip_smoke.
FUSED_MAIN`` (Qwen3-8B's 2 x 1024 "overlap" prefill: B9 at wq, wk / wv and
w_gate / w_up, 512 rows a rank; B10 at wo and w_down over 2048 rows; a
batch-2 decode step: B11 at wo and w_down, 2 rows, over one persistent
workspace). Each kernel is checked against the tree's plain version (B9:
B3's tolerance, 2^-13 sqrt(K) rms(A) rms(B) plus one unit of bf16; B10
and B11: n times that of one partial rounded to bf16, plus one unit of
the sum; B11's output also bit for bit the sum of its own slots, and the
same on every rank), then timed: every rank's stream is held (by the
tree's ``HOLD`` kernel polling one page-locked host word, released at one
instant) while the rank threads enqueue 21 calls, CUDA events between
consecutive calls on each rank's stream, a call's time
the slowest rank's, the median of the last 20 (L2 not flushed: the calls
follow each other, as on the main path); and again with events only
around the 21 calls, the slowest rank's span over 21 (``span_ms``). The
batched ``torch.matmul`` of the same products (no communication) is timed
both ways in the same run. The bound is the larger of the operations at
989 TFLOP/s and the bytes (each input read once, each output written
once, every rank through one HBM at 3.35 TB/s): B9 and B10 are bound by
operations, B11 by bytes.
Prints one JSON line per case (with the SHA-256 of the ranks' outputs:
inputs come from one seed, so two trees whose kernels compute the same
bits print the same digest; B11's route), ptxas's report of the tree's
``gemm_comm.cu`` (registers, spills, shared memory), then the card's name
and power limit. ``--only NAME[,NAME]`` runs those cases alone.

``--engine`` also serves Qwen3-8B (random weights, seed 0, bf16, 36
layers) on the 4 virtual ranks with the reference's defaults
(``Engine(cfg, params, ctx, max_seq=2048)``): the 2 x 1024 prefill
PREFILLS times (host ms: until ``prefill`` returns, its launches
enqueued; wall ms: until the synchronize after it), a serve of
8 tokens three times (decode ms a step: the serve less the median
prefill, over 7 steps), and one prefill under ``torch.profiler`` (the
card's kernel time, all ranks together, and B9 / B10's part of it); then
the same serves under ``TDTPU_GEMM_AR=1`` (B11 in place of the parity
AllReduce, 2 a layer a rank) and one 8-token serve of a 2 x 64 prompt
under ``torch.profiler``: B11's device time a decode step and rank, and
its routes. The rank threads enqueue one at a time, so the wall time
moves with the host's speed; the kernel time does not.

To compare two commits on one card, unpack the other one's tree with
``git archive`` into a git-ignored directory and run, in one call, parent,
change, change, parent:

    python3 scripts/time_port_gemm_comm.py [--tree DIR] [--label NAME]
        [--engine] [--only NAME,...]
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

os.environ["CUDA_DEVICE_MAX_CONNECTIONS"] = "32"

RANKS = 4
# (op, name, rows a rank, K, N)
CASES = [("ag_gemm", "wq", 512, 4096, 1024),
         ("ag_gemm", "wk_wv", 512, 4096, 256),
         ("ag_gemm", "gate_up", 512, 4096, 3072),
         ("gemm_rs", "wo", 2048, 1024, 4096),
         ("gemm_rs", "down", 2048, 3072, 4096),
         ("gemm_ar", "wo", 2, 1024, 4096),
         ("gemm_ar", "down", 2, 3072, 4096)]
CALLS = 21
HBM_BYTES_PER_S = 3.35e12
PREFILLS = 15


def spaced_ms(torch, ctx, comm, build, fn, every: bool = True) -> float:
    """The streams held while CALLS calls are enqueued (by the tree's
    ``HOLD`` kernel polling one page-locked host word, released at one
    instant; a tree without it holds with ``SPIN`` for a duration);
    ``every``: the median over calls 2..CALLS of the slowest rank's time
    between consecutive events (an event after every call); else the
    slowest rank's span over the CALLS calls divided by CALLS (events only
    around them: an event recorded on each of n streams costs the card's
    front end about what a short call does)."""
    n = ctx.num_ranks
    ctx.run(lambda r: [fn(r) for _ in range(3)])
    torch.cuda.synchronize()
    go = (torch.zeros(1, dtype=torch.int32).pin_memory()
          if hasattr(comm, "HOLD") else None)
    hold = 0.05
    for _ in range(4):
        evs = [[torch.cuda.Event(enable_timing=True)
                for _ in range(CALLS + 1)] for _ in range(n)]

        def body(r):
            stream = build.current_stream(ctx.devices[r])
            if go is not None:
                comm.HOLD.launch(build.ptr(go), int(hold * 1e9), stream)
            else:
                comm.SPIN.launch(int(hold * 1e9), stream)
            evs[r][0].record()
            for i in range(CALLS):
                fn(r)
                if every or i == CALLS - 1:
                    evs[r][i + 1].record()

        if go is not None:
            go.zero_()
        t0 = time.perf_counter()
        ctx.run(body)
        enqueue = time.perf_counter() - t0
        if go is not None:
            go.fill_(1)
        torch.cuda.synchronize()
        ctx.raise_on_comm_error()
        if enqueue < hold:
            if not every:
                return max(evs[r][0].elapsed_time(evs[r][CALLS])
                           for r in range(n)) / CALLS
            per = [max(evs[r][i].elapsed_time(evs[r][i + 1])
                       for r in range(n)) for i in range(1, CALLS)]
            return statistics.median(per)
        hold *= 2
    raise RuntimeError("the enqueue outlasted every hold")


def library_ms(torch, fn, every: bool = True) -> float:
    """Median of CALLS - 1 back-to-back calls of ``fn``, events between;
    else (``every`` False) the span of CALLS calls over CALLS."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    evs = [torch.cuda.Event(enable_timing=True) for _ in range(CALLS + 1)]
    evs[0].record()
    for i in range(CALLS):
        fn()
        if every or i == CALLS - 1:
            evs[i + 1].record()
    torch.cuda.synchronize()
    if not every:
        return evs[0].elapsed_time(evs[CALLS]) / CALLS
    return statistics.median(evs[i].elapsed_time(evs[i + 1])
                             for i in range(1, CALLS))


def gemm_share(got, want, atol) -> tuple:
    """(max |got - want|, largest share of atol + one unit of bf16 (2^-7
    relative) one element used)."""
    diff = (got.float() - want.float()).abs()
    tol = atol + 2.0 ** -7 * want.float().abs()
    return diff.max().item(), (diff / tol).max().item()


def kernel_case(torch, ctx, mods, op, name, m, k, ncols, seed) -> dict:
    agm, grs, gar, comm, build = mods
    n = ctx.num_ranks
    g = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn((n, m, k), generator=g, device="cuda").bfloat16()
    W = (torch.randn((n, k, ncols), generator=g, device="cuda")
         * k ** -0.5).bfloat16()
    xs, bs = list(X), list(W)
    spread = (k ** 0.5 * X.float().pow(2).mean().sqrt().item()
              * W.float().pow(2).mean().sqrt().item())
    kern = {"ag_gemm": comm.AG_GEMM_KERNEL, "gemm_rs": comm.GEMM_RS_KERNEL,
            "gemm_ar": comm.GEMM_AR_KERNEL}[op]
    kern.variant_launches = {}
    slots_ok = True
    if op == "ag_gemm":
        def fn(r):
            return agm.ag_gemm_local(xs[r], bs[r], num_ranks=n)
        full = torch.cat(xs)
        sub = agm._ag_sub_chunks(m, agm.AGGemmConfig().sub_chunks,
                                 torch.bfloat16)
        want = [agm.ag_gemm_plain(full, W[r], n, sub, r) for r in range(n)]
        flops = n * 2.0 * n * m * k * ncols
        nbytes = (n * m * k + n * k * ncols + n * n * m * ncols) * 2

        def lib():
            return torch.matmul(full.expand(n, n * m, k), W)
    elif op == "gemm_rs":
        def fn(r):
            return grs.gemm_rs_local(xs[r], bs[r], num_ranks=n)
        want = [grs.gemm_rs_plain(xs, bs, r) for r in range(n)]
        flops = n * 2.0 * m * k * ncols
        nbytes = (n * m * k + n * k * ncols + m * ncols) * 2

        def lib():
            return torch.matmul(X, W)
    else:
        ws, _ = gar.gemm_ar_stream_workspace(n, m, ncols, torch.bfloat16,
                                             ctx=ctx, tag=f"time-{name}")
        idx = list(ws.epochs)

        def fn(r):
            out, _, idx[r] = gar.gemm_ar_stream(xs[r], bs[r], ws, idx[r],
                                                num_ranks=n)
            return out
        p = idx[0] % 2
        want = [gar.gemm_ar_plain(xs, bs)] * n
        flops = n * 2.0 * m * k * ncols
        nbytes = (n * m * k + n * k * ncols + n * m * ncols) * 2

        def lib():
            return torch.matmul(X, W)
    got = ctx.run(fn)
    torch.cuda.synchronize()
    ctx.raise_on_comm_error()
    if op == "gemm_ar":
        # The communication: each rank's output is its own slots' sum.
        nch = ws.tensors[0].shape[1]
        for r in range(n):
            slab = ws.tensors[r][p][:, :, :m]
            red = torch.cat([gar.reduce_slots_plain(slab[c])
                             for c in range(nch)], dim=1)
            slots_ok = slots_ok and torch.equal(red, got[r])
        slots_ok = slots_ok and all(torch.equal(o, got[0]) for o in got)
    # B9: B3's tolerance, 2^-13 s plus one unit. B10 and B11 sum n
    # partials, each rounded to bf16 (within B3's tolerance, and one unit
    # of a value of about s, counted as 4 s): n times that, plus one unit
    # of the sum.
    atol = (2.0 ** -13 * spread if op == "ag_gemm"
            else n * (2.0 ** -13 + 4 * 2.0 ** -7) * spread)
    errs = [gemm_share(o, w, atol) for o, w in zip(got, want)]
    digest = hashlib.sha256()
    for o in got:
        digest.update(o.contiguous().view(torch.uint8).cpu().numpy()
                      .tobytes())
    rec = {"case": f"{op}_{name}", "ranks": n, "rows": m, "k": k,
           "ncols": ncols, "max_abs_err": max(e for e, _ in errs),
           "tol_share": max(s for _, s in errs),
           "finite": all(bool(torch.isfinite(o).all()) for o in got),
           "sha256": digest.hexdigest()}
    if op == "gemm_ar":
        rec["slots_sum_bit_identical"] = slots_ok
    rec["ok"] = rec["finite"] and rec["tol_share"] <= 1.0 and slots_ok
    rec["ms"] = spaced_ms(torch, ctx, comm, build, fn)
    rec["span_ms"] = spaced_ms(torch, ctx, comm, build, fn, every=False)
    rec["library_ms"] = library_ms(torch, lib)
    rec["library_span_ms"] = library_ms(torch, lib, every=False)
    by_ops, by_bytes = flops / 989e12 * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    rec["bound_ms"] = max(by_ops, by_bytes)
    rec["bound_by"] = "operations" if by_ops >= by_bytes else "bytes"
    rec["routes"] = dict(getattr(kern, "variant_launches", {}))
    return rec


def prefill_device_ms(torch, eng, ids) -> dict:
    """One prefill under ``torch.profiler``: the card's kernel time, all
    ranks together and B9 / B10's share of it (ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.prefill(ids)
        torch.cuda.synchronize()
    total = fused = 0.0
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = (getattr(e, "self_device_time_total", None)
              or getattr(e, "self_cuda_time_total", 0.0))
        total += us
        if "ag_gemm" in e.key or "gemm_rs" in e.key:
            fused += us
    return {"device_ms_all_ranks": total / 1e3,
            "b9_b10_ms_all_ranks": fused / 1e3}


def engine_case(torch, root) -> dict:
    from triton_distributed_tpu_torch.models.config import QWEN3_8B
    from triton_distributed_tpu_torch.models.dense import init_dense_llm
    from triton_distributed_tpu_torch.models.engine import Engine
    from triton_distributed_tpu_torch.runtime.context import (
        initialize_distributed,
    )

    cfg = QWEN3_8B
    params = init_dense_llm(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0))
    ctx = initialize_distributed(devices=["cuda:0"] * RANKS,
                                 wait_timeout_ms=60_000)
    eng = Engine(cfg, params, ctx, max_seq=2048)
    del params
    g = torch.Generator(device="cuda").manual_seed(31)
    ids = torch.randint(0, cfg.vocab_size, (2, 1024), generator=g,
                        device="cuda", dtype=torch.int32)
    gen = 8
    eng.serve(ids[:, :64], 2)
    prefill, host, serve = [], [], []
    for _ in range(PREFILLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.prefill(ids)
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        prefill.append((time.perf_counter() - t0) * 1e3)
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.serve(ids, gen)
        torch.cuda.synchronize()
        serve.append((time.perf_counter() - t0) * 1e3)
    pre = statistics.median(prefill)
    rec = {"case": "tp_engine_2x1024", "ranks": RANKS,
           "layers": cfg.num_layers, "mode": eng._prefill_mode(2, 1024),
           "prefill_ms": prefill, "prefill_ms_median": pre,
           "prefill_host_ms": host,
           "prefill_host_ms_median": statistics.median(host),
           "prefill_tail_ms_median": statistics.median(
               w - h for w, h in zip(prefill, host)),
           "decode_ms_per_step": [(s - pre) / (gen - 1) for s in serve],
           "tokens_ok": tuple(out.shape) == (2, gen)}
    rec.update(prefill_device_ms(torch, eng, ids))
    rec.update(gemm_ar_decode(torch, eng, ids, gen, pre))
    eng.check_comm()
    del eng
    ctx.close()
    return rec


def gemm_ar_decode(torch, eng, ids, gen, pre) -> dict:
    """The serve of :func:`engine_case` under ``TDTPU_GEMM_AR=1`` (B11 in
    place of the parity AllReduce): decode ms a step (its prefill's median
    ``pre`` taken off), then one serve of a 2 x 64 prompt under
    ``torch.profiler``: B11's device time a decode step and rank, its
    launches a step and rank, and its routes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    comm = importlib.import_module("triton_distributed_tpu_torch.ops._comm")
    prev = os.environ.get("TDTPU_GEMM_AR")
    os.environ["TDTPU_GEMM_AR"] = "1"
    try:
        eng.serve(ids[:, :64], 2)
        serve = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.serve(ids, gen)
            torch.cuda.synchronize()
            serve.append((time.perf_counter() - t0) * 1e3)
        comm.GEMM_AR_KERNEL.variant_launches = {}
        k0 = comm.GEMM_AR_KERNEL.launches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng.serve(ids[:, :64], gen)
            torch.cuda.synchronize()
        launches = comm.GEMM_AR_KERNEL.launches - k0
    finally:
        if prev is None:
            os.environ.pop("TDTPU_GEMM_AR", None)
        else:
            os.environ["TDTPU_GEMM_AR"] = prev
    us, count = 0.0, 0
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        if "gemm_ar" in e.key:
            us += (getattr(e, "self_device_time_total", None)
                   or getattr(e, "self_cuda_time_total", 0.0))
            count += e.count
    per_step = 2 * eng.cfg.num_layers * eng.n    # B11 launches a step
    steps = count / per_step if count else 0
    return {"gemm_ar_decode_ms_per_step": [(t - pre) / (gen - 1)
                                           for t in serve],
            "gemm_ar_launches": launches,
            "gemm_ar_kernels_profiled": count,
            "gemm_ar_routes": dict(comm.GEMM_AR_KERNEL.variant_launches),
            "gemm_ar_device_ms_per_step_per_rank":
                us / 1e3 / steps / eng.n if steps else None}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=".", help="root of the tree to time")
    ap.add_argument("--label", default=None)
    ap.add_argument("--engine", action="store_true",
                    help="also time tp_engine's 2 x 1024 serve")
    ap.add_argument("--only", default=None,
                    help="comma-separated case names to run (default all)")
    args = ap.parse_args()
    only = set(args.only.split(",")) if args.only else None
    root = os.path.abspath(args.tree)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("time_port_gemm_comm: needs a CUDA card", file=sys.stderr)
        return 1
    agm = importlib.import_module(
        "triton_distributed_tpu_torch.ops.allgather_gemm")
    if not agm.__file__.startswith(root):
        print(f"time_port_gemm_comm: imported {agm.__file__}, not "
              f"{root}'s", file=sys.stderr)
        return 1
    grs = importlib.import_module(
        "triton_distributed_tpu_torch.ops.gemm_reduce_scatter")
    gar = importlib.import_module(
        "triton_distributed_tpu_torch.ops.gemm_allreduce")
    comm = importlib.import_module("triton_distributed_tpu_torch.ops._comm")
    build = importlib.import_module(
        "triton_distributed_tpu_torch.runtime.build")
    from triton_distributed_tpu_torch.runtime.context import DistContext

    label = args.label or root
    t0 = time.perf_counter()
    build.build([comm.AG_GEMM_KERNEL.source_path,
                 comm.SPIN.source_path])
    log = build.library_path(comm.AG_GEMM_KERNEL.source_path).with_suffix(
        ".log").read_text()
    print(json.dumps({"tree": label, "build_s": time.perf_counter() - t0,
                      "ptxas": [ln.strip() for ln in log.splitlines()
                                if "Compiling" in ln or "registers" in ln
                                or "spill" in ln or "warning" in ln]}),
          flush=True)
    ctx = DistContext([torch.device("cuda:0")] * RANKS,
                      wait_timeout_ms=20_000)
    mods = (agm, grs, gar, comm, build)
    failed = []
    for i, (op, name, m, k, ncols) in enumerate(CASES):
        if only is not None and f"{op}_{name}" not in only:
            continue
        rec = kernel_case(torch, ctx, mods, op, name, m, k, ncols, 900 + i)
        rec["tree"] = label
        print(json.dumps(rec), flush=True)
        if not rec["ok"]:
            failed.append(rec["case"])
    ctx.close()
    if args.engine:
        rec = engine_case(torch, root)
        rec["tree"] = label
        print(json.dumps(rec), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
