#!/usr/bin/env python3
"""Time the port's copy kernels B4's full-mesh push (``ops/allgather.py``
``all_gather_local(method="full_mesh_push")``), B7's shift and permutation
(``ops/p2p.py``), B12's torus AllGather and AllReduce (``ops/multi_axis.py``
through ``all_gather_local`` / ``all_reduce_local`` over both axes), B5's
double tree (``ops/allreduce.py`` ``method="tree"``), B6's ring
reduce-scatter (``ops/reduce_scatter.py`` ``reduce_scatter_local``) and
B8's parity AllToAll (``ops/all_to_all.py`` ``fast_all_to_all_stream``)
of one tree at the main path's shapes on one CUDA card, each beside the
PyTorch call that computes the same outputs.

Main shapes (virtual ranks on ``cuda:0``, bf16): the push at n = 2, 1024
rows a rank x 2048 (the sequential "overlap" TP-MoE layer's tokens at
Qwen3-30B-A3B's hidden); B7 at n = 4, one 512 x 4096 microbatch (Qwen3-8B's
pipeline stage boundary), the shift by one and a butterfly permutation;
B12 on a (2, 4) grid of 8 ranks, the AllGather of 256 x 4096 a rank and
the AllReduce of 16 x 4096; the tree at n = 4, 203 x 4096 (a 1 x 203
prompt's "ar" prefill); B6 at n = 4, 256 x 4096 a rank into 64-row chunks
(the two-shot AllReduce's first half on a 256-row prefill slice); B8's
parity stream at n = 4, cap 32 x 2048 a slot, the splits of 4 tokens a
rank routed top-8 over 128 experts (the EP decode's dispatch).
Each case is first checked bit for bit against the tree's plain version on
every rank, then timed: every rank's stream is held while the rank threads
enqueue CALLS calls (by the tree's ``HOLD`` kernel polling one page-locked
host word, released at one instant; a tree without it holds with its
``SPIN`` for a duration), CUDA events between consecutive calls on each
rank's stream, a call's time the slowest rank's, the median of calls
2..CALLS (``ms``); and again with events only around the CALLS calls, the
slowest rank's span over CALLS (``span_ms``: an event recorded on each of
n streams costs the card's front end about what a small call does). L2 is
not flushed: the calls follow each other, as on the main path. The
library call is timed both ways in the same run (its one stream held by
``SPIN``): for the push ``torch.cat`` of the n chunks once a rank (n
calls), for B7 one ``Y.copy_(X)`` of every rank's block, for the torus
AllGather ``torch.cat`` once a rank, for the AllReduces ``X.sum(0)`` once
a rank, for B6 one ``X.sum(0)`` (it makes every rank's chunk), for B8
``S.transpose(0, 1).contiguous()`` of the slot matrix. The bound: the
bytes every rank must move (each source read once, each output written
once; B8 each slot's token rows and the splits) through one HBM at 3.35
TB/s. Prints one JSON line a case (with each rank's output's SHA-256 —
B8's live rows and splits —, the same in every tree), ptxas's report of
``collectives.cu``, ``p2p.cu``, ``multi_axis.cu`` and ``all_to_all.cu``
(registers, spills, shared memory), the launch floor (a kernel that exits
at once, on each rank's stream, timed both ways), then the card's name and
power limit. ``--only NAME[,NAME]`` runs those cases alone.

``--paths`` also reads the walls of the paths that run these kernels, from
the tree's own ``chip_smoke.py``: ``phase_pp_forward`` on Qwen3-8B (random
weights, seed 0; GPipe and interleaved, 10 and 54 shifts a rank),
``phase_sp_prefill`` (S = 8192; the SP-AG attention's wall among them) and
``Engine.prefill`` of a 1 x 203 prompt on 4 ranks (the "ar" prefill, 72
tree AllReduces a rank): its wall, and the tree kernel's device time a
prefill and rank from ``torch.profiler``; a 256-row prefill slice on 4
ranks (``ServingEngine(max_batch=4, prefill_chunk=256)`` on Qwen3-8B, a
256-token prompt, one new token: 72 two-shot AllReduces a rank, each a B6
and a B4 ring launch), its wall and B6's device time a slice and rank;
and the EP layer's decode stream (``chip_smoke.ep_run`` over EP_LAYERS
random bf16 layers at Qwen3-30B-A3B's MoE widths, 4 tokens a rank, 4
ranks), its ms a layer and B8's device time a layer and rank.

To compare two commits on one card, unpack the other one's tree with
``git archive`` into a git-ignored directory and run, in one call, parent,
change, change, parent:

    python3 scripts/time_port_copy.py [--tree DIR] [--label NAME] [--paths]
                                      [--only NAME,...]
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

CALLS = 21
HBM_BYTES_PER_S = 3.35e12
# (case, kernel, ranks, rows, cols)
CASES = [("ag_full_mesh_n2", "push", 2, 1024, 2048),
         ("p2p_shift_n4", "shift", 4, 512, 4096),
         ("p2p_butterfly_n4", "butterfly", 4, 512, 4096),
         ("ag_torus_2x4", "ag_torus", 8, 256, 4096),
         ("ar_torus_2x4", "ar_torus", 8, 16, 4096),
         ("ar_tree_n4", "tree", 4, 203, 4096),
         ("rs_ring_n4", "rs", 4, 256, 4096),
         ("a2a_parity_n4", "a2a", 4, 32, 2048)]
GRID_2D = (2, 4)
TREE_PROMPT = 203
SLICE = 256                  # the TP serving loop's prefill chunk
EP_LAYERS = 8
A2A_EXPERTS, A2A_TOPK = 128, 8


def spaced_ms(torch, ctx, comm, build, fn, every: bool = True) -> tuple:
    """(ms a call, the hold used). The streams are held while CALLS calls
    are enqueued; ``every``: the median over calls 2..CALLS of the slowest
    rank's time between consecutive events (an event after every call);
    else the slowest rank's span over the CALLS calls divided by CALLS
    (events only around them: an event recorded on each of n streams
    costs the card's front end about as much as a small call)."""
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
            kind = "go_word" if go is not None else "spin"
            if not every:
                return max(evs[r][0].elapsed_time(evs[r][CALLS])
                           for r in range(n)) / CALLS, kind
            per = [max(evs[r][i].elapsed_time(evs[r][i + 1])
                       for r in range(n)) for i in range(1, CALLS)]
            return statistics.median(per), kind
        hold *= 2
    raise RuntimeError("the enqueue outlasted every hold")


def library_ms(torch, comm, build, fn, every: bool = True) -> float:
    """As :func:`spaced_ms` for one PyTorch call on the current stream,
    held by the tree's ``SPIN`` while the calls are enqueued (a call of a
    few microseconds is shorter than its launch on the host)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    hold = 0.02
    for _ in range(4):
        evs = [torch.cuda.Event(enable_timing=True)
               for _ in range(CALLS + 1)]
        t0 = time.perf_counter()
        comm.SPIN.launch(int(hold * 1e9),
                         build.current_stream(torch.device("cuda:0")))
        evs[0].record()
        for i in range(CALLS):
            fn()
            if every or i == CALLS - 1:
                evs[i + 1].record()
        enqueue = time.perf_counter() - t0
        torch.cuda.synchronize()
        if enqueue < hold:
            if not every:
                return evs[0].elapsed_time(evs[CALLS]) / CALLS
            return statistics.median(evs[i].elapsed_time(evs[i + 1])
                                     for i in range(1, CALLS))
        hold *= 2
    raise RuntimeError("the enqueue outlasted every hold")


def copy_case(torch, mods, name, kind, n, rows, cols, seed) -> dict:
    """One main-shape case: checked bit for bit on every rank, then
    timed beside its library call."""
    ag, p2p, comm, build, context, ar, ma, rs, _ = mods
    if kind in ("ag_torus", "ar_torus"):
        ctx = context.DistContext([torch.device("cuda:0")] * n,
                                  mesh_shape=GRID_2D,
                                  axis_names=("dcn", "tp"),
                                  wait_timeout_ms=20_000)
    else:
        ctx = context.DistContext([torch.device("cuda:0")] * n,
                                  wait_timeout_ms=20_000)
    g = torch.Generator(device="cuda").manual_seed(seed)
    X = (torch.randn((n, rows, cols), generator=g, device="cuda")
         * 4).bfloat16()
    xs = list(X)
    B = rows * cols * X.element_size()
    if kind in ("push", "ag_torus"):
        if kind == "push":
            def fn(r):
                return ag.all_gather_local(xs[r], num_ranks=n,
                                           method="full_mesh_push")
        else:
            def fn(r):
                return ag.all_gather_local(xs[r], axis=("dcn", "tp"),
                                           num_ranks=GRID_2D)
        want = [ag.ag_plain(xs)] * n
        nbytes = n * (B + n * B)

        def lib():
            for _ in range(n):
                torch.cat(xs)
        lib_call = f"{n} x torch.cat of the {n} chunks"
    elif kind in ("ar_torus", "tree"):
        if kind == "tree":
            def fn(r):
                return ar.all_reduce_local(xs[r], num_ranks=n,
                                           method="tree")
            want = [ar.tree_plain(xs)] * n
        else:
            def fn(r):
                return ar.all_reduce_local(xs[r], axis=("dcn", "tp"),
                                           num_ranks=GRID_2D)
            want = [ma.ar_torus_plain(xs, *GRID_2D)] * n
        nbytes = n * 2 * B

        def lib():
            for _ in range(n):
                X.sum(0)
        lib_call = f"{n} x X.sum(0) over the stacked inputs"
    elif kind == "rs":
        def fn(r):
            return rs.reduce_scatter_local(xs[r], num_ranks=n)
        want = [rs.rs_ring_plain(xs, r) for r in range(n)]
        nbytes = n * (B + B // n)

        def lib():
            X.sum(0)
        lib_call = "X.sum(0) over the stacked inputs (every rank's chunk)"
    else:
        perm = ([(s, (s + 1) % n) for s in range(n)] if kind == "shift"
                else [(s, s ^ 1) for s in range(n)])

        def fn(r):
            if kind == "shift":
                return p2p.p2p_shift_local(xs[r], 1, num_ranks=n)
            return p2p.p2p_permute_local(xs[r], perm, num_ranks=n)
        want = p2p.p2p_plain(xs, perm)
        nbytes = n * B + n * B
        Y = torch.empty_like(X)

        def lib():
            Y.copy_(X)
        lib_call = "Y.copy_(X) of every rank's block"
    got = ctx.run(fn)
    torch.cuda.synchronize()
    ctx.raise_on_comm_error()
    same = all(torch.equal(o.view(torch.int16), w.view(torch.int16))
               for o, w in zip(got, want))
    sha = sorted({hashlib.sha256(o.view(torch.uint8).cpu().numpy()
                                 .tobytes()).hexdigest()[:16] for o in got})
    ms, hold = spaced_ms(torch, ctx, comm, build, fn)
    span, _ = spaced_ms(torch, ctx, comm, build, fn, every=False)
    ctx.close()
    return {"case": name, "ranks": n, "rows": rows, "cols": cols,
            "dtype": "bfloat16", "bit_identical": same, "ok": same,
            "sha256_16": sha,
            "ms": ms, "span_ms": span, "hold": hold,
            "library_ms": library_ms(torch, comm, build, lib),
            "library_span_ms": library_ms(torch, comm, build, lib,
                                          every=False),
            "library_call": lib_call, "bytes": nbytes,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}


def a2a_inputs(torch, n: int, cap: int, h: int, seed: int):
    """The EP decode's dispatch (``chip_smoke.a2a_inputs``' "main"): cap /
    A2A_TOPK tokens a rank, each routed to A2A_TOPK distinct experts of
    A2A_EXPERTS drawn uniformly, so a rank holds A2A_EXPERTS / n experts.
    Returns the slot matrix S (n, n, cap, h) bf16 and the splits (n, n,
    epr) int32, on the card."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    epr = A2A_EXPERTS // n
    scores = torch.rand((n, cap // A2A_TOPK, A2A_EXPERTS), generator=g)
    ids = scores.topk(A2A_TOPK, dim=-1).indices.reshape(n, -1)
    splits = torch.stack([torch.bincount(i, minlength=A2A_EXPERTS)
                          for i in ids]).reshape(n, n, epr).to(torch.int32)
    S = (torch.randn((n, n, cap, h), generator=torch.Generator(
        device="cuda").manual_seed(seed), device="cuda") * 4).bfloat16()
    return S, splits.cuda()


def a2a_copy_case(torch, mods, name, n, cap, h, seed) -> dict:
    """B8's parity stream at its main shape: every rank's live rows and
    splits checked bit for bit against ``a2a_plain``, then timed beside
    ``S.transpose(0, 1).contiguous()``."""
    comm, build, context, a2a = mods[2], mods[3], mods[4], mods[8]
    ctx = context.DistContext([torch.device("cuda:0")] * n,
                              wait_timeout_ms=20_000)
    S, spl = a2a_inputs(torch, n, cap, h, seed)
    block = a2a.default_block_rows(S.dtype)
    ws, _ = a2a.a2a_stream_workspace(n, cap, h, S.dtype, ctx=ctx,
                                     tag=f"time-{name}")
    idx = list(ws.epochs)

    def fn(r):
        out, rsp, _, idx[r] = a2a.fast_all_to_all_stream(
            S[r], spl[r], ws, idx[r], num_ranks=n)
        return out, rsp

    got = ctx.run(fn)
    torch.cuda.synchronize()
    ctx.raise_on_comm_error()
    want, want_rs = a2a.a2a_plain(S, spl, block)
    same, sha = True, set()
    for d, (out, rsp) in enumerate(got):
        rows = a2a.live_rows(want_rs[d], cap, block)
        h256 = hashlib.sha256(rsp.cpu().numpy().tobytes())
        same = same and torch.equal(rsp, want_rs[d])
        for p in range(n):
            live = out[p, :rows[p]].view(torch.int16)
            same = same and torch.equal(
                live, want[d, p, :rows[p]].view(torch.int16))
            h256.update(live.cpu().numpy().tobytes())
        sha.add(h256.hexdigest()[:16])
    token_rows = int(spl.sum(-1).clamp(max=cap).sum().item())
    nbytes = 2 * (token_rows * h * S.element_size()
                  + spl.numel() * spl.element_size())
    ms, hold = spaced_ms(torch, ctx, comm, build, fn)
    span, _ = spaced_ms(torch, ctx, comm, build, fn, every=False)
    ctx.close()

    def lib():
        S.transpose(0, 1).contiguous()
    return {"case": name, "ranks": n, "cap": cap, "hidden": h,
            "dtype": "bfloat16", "token_rows": token_rows,
            "bit_identical": same, "ok": same, "sha256_16": sorted(sha),
            "ms": ms, "span_ms": span, "hold": hold,
            "library_ms": library_ms(torch, comm, build, lib),
            "library_span_ms": library_ms(torch, comm, build, lib,
                                          every=False),
            "library_call": "S.transpose(0, 1).contiguous() of the slot "
                            "matrix (every row)", "bytes": nbytes,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}


def floor_case(torch, mods, n: int) -> dict:
    """The launch floor of a call on n virtual ranks: the tree's ``SPIN``
    for 0 ns (one thread that exits) on every rank's stream, timed as the
    kernels are — what the card's front end alone costs a call."""
    _, _, comm, build, context = mods[:5]
    ctx = context.DistContext([torch.device("cuda:0")] * n,
                              wait_timeout_ms=20_000)

    def fn(r):
        comm.SPIN.launch(0, build.current_stream(ctx.devices[r]))

    ms, hold = spaced_ms(torch, ctx, comm, build, fn)
    span, _ = spaced_ms(torch, ctx, comm, build, fn, every=False)
    ctx.close()
    return {"case": f"launch_floor_n{n}", "ranks": n, "ms": ms,
            "span_ms": span, "hold": hold, "ok": True}


def paths_case(torch, root) -> dict:
    """The walls of pp_forward (GPipe, interleaved) and sp_prefill (ring,
    SP-AG, Ulysses), from the tree's chip_smoke.py."""
    cs = importlib.import_module("chip_smoke")
    if not cs.__file__.startswith(root):
        raise RuntimeError(f"imported {cs.__file__}, not {root}'s")
    fa = importlib.import_module(
        "triton_distributed_tpu_torch.ops.flash_attention")
    from triton_distributed_tpu_torch.models.config import QWEN3_8B
    from triton_distributed_tpu_torch.models.dense import init_dense_llm

    timer = cs.Timer(torch, "cuda")
    sp = cs.phase_sp_prefill(torch, fa, timer)
    params = init_dense_llm(QWEN3_8B, generator=torch.Generator(
        device="cuda").manual_seed(0))
    pp = cs.phase_pp_forward(torch, params, QWEN3_8B, fa)
    del params
    return {"case": "paths",
            "pp_gpipe_ms": pp["gpipe"]["ms"],
            "pp_interleaved_ms": pp["interleaved"]["ms"],
            "pp_shifts_per_rank": [pp["gpipe"]["shift_launches_per_rank"],
                                   pp["interleaved"]
                                   ["shift_launches_per_rank"]],
            "pp_one_rank_ms": pp["one_rank_ms_runs"],
            "sp_prefill_ms": {f: r["ms"] for f, r in sp["ops"].items()},
            "sp_ag_launches": sp["ops"]["sp_ag_attention"]["ag_launches"],
            "ok": pp["bit_identical"]}


def tree_path_case(torch, mods) -> dict:
    """``Engine.prefill`` of a 1 x TREE_PROMPT prompt on 4 virtual ranks
    (Qwen3-8B, random weights, seed 0; the "ar" prefill: 2 tree
    AllReduces a layer): the wall of each of 5 prefills after a warm-up,
    and, from one profiled prefill, the tree kernel's device time summed
    over the ranks' launches, a rank."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    comm, context = mods[2], mods[4]
    from triton_distributed_tpu_torch.models.config import QWEN3_8B
    from triton_distributed_tpu_torch.models.dense import init_dense_llm
    from triton_distributed_tpu_torch.models.engine import Engine

    n = 4
    params = init_dense_llm(QWEN3_8B, generator=torch.Generator(
        device="cuda").manual_seed(0))
    ctx = context.initialize_distributed(devices=["cuda:0"] * n,
                                         wait_timeout_ms=60_000)
    eng = Engine(QWEN3_8B, params, ctx, max_seq=2048)
    del params
    ids = torch.randint(0, QWEN3_8B.vocab_size, (1, TREE_PROMPT),
                        generator=torch.Generator(device="cuda")
                        .manual_seed(31), device="cuda", dtype=torch.int32)
    mode = eng._prefill_mode(1, TREE_PROMPT)
    for _ in range(2):
        eng.prefill(ids)
    torch.cuda.synchronize()
    walls = []
    k0 = comm.TREE_KERNEL.launches
    for _ in range(5):
        t0 = time.perf_counter()
        eng.prefill(ids)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    launches = (comm.TREE_KERNEL.launches - k0) // 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.prefill(ids)
        torch.cuda.synchronize()
    tree_us, calls = 0.0, 0
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        if "ar_tree_kernel" in e.key:
            tree_us += (getattr(e, "self_device_time_total", None)
                        or getattr(e, "self_cuda_time_total", 0))
            calls += e.count
    eng.check_comm()
    del eng
    ctx.close()
    return {"case": "tree_path", "prompt": [1, TREE_PROMPT],
            "prefill_mode": mode, "ranks": n,
            "prefill_wall_ms": walls,
            "prefill_wall_ms_median": statistics.median(walls),
            "tree_launches_per_prefill": launches,
            "tree_kernels_profiled": calls,
            "tree_device_ms_per_prefill_per_rank": tree_us / 1e3 / n,
            "ok": mode == "ar" and launches == n * 2 * QWEN3_8B.num_layers}


def _device_ms(prof, name: str) -> tuple:
    """(device ms, launches) of the kernels whose name holds ``name`` in a
    ``torch.profiler`` run."""
    from torch.autograd import DeviceType

    us, calls = 0.0, 0
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        if name in e.key:
            us += (getattr(e, "self_device_time_total", None)
                   or getattr(e, "self_cuda_time_total", 0))
            calls += e.count
    return us / 1e3, calls


def slice_path_case(torch, mods) -> dict:
    """One SLICE-row prefill slice on 4 virtual ranks, the TP serving
    loop's (Qwen3-8B, random weights, seed 0; ``ServingEngine(max_batch=4,
    prefill_chunk=SLICE)``, a SLICE-token prompt and one new token, so the
    request is one slice and its first token): the wall of each of 5
    requests after two warm-ups, B6's launches a slice, and, from one
    profiled request, B6's device time a slice and rank."""
    from torch.profiler import ProfilerActivity, profile

    comm, context = mods[2], mods[4]
    from triton_distributed_tpu_torch.models.config import QWEN3_8B
    from triton_distributed_tpu_torch.models.dense import init_dense_llm
    from triton_distributed_tpu_torch.models.engine import Engine
    from triton_distributed_tpu_torch.serving import ServingEngine

    n = 4
    params = init_dense_llm(QWEN3_8B, generator=torch.Generator(
        device="cuda").manual_seed(0))
    ctx = context.initialize_distributed(devices=["cuda:0"] * n,
                                         wait_timeout_ms=60_000)
    eng = Engine(QWEN3_8B, params, ctx, max_seq=2048, page_size=16)
    del params
    se = ServingEngine(eng, max_batch=4, prefill_chunk=SLICE)
    prompt = torch.randint(0, QWEN3_8B.vocab_size, (SLICE,),
                           generator=torch.Generator().manual_seed(32))

    def one():
        se.submit(prompt, 1)
        se.run()
        torch.cuda.synchronize()

    for _ in range(2):
        one()
    walls = []
    k0 = comm.RS_RING_KERNEL.launches
    for _ in range(5):
        t0 = time.perf_counter()
        one()
        walls.append((time.perf_counter() - t0) * 1e3)
    launches = (comm.RS_RING_KERNEL.launches - k0) // 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        one()
    rs_ms, calls = _device_ms(prof, "rs_ring_kernel")
    eng.check_comm()
    del se, eng
    ctx.close()
    return {"case": "slice_path", "prompt": SLICE, "ranks": n,
            "request_wall_ms": walls,
            "request_wall_ms_median": statistics.median(walls),
            "rs_launches_per_slice": launches,
            "rs_kernels_profiled": calls,
            "rs_device_ms_per_slice_per_rank": rs_ms / n,
            "ok": launches == n * 2 * QWEN3_8B.num_layers}


def ep_path_case(torch, root) -> dict:
    """The EP layer's decode stream on 4 virtual ranks through the tree's
    ``chip_smoke.ep_run``: EP_LAYERS random bf16 layers at Qwen3-30B-A3B's
    MoE widths, 4 tokens a rank, 4 steps (two parity AllToAlls a layer a
    rank, each layer held against the one-rank form), its ms a layer; then
    one step under ``torch.profiler``: B8's device time a layer and
    rank."""
    from torch.profiler import ProfilerActivity, profile

    cs = importlib.import_module("chip_smoke")
    if not cs.__file__.startswith(root):
        raise RuntimeError(f"imported {cs.__file__}, not {root}'s")
    ep = importlib.import_module("triton_distributed_tpu_torch.layers.ep_moe")
    context = importlib.import_module(
        "triton_distributed_tpu_torch.runtime.context")
    from triton_distributed_tpu_torch.models.config import QWEN3_30B_A3B as C

    n = cs.EP_RANKS
    g = torch.Generator(device="cuda").manual_seed(61)
    layers = [{"moe": ep.init_ep_moe(C.hidden_size, C.moe_intermediate_size,
                                     C.num_experts, torch.bfloat16,
                                     generator=g)}
              for _ in range(EP_LAYERS)]
    ctx = context.DistContext([torch.device("cuda:0")] * n,
                              wait_timeout_ms=60_000)
    x = torch.randn((n * cs.EP_DECODE_TOKENS, C.hidden_size), generator=g,
                    device="cuda").to(torch.bfloat16)
    kw = dict(topk=C.num_experts_per_tok, stream=True)
    cs.ep_run(torch, ep, layers, ctx, x, steps=1, name="warm", **kw)
    rec = cs.ep_run(torch, ep, layers, ctx, x, steps=4, name="time", **kw)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cs.ep_run(torch, ep, layers, ctx, x, steps=1, name="prof", **kw)
    a2a_ms, calls = _device_ms(prof, "a2a")
    ctx.close()
    return {"case": "ep_path", "layers": EP_LAYERS, "ranks": n,
            "tokens_per_rank": cs.EP_DECODE_TOKENS,
            "ep_ms_per_layer": rec["ep_ms_per_layer"],
            "a2a_launches": rec["launches"],
            "a2a_kernels_profiled": calls,
            "a2a_device_ms_per_layer_per_rank": a2a_ms / EP_LAYERS / n,
            "vs_one_rank": rec["vs_one_rank"],
            "ok": calls == 2 * n * EP_LAYERS}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=".", help="root of the tree to time")
    ap.add_argument("--label", default=None)
    ap.add_argument("--paths", action="store_true",
                    help="also read the walls of the paths these kernels "
                         "run on")
    ap.add_argument("--only", default=None,
                    help="comma-separated case names to run (default all)")
    args = ap.parse_args()
    only = set(args.only.split(",")) if args.only else None
    root = os.path.abspath(args.tree)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("time_port_copy: needs a CUDA card", file=sys.stderr)
        return 1
    ag = importlib.import_module("triton_distributed_tpu_torch.ops.allgather")
    if not ag.__file__.startswith(root):
        print(f"time_port_copy: imported {ag.__file__}, not {root}'s",
              file=sys.stderr)
        return 1
    p2p = importlib.import_module("triton_distributed_tpu_torch.ops.p2p")
    comm = importlib.import_module("triton_distributed_tpu_torch.ops._comm")
    build = importlib.import_module(
        "triton_distributed_tpu_torch.runtime.build")
    context = importlib.import_module(
        "triton_distributed_tpu_torch.runtime.context")
    label = args.label or root
    t0 = time.perf_counter()
    srcs = [comm.AG_FULL_MESH_KERNEL.source_path,
            comm.P2P_SHIFT_KERNEL.source_path,
            comm.AG_TORUS_KERNEL.source_path,
            comm.A2A_PARITY_KERNEL.source_path]
    build.build(srcs)
    ptxas = []
    for src in srcs:
        log = build.library_path(src).with_suffix(".log").read_text()
        ptxas += [ln.strip() for ln in log.splitlines()
                  if "Compiling" in ln or "registers" in ln
                  or "spill" in ln or "warning" in ln]
    print(json.dumps({"tree": label, "build_s": time.perf_counter() - t0,
                      "ptxas": ptxas}), flush=True)
    ar = importlib.import_module("triton_distributed_tpu_torch.ops.allreduce")
    ma = importlib.import_module(
        "triton_distributed_tpu_torch.ops.multi_axis")
    rs = importlib.import_module(
        "triton_distributed_tpu_torch.ops.reduce_scatter")
    a2a = importlib.import_module("triton_distributed_tpu_torch.ops.all_to_all")
    mods = (ag, p2p, comm, build, context, ar, ma, rs, a2a)
    failed = []
    cases = [c for c in CASES if only is None or c[0] in only]
    for i, (name, kind, n, rows, cols) in enumerate(CASES):
        if (name, kind, n, rows, cols) not in cases:
            continue
        if kind == "a2a":
            rec = a2a_copy_case(torch, mods, name, n, rows, cols, 950 + i)
        else:
            rec = copy_case(torch, mods, name, kind, n, rows, cols, 950 + i)
        rec["tree"] = label
        print(json.dumps(rec), flush=True)
        if not rec["ok"]:
            failed.append(name)
    for n in sorted({c[2] for c in cases}):
        rec = floor_case(torch, mods, n)
        rec["tree"] = label
        print(json.dumps(rec), flush=True)
    if args.paths:
        paths = (("paths", lambda: paths_case(torch, root)),
                 ("tree_path", lambda: tree_path_case(torch, mods)),
                 ("slice_path", lambda: slice_path_case(torch, mods)),
                 ("ep_path", lambda: ep_path_case(torch, root)))
        for what, fn in paths:
            if only is not None and what not in only:
                continue
            rec = fn()
            rec["tree"] = label
            print(json.dumps(rec), flush=True)
            if not rec["ok"]:
                failed.append(what)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    if failed:
        print(f"time_port_copy: wrong results: {failed}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
