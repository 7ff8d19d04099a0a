#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's megakernel lanes for one tree, on one CUDA
card, and fingerprint their outputs.

Each case builds its program from ``chip_smoke.py``'s helpers at Qwen3-8B
(or Qwen3-30B-A3B) widths cut to 2 layers, bf16, seeded inputs, then
launches the kernel: the paged step (4 slots at kv_lens [0, 1, 127, 1999])
over bf16 and e4m3 pools, the 4-row speculative window step, the linear
batch-1 step at position 1999 in the matrix and the e4m3-tile layouts, and
the MoE step at batch 1 and 4. Per case it prints the kernel's time (L2
flushed before every launch; three rounds) and the SHA-256 of the
workspaces one launch leaves from the staged inputs, so two trees can be
compared bit for bit as well as in time. One JSON line, with the card's
name and power limit and ptxas's register and spill report for
``megakernel.cu``.

``--tp N`` times the megakernel on a TP group of N virtual ranks on the
card instead: ALLREDUCE_ROW alone at the decode shape (``chip_smoke.
mk_ar_case``: 1 live row x 32 tiles, bf16; the slowest rank's device time
a launch over 20 back-to-back launches, every rank released at one
instant, beside N x ``X.sum(0)`` and its byte bound), three rounds; then
the bf16 linear decoder of Qwen3-8B at full depth (random weights, seed 0;
a random KV cache at position TP_POS) on one rank and on N ranks: the
one-rank step's kernel time (three rounds), ``force_ar``'s price a step at
one rank (``chip_smoke.force_ar_price``), and the N-rank decoder's
TP_STEPS steps through ``MegakernelDecoder.step`` — each step's wall
(synced) and enqueue —, then its launches alone (the ranks' kernels back
to back behind a held stream, the slowest rank's device time a step),
three rounds, and the final rows' SHA-256 (the ranks' alike).

To compare two commits, unpack the other one (``git archive <commit>
chip_smoke.py triton_distributed_tpu_torch | tar -x -C <dir>``) into a
git-ignored directory and run this script on each tree inside ONE call
on the same card — parent, change, change, parent — since a card's speed
differs from one run to the next:

    python3 <path to>/time_port_megakernel_step.py [label] [--tree DIR]
                                                   [--tp N]

It uses only helpers that older trees of the port (with the MoE program,
and the TP megakernel for ``--tp``) have too.
"""
import argparse
import dataclasses
import hashlib
import importlib
import json
import os
import statistics
import sys
import time

TP_POS = 1024        # the TP decoder's cache position
TP_STEPS = 16        # its timed steps

torch = cs = QWEN3_8B = QWEN3_30B_A3B = build = None


def _load(root: str) -> None:
    """Import torch, the tree's chip_smoke and the package from ``root``."""
    global torch, cs, QWEN3_8B, QWEN3_30B_A3B, build
    os.environ.setdefault("CUDA_DEVICE_MAX_CONNECTIONS", "32")
    os.chdir(root)
    sys.path.insert(0, root)
    import torch as _torch

    torch = _torch
    cs = importlib.import_module("chip_smoke")
    if not os.path.abspath(cs.__file__).startswith(root):
        raise RuntimeError(f"imported {cs.__file__}, not {root}'s")
    config = importlib.import_module(
        "triton_distributed_tpu_torch.models.config")
    QWEN3_8B, QWEN3_30B_A3B = config.QWEN3_8B, config.QWEN3_30B_A3B
    build = importlib.import_module(
        "triton_distributed_tpu_torch.runtime.build")


def _sha(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        if t is not None:
            h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def paged(mk, mkserv, cfg, *, seed, kv_dtype=None, window=1):
    lens = cs.MK_WIN_LENS if window > 1 else cs.MK_LENS
    dec, ws0, queue, _ = cs.mk_state(torch, mkserv, cfg, torch.bfloat16, seed,
                                     lens=lens, kv_dtype=kv_dtype,
                                     window=window)
    comp = dec.comp
    kw = dict(num_exec=comp.num_exec, mat_specs=comp.mat_specs,
              head_dim=comp.head_dim, sync_before=comp.sync_before,
              live_rows=dec.spec_w)

    def launcher(ws):
        main, pool = dec._split(ws)
        return mk.cuda_launcher(queue, main, dec._wsm,
                                wkv8=pool if dec.kv_fp8 else None, **kw)

    return ws0, lambda ws: (ws if dec.kv_fp8 else (ws,)), launcher, \
        (lambda ws: (ws[0].clone(), ws[1].clone()) if dec.kv_fp8
         else ws.clone())


def linear(mk, mkserv, cfg, *, seed, fp8_weights=False):
    from triton_distributed_tpu_torch.models.dense import init_dense_llm
    from triton_distributed_tpu_torch.models.kv_cache import KVCache

    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    params = init_dense_llm(
        cfg, generator=torch.Generator(device="cuda").manual_seed(seed))
    dec = mkserv.MegakernelDecoder(cfg, params, max_seq=cs.LIN_MAX_SEQ,
                                   dtype=torch.bfloat16,
                                   fp8_weights=fp8_weights)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    shape = (cfg.num_layers, 1, cs.LIN_MAX_SEQ, cfg.num_kv_heads,
             cfg.head_dim)
    cache = KVCache(
        k=torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16),
        v=torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16),
        offset=0)
    ws0 = dec.start(cache)
    queue = dec.queue_at(1999)
    dec.put_inputs(ws0, [17], 1999)
    comp = dec.comp
    wsm, ws8 = dec.weights()

    def launcher(ws):
        return mk.cuda_launcher(queue, ws, wsm, ws8=ws8,
                                live_rows=1, sync_before=comp.sync_before,
                                num_exec=comp.num_exec,
                                mat_specs=comp.mat_specs,
                                head_dim=comp.head_dim)

    return ws0, lambda ws: (ws,), launcher, lambda ws: ws.clone()


def moe(mk, mkmodels, mkserv, cfg, *, seed, batch):
    from triton_distributed_tpu_torch.models.dense import init_dense_llm

    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    params = init_dense_llm(
        cfg, generator=torch.Generator(device="cuda").manual_seed(seed))
    prog, comp = cs.moe_build(torch, mkmodels, cfg, batch=batch,
                              dtype=torch.bfloat16)
    main, _, wm = comp.split_feeds(mkserv.weight_feeds(prog, cfg, params))
    ws0, wsm = comp.make_workspace(main), comp.make_workspace_mat(wm)
    caches = torch.tensor(cs.moe_cache_tiles(prog), device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    ws0[caches] = torch.randn((len(caches), 128, 128), generator=g,
                              device="cuda").to(torch.bfloat16)
    toks = torch.randint(0, cfg.vocab_size, (batch,), generator=g,
                         device="cuda")
    queue = cs.moe_stage(torch, mkmodels, prog, comp, ws0, cfg,
                         params["embed"][toks], 1999)

    def launcher(ws):
        return mk.cuda_launcher(queue, ws, wsm, live_rows=batch,
                                sync_before=comp.sync_before,
                                num_exec=comp.num_exec,
                                mat_specs=comp.mat_specs,
                                head_dim=comp.head_dim)

    return ws0, lambda ws: (ws,), launcher, lambda ws: ws.clone()


def _median(xs):
    return statistics.median(xs) if xs else None


def tp_cases(n: int, mk, mkserv, mkmodels, timer) -> dict:
    """The ``--tp`` mode's records (see the module's docstring)."""
    from triton_distributed_tpu_torch.models.dense import init_dense_llm
    from triton_distributed_tpu_torch.models.kv_cache import KVCache

    context = importlib.import_module(
        "triton_distributed_tpu_torch.runtime.context")
    out = {}
    rounds = []
    for i in range(3):
        rec = cs.mk_ar_case(torch, timer, n=n, dtype=torch.bfloat16,
                            rows=1, seed=611 + i, time_it=True)
        rounds.append(rec)
    out["allreduce_row"] = {
        "ms": [r["ms"] for r in rounds],
        "library_ms": [r["library_ms"] for r in rounds],
        "library_call": rounds[0]["library_call"],
        "plain_ms": rounds[0]["plain_ms"],
        "bound_ms": rounds[0]["bound_ms"],
        "grid_blocks": rounds[0]["grid_blocks"],
        "ok": all(r["ok"] for r in rounds)}
    cfg = dataclasses.replace(QWEN3_8B, dtype="bfloat16")
    params = init_dense_llm(cfg, generator=torch.Generator(
        device="cuda").manual_seed(0))
    g = torch.Generator(device="cuda").manual_seed(1)
    shape = (cfg.num_layers, 1, 2048, cfg.num_kv_heads, cfg.head_dim)
    cache = KVCache(
        k=torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16),
        v=torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16),
        offset=TP_POS)
    tok = torch.tensor([17], dtype=torch.int32, device="cuda")
    # One rank: the linear decoder's step alone.
    one = mkserv.MegakernelDecoder(cfg, params, max_seq=2048,
                                   dtype=torch.bfloat16)
    ws = one.start(cache)
    queue = one.queue_at(TP_POS)
    one.put_inputs(ws, tok, TP_POS)
    launch = mk.cuda_launcher(queue, ws, one.weights()[0], live_rows=1,
                              sync_before=one.comp.sync_before,
                              num_exec=one.comp.num_exec,
                              mat_specs=one.comp.mat_specs,
                              head_dim=one.comp.head_dim)
    out["one_rank_step_ms"] = [timer.ms(launch) for _ in range(3)]
    del one, ws, launch
    torch.cuda.empty_cache()
    out["force_ar"] = cs.force_ar_price(torch, mk, mkserv, mkmodels, cfg,
                                        params, cache, tok, context)
    torch.cuda.empty_cache()
    # n ranks: the decoder's steps, then its launches alone.
    ctx = context.DistContext([torch.device("cuda:0")] * n,
                              wait_timeout_ms=60_000)
    dec = mkserv.MegakernelDecoder(cfg, params, max_seq=2048,
                                   dtype=torch.bfloat16, ctx=ctx,
                                   num_ranks=n)
    del params
    ws = dec.start(cache)
    pos, t = TP_POS, tok
    walls, enq = [], []
    for _ in range(TP_STEPS):
        t0 = time.perf_counter()
        ws, t = dec.step(ws, t, pos)
        enq.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        pos += 1
    dec.check_comm()
    rows = dec.rank_rows(ws)
    comp = dec.comp
    queue = dec.queue_at(pos - 1)
    ctx.run(lambda r: dec.put_inputs(ws[r], t, pos - 1, r))
    launch = ctx.run(lambda r: mk.cuda_launcher(
        queue, ws[r], dec.weights(r)[0], live_rows=1,
        sync_before=comp.sync_before, num_exec=comp.num_exec,
        mat_specs=comp.mat_specs, head_dim=comp.head_dim,
        group=mk.ar_group(queue, comp.num_exec, ws[r], num_ranks=n,
                          axis="tp", max_ar=comp.max_ar, force_ar=False,
                          ar_tag=dec.ar_tag)))
    dev = [cs._coll_ms(torch, ctx, lambda r: launch[r](), 5)[0]
           for _ in range(3)]
    ctx.raise_on_comm_error()
    out["tp_step"] = {
        "ranks": n, "layers": cfg.num_layers, "pos": TP_POS,
        "allreduce_rows_per_rank": int(sum(
            1 for w in comp.queue[:comp.num_exec, 0] if w in (4, 22))),
        "barriers": int(comp.sync_before.sum()),
        "device_ms": dev, "wall_ms": _median(walls[1:]) * 1e3,
        "wall_ms_all": [w * 1e3 for w in walls],
        "enqueue_ms": _median(enq[1:]) * 1e3,
        "ranks_identical": all(torch.equal(rows[0], r) for r in rows[1:]),
        "sha256": _sha(rows[0])}
    out["ok"] = out["allreduce_row"]["ok"] and out["tp_step"][
        "ranks_identical"]
    del dec, ws, launch, cache
    ctx.close()
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("label", nargs="?", default=None)
    ap.add_argument("--tree", default=".", help="root of the tree to time")
    ap.add_argument("--tp", type=int, default=0,
                    help="time the megakernel on a TP group of this many "
                         "virtual ranks (0: the one-rank lanes)")
    args = ap.parse_args()
    root = os.path.abspath(args.tree)
    _load(root)
    if not torch.cuda.is_available():
        print("time_port_megakernel_step: needs a CUDA card", file=sys.stderr)
        return 1
    mk = importlib.import_module(
        "triton_distributed_tpu_torch.megakernel.kernel")
    mkserv = importlib.import_module(
        "triton_distributed_tpu_torch.megakernel.serving")
    mkmodels = importlib.import_module(
        "triton_distributed_tpu_torch.megakernel.models")
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    ptxas = []
    for src in build.sources():
        log = build.library_path(src).with_suffix(".log")
        if src.name == "megakernel.cu" and log.exists():
            ptxas = [line.strip() for line in log.read_text().splitlines()
                     if "registers" in line or "spill" in line]
    timer = cs.Timer(torch, "cuda")
    out = {"tree": args.label or root}
    if args.tp:
        out.update(tp_cases(args.tp, mk, mkserv, mkmodels, timer))
        out["nvidia_smi"] = cs.nvidia_smi()
        out["ptxas"] = ptxas
        print(json.dumps(out))
        return 0 if out["ok"] else 1
    cfg = dataclasses.replace(QWEN3_8B, num_layers=2)
    mcfg = dataclasses.replace(QWEN3_30B_A3B, num_layers=2)
    cases = {
        "step_2l_bf16": lambda: paged(mk, mkserv, cfg, seed=20),
        "step_2l_bf16_e4m3": lambda: paged(mk, mkserv, cfg, seed=23,
                                           kv_dtype=torch.float8_e4m3fn),
        "window4_2l_bf16": lambda: paged(mk, mkserv, cfg, seed=25,
                                         window=cs.MK_WINDOW),
        "linear_2l_bf16": lambda: linear(mk, mkserv, cfg, seed=30),
        "linear_w8_2l_bf16": lambda: linear(mk, mkserv, cfg, seed=35,
                                            fp8_weights=True),
        "moe_2l_bf16_b1": lambda: moe(mk, mkmodels, mkserv, mcfg, seed=40,
                                      batch=1),
        "moe_2l_bf16_b4": lambda: moe(mk, mkmodels, mkserv, mcfg, seed=41,
                                      batch=4),
    }
    for name, make in cases.items():
        ws0, parts, launcher, clone = make()
        ws = clone(ws0)
        launcher(ws)()
        torch.cuda.synchronize()
        sha = _sha(*parts(ws))
        launch = launcher(clone(ws0))
        out[name] = {"ms": [timer.ms(launch) for _ in range(3)],
                     "sha256": sha}
        del ws0, ws, launch
        torch.cuda.empty_cache()
    out["nvidia_smi"] = cs.nvidia_smi()
    out["ptxas"] = ptxas
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
