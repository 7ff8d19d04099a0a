#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``triton_distributed_tpu_torch/csrc``
(one ``nvcc`` per source, in parallel), then runs these phases, each
printing one JSON line:

1. ``device``  — card name, ``nvidia-smi`` name and power limit, build time;
2. ``kernels`` — each kernel against its plain PyTorch version on the card
   (max-abs error within the stated tolerance), and its time beside its
   plain version's, a one-call PyTorch yardstick where one exists, and the
   least time the card could take (bytes over 3.35 TB/s or flops over the
   peak rate of the input type, whichever is larger); the megakernel's
   cases run one decode step at Qwen3-8B widths cut to 2 layers, 4 slots
   of page 128 at kv_lens [0, 1, 127, 1999], in bf16 and in fp32;
3. ``engine``  — Qwen3-8B at full width and depth, random bf16 weights from a
   seeded generator, ``Engine.serve`` of 2 x 1024-token prompts for 64 new
   tokens; K1/K2 launch counts must match the layer count, plain versions
   never called;
4. ``serving`` — the same model through ``ServingEngine`` (6 requests, prompts
   100-1500 tokens, 32 new tokens each); all finish, counts match; then a
   decode-only window of 4 running slots times the eager step;
5. ``megakernel_serving`` — the same model and requests through
   ``ServingEngine`` on ``Engine(backend="megakernel", page_size=128)``:
   every decode step is one megakernel launch (K2 never, K1 once per layer
   and prefill slice, no plain version); the same decode-only window, and
   the kernel's time at this shape against its bound and its plain time;
6. ``parity``  — float32 Qwen3-8B widths at 2 layers: ``ServingEngine``
   tokens identical to sequential ``Engine.serve`` on both lanes, each with
   a run whose small pool forces preemption; ``torch.argmax`` ties go to
   the first max.

Then the kernel summary line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any failed phase raises: exit code 1
and no result line. Without CUDA it exits 2 before printing anything.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12                                   # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}         # dense; fp32 = FMA

# Elementwise tolerance |kernel - plain| <= atol + rtol * |plain|, per
# kernel and arithmetic, set from the errors measured on the card with a
# margin; every case reports the largest share of it that one element used.
# One bf16 unit in the last place is at most 2^-7 (7.8e-3) of a value.
TOL = {
    # K1 in bf16: p is rounded to bf16 (2^-8 relative) at each 32-key
    # tile's running max in the kernel and at the row max in the plain
    # version, then the output rounds to bf16. Two units, plus an atol of
    # twice the largest error seen where |plain| is small (1.95e-3 on an
    # H100 at 700 W: the cases' ``max_abs_err_where_atol_rules``).
    "flash_attention": dict(atol=4e-3, rtol=1.6e-2),
    # K2 in bf16 computes in fp32 from the stored values, as its plain
    # version does, and rounds only the output: a flip of one unit, under
    # a tolerance of two (so it uses at most half).
    "paged_attention": dict(atol=1e-5, rtol=1.6e-2),
    # fp32 arithmetic throughout (both kernels' fp32 cases, and K2's
    # partials from bf16 pools): summation order only.
    "fp32": dict(atol=1e-5, rtol=1e-5),
    # The megakernel: a whole 2-layer decode step, every stored activation
    # compared (live rows) plus the KV pools. Per task the kernel and the
    # plain version differ in summation order only, but each store rounds
    # to the workspace type, so a one-unit flip in an early output feeds
    # every later task: the error compounds through the layers.
    "megakernel_bf16": dict(atol=4e-2, rtol=6.4e-2),
    "megakernel_fp32": dict(atol=1e-4, rtol=1e-4),
}
# Partials: |m - m_plain| <= 1e-4 and |l - l_plain| <= 1e-4 * l_plain
# (fp32 sums of up to 2048 terms; m = -1e30, l = 0 on dead rows).
M_ATOL, L_RTOL = 1e-4, 1e-4
TOL_REASON = (
    "K1 bf16: p rounded to bf16 at the key tile's running max (kernel) or "
    "the row max (plain), output rounded to bf16; K2 bf16: only the output "
    "rounds; fp32 (and K2 partials): summation order only; megakernel: "
    "summation order per task, compounded through a 2-layer step by each "
    "task's rounded stores. Each bf16 case also reports the plain bf16 "
    "version's and the kernel's max error against the plain version run "
    "in fp32.")
# The case whose shape the main path gives each kernel (engine prefill of
# 2 x 1024 prompts; a decode batch of 4 in the serving phase).
MAIN_CASE = {"flash_attention": "prefill_2x1024",
             "paged_attention": "decode_4"}
# The megakernel cases' slots: idle (scratch page), one token, an append
# at a page's last column, and a long context over 16 shuffled pages.
MK_LENS = [0, 1, 127, 1999]
MK_MAX_PAGES = 16
# The serving phases' prompt lengths (32 new tokens each).
SERVING_LENGTHS = [100, 1500, 640, 333, 1024, 877]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """CUDA-event time of one call, averaged over ``iters`` calls, with
    the 50 MB L2 cache flushed before each (the main path finds its
    operands cold: every layer reads fresh activations and KV)."""

    def __init__(self, torch, device):
        self.torch = torch
        self.flush = torch.empty(64 * 2**20, dtype=torch.float32,
                                 device=device)              # 256 MB

    def ms(self, fn, iters: int = 10, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(iters):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / iters


def _bound_ms(nbytes: float, flops: float, dtype_name: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions.
# ---------------------------------------------------------------------------

def _max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def compare(torch, kernel, dtype, normalize, got, want, want32) -> dict:
    """Hold one kernel output against its plain version.

    ``got``, ``want`` and ``want32`` are (out, m, l) from the kernel, the
    plain version, and the plain version on fp32 copies of the inputs
    (None for an fp32 case). Partials are compared as acc / l, and m and l
    on their own. Returns the record's error fields; ``ok`` is False on
    any disagreement or non-finite output."""
    fp32_math = dtype == torch.float32 or (kernel == "paged_attention"
                                           and not normalize)
    tol = TOL["fp32" if fp32_math else kernel]
    out, m, l = got
    ref, rm, rl = want

    def normalized(t, lsum):
        return t / torch.clamp(lsum, min=1e-30)[..., None]

    rec, ok = {}, True
    if not normalize:
        m_err = _max_err(m, rm)
        l_rel = ((l - rl).abs() / torch.clamp(rl, min=1e-30)).max().item()
        rec.update(m_max_abs_err=m_err, l_max_rel_err=l_rel)
        ok = m_err <= M_ATOL and l_rel <= L_RTOL
        out, ref = normalized(out, l), normalized(ref, rl)
        if want32 is not None:
            want32 = (normalized(want32[0], want32[2]),)
    diff = (out.float() - ref.float()).abs()
    mag = ref.float().abs()
    share = (diff / (tol["atol"] + tol["rtol"] * mag)).max()
    atol_rules = mag * tol["rtol"] < tol["atol"]
    rec.update(max_abs_err=diff.max().item(),
               max_abs_err_where_atol_rules=(
                   diff[atol_rules].max().item() if atol_rules.any() else 0.0),
               tol=tol, tol_share=share.item())
    if want32 is not None:
        rec["plain_err_vs_fp32"] = _max_err(ref, want32[0])
        rec["kernel_err_vs_fp32"] = _max_err(out, want32[0])
    rec["ok"] = bool(ok and torch.isfinite(out).all().item()
                     and rec["tol_share"] <= 1.0)
    return rec


def flash_case(torch, fa, timer, *, name, dtype, B, Sq, Sk, hq, hkv, d,
               q_off, normalize, time_it, seed):
    """One K1 case. Keys past the causal frontier are NaN in the kernel's
    input: K1 must never load them (the plain version gets zeros there)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, Sq, hq, d), generator=g, device="cuda").to(dtype)
    k = torch.randn((B, Sk, hkv, d), generator=g, device="cuda").to(dtype)
    v = torch.randn((B, Sk, hkv, d), generator=g, device="cuda").to(dtype)
    frontier = min(Sk, q_off + Sq)              # keys any query can see
    k_nan, v_nan = k.clone(), v.clone()
    k_nan[:, frontier:] = float("nan")
    v_nan[:, frontier:] = float("nan")
    got = fa._flash_cuda(q, k_nan, v_nan, q_off, 0, causal=True,
                         normalize=normalize)
    want = fa._flash_plain(q, k, v, q_off, 0, causal=True,
                           normalize=normalize)
    want32 = None if dtype == torch.float32 else fa._flash_plain(
        q.float(), k.float(), v.float(), q_off, 0, causal=True,
        normalize=normalize)
    torch.cuda.synchronize()
    rec = {"case": name, "dtype": _dtype_name(dtype), "shape": {
        "B": B, "Sq": Sq, "Sk": Sk, "hq": hq, "hkv": hkv, "d": d,
        "q_offset": q_off, "normalize": normalize},
        **compare(torch, "flash_attention", dtype, normalize, got, want,
                  want32)}
    out = got[0]
    if time_it:
        item = q.element_size()
        pairs = sum(max(0, min(Sk, q_off + i + 1)) for i in range(Sq))
        flops = 4.0 * B * hq * d * pairs
        nbytes = item * (B * Sq * hq * d + 2 * B * frontier * hkv * d) \
            + out.element_size() * B * Sq * hq * d
        rec["bound_ms"], rec["bound_by"] = _bound_ms(nbytes, flops,
                                                     _dtype_name(dtype))
        rec["ms"] = timer.ms(lambda: fa._flash_cuda(
            q, k, v, q_off, 0, causal=True, normalize=normalize))
        rec["plain_ms"] = timer.ms(lambda: fa._flash_plain(
            q, k, v, q_off, 0, causal=True, normalize=normalize))
        if q_off == 0 and Sq == Sk and normalize:
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            sdpa = torch.nn.functional.scaled_dot_product_attention
            rec["library_ms"] = timer.ms(lambda: sdpa(
                qt, kt, vt, is_causal=True, enable_gqa=True))
        else:
            rec["library_ms"] = None
    return rec


def paged_case(torch, pa, timer, *, name, dtype, lens, page, hq, hkv, d,
               normalize, time_it, seed):
    """One K2 case: shuffled pages, stale random data everywhere in the
    pool, -1 in the table past each sequence's valid pages."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    B = len(lens)
    max_pages = -(-max(max(lens), 1) // page)
    num_pages = B * max_pages + 1
    kp = torch.randn((num_pages, page, hkv, d), generator=g,
                     device="cuda").to(dtype)
    vp = torch.randn((num_pages, page, hkv, d), generator=g,
                     device="cuda").to(dtype)
    perm = torch.randperm(num_pages, generator=g, device="cuda")
    table = perm[:B * max_pages].reshape(B, max_pages).to(torch.int32)
    for i, n in enumerate(lens):
        table[i, -(-n // page):] = -1
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    cache = pa.PagedKVCache(kp, vp, table, lens_t)
    q = torch.randn((B, hq, d), generator=g, device="cuda").to(dtype)
    got = pa._paged_decode_cuda(q, cache, normalize=normalize)
    want = pa._paged_decode_plain(q, cache, normalize=normalize)
    want32 = None if dtype == torch.float32 else pa._paged_decode_plain(
        q.float(), cache._replace(k_pool=kp.float(), v_pool=vp.float()),
        normalize=normalize)
    torch.cuda.synchronize()
    out = got[0]
    rec = {"case": name, "dtype": _dtype_name(dtype), "shape": {
        "B": B, "kv_lens": lens, "page": page, "hq": hq, "hkv": hkv, "d": d,
        "normalize": normalize},
        **compare(torch, "paged_attention", dtype, normalize, got, want,
                  want32)}
    empty_zero = all((out[i] == 0).all().item()
                     for i, n in enumerate(lens) if n == 0)
    rec["ok"] = rec["ok"] and empty_zero
    if not empty_zero:
        rec["fault"] = "kv_len 0 did not give zeros"
    if time_it:
        item = q.element_size()
        n_tok = sum(lens)
        n_pages_read = sum(-(-n // page) for n in lens)
        nbytes = (item * (2 * B * hq * d + 2 * n_tok * hkv * d)
                  + 4 * (n_pages_read + B))
        flops = 4.0 * hq * d * n_tok
        rec["bound_ms"], rec["bound_by"] = _bound_ms(nbytes, flops,
                                                     _dtype_name(dtype))
        rec["ms"] = timer.ms(lambda: pa._paged_decode_cuda(
            q, cache, normalize=normalize))
        rec["plain_ms"] = timer.ms(lambda: pa._paged_decode_plain(
            q, cache, normalize=normalize))
        rec["library_ms"] = None      # no single PyTorch call computes it
    return rec


def phase_kernels(torch, fa, pa, timer) -> dict:
    bf16, f32 = torch.bfloat16, torch.float32
    qwen = dict(hq=32, hkv=8, d=128)
    k1 = [
        flash_case(torch, fa, timer, name="prefill_1024", dtype=bf16, B=1,
                   Sq=1024, Sk=1024, q_off=0, normalize=True, time_it=True,
                   seed=0, **qwen),
        flash_case(torch, fa, timer, name="prefill_2x1024", dtype=bf16, B=2,
                   Sq=1024, Sk=1024, q_off=0, normalize=True, time_it=True,
                   seed=8, **qwen),
        flash_case(torch, fa, timer, name="slice_256_at_768_of_2048",
                   dtype=bf16, B=1, Sq=256, Sk=2048, q_off=768,
                   normalize=False, time_it=True, seed=1, **qwen),
        flash_case(torch, fa, timer, name="fp32_ragged_300", dtype=f32, B=2,
                   Sq=300, Sk=300, q_off=0, normalize=True, time_it=False,
                   seed=2, **qwen),
        flash_case(torch, fa, timer, name="d64_gqa4_ragged", dtype=bf16, B=1,
                   Sq=100, Sk=357, q_off=257, normalize=False,
                   time_it=False, seed=3, hq=16, hkv=4, d=64),
    ]
    k2 = [
        paged_case(torch, pa, timer, name="decode_4", dtype=bf16,
                   lens=[0, 1, 17, 1999], page=16, normalize=True,
                   time_it=True, seed=4, **qwen),
        paged_case(torch, pa, timer, name="decode_4_partial", dtype=bf16,
                   lens=[0, 1, 17, 1999], page=16, normalize=False,
                   time_it=False, seed=5, **qwen),
        paged_case(torch, pa, timer, name="decode_fp32", dtype=f32,
                   lens=[5, 0, 64, 333], page=16, normalize=True,
                   time_it=False, seed=6, **qwen),
        paged_case(torch, pa, timer, name="d64_page4", dtype=bf16,
                   lens=[3, 0, 9], page=4, normalize=False, time_it=False,
                   seed=7, hq=16, hkv=4, d=64),
    ]
    return {"flash_attention": k1, "paged_attention": k2}


def _mk_bound(cfg, lens, item: int, rows: int):
    """Least time of one decode step: every weight read once, each valid
    KV position's k and v read once (bytes), against the GEMM and
    attention flops of ``rows`` tokens — whichever is larger."""
    d, L = cfg.head_dim, cfg.num_layers
    h, f = cfg.hidden_size, cfg.intermediate_size
    per_layer = (h * (cfg.num_heads + 2 * cfg.num_kv_heads) * d
                 + cfg.num_heads * d * h + 3 * h * f)
    kv = 2 * sum(lens) * cfg.num_kv_heads * d
    nbytes = item * L * (per_layer + kv)
    flops = L * (2.0 * rows * per_layer + 4.0 * cfg.num_heads * d * sum(lens))
    return nbytes, flops


def mk_state(torch, mkserv, cfg, dtype, seed):
    """A PagedMegakernelDecoder over ``cfg`` with seeded random weights,
    every pool tile filled with random KV, and one slot per entry of
    MK_LENS on shuffled pages (each slot maps the pages its append
    needs). Returns (decoder, workspace, staged queue, tables)."""
    lens = MK_LENS
    from triton_distributed_tpu_torch.models.dense import init_dense_llm

    cfg = dataclasses.replace(cfg, dtype=_dtype_name(dtype))
    params = init_dense_llm(
        cfg, generator=torch.Generator(device="cuda").manual_seed(seed))
    need = [n // 128 + 1 if n else 0 for n in lens]
    dec = mkserv.PagedMegakernelDecoder(
        cfg, params, num_slots=len(lens), num_pages=sum(need),
        max_pages=MK_MAX_PAGES, dtype=dtype)
    ws = dec.start()
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    pools = torch.tensor([t for h in dec.prog.layers for pool in h.kT + h.v
                          for t in pool.tiles()], device="cuda")
    ws[pools] = torch.randn((len(pools), 128, 128), generator=g,
                            device="cuda").to(dtype)
    gh = torch.Generator().manual_seed(seed)
    perm = torch.randperm(sum(need), generator=gh).tolist()
    tables, i = [], 0
    for k in need:
        tables.append(perm[i:i + k] + [-1] * (MK_MAX_PAGES - k))
        i += k
    toks = torch.randint(0, cfg.vocab_size, (len(lens),), generator=gh)
    queue = dec.stage(ws, toks.tolist(), lens, tables)
    return dec, ws, queue, tables


def megakernel_case(torch, mk, mkserv, timer, *, name, dtype, cfg, seed,
                    time_it):
    """One megakernel step against run_queue_plain on the same staged
    workspace: every tile's live row (row 0 of each slot block) and every
    KV pool tile in full, elementwise under TOL; the errors also by the
    task type that wrote each tile."""
    dec, ws0, queue, _ = mk_state(torch, mkserv, cfg, dtype, seed)
    comp = dec.comp
    kw = dict(num_exec=comp.num_exec, mat_specs=comp.mat_specs,
              head_dim=comp.head_dim)
    ws_k = ws0.clone()
    launch = mk.cuda_launcher(queue, ws_k, dec._wsm, live_rows=1,
                              sync_before=comp.sync_before, **kw)
    launch()
    ws_p = mk.run_queue_plain(queue, ws0.clone(), dec._wsm, **kw)
    ws_32 = None
    if dtype != torch.float32:
        ws_32 = mk.run_queue_plain(queue, ws0.float(), dec._wsm.float(), **kw)
    torch.cuda.synchronize()
    pools = sorted(t for h in dec.prog.layers for pool in h.kT + h.v
                   for t in pool.tiles())
    pool_set = set(pools)
    rest = [t for t in range(comp.num_tiles) if t not in pool_set]
    pools_t = torch.tensor(pools, device="cuda")
    rest_t = torch.tensor(rest, device="cuda")

    def view(ws):
        return torch.cat([ws[pools_t].flatten(), ws[rest_t, 0].flatten()])

    got, want = view(ws_k).float(), view(ws_p).float()
    tol = TOL["megakernel_fp32" if dtype == torch.float32
              else "megakernel_bf16"]
    diff = (got - want).abs()
    mag = want.abs()
    share = (diff / (tol["atol"] + tol["rtol"] * mag)).max().item()
    atol_rules = mag * tol["rtol"] < tol["atol"]
    changed = (view(ws0).float() != want).sum().item()
    by_type = {}
    rows = comp.task_rows
    for tid, writes in enumerate(comp.task_writes):
        ty = mk.TaskType(int(comp.queue[rows[tid], 0])).name
        tiles = [t for t in writes if t < comp.num_tiles]
        if not tiles:
            continue
        idx = torch.tensor(tiles, device="cuda")
        err = (ws_k[idx, 0].float() - ws_p[idx, 0].float()).abs().max()
        by_type[ty] = max(by_type.get(ty, 0.0), err.item())
    rec = {"case": name, "dtype": _dtype_name(dtype), "shape": {
        "layers": cfg.num_layers, "hidden": cfg.hidden_size,
        "head_dim": cfg.head_dim, "kv_lens": MK_LENS, "page": 128, "tasks": comp.num_exec,
        "barriers": int(comp.sync_before.sum())},
        "max_abs_err": diff.max().item(),
        "max_abs_err_where_atol_rules": (diff[atol_rules].max().item()
                                         if atol_rules.any() else 0.0),
        "max_rel_err_where_rtol_rules": (
            (diff[~atol_rules] / mag[~atol_rules]).max().item()
            if (~atol_rules).any() else 0.0),
        "max_abs_err_by_writer": by_type, "tol": tol, "tol_share": share,
        "elements": got.numel(), "elements_changed_by_step": changed}
    if ws_32 is not None:
        ref = view(ws_32)
        rec["plain_err_vs_fp32"] = (want - ref).abs().max().item()
        rec["kernel_err_vs_fp32"] = (got - ref).abs().max().item()
    rec["ok"] = bool(torch.isfinite(got).all().item() and share <= 1.0
                     and changed > 0)
    if time_it:
        nbytes, flops = _mk_bound(cfg, MK_LENS, ws0.element_size(),
                                  len(MK_LENS))
        rec["bound_ms"], rec["bound_by"] = _bound_ms(nbytes, flops,
                                                     _dtype_name(dtype))
        rec["ms"] = timer.ms(launch)
        rec["plain_ms"] = timer.ms(lambda: mk.run_queue_plain(
            queue, ws_p, dec._wsm, **kw), iters=2, warmup=1)
        rec["library_ms"] = None     # no single PyTorch call runs a step
        rec["grid_blocks"] = mk.grid_blocks(dtype)
    return rec


def phase_megakernel_cases(torch, mk, mkserv, timer, QWEN3_8B) -> list:
    cfg = dataclasses.replace(QWEN3_8B, num_layers=2)
    cases = [
        megakernel_case(torch, mk, mkserv, timer, name="step_2l_bf16",
                        dtype=torch.bfloat16, cfg=cfg, seed=20,
                        time_it=True),
        megakernel_case(torch, mk, mkserv, timer, name="step_2l_fp32",
                        dtype=torch.float32, cfg=cfg, seed=21,
                        time_it=False),
        # The padded-head layout (head_dim 64 in 128-wide tiles), off the
        # Qwen3-8B path: the norm/rope sub-tile span of NORM_ROPE_QKV.
        megakernel_case(torch, mk, mkserv, timer, name="step_d64_fp32",
                        dtype=torch.float32, seed=22, time_it=False,
                        cfg=dataclasses.replace(
                            cfg, hidden_size=1024, intermediate_size=3072,
                            num_heads=16, num_kv_heads=8, head_dim=64)),
    ]
    torch.cuda.empty_cache()
    return cases


# ---------------------------------------------------------------------------
# Phases 3-5: the main path.
# ---------------------------------------------------------------------------

def reset_counts(kernels) -> None:
    for k in kernels:
        k.launches = 0
        k.plain_calls = 0


def phase_engine(torch, eng, kernels, *, batch=2, prompt=1024, gen=64,
                 reps=3):
    cfg = eng.cfg
    g = torch.Generator(device=eng.device).manual_seed(11)
    ids = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=g,
                        device=eng.device, dtype=torch.int32)
    eng.serve(ids[:, :128], 4)                       # warm-up (cuBLAS, …)
    flash, paged = kernels
    L = cfg.num_layers
    serve_s, prefill_s, first = [], [], None
    for _ in range(reps):     # the host's speed varies: keep the spread
        torch.cuda.synchronize()
        reset_counts(kernels)
        t0 = time.perf_counter()
        out = eng.serve(ids, gen)
        torch.cuda.synchronize()
        serve_s.append(time.perf_counter() - t0)
        check(flash.launches == L,
              f"engine: K1 launched {flash.launches} times, expected {L}")
        check(paged.launches == L * (gen - 1),
              f"engine: K2 launched {paged.launches} times, expected "
              f"{L * (gen - 1)}")
        check(flash.plain_calls == 0 and paged.plain_calls == 0,
              "engine: a plain version ran on the main path")
        check(tuple(out.shape) == (batch, gen) and out.dtype == torch.int32,
              f"engine: output shape {tuple(out.shape)} / {out.dtype}")
        check(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
              "engine: token ids out of range")
        check(first is None or torch.equal(out, first),
              "engine: a repeated serve gave other tokens")
        first = out
        launches = {"flash_attention": flash.launches,
                    "paged_attention": paged.launches}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = eng.prefill(ids)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
    check(bool(torch.isfinite(logits).all()), "engine: non-finite logits")
    total = sorted(serve_s)[len(serve_s) // 2]
    pre = sorted(prefill_s)[len(prefill_s) // 2]
    return {"phase": "engine", "batch": batch, "prompt": prompt, "gen": gen,
            "layers": L, "serve_s_runs": serve_s,
            "prefill_ms_runs": [t * 1e3 for t in prefill_s],
            "serve_s": total, "prefill_ms": pre * 1e3,
            "decode_ms_per_step": (total - pre) * 1e3 / (gen - 1),
            "tokens_per_s": batch * gen / total, "launches": launches,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "decode_profile": profile_decode(
                torch, eng, logits.argmax(-1).to(torch.int32),
                eng.to_paged(cache))}


def profile_decode(torch, eng, tok, cache, steps: int = 4) -> dict:
    """Device time of ``steps`` decode steps by kernel group, from
    ``torch.profiler`` (the launches here are outside the counted run).
    ``busy_share`` is kernel time over the profiled wall time, profiler
    overhead included."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        tok, cache = eng.decode(tok, cache)
    torch.cuda.synchronize()
    # Unprofiled: host time to enqueue each step vs the synced wall time.
    # Equal numbers mean the device waits on the host.
    enqueue = 0.0
    t0 = time.perf_counter()
    for _ in range(steps):
        t1 = time.perf_counter()
        tok, cache = eng.decode(tok, cache)
        enqueue += time.perf_counter() - t1
    torch.cuda.synchronize()
    unprofiled_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            tok, cache = eng.decode(tok, cache)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups: dict = {}
    names: dict = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = (getattr(e, "self_device_time_total", None)
              or getattr(e, "self_cuda_time_total", 0))
        low = e.key.lower()
        group = ("paged_attention" if "paged_decode_kernel" in low else
                 "flash_attention" if "flash_fwd_kernel" in low else
                 "matmul" if any(w in low for w in ("gemm", "gemv", "xmma",
                                                    "cutlass", "nvjet"))
                 else "other")
        groups[group] = groups.get(group, 0.0) + us / 1e3 / steps
        names[e.key[:80]] = names.get(e.key[:80], 0.0) + us / 1e3 / steps
    if not groups:
        return {"measured": False, "unprofiled_wall_ms_per_step":
                unprofiled_ms, "unprofiled_enqueue_ms_per_step":
                enqueue * 1e3 / steps,
                "reason": "profiler recorded no device time"}
    top = sorted(names.items(), key=lambda kv: -kv[1])[:8]
    return {"measured": True, "steps": steps,
            "unprofiled_wall_ms_per_step": unprofiled_ms,
            "unprofiled_enqueue_ms_per_step": enqueue * 1e3 / steps,
            "wall_ms_per_step": wall_ms / steps,
            "device_ms_per_step": groups,
            "busy_share": sum(groups.values()) * steps / wall_ms,
            "top_kernels_ms_per_step": dict(top)}


def _drive(se, prompts, gens):
    """Submit everything, step to completion; returns (requests, decode
    steps, prefill slices, wall seconds)."""
    from triton_distributed_tpu_torch.serving import AdmitResult

    reqs = []
    t0 = time.perf_counter()
    for p, n in zip(prompts, gens):
        req, res = se.submit(p, n)
        check(res is AdmitResult.ADMITTED, f"serving: {req.req_id} refused")
        reqs.append(req)
    decode_steps = slices = 0
    while se.sched.has_work():
        s = se.step()
        decode_steps += s["decoded"] > 0
        slices += s["prefilled"] is not None
        check(s["iter"] < 100_000, "serving: loop did not finish")
    return reqs, decode_steps, slices, time.perf_counter() - t0


def decode_window(torch, se, target, name: str, steps: int = 8) -> dict:
    """Decode-only steps of 4 running slots (prompts 100-1500 tokens,
    prefilled first), outside the counted run: each step's wall time
    (host sync included, the GPU idle at its start) and the host time of
    the lane's call that enqueues the step (``Engine.decode`` or
    ``PagedMegakernelDecoder.step``); equal numbers mean the device
    waits on the host. Then ``torch.profiler`` over 4 more steps for the
    device's busy share. ``target.name`` is the lane's call, wrapped for
    the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    inner = getattr(target, name)
    enqueue: list = []

    def timed(*a, **k):
        t0 = time.perf_counter()
        out = inner(*a, **k)
        enqueue.append(time.perf_counter() - t0)
        return out

    setattr(target, name, timed)
    g = torch.Generator().manual_seed(14)
    for n in (100, 1500, 640, 333):
        se.submit(torch.randint(0, se.cfg.vocab_size, (n,),
                                generator=g).tolist(), steps + 32)
    while se.sched.waiting or se.sched.prefill_head() is not None:
        se.step()
    enqueue.clear()
    walls = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = se.step()
        walls.append(time.perf_counter() - t0)
        check(s["decoded"] == 4, "decode window: a slot stopped decoding")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(4):
            se.step()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    setattr(target, name, inner)
    busy = sum((getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0))
               for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA)
    med = sorted(walls)[len(walls) // 2]
    enq = sorted(enqueue[:steps])[steps // 2]
    return {"slots": 4, "steps": steps, "step_ms_runs": [w * 1e3 for w in walls],
            "step_ms": med * 1e3, "enqueue_ms": enq * 1e3,
            "profiled_busy_share": (busy / 1e6 / prof_wall if busy
                                    else "not measured")}


def phase_serving(torch, eng, kernels, ServingEngine, RequestState):
    lengths = SERVING_LENGTHS
    gen = 32
    g = torch.Generator().manual_seed(12)
    prompts = [torch.randint(0, eng.cfg.vocab_size, (n,),
                             generator=g).tolist() for n in lengths]
    se = ServingEngine(eng, max_batch=4, prefill_chunk=256)
    torch.cuda.synchronize()
    reset_counts(kernels)
    reqs, steps, slices, wall = _drive(se, prompts, [gen] * len(lengths))
    torch.cuda.synchronize()
    flash, paged = kernels
    L = eng.cfg.num_layers
    check(all(r.state is RequestState.FINISHED and len(r.tokens) == gen
              for r in reqs), "serving: not every request finished")
    check(flash.launches == L * slices,
          f"serving: K1 launched {flash.launches}, expected {L * slices}")
    check(paged.launches == L * steps,
          f"serving: K2 launched {paged.launches}, expected {L * steps}")
    check(flash.plain_calls == 0 and paged.plain_calls == 0,
          "serving: a plain version ran on the main path")
    ttft = sorted(r.ttft_s * 1e3 for r in reqs)

    def pct(p):
        return ttft[min(len(ttft) - 1, int(round(p / 100 * (len(ttft) - 1))))]

    return {"phase": "serving", "requests": len(reqs), "prompt_lens": lengths,
            "gen": gen, "max_batch": 4, "prefill_chunk": 256,
            "prefill_slices": slices, "decode_steps": steps, "wall_s": wall,
            "tokens_per_s": sum(len(r.tokens) for r in reqs) / wall,
            "ttft_ms_p50": pct(50), "ttft_ms_p99": pct(99),
            "preemptions": sum(r.preemptions for r in reqs),
            "launches": {"flash_attention": flash.launches,
                         "paged_attention": paged.launches},
            "decode_window": decode_window(torch, se, eng, "decode")}


def phase_megakernel_serving(torch, mk, mkserv, kernels, Engine,
                             ServingEngine, RequestState, QWEN3_8B,
                             init_dense_llm):
    """Full Qwen3-8B (36 layers, bf16, the serving phase's seeded weights
    and requests) on the megakernel lane: every request finishes, one
    megakernel launch per decode step, K1 once per layer and prefill
    slice, K2 never, no plain version. Then the decode-only window, and
    the kernel alone at this shape (4 slots at MK_LENS, one step, CUDA
    events) against its bound and its plain version."""
    params = init_dense_llm(
        QWEN3_8B, generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(QWEN3_8B, params, max_seq=2048, page_size=128,
                 backend="megakernel")
    t0 = time.perf_counter()
    se = ServingEngine(eng, max_batch=4, prefill_chunk=256)
    torch.cuda.synchronize()
    build_lane_s = time.perf_counter() - t0
    gen = 32
    g = torch.Generator().manual_seed(12)
    prompts = [torch.randint(0, QWEN3_8B.vocab_size, (n,),
                             generator=g).tolist() for n in SERVING_LENGTHS]
    torch.cuda.synchronize()
    reset_counts(kernels)
    reqs, steps, slices, wall = _drive(se, prompts,
                                       [gen] * len(SERVING_LENGTHS))
    torch.cuda.synchronize()
    flash, paged, mega = kernels
    L = QWEN3_8B.num_layers
    check(all(r.state is RequestState.FINISHED and len(r.tokens) == gen
              for r in reqs), "megakernel serving: not every request "
          "finished")
    check(mega.launches == steps, f"megakernel serving: {mega.launches} "
          f"megakernel launches for {steps} decode steps")
    check(paged.launches == 0, f"megakernel serving: K2 launched "
          f"{paged.launches} times")
    check(flash.launches == L * slices, f"megakernel serving: K1 launched "
          f"{flash.launches}, expected {L * slices}")
    check(all(k.plain_calls == 0 for k in kernels),
          "megakernel serving: a plain version ran on the main path")
    launches = {"flash_attention": flash.launches,
                "paged_attention": paged.launches,
                "megakernel": mega.launches}
    peak = torch.cuda.max_memory_allocated() / 1e9
    ttft = sorted(r.ttft_s * 1e3 for r in reqs)
    window = decode_window(torch, se, se._mk, "step")

    # The kernel alone at the main path's shape: the lane's own program
    # and weights, slots at MK_LENS on free pool pages.
    dec, ws = se._mk, se._mk_ws
    need = [n // 128 + 1 if n else 0 for n in MK_LENS]
    pages = list(range(sum(need)))
    tables, i = [], 0
    for k in need:
        tables.append(pages[i:i + k] + [-1] * (dec.max_pages - k))
        i += k
    queue = dec.stage(ws, [1, 2, 3, 4], MK_LENS, tables)
    comp = dec.comp
    kw = dict(num_exec=comp.num_exec, mat_specs=comp.mat_specs,
              head_dim=comp.head_dim)
    launch = mk.cuda_launcher(queue, ws, dec._wsm, live_rows=1,
                              sync_before=comp.sync_before, **kw)
    timer = Timer(torch, "cuda")
    ms = timer.ms(launch, iters=5)
    plain_ms = timer.ms(lambda: mk.run_queue_plain(
        queue, ws.clone(), dec._wsm, **kw), iters=1, warmup=1)
    nbytes, flops = _mk_bound(QWEN3_8B, MK_LENS, ws.element_size(),
                              len(MK_LENS))
    bound, bound_by = _bound_ms(nbytes, flops, "bfloat16")
    return {"phase": "megakernel_serving", "requests": len(reqs),
            "prompt_lens": SERVING_LENGTHS, "gen": gen, "max_batch": 4,
            "prefill_chunk": 256, "page_size": 128,
            "build_lane_s": build_lane_s, "prefill_slices": slices,
            "decode_steps": steps, "wall_s": wall,
            "tokens_per_s": sum(len(r.tokens) for r in reqs) / wall,
            "ttft_ms_p50": ttft[len(ttft) // 2], "ttft_ms_p99": ttft[-1],
            "preemptions": sum(r.preemptions for r in reqs),
            "launches": launches, "peak_mem_gb": peak,
            "decode_window": window,
            "step_kernel": {"kv_lens": MK_LENS, "tasks": comp.num_exec,
                            "barriers": int(comp.sync_before.sum()),
                            "ms": ms, "plain_ms": plain_ms,
                            "bound_ms": bound, "bound_by": bound_by,
                            "grid_blocks": mk.grid_blocks(torch.bfloat16),
                            "library_ms": None}}


def _first_divergence(torch, eng, prompt, got, want):
    """Step and top-2 logit gap where ``got`` left ``want``."""
    step = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    ids = torch.tensor([list(prompt) + list(want[:step])], dtype=torch.int32)
    logits, _ = eng.prefill(ids)
    top = torch.topk(logits[0].float(), 2).values
    return step, float(top[0] - top[1])


def phase_parity(torch, QWEN3_8B, init_dense_llm, Engine, ServingEngine,
                 mega):
    cfg = dataclasses.replace(QWEN3_8B, num_layers=2, dtype="float32")
    params = init_dense_llm(
        cfg, generator=torch.Generator(device="cuda").manual_seed(1))
    eng = Engine(cfg, params, max_seq=256, page_size=16)
    mk_eng = Engine(cfg, params, max_seq=256, page_size=128,
                    backend="megakernel")
    # torch.argmax on the card must return the FIRST maximum (jnp.argmax's
    # rule), or greedy token identity could not be relied on.
    x = torch.zeros((3, cfg.vocab_size), device="cuda")
    x[:, [5, cfg.vocab_size // 2, cfg.vocab_size - 1]] = 1.0
    check(torch.argmax(x, dim=-1).tolist() == [5, 5, 5],
          "parity: torch.argmax does not return the first maximum")
    g = torch.Generator().manual_seed(13)
    runs = {
        # 4 requests through 2 slots, slices interleaving with decode.
        "two_slots": (eng, dict(max_batch=2, prefill_chunk=64),
                      [37, 100, 64, 150], [12, 8, 16, 10]),
        # An undersized pool: page growth preempts, resume recomputes.
        "preempt": (eng, dict(max_batch=3, num_pages=20, prefill_chunk=64),
                    [90, 60, 75, 100], [40, 40, 40, 40]),
        # The same two shapes on the megakernel lane (page 128): slot
        # reuse, and a 3-page pool that preempts a request mid-decode
        # and recomputes it into its pool pages on resume.
        "megakernel_two_slots": (mk_eng, dict(max_batch=2,
                                              prefill_chunk=128),
                                 [37, 100, 64, 150], [12, 8, 16, 10]),
        "megakernel_preempt": (mk_eng, dict(max_batch=3, num_pages=3,
                                            prefill_chunk=128),
                               [90, 60, 75, 100], [40, 40, 40, 40]),
    }
    result = {"phase": "parity", "layers": cfg.num_layers, "dtype": "float32"}
    for name, (engine, kw, lengths, gens) in runs.items():
        prompts = [torch.randint(0, cfg.vocab_size, (n,),
                                 generator=g).tolist() for n in lengths]
        golden = [eng.serve([p], n)[0].tolist()
                  for p, n in zip(prompts, gens)]
        mega.launches = 0
        reqs, steps, _, _ = _drive(ServingEngine(engine, **kw), prompts,
                                   gens)
        for r, p, want in zip(reqs, prompts, golden):
            if r.tokens != want:
                step, gap = _first_divergence(torch, eng, p, r.tokens, want)
                emit({"phase": "parity", "run": name, "req": r.req_id,
                      "diverged_at_step": step, "top2_logit_gap": gap})
                raise RuntimeError(f"chip_smoke: parity {name}: {r.req_id} "
                                   f"diverged at step {step}")
        pre = sum(r.preemptions for r in reqs)
        if name.endswith("preempt"):
            check(pre >= 1, f"parity {name}: the small pool forced no "
                  "preemption")
        if engine is mk_eng:
            check(mega.launches == steps, f"parity {name}: "
                  f"{mega.launches} megakernel launches for {steps} steps")
        result[name] = {"requests": len(reqs), "tokens": sum(gens),
                        "preemptions": pre, "identical": True}
    return result


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "script runs on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import importlib

    fa = importlib.import_module(
        "triton_distributed_tpu_torch.ops.flash_attention")
    pa = importlib.import_module(
        "triton_distributed_tpu_torch.ops.paged_attention")
    mk = importlib.import_module(
        "triton_distributed_tpu_torch.megakernel.kernel")
    mkserv = importlib.import_module(
        "triton_distributed_tpu_torch.megakernel.serving")
    from triton_distributed_tpu_torch.models.config import QWEN3_8B
    from triton_distributed_tpu_torch.models.dense import init_dense_llm
    from triton_distributed_tpu_torch.models.engine import Engine
    from triton_distributed_tpu_torch.runtime import build
    from triton_distributed_tpu_torch.serving import (
        RequestState, ServingEngine,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = (fa.FLASH_KERNEL, pa.PAGED_KERNEL)
    all_kernels = kernels + (mk.MEGA_KERNEL,)
    names = ("flash_attention", "paged_attention", "megakernel")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()

    build_s = build.build_all()
    ptxas = {}
    for src in build.sources():
        log = build.library_path(src).with_suffix(".log")
        ptxas[src.name] = [ln.strip() for ln in log.read_text().splitlines()
                           if "registers" in ln or "spill" in ln]
    emit({"phase": "device", "kind": kind, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s, "ptxas": ptxas})

    timer = Timer(torch, "cuda")
    cases = phase_kernels(torch, fa, pa, timer)
    cases["megakernel"] = phase_megakernel_cases(torch, mk, mkserv, timer,
                                                 QWEN3_8B)
    L = QWEN3_8B.num_layers
    emit({"phase": "kernels", "nvidia_smi": smi, "tol_reason": TOL_REASON,
          "launches_per_step": {"flash_attention": f"{L} per prefill or "
                                "prefill slice (one per layer)",
                                "paged_attention": f"{L} per decode step "
                                "(one per layer) on the eager lane",
                                "megakernel": "1 per decode step on the "
                                "megakernel lane"},
          "cases": cases})
    bad = [c["case"] for cs in cases.values() for c in cs if not c["ok"]]
    check(not bad, f"kernels disagree with their plain versions: {bad}")

    params = init_dense_llm(
        QWEN3_8B, generator=torch.Generator(device="cuda").manual_seed(0))
    eng = Engine(QWEN3_8B, params, max_seq=2048, page_size=16)
    engine_rec = phase_engine(torch, eng, kernels)
    engine_rec["nvidia_smi"] = smi
    emit(engine_rec)
    serving_rec = phase_serving(torch, eng, kernels, ServingEngine,
                                RequestState)
    serving_rec["nvidia_smi"] = smi
    emit(serving_rec)
    del eng, params
    torch.cuda.empty_cache()

    mk_rec = phase_megakernel_serving(torch, mk, mkserv, all_kernels, Engine,
                                      ServingEngine, RequestState, QWEN3_8B,
                                      init_dense_llm)
    mk_rec["nvidia_smi"] = smi
    mk_rec["eager_lane"] = {k: serving_rec[k] for k in (
        "tokens_per_s", "ttft_ms_p50", "decode_window")}
    emit(mk_rec)
    torch.cuda.empty_cache()

    emit(phase_parity(torch, QWEN3_8B, init_dense_llm, Engine,
                      ServingEngine, mk.MEGA_KERNEL))

    replaces = {"flash_attention": "triton_distributed_tpu/ops/"
                                   "flash_attention.py:157",
                "paged_attention": "triton_distributed_tpu/ops/"
                                   "paged_attention.py:160",
                "megakernel": "triton_distributed_tpu/megakernel/"
                              "kernel.py:39"}
    summary = []
    for kernel, name in zip(all_kernels, names):
        if name == "megakernel":   # the main path's shape: 36 layers
            main_case = mk_rec["step_kernel"]
            launches = mk_rec["launches"][name]
        else:
            main_case = next(c for c in cases[name]
                             if c["case"] == MAIN_CASE[name])
            launches = serving_rec["launches"][name]
        summary.append({
            "name": name, "route": "cuda",
            "source": str(kernel.source_path.relative_to(
                build.PKG_DIR.parent)),
            "replaces": replaces[name], "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in cases[name]),
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"]})
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
