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
   peak rate of the input type, whichever is larger). K2 runs over bf16,
   fp32 and e4m3 pools; the megakernel's cases run one decode step at
   Qwen3-8B widths cut to 2 layers, 4 slots of page 128: at kv_lens [0, 1,
   127, 1999] in bf16 and fp32 over workspace-dtype and e4m3 pools, and
   with a speculative window of 4 rows at kv_lens [0, 1, 126, 1999] (slot
   2's window spills into its next page) in both types over both pools;
   the linear decoder (``MegakernelDecoder``, batch 1, max_seq 2048) at
   the same widths and depth, stepped at positions 0, 1, 127 and 1999 in
   bf16 and fp32, in the matrix layout and over e4m3 weight tiles, plus
   head_dim 64 (with the in-kernel final norm), each with a per-task
   replay of its attention and append tasks; a hand-built program of
   the task types no decoder emits, on 4 rows and on 1, and with
   PREFETCH / PREFETCH_W8 warms on 8 and 128 rows (bit-identical to the
   same program without them); speculative windows of 5, 8 and 128 rows
   in both types over both pools; the MoE program at batch 8 and 32;
3. ``engine``  — Qwen3-8B at full width and depth, random bf16 weights from a
   seeded generator, ``Engine.serve`` of 2 x 1024-token prompts for 64 new
   tokens; K1/K2 launch counts must match the layer count, plain versions
   never called;
4. ``serving`` — the same model through ``ServingEngine`` (6 requests, prompts
   100-1500 tokens, 32 new tokens each); all finish, counts match; then a
   decode-only window of 4 running slots times the eager step;
5. ``fp8_serving`` / ``spec_serving`` — the same on e4m3 KV pools sized by a
   byte budget (K2's e4m3 lane on every step), and with speculative decode
   (``spec_k=3``, prompts of repeated phrases so drafts are proposed);
6. ``megakernel_serving`` — the same model and requests through
   ``ServingEngine`` on ``Engine(backend="megakernel", page_size=128)``:
   every decode step is one megakernel launch (K2 never, K1 once per layer
   and prefill slice, no plain version); the same decode-only window, and
   the kernel's time at this shape against its bound and its plain time;
   then ``fp8_megakernel_serving`` (e4m3 pools: types 24/25 on every
   launch), ``spec_megakernel_serving`` (the 4-row window program) and
   ``spec4_megakernel_serving`` (``spec_k=4``: 5 rows, past one 4-row
   group of the kernel);
7. ``megakernel_engine`` — the same model through
   ``Engine(backend="megakernel", max_seq=2048).serve``: one 1024-token
   prompt, 64 tokens, the linear decoder as the engine builds it (float32
   workspace): one megakernel launch per decoded token, K2 never; then the
   decoder alone over a bfloat16 workspace and over e4m3 weight tiles
   (step wall and enqueue time, the kernel's time with L2 flushed against
   its byte bound, tokens/s, peak memory; the bf16 decoder also takes
   one ``profile=True`` step, whose dump must equal the step queue's
   records, and the stamp's cost is timed), and the eager
   ``Engine.serve`` at batch 1 in the same call;
8. ``parity``  — float32 Qwen3-8B widths at 2 layers: ``ServingEngine``
   tokens identical to sequential ``Engine.serve`` on both lanes, each with
   a run whose small pool forces preemption — with workspace-dtype pools,
   e4m3 pools, speculative decode, (megakernel lane) both at once, and
   ``spec_k`` 4 and 7;
   ``torch.argmax`` ties go to the first max. ``linear_parity``:
   ``Engine.serve`` on the megakernel token-identical to the eager serve,
   and the fp8-weight decoder to the eager engine on e4m3 pre-quantized
   weights;
9. kernel B3 (the tiled GEMM, ``ops/gemm.py``): ``gemm`` cases in the
   ``kernels`` phase — every lane against its plain version at the
   headline M=2048, K=N=5120 (bf16, e4m3 with e4m3 and bf16 output, bf16 x
   e4m3, fp32 by FMA with TF32 off), at m=8, at the Qwen3-8B decode
   products (M=1, e4m3) and the Qwen3-30B-A3B expert products (4 rows),
   and at the reference's odd shapes; ``gemm_tuned`` —
   ``pallas_matmul_tuned`` at the headline shape measures its candidates
   once (a fresh tuner cache file), then hits the cache;
   ``linear_engine`` — Qwen3-8B through ``Engine(cfg, params,
   max_seq=2048)`` with the reference's defaults (linear-cache decode),
   2 x 1024 prompts, 64 new; ``fp8_decode`` — the same model quantized by
   ``quantize_dense_weights``, 64 ``dense_decode_step(dot_fn=fp8_dot)``
   steps after a 1024-token prefill: 252 B3 launches a step, its time
   against its byte bound, the device's busy share; then at float32 and 2
   layers ``linear_engine_parity`` (the default engine's tokens identical
   to the paged and megakernel serves) and ``fp8_parity`` (``fp8_dot``'s
   tokens identical to ``fp8_emulated_dot``'s); last ``fp8_experts`` —
   one Qwen3-30B-A3B MoE layer over e4m3 expert stacks through B3 against
   its plain version, and one quantized decode step.
10. tensor parallelism on n virtual ranks on cuda:0 (asked for
   explicitly; the kernel code that would run across cards, only the peer
   pointer table differs): ``collectives`` — the one-shot and parity-stream
   AllReduce (B5), the ring reduce-scatter (B6) and the ring all-gather
   (B4) of ``csrc/collectives.cu``, and the two-shot they make, at n = 2, 4
   and 8, fp32 and bf16, 4-2048 rows x 4096, bit-identical to their plain
   versions and timed (bound: the bytes every rank moves, all through the
   one card's HBM); B6's push-protocol edges at n = 2, 3, 4 and 8 (chunks
   of 1-2048 rows, held-back ranks, NaN written into a source's input
   after each call, 200 calls without a sync); 200 back-to-back parity
   calls with a rotating rank held back; a lost peer raising
   ``CommTimeoutError``; AUTO's method at every
   AR payload the serving path runs; K1/K2 at one rank's TP=4 heads.
   ``tp_serving`` — Qwen3-8B at full width and depth, bf16, through
   ``ServingEngine(Engine(cfg, params, ctx of 4 ranks, page_size=16),
   max_batch=4, prefill_chunk=256)`` over the six prompts x 4 tokens,
   every kernel's launches as the path predicts (72 parity ARs a rank a
   decode step, a two-shot per reduction of a slice), the decode window;
   then ``spec_k=3`` (its verify steps take the one-shot). ``tp_parity`` —
   float32, 2 layers: the TP=4 tokens identical to the TP=1 eager lane's
   with a preemption, over workspace-dtype pools, e4m3 pools and with
   ``spec_k=3``, and every rank's logits bit-identical.
11. the fused kernels of ``csrc/gemm_comm.cu`` — AG+GEMM (B9), GEMM+RS
   (B10), GEMM+AR (B11) — and the double-tree AllReduce (B5's tree, in
   ``csrc/collectives.cu``): ``collectives`` runs the tree beside the
   other AR forms; ``collectives_fused`` each fused kernel at n = 2, 4 and
   8, fp32 and bf16, the communication (B9's gathered A, B10's and B11's
   reductions of the kernel's own slots) and the replicas bit for bit,
   the GEMM at B3's tolerance, and at the main path's shapes (n = 4, bf16:
   Qwen3-8B's 2 x 1024 prefill and a batch-2 decode step) timed; B9 and
   B10 on their wgmma + TMA route at the edges of its tile (bf16, every n;
   a held-back rank at n = 4), with NaN in B9's landing workspace and
   B10's slots before every checked call, and each case's route
   (``variant_launches``) the picker's — "wgmma" at every main and edge
   shape, the tall mma.sync tile for bf16 at the "_tall" controls (B9 at
   100 columns, B10 with a B one element off 16 bytes); the tree at 1, 7
   and 203 rows at n = 2, 3, 4, 8 into 0xFF-filled outputs, a held-back
   rank 0 and rank n - 1, 200 calls without a sync (the tree on the push
   protocol); 200 back-to-back B11 calls with a rotating straggler; a
   lost peer's ``CommTimeoutError`` for B9 and B11. ``tp_engine`` —
   Qwen3-8B, bf16, ``Engine(cfg, params, ctx of 4 ranks,
   max_seq=2048).serve`` with the reference's defaults: a 2 x 1024
   prompt for 12 tokens (prefill "overlap": B9 180 and B10 72 launches a
   rank, every one on the wgmma route;
   linear decode: 72 parity ARs a rank a step), again under
   ``TDTPU_GEMM_AR=1`` (72 B11 a step), then a 1 x 203 prompt whose "ar"
   prefill reduces through the tree (72 a rank); TP=1's serve in the same
   call. ``tp_engine_parity`` — float32, 2 layers: TP=4 ``Engine.serve``
   tokens identical to TP=1's with the defaults, ``TDTPU_GEMM_AR=1``, the
   tree prompt and ``backend="xla"``; every rank's logits bit-identical.
12. MoE over ranks: ``collectives_a2a`` — the AllToAll of
   ``csrc/all_to_all.cu`` (B8: the barrier form and the parity stream)
   and the all-gather's full-mesh push (B4, ``csrc/collectives.cu``) at
   n = 2, 4 and 8, fp32, bf16 and e4m3, with empty, ragged and full slots,
   bit-identical to their plain versions on every rank, each timed at its
   main-path shape; the parity stream's push-protocol edges (0xFF-filled
   outputs, held-back ranks, the loopback); 200 parity calls with a
   rotating straggler; a lost and a held-back peer raising
   ``CommTimeoutError``. After ``moe_engine`` and
   ``moe_serving`` on the same Qwen3-30B-A3B weights: ``ep_moe`` — the EP
   layer on 4 virtual ranks (32 experts a rank, dim-0 views): 4 tokens a
   rank through all 48 layers for 4 steps on the parity stream, 512
   tokens a rank through the barrier form, each layer held against the
   one-rank form, then fp32 at 2 layers; ``tp_moe_engine`` — TP=1's
   ``Engine.serve`` of a 2 x 1024 prompt for 4 tokens, then the weights
   sharded over 4 virtual ranks leaf by leaf (never held twice) and the TP
   engine's serve with the defaults (the prefill's B9 / B10 / ring RS and
   the decode's parity AR counted exactly), its decode profile, and the
   sequential "overlap" TP-MoE layer at n = 2 through the full-mesh push;
   ``tp_moe_serving`` — ServingEngine on those shards, 2 prompts x 4
   tokens and a 4-step decode window; last ``tp_moe_parity`` — float32, 2
   layers: TP=4 tokens identical to TP=1's in ``Engine.serve`` (defaults,
   ``backend="xla"``) and ``ServingEngine`` (a preemption, ``spec_k=3``).

13. sequence and pipeline parallelism: ``collectives_sp_pp`` — B4's
   barrier-free parity AllGather (``ag_parity`` in
   ``csrc/collectives.cu``) in fp32, bf16 and e4m3 at 1-2048 rows, and
   B7's ring shift and permutation (``csrc/p2p.cu``) — shifts of +1, -1
   and 2, a partial permutation with a multicast, a butterfly, a full
   ring (which takes the shift kernel), one rank under ``force_kernel``
   — at n = 2, 4 and 8, bit-identical to their plain versions on every
   rank, timed at their main shapes (the SP decode's 128 x 130 fp32
   partials; one 512 x 4096 bf16 PP microbatch); 200 parity calls with a
   rotating straggler; held-back ranks raising ``CommTimeoutError``.
   ``sp_decode`` — Qwen3-8B's attention widths, B = 4 sequences of 32768
   tokens sharded over 4 ranks (ragged shard lengths, one empty), 36
   layers x 16 steps through ``SpFlashDecodeAttention`` on the parity
   stream, held against one-rank K2; one layer through ``flash_decode``
   over B4's push and the plain gather. ``sp_prefill`` — ring, SP-AG and
   Ulysses attention at S = 8192 on 4 ranks against one-rank K1.
   ``pp_forward`` (with the Qwen3-8B weights) — GPipe on 4 stages of 9
   layers and the interleaved schedule with 3 chunks, 8 microbatches of
   512 tokens, against the 36 layers on one rank; one ``CommOp.exchange``
   of a butterfly. ``sp_pp_parity`` (after ``tp_engine_parity``) — every
   new entry point at n = 2 and 4, fp32, on the card against the CPU
   rank threads' plain versions.

14. the two-tier rank group (``mesh_shape=(2, 4), axis_names=("dcn",
   "tp")``, 8 virtual ranks): ``collectives_2d`` — B12's torus AllGather
   and hierarchical one-shot AllReduce (``csrc/multi_axis.cu``) at (2, 4),
   (4, 2) and (2, 2), fp32 and bf16, 1-2048 rows x 4096, and the two-shot
   (B6 along each axis, then the torus AG), bit-identical to their plain
   versions on every rank — the AllGather (on the push protocol) into
   0xFF-filled outputs, at 3 and 1000 rows too, with a
   held-back rank 0 and rank n - 1 and 200 calls without a sync on each
   grid; the (8, 1) and (1, 8) grids through the 1-D
   ops; a counted main run through the tuple-axis entry points, timed.
   ``migrate`` — ``kv_migrate_local`` of one 1024-token request's KV at
   Qwen3-8B widths (64 pages x 16 rows x 18432 bf16) from slice 0 into
   slice 1 at rewritten ids, in two blocks, through B13's pack and scatter
   (``csrc/migrate.cu``): the landed pages bit for bit, the rest and the
   inputs untouched, the validation errors; B13 timed at one 32-page
   block; a ``MigrationStream`` over card tensors with its checksums and
   the dropped / corrupted / late-block errors. ``tp2d_engine`` (after
   ``tp_engine``) — Qwen3-8B at full width cut to 4 layers, bf16:
   ``Engine.serve`` on (dcn=2, tp=4) of a 2 x 1024 prompt for 8 tokens,
   the prefill in "overlap2d" (256 rows a rank; B9, B10 and B3 counted
   exactly), the decode through the two-tier AllReduce; B9, B10 and B3
   under ``ag_gemm_2d_local`` / ``gemm_rs_2d_local`` at the prefill's
   shapes and weights against their plain composition, every rank's
   prefill logits bit-identical; the one-axis TP=4 engine's serve in the
   same call. ``tp2d_parity`` (after
   ``sp_pp_parity``) — float32, 2 layers: the two-tier serve's tokens
   equal to the one-rank engine's ("overlap2d" and "ar" prefills), every
   rank's logits bit-identical.

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

# Virtual ranks run one stream each on one card: give every stream its own
# hardware queue (the default is 8), so no rank's kernel queues behind a
# peer's kernel that waits for it. Read when CUDA initialises.
os.environ["CUDA_DEVICE_MAX_CONNECTIONS"] = "32"

HBM_BYTES_PER_S = 3.35e12                                   # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12,         # dense; fp32 = FMA
              "float8_e4m3fn": 1979e12}

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
    # A whole 2-layer step over e4m3 pools, activations and pool tiles: a
    # k/v value next to an e4m3 rounding boundary (it differs in summation
    # order, or by a flipped bf16 unit) rounds one e4m3 step away — up to
    # 2^-3 of the value — and that step moves layer 2's inputs, whose
    # appends then round to other e4m3 values. Set from the spread
    # measured on an H100 (700 W) with a margin; the per-task replay
    # below holds each task to the arithmetic tolerances.
    "megakernel_e4m3_bf16": dict(atol=0.4, rtol=0.32),
    "megakernel_e4m3_fp32": dict(atol=0.125, rtol=0.125),
    # Per-task replay: every attention task rerun by the plain version on
    # the inputs the kernel left (its q, current k/v and the step's
    # starting pools), output against the kernel's. bf16: p rounds to
    # bf16 at each warp's page tile max in the kernel and at the row max
    # in the plain version (e4m3 pools: p unrounded), then the output
    # rounds. fp32 replays use "fp32". Appends replay bit for bit.
    "megakernel_attn_bf16": dict(atol=4e-3, rtol=1.6e-2),
}
# Partials: |m - m_plain| <= 1e-4 and |l - l_plain| <= 1e-4 * l_plain
# (fp32 sums of up to 2048 terms; m = -1e30, l = 0 on dead rows).
M_ATOL, L_RTOL = 1e-4, 1e-4
TOL_REASON = (
    "K1 bf16: p rounded to bf16 at the key tile's running max (kernel) or "
    "the row max (plain), output rounded to bf16; K2 bf16: only the output "
    "rounds; fp32 (and K2 partials): summation order only; megakernel: "
    "summation order per task, compounded through a 2-layer step by each "
    "task's rounded stores; the megakernel's e4m3 pool tiles: one e4m3 "
    "step for an appended value next to a rounding boundary. Each bf16 "
    "case also reports the plain bf16 version's and the kernel's max "
    "error against the plain version run in fp32.")
# The case whose shape the main path gives each kernel (engine prefill of
# 2 x 1024 prompts; a decode batch of 4 in the serving phase).
MAIN_CASE = {"flash_attention": "prefill_2x1024",
             "paged_attention": "decode_4",
             "paged_attention_e4m3": "decode_4_e4m3",
             "flash_attention_g8": "prefill_2x1024_g8",
             "paged_attention_g8": "decode_4_g8"}
# The megakernel cases' slots: idle (scratch page), one token, an append
# at a page's last column, and a long context over 16 shuffled pages.
MK_LENS = [0, 1, 127, 1999]
MK_MAX_PAGES = 16
# The window cases: 4 candidate rows per slot; slot 2's window (positions
# 126-129) spills into its next page.
MK_WIN_LENS = [0, 1, 126, 1999]
MK_WINDOW = 4
# Windows past the 4 rows a GEMM item holds sums for: one group plus a row,
# two groups, a whole slot block (at 128 rows the long slot starts at 1900,
# so its window ends inside MK_MAX_PAGES pages; slot 2's window spills).
MK_ROWS_WINDOWS = (5, 8, 128)
MK_ROWS_LENS = [0, 1, 126, 1900]
# The serving phases' prompt lengths (32 new tokens each), the draft depth
# of the spec phases (the megakernel computes at most 4 rows per slot
# block), and the KV byte budget of the fp8 phases.
SERVING_LENGTHS = [100, 1500, 640, 333, 1024, 877]
SPEC_K = 3
SPEC_K_ROWS = 4     # W = 5: one row past the kernel's 4-row groups
KV_BUDGET = 1 << 30


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


def nvidia_smi_all() -> str:
    """Every card's name and power limit, one line each."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


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


def library_every_rank(timer, n: int, call, what: str, *,
                       outputs_per_call: int = 1) -> dict:
    """A collective's library yardstick: the PyTorch call that makes one
    rank's output, once per rank, back to back in one timed lambda — the
    work that the kernel time (every rank's call) and the bound (every
    rank's bytes) cover. ``outputs_per_call`` > 1 where one call makes
    several ranks' outputs (a reduce-scatter's chunks)."""
    calls = -(-n // outputs_per_call)

    def run():
        for _ in range(calls):
            call()

    return {"library_ms": timer.ms(run), "library_outputs": n,
            "library_call": f"{calls} x {what}"}


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
               q_off, normalize, time_it, seed, k_off=0, causal=True):
    """One K1 case. Keys past the call's key frontier are NaN in the
    kernel's input: K1 must never let them reach its output (the plain
    version gets zeros there). Rows that see no key must end dead: m =
    -1e30 and l = 0 exactly, a normalized output of 0."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, Sq, hq, d), generator=g, device="cuda").to(dtype)
    k = torch.randn((B, Sk, hkv, d), generator=g, device="cuda").to(dtype)
    v = torch.randn((B, Sk, hkv, d), generator=g, device="cuda").to(dtype)
    frontier = max(0, fa.key_frontier(Sq, Sk, q_off, k_off, causal=causal))
    k_nan, v_nan = k.clone(), v.clone()
    k_nan[:, frontier:] = float("nan")
    v_nan[:, frontier:] = float("nan")
    got = fa._flash_cuda(q, k_nan, v_nan, q_off, k_off, causal=causal,
                         normalize=normalize)
    want = fa._flash_plain(q, k, v, q_off, k_off, causal=causal,
                           normalize=normalize)
    want32 = None if dtype == torch.float32 else fa._flash_plain(
        q.float(), k.float(), v.float(), q_off, k_off, causal=causal,
        normalize=normalize)
    torch.cuda.synchronize()
    plan = fa.flash_launch_plan(B, Sq, Sk, hq, d, q_off, k_off, causal=causal,
                                dtype=dtype)
    rec = {"case": name, "dtype": _dtype_name(dtype), "lane": plan["lane"],
           "shape": {"B": B, "Sq": Sq, "Sk": Sk, "hq": hq, "hkv": hkv, "d": d,
                     "q_offset": q_off, "k_offset": k_off, "causal": causal,
                     "normalize": normalize, "key_frontier":
                     plan["key_frontier"]},
        **compare(torch, "flash_attention", dtype, normalize, got, want,
                  want32)}
    out = got[0]
    # Visible keys of each query row, and the rows that see none.
    seen = [min(Sk, max(0, q_off + i + 1 - k_off)) if causal else Sk
            for i in range(Sq)]
    dead = [i for i, n in enumerate(seen) if n == 0]
    if dead:
        rows = torch.tensor(dead, device="cuda")
        if normalize:
            dead_ok = bool((out[:, rows] == 0).all().item())
        else:
            dead_ok = bool((got[1][:, rows] == -1e30).all().item()
                           and (got[2][:, rows] == 0).all().item()
                           and (out[:, rows] == 0).all().item())
        rec["dead_rows"] = len(dead)
        rec["dead_rows_ok"] = dead_ok
        rec["ok"] = rec["ok"] and dead_ok
    if time_it:
        item = q.element_size()
        flops = 4.0 * B * hq * d * sum(seen)
        nbytes = item * (B * Sq * hq * d + 2 * B * frontier * hkv * d) \
            + out.element_size() * B * Sq * hq * d
        if not normalize:
            nbytes += 2 * 4 * B * Sq * hq               # m and l
        rec["bound_ms"], rec["bound_by"] = _bound_ms(nbytes, flops,
                                                     _dtype_name(dtype))
        rec["ms"] = timer.ms(lambda: fa._flash_cuda(
            q, k, v, q_off, k_off, causal=causal, normalize=normalize))
        rec["tflops"] = flops / (rec["ms"] * 1e-3) / 1e12
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        rec["plain_ms"] = timer.ms(lambda: fa._flash_plain(
            q, k, v, q_off, k_off, causal=causal, normalize=normalize))
        if q_off == k_off and Sq == Sk and normalize:
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            sdpa = torch.nn.functional.scaled_dot_product_attention
            rec["library_ms"] = timer.ms(lambda: sdpa(
                qt, kt, vt, is_causal=causal, enable_gqa=True))
            rec["library_ratio"] = rec["ms"] / rec["library_ms"]
        else:
            rec["library_ms"] = None
    return rec


def paged_case(torch, pa, timer, *, name, dtype, lens, page, hq, hkv, d,
               normalize, time_it, seed, kv_dtype=None):
    """One K2 case: shuffled pages, stale random data everywhere in the
    pool, -1 in the table past each sequence's valid pages. ``kv_dtype``
    e4m3: the pools are the saturating cast of the random data, a few V
    values past +-448 included."""
    from triton_distributed_tpu_torch.models.fp8 import saturate_cast

    g = torch.Generator(device="cuda").manual_seed(seed)
    B = len(lens)
    max_pages = -(-max(max(lens), 1) // page)
    num_pages = B * max_pages + 1
    pool_dt = kv_dtype or dtype
    kp = torch.randn((num_pages, page, hkv, d), generator=g,
                     device="cuda")
    vp = torch.randn((num_pages, page, hkv, d), generator=g,
                     device="cuda")
    if kv_dtype is not None:
        vp[:, 0, 0, :4] = torch.tensor([900.0, -900.0, 464.0, -1000.0])
    kp, vp = saturate_cast(kp, pool_dt), saturate_cast(vp, pool_dt)
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
    rec = {"case": name, "dtype": _dtype_name(dtype),
           "pool_dtype": _dtype_name(pool_dt), "shape": {
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
        nbytes = (item * 2 * B * hq * d + kp.element_size() * 2 * n_tok * hkv
                  * d + 4 * (n_pages_read + B))
        flops = 4.0 * hq * d * n_tok
        rec["bound_ms"], rec["bound_by"] = _bound_ms(nbytes, flops,
                                                     _dtype_name(dtype))
        rec["ms"] = timer.ms(lambda: pa._paged_decode_cuda(
            q, cache, normalize=normalize))
        rec["plain_ms"] = timer.ms(lambda: pa._paged_decode_plain(
            q, cache, normalize=normalize))
        rec["library_ms"] = None      # no single PyTorch call computes it
    return rec


def k1_cases(torch, fa, timer) -> tuple:
    """K1 against its plain version: the Qwen3-8B shapes (32 / 8 heads, d
    128) and GQA group 8 (Qwen3-30B-A3B, 32 / 4), both lanes; the bf16
    lane's partials as the ring / SP-AG shards call them (causal=False),
    a key frontier off every key-tile edge, a ragged tile, d = 64, and a
    call whose frontier is <= 0 (every row dead)."""
    bf16, f32 = torch.bfloat16, torch.float32
    qwen = dict(hq=32, hkv=8, d=128)
    g8 = dict(hq=32, hkv=4, d=128)
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
        # An off-diagonal ring / SP-AG shard: every key visible, no mask.
        flash_case(torch, fa, timer, name="shard_512_at_k512_noncausal",
                   dtype=bf16, B=1, Sq=512, Sk=512, q_off=1024, k_off=512,
                   causal=False, normalize=False, time_it=True, seed=16,
                   **qwen),
        flash_case(torch, fa, timer, name="noncausal_ragged_200x333",
                   dtype=bf16, B=2, Sq=200, Sk=333, q_off=0, causal=False,
                   normalize=True, time_it=False, seed=17, **qwen),
        # Frontier 900: inside the 8th key tile, NaN past it.
        flash_case(torch, fa, timer, name="slice_200_at_700_frontier_900",
                   dtype=bf16, B=1, Sq=200, Sk=2048, q_off=700,
                   normalize=False, time_it=False, seed=18, **qwen),
        flash_case(torch, fa, timer, name="bf16_ragged_300", dtype=bf16, B=2,
                   Sq=300, Sk=300, q_off=0, normalize=True, time_it=False,
                   seed=19, **qwen),
        flash_case(torch, fa, timer, name="prefill_2x1024_d64", dtype=bf16,
                   B=2, Sq=1024, Sk=1024, q_off=0, normalize=True,
                   time_it=True, seed=20, hq=32, hkv=8, d=64),
        # Keys start after every query: the frontier is -448.
        flash_case(torch, fa, timer, name="frontier_le_0_dead", dtype=bf16,
                   B=1, Sq=64, Sk=256, q_off=0, k_off=512, normalize=False,
                   time_it=False, seed=21, **qwen),
        # A block whose first rows are dead and whose last are not.
        flash_case(torch, fa, timer, name="half_dead_k_offset_100",
                   dtype=bf16, B=1, Sq=300, Sk=300, q_off=0, k_off=100,
                   normalize=True, time_it=False, seed=22, **qwen),
    ]
    k1_g8 = [
        flash_case(torch, fa, timer, name="prefill_2x1024_g8", dtype=bf16,
                   B=2, Sq=1024, Sk=1024, q_off=0, normalize=True,
                   time_it=True, seed=9, **g8),
        flash_case(torch, fa, timer, name="slice_256_at_768_g8", dtype=bf16,
                   B=1, Sq=256, Sk=2048, q_off=768, normalize=False,
                   time_it=False, seed=10, **g8),
        flash_case(torch, fa, timer, name="fp32_ragged_300_g8", dtype=f32,
                   B=2, Sq=300, Sk=300, q_off=0, normalize=True,
                   time_it=False, seed=11, **g8),
    ]
    return k1, k1_g8


def phase_kernels(torch, fa, pa, timer) -> dict:
    bf16, f32 = torch.bfloat16, torch.float32
    qwen = dict(hq=32, hkv=8, d=128)
    k1, k1_g8 = k1_cases(torch, fa, timer)
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
        # SP decode's shard partial: pages of pick_tile(8192, 512, 8) = 512
        # rows, which the kernel walks in 128-token slices; a full shard,
        # a ragged one, an empty one and one a row short of a page.
        paged_case(torch, pa, timer, name="sp_shard_page512", dtype=bf16,
                   lens=[8192, 3001, 0, 511], page=512, normalize=False,
                   time_it=True, seed=15, **qwen),
    ]
    # K2's e4m3 lane: the main shape (the fp8 serving phase's decode batch
    # of 4, page 16), its partials, fp32 queries, and head_dim 64.
    e4m3 = torch.float8_e4m3fn
    k2_8 = [
        paged_case(torch, pa, timer, name="decode_4_e4m3", dtype=bf16,
                   lens=[0, 1, 17, 1999], page=16, normalize=True,
                   time_it=True, seed=4, kv_dtype=e4m3, **qwen),
        paged_case(torch, pa, timer, name="decode_4_e4m3_partial", dtype=bf16,
                   lens=[0, 1, 17, 1999], page=16, normalize=False,
                   time_it=False, seed=5, kv_dtype=e4m3, **qwen),
        paged_case(torch, pa, timer, name="decode_fp32_e4m3", dtype=f32,
                   lens=[5, 0, 64, 333], page=16, normalize=True,
                   time_it=False, seed=6, kv_dtype=e4m3, **qwen),
        paged_case(torch, pa, timer, name="d64_page4_e4m3", dtype=bf16,
                   lens=[3, 0, 9], page=4, normalize=False, time_it=False,
                   seed=7, kv_dtype=e4m3, hq=16, hkv=4, d=64),
    ]
    bf16_ms = next(c["ms"] for c in k2 if c["case"] == "decode_4")
    k2_8[0]["bf16_pools_ms"] = bf16_ms
    # GQA group 8 (Qwen3-30B-A3B: 32 q heads over 4 kv heads), the MoE
    # engine's prefill and decode shapes.
    g8 = dict(hq=32, hkv=4, d=128)
    k2_g8 = [
        paged_case(torch, pa, timer, name="decode_4_g8", dtype=bf16,
                   lens=[0, 1, 17, 1999], page=16, normalize=True,
                   time_it=True, seed=12, **g8),
        paged_case(torch, pa, timer, name="decode_4_g8_partial", dtype=bf16,
                   lens=[0, 1, 17, 1999], page=16, normalize=False,
                   time_it=False, seed=13, **g8),
        paged_case(torch, pa, timer, name="decode_fp32_g8", dtype=f32,
                   lens=[5, 0, 64, 333], page=16, normalize=True,
                   time_it=False, seed=14, **g8),
    ]
    return {"flash_attention": k1, "paged_attention": k2,
            "paged_attention_e4m3": k2_8, "flash_attention_g8": k1_g8,
            "paged_attention_g8": k2_g8}


def _mk_bound(cfg, lens, item: int, rows: int, kv_item: int | None = None):
    """Least time of one decode step: every weight read once, each valid
    KV position's k and v read once (``kv_item`` bytes each: the
    workspace type, or 1 for e4m3 pools), against the GEMM and attention
    flops of ``rows`` tokens — whichever is larger."""
    d, L = cfg.head_dim, cfg.num_layers
    h, f = cfg.hidden_size, cfg.intermediate_size
    per_layer = (h * (cfg.num_heads + 2 * cfg.num_kv_heads) * d
                 + cfg.num_heads * d * h + 3 * h * f)
    kv = 2 * sum(lens) * cfg.num_kv_heads * d
    nbytes = L * (item * per_layer + (kv_item or item) * kv)
    flops = L * (2.0 * rows * per_layer + 4.0 * cfg.num_heads * d * sum(lens))
    return nbytes, flops


def mk_pages(lens, window: int, max_pages: int):
    """Per-slot page counts covering each slot's append window (idle
    slots: none) and tables over a shuffled pool of that many pages."""
    import random

    need = [(n + window - 1) // 128 + 1 if n else 0 for n in lens]
    perm = list(range(sum(need)))
    random.Random(sum(lens)).shuffle(perm)
    tables, i = [], 0
    for k in need:
        tables.append(perm[i:i + k] + [-1] * (max_pages - k))
        i += k
    return need, tables


def mk_state(torch, mkserv, cfg, dtype, seed, *, lens=MK_LENS,
             kv_dtype=None, window=1):
    """A PagedMegakernelDecoder over ``cfg`` with seeded random weights,
    every pool tile filled with random KV (e4m3 through the saturating
    cast), and one slot per entry of ``lens`` on shuffled pages (each slot
    maps the pages its append window needs; ``window`` rows per busy slot,
    1 on the idle one). Returns (decoder, workspace, staged queue, wins)."""
    from triton_distributed_tpu_torch.models.dense import init_dense_llm
    from triton_distributed_tpu_torch.models.fp8 import saturate_cast

    cfg = dataclasses.replace(cfg, dtype=_dtype_name(dtype))
    params = init_dense_llm(
        cfg, generator=torch.Generator(device="cuda").manual_seed(seed))
    need, tables = mk_pages(lens, window, MK_MAX_PAGES)
    dec = mkserv.PagedMegakernelDecoder(
        cfg, params, num_slots=len(lens), num_pages=sum(need),
        max_pages=MK_MAX_PAGES, dtype=dtype, kv_dtype=kv_dtype,
        spec_window=window)
    ws = dec.start()
    pool = dec._split(ws)[1]
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    tiles = torch.tensor([t for h in dec.prog.layers for p in h.kT + h.v
                          for t in p.tiles()], device="cuda")
    pool[tiles] = saturate_cast(torch.randn((len(tiles), 128, 128),
                                            generator=g, device="cuda"),
                                pool.dtype)
    gh = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (len(lens), window), generator=gh)
    wins = [window if n else 1 for n in lens]
    queue = dec.stage(ws, toks.numpy(), lens, tables,
                      wins if window > 1 else None)
    return dec, ws, queue, wins


def _mk_clone(dec, ws):
    return (ws[0].clone(), ws[1].clone()) if dec.kv_fp8 else ws.clone()


def _errs(got, want, t):
    """(|got - want|, the error record of one comparison under tolerance
    ``t``: the largest errors where atol and where rtol rules, and the
    largest share of the tolerance one element used)."""
    diff = (got - want).abs()
    mag = want.abs()
    atol_rules = mag * t["rtol"] < t["atol"]
    return diff, {
        "max_abs_err": diff.max().item(),
        "max_abs_err_where_atol_rules": (
            diff[atol_rules].max().item() if atol_rules.any() else 0.0),
        "max_rel_err_where_rtol_rules": (
            (diff[~atol_rules] / mag[~atol_rules]).max().item()
            if (~atol_rules).any() else 0.0),
        "tol": t,
        "tol_share": (diff / (t["atol"] + t["rtol"] * mag)).max().item()}


def megakernel_case(torch, mk, mkserv, timer, *, name, dtype, cfg, seed,
                    time_it, kv_dtype=None, window=1, lens=MK_LENS):
    """One megakernel step against run_queue_plain on the same staged
    workspaces: every tile's live rows (rows 0..window-1 of each slot
    block) and every KV pool tile in full (e4m3 pools to one e4m3 step),
    elementwise under TOL; the errors also by the task type that wrote
    each tile."""
    dec, ws0, queue, wins = mk_state(torch, mkserv, cfg, dtype, seed,
                                     lens=lens, kv_dtype=kv_dtype,
                                     window=window)
    comp, kv8, W = dec.comp, dec.kv_fp8, dec.spec_w
    kw = dict(num_exec=comp.num_exec, mat_specs=comp.mat_specs,
              head_dim=comp.head_dim)
    ws_k = _mk_clone(dec, ws0)
    main_k, pool_k = dec._split(ws_k)
    launch = mk.cuda_launcher(queue, main_k, dec._wsm, live_rows=W,
                              sync_before=comp.sync_before,
                              wkv8=pool_k if kv8 else None, **kw)
    launch()
    ws_p = _mk_clone(dec, ws0)
    main_p, pool_p = dec._split(ws_p)
    mk.run_queue_plain(queue, main_p, dec._wsm,
                       wkv8=pool_p if kv8 else None, **kw)
    ws_32 = None
    if dtype != torch.float32:
        main0, pool0 = dec._split(ws0)
        ws_32 = (main0.float(), pool0.clone()) if kv8 else main0.float()
        m32, p32 = (ws_32 if kv8 else (ws_32, ws_32))
        mk.run_queue_plain(queue, m32, dec._wsm.float(),
                           wkv8=p32 if kv8 else None, **kw)
    torch.cuda.synchronize()
    pools = sorted(t for h in dec.prog.layers for pool in h.kT + h.v
                   for t in pool.tiles())
    pool_set = set() if kv8 else set(pools)
    rest = [t for t in range(comp.num_tiles) if t not in pool_set]
    pools_t = torch.tensor(pools, device="cuda")
    rest_t = torch.tensor(rest, device="cuda")

    def views(ws):
        main, pool = (ws if kv8 else (ws, ws))
        return (pool[pools_t].flatten().float(),
                main[rest_t, :W].flatten().float())

    (gp, ga), (wp, wa) = views(ws_k), views(ws_p)
    fp32 = dtype == torch.float32
    tol = TOL[("megakernel_e4m3_" if kv8 else "megakernel_")
              + ("fp32" if fp32 else "bf16")]

    da, act = _errs(ga, wa, tol)
    dp, pool_rec = _errs(gp, wp, tol)
    replay = mk_replay(torch, mk, dec, ws0, ws_k, queue,
                       TOL["fp32" if fp32 else "megakernel_attn_bf16"],
                       rows_live=W, split=dec._split)
    share = max(act["tol_share"], pool_rec["tol_share"],
                replay["attn_tol_share"])
    g0p, g0a = views(ws0)
    changed = ((g0p != wp).sum() + (g0a != wa).sum()).item()
    by_type = {}
    rows = comp.task_rows
    main_k0, main_p0 = dec._split(ws_k)[0], dec._split(ws_p)[0]
    for tid, writes in enumerate(comp.task_writes):
        ty = mk.TaskType(int(comp.queue[rows[tid], 0])).name
        tiles = [t for t in writes if t < comp.num_tiles]
        if not tiles:
            continue
        idx = torch.tensor(tiles, device="cuda")
        err = (main_k0[idx, :W].float() - main_p0[idx, :W].float()).abs().max()
        by_type[ty] = max(by_type.get(ty, 0.0), err.item())
    rec = {"case": name, "dtype": _dtype_name(dtype),
           "pool_dtype": "float8_e4m3fn" if kv8 else _dtype_name(dtype),
           "shape": {"layers": cfg.num_layers, "hidden": cfg.hidden_size,
                     "head_dim": cfg.head_dim, "kv_lens": lens, "wins": wins,
                     "page": 128, "tasks": comp.num_exec,
                     "barriers": int(comp.sync_before.sum())},
           "max_abs_err": max(act["max_abs_err"], pool_rec["max_abs_err"]),
           "activations": act, "pools": pool_rec,
           "pool_elements_differing": int((dp > 0).sum().item()),
           "replay": replay,
           "max_abs_err_by_writer": by_type, "tol_share": share,
           "elements": ga.numel() + gp.numel(),
           "elements_changed_by_step": changed}
    if ws_32 is not None:
        rp, ra = views(ws_32)
        rec["plain_err_vs_fp32"] = max((wa - ra).abs().max().item(),
                                       (wp - rp).abs().max().item())
        rec["kernel_err_vs_fp32"] = max((ga - ra).abs().max().item(),
                                        (gp - rp).abs().max().item())
    # A bf16 step over workspace-dtype pools with a window past one 4-row
    # group compares 2-32x the elements of the 4-row cases against a
    # tolerance set at 4 rows: its extreme one-unit flips, compounded
    # through the layers, reach past it (on an H100, 700 W, over two
    # seeds: shares 0.97-1.00 at 8 rows, 1.2-2.0 at 128). Its whole step
    # is reported, and held per task instead: the attention and append
    # replays above, and every GEMM_MAT / RMS_NORM whose tiles no later
    # task rewrites rerun by the plain version on the kernel's inputs.
    # The fp32 cases of the same windows hold the whole step.
    step_held = fp32 or kv8 or W <= MK_WINDOW
    rec["step_held"] = step_held
    if not step_held:
        rec["task_replay"] = task_replay(
            torch, mk, comp, main_k, dec._wsm, queue,
            TOL["megakernel_attn_bf16"], W)
    held_share = share if step_held else max(
        replay["attn_tol_share"], rec["task_replay"]["tol_share"])
    rec["ok"] = bool(torch.isfinite(ga).all().item()
                     and torch.isfinite(gp).all().item()
                     and held_share <= 1.0 and changed > 0
                     and replay["append_elements_differing"] == 0
                     and ("task_replay" not in rec
                          or rec["task_replay"]["tol_share"] <= 1.0))
    if time_it:
        nbytes, flops = _mk_bound(cfg, lens, main_k.element_size(),
                                  len(lens) * W, 1 if kv8 else None)
        rec["bound_ms"], rec["bound_by"] = _bound_ms(nbytes, flops,
                                                     _dtype_name(dtype))
        rec["ms"] = timer.ms(launch)
        rec["plain_ms"] = timer.ms(lambda: mk.run_queue_plain(
            queue, main_p, dec._wsm, wkv8=pool_p if kv8 else None, **kw),
            iters=2, warmup=1)
        rec["library_ms"] = None     # no single PyTorch call runs a step
        rec["grid_blocks"] = mk.grid_blocks(dtype)
    return rec


def task_replay(torch, mk, comp, main_k, wsm, queue, tol, rows_live) -> dict:
    """Every GEMM_MAT and RMS_NORM task of one step whose read and written
    tiles no later task rewrites, rerun one by one by the plain version
    on the workspace the kernel left (so on the kernel's own inputs); the
    live rows of its outputs against the kernel's, under ``tol``."""
    T = mk.TaskType
    rows = comp.task_rows
    order = sorted(range(len(rows)), key=lambda t: rows[t])
    later: set = set()
    picked = []
    for tid in reversed(order):
        t = int(queue[rows[tid], 0])
        tiles = {x for x in comp.task_reads[tid] + comp.task_writes[tid]
                 if x < comp.num_tiles}
        if t in (int(T.GEMM_MAT), int(T.RMS_NORM)) and not tiles & later:
            picked.append(tid)
        later |= {x for x in comp.task_writes[tid] if x < comp.num_tiles}
    ws_r = main_k.clone()
    outs = []
    for tid in picked:
        row = [int(v) for v in queue[rows[tid]]]
        if row[0] == int(T.GEMM_MAT):
            mk._p_gemm_mat(ws_r, wsm, row, comp.mat_specs)
        else:
            mk._p_rms_norm(ws_r, row)
        outs += [x for x in comp.task_writes[tid] if x < comp.num_tiles]
    idx = torch.tensor(sorted(set(outs)), device=main_k.device)
    _, rec = _errs(main_k[idx, :rows_live].float(),
                   ws_r[idx, :rows_live].float(), tol)
    return {"tasks": len(picked), "tiles": len(idx), **rec}


def mk_replay(torch, mk, dec, ws0, ws_k, queue, attn_tol, *, rows_live=1,
              split=lambda ws: (ws, ws)) -> dict:
    """The attention and append tasks of one step rerun one by one by the
    plain version on the inputs the kernel saw: its stored q and current
    k/v (final in ``ws_k``: nothing rewrites them after the task) and the
    step's starting pools or linear caches (``ws0``: appends only write
    positions the attention masks). Attention outputs are held to
    ``attn_tol``; the appends, replayed onto the starting pools from the
    kernel's k/v, must give the kernel's pools bit for bit, every other
    element untouched. ``split`` maps a workspace to (main, the one
    holding the KV): the paged decoder's ``_split``, or the identity pair
    of a linear decoder, whose caches live in the main workspace."""
    import numpy as np

    T = mk.TaskType
    comp, W = dec.comp, rows_live
    main_k, pool_k = split(ws_k)
    _, pool0 = split(ws0)
    q = np.ascontiguousarray(queue, np.int32)
    flat = q.reshape(-1)
    rows = q[:comp.num_exec].tolist()
    paged = {int(T.ATTN_DECODE_PAGED), int(T.ATTN_DECODE_PAGED_F8)}
    app = {int(T.APPEND_KV), int(T.APPEND_KV_F8)}
    main_r = main_k.clone()
    outs = []
    for row in rows:
        if row[0] in paged:
            mk._p_attn_paged(main_r, flat, row, pool0)
            outs.append(row[1])
        elif row[0] == int(T.ATTN_DECODE):
            mk._p_attn_linear(main_r, row, pool0)
            outs.append(row[1])
        elif row[0] == int(T.ATTN_DECODE_GQA):
            mk._p_attn_linear(main_r, row, pool0)
            outs += [row[1] + h for h in range(row[7] >> 24)]
    idx = torch.tensor(outs, device=main_k.device)
    got, want = main_k[idx, :W].float(), main_r[idx, :W].float()
    diff = (got - want).abs()
    share = (diff / (attn_tol["atol"] + attn_tol["rtol"] * want.abs())).max()
    pool_r = pool0.clone()
    n_app = 0
    for row in rows:
        if row[0] in app:
            mk._p_append_kv(main_k, row, pool_r)
            n_app += 1
    tiles = torch.tensor(sorted(t for h in dec.prog.layers
                                for pool in h.kT + h.v for t in pool.tiles()),
                         device=main_k.device)
    differ = (pool_r[tiles].view(torch.uint8)
              != pool_k[tiles].view(torch.uint8)).sum().item()
    return {"attn_tasks": len(outs), "attn_max_abs_err": diff.max().item(),
            "attn_tol": attn_tol, "attn_tol_share": share.item(),
            "append_tasks": n_app, "append_elements_differing": int(differ)}


# The linear decoder's cases: one step of MegakernelDecoder at each of these
# cache lengths (empty cache; one token; an append at a tile's last column;
# a long context whose last tile is partly valid), over a cache whose every
# position holds random data.
LIN_POSITIONS = [0, 1, 127, 1999]
LIN_MAX_SEQ = 2048


def linear_case(torch, mk, mkserv, timer, *, name, dtype, cfg, seed,
                fp8_weights=False, final_norm=False, time_it=False):
    """One linear decoder (``MegakernelDecoder``: matrix layout, or the
    e4m3 weight tiles of ``fp8_weights``) stepped once at each of
    LIN_POSITIONS by the CUDA kernel and by run_queue_plain from the same
    staged workspace: the live row (row 0) of every tile and every cache
    tile in full, elementwise under TOL, the errors also by the task type
    that wrote each tile; and the per-task replay of the attention and
    append tasks (appends bit for bit)."""
    from triton_distributed_tpu_torch.models.dense import init_dense_llm
    from triton_distributed_tpu_torch.models.kv_cache import KVCache

    cfg = dataclasses.replace(cfg, dtype=_dtype_name(dtype))
    params = init_dense_llm(
        cfg, generator=torch.Generator(device="cuda").manual_seed(seed))
    dec = mkserv.MegakernelDecoder(cfg, params, max_seq=LIN_MAX_SEQ,
                                   dtype=dtype, fp8_weights=fp8_weights,
                                   final_norm=final_norm)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    shape = (cfg.num_layers, 1, LIN_MAX_SEQ, cfg.num_kv_heads, cfg.head_dim)
    cache = KVCache(
        k=torch.randn(shape, generator=g, device="cuda").to(dtype),
        v=torch.randn(shape, generator=g, device="cuda").to(dtype), offset=0)
    ws0 = dec.start(cache)
    comp = dec.comp
    kw = dict(num_exec=comp.num_exec, mat_specs=comp.mat_specs,
              head_dim=comp.head_dim)
    caches = sorted(t for h in dec.prog.layers for c in h.kT + h.v
                    for t in c.tiles())
    cache_set = set(caches)
    caches_t = torch.tensor(caches, device="cuda")
    rest_t = torch.tensor([t for t in range(comp.num_tiles)
                           if t not in cache_set], device="cuda")

    def views(ws):
        return ws[caches_t].flatten().float(), ws[rest_t, 0].flatten().float()

    fp32 = dtype == torch.float32
    tol = TOL["megakernel_fp32" if fp32 else "megakernel_bf16"]
    attn_tol = TOL["fp32" if fp32 else "megakernel_attn_bf16"]
    per_pos, by_type, share, ok = [], {}, 0.0, True
    launch = None
    wsm, ws8 = dec.weights()
    for pos in LIN_POSITIONS:
        ws_s = ws0.clone()
        queue = dec.queue_at(pos)
        dec.put_inputs(ws_s, [17 + pos], pos)
        ws_k, ws_p = ws_s.clone(), ws_s.clone()
        launch = mk.cuda_launcher(queue, ws_k, wsm, ws8=ws8, live_rows=1,
                                  sync_before=comp.sync_before, **kw)
        launch()
        mk.run_queue_plain(queue, ws_p, wsm, ws8=ws8, **kw)
        torch.cuda.synchronize()
        (gc_, ga), (wc, wa) = views(ws_k), views(ws_p)
        _, act = _errs(ga, wa, tol)
        dc, cache_rec = _errs(gc_, wc, tol)
        replay = mk_replay(torch, mk, dec, ws_s, ws_k, queue, attn_tol)
        s0c, s0a = views(ws_s)
        changed = ((s0c != wc).sum() + (s0a != wa).sum()).item()
        for tid, writes in enumerate(comp.task_writes):
            ty = mk.TaskType(int(comp.queue[comp.task_rows[tid], 0])).name
            idx = torch.tensor([t for t in writes if t < comp.num_tiles],
                               device="cuda")
            err = (ws_k[idx, 0].float() - ws_p[idx, 0].float()).abs().max()
            by_type[ty] = max(by_type.get(ty, 0.0), err.item())
        pos_share = max(act["tol_share"], cache_rec["tol_share"],
                        replay["attn_tol_share"])
        pos_ok = bool(torch.isfinite(ga).all().item()
                      and torch.isfinite(gc_).all().item()
                      and pos_share <= 1.0 and changed > 0
                      and replay["append_elements_differing"] == 0)
        per_pos.append({"pos": pos, "activations": act, "caches": cache_rec,
                        "cache_elements_differing": int((dc > 0).sum().item()),
                        "replay": replay, "tol_share": pos_share,
                        "elements_changed_by_step": changed, "ok": pos_ok})
        share, ok = max(share, pos_share), ok and pos_ok
    rec = {"case": name, "dtype": _dtype_name(dtype),
           "weights": "float8_e4m3fn tiles" if fp8_weights
           else _dtype_name(dtype) + " matrix",
           "shape": {"layers": cfg.num_layers, "hidden": cfg.hidden_size,
                     "head_dim": cfg.head_dim, "max_seq": LIN_MAX_SEQ,
                     "positions": LIN_POSITIONS, "final_norm": final_norm,
                     "tasks": comp.num_exec,
                     "barriers": int(comp.sync_before.sum())},
           "max_abs_err": max(max(p["activations"]["max_abs_err"],
                                  p["caches"]["max_abs_err"])
                              for p in per_pos),
           "tol": tol, "tol_share": share, "positions": per_pos,
           "max_abs_err_by_writer": by_type, "ok": ok}
    if time_it:
        nbytes, flops = _mk_bound(cfg, [LIN_POSITIONS[-1]],
                                  1 if fp8_weights else ws0.element_size(), 1,
                                  ws0.element_size())
        rec["bound_ms"], rec["bound_by"] = _bound_ms(nbytes, flops,
                                                     _dtype_name(dtype))
        rec["ms"] = timer.ms(launch)
        rec["plain_ms"] = timer.ms(lambda: mk.run_queue_plain(
            queue, ws_p, wsm, ws8=ws8, **kw), iters=2, warmup=1)
        rec["library_ms"] = None     # no single PyTorch call runs a step
    return rec


def builder_ops_case(torch, mk, builder, *, name, dtype, live_rows, seed,
                     warm=False):
    """The task types no decoder program emits, plus the rest of the
    linear handlers at another row count: one hand-built program — COPY,
    ADD, SCALE, SILU_MUL over a 32-tile row; GEMM_WIDE from main-workspace
    weights as one full-width task (the super-strip flag) and as 3-wide
    strips, GEMM_WIDE_W8 from e4m3 tiles; ATTN_DECODE with and without
    the current token; NORM_ROPE into a second tile; ADD_NORM — run by the
    CUDA kernel on ``live_rows`` rows and by run_queue_plain, rows
    [0, live_rows) of every tile compared per writer task type. ``warm``:
    the full-width GEMM_WIDE and the GEMM_WIDE_W8 consume a PREFETCH /
    PREFETCH_W8 warm of their first weight tile, and the kernel's outputs
    must equal, bit for bit, the kernel's on the same program built
    without the warms."""
    rec, outputs = _builder_ops_run(torch, mk, builder, name=name,
                                    dtype=dtype, live_rows=live_rows,
                                    seed=seed, warm=warm)
    if warm:
        plain_rec, plain_out = _builder_ops_run(
            torch, mk, builder, name=name, dtype=dtype, live_rows=live_rows,
            seed=seed, warm=False)
        differ = {k: int((v.view(torch.uint8) != plain_out[k]
                          .view(torch.uint8)).sum().item())
                  for k, v in outputs.items()}
        rec["elements_differing_from_unwarmed"] = differ
        rec["ok"] = bool(rec["ok"] and plain_rec["ok"] and rec["warms"] == 2
                         and not any(differ.values()))
    return rec


def _builder_ops_run(torch, mk, builder, *, name, dtype, live_rows, seed,
                     warm):
    """builder_ops_case's program, run once: (record, the kernel's
    output of every task by name)."""
    TILE = head_dim = 128
    mb = builder.MegaKernelBuilder()
    hid, n = 32 * TILE, 8 * TILE
    a, b, nw = (mb.tensor(TILE, hid) for _ in range(3))
    w = mb.tensor(hid, n)
    w8 = mb.tensor(hid, n, fp8=True)
    q, kn, vn, hw, cos, sin = (mb.tensor(TILE, TILE) for _ in range(6))
    kT, v = mb.tensor(TILE, 3 * TILE), mb.tensor(3 * TILE, TILE)
    outs = {k: mb.tensor(TILE, hid) for k in
            ("copy", "add", "scale", "silu_mul", "x2", "xn")}
    outs.update({k: mb.tensor(TILE, n) for k in ("full", "strips", "w8")})
    outs.update({k: mb.tensor(TILE, TILE) for k in
                 ("attn", "attn_cache_only", "rope")})
    mb.copy(outs["copy"], a)
    mb.add(outs["add"], a, b)
    mb.scale(outs["scale"], a, 0.3337)
    mb.silu_mul(outs["silu_mul"], a, b)
    if warm:       # the warms' token tile comes after every tensor's
        mb.prefetch(w.tile(0, 0))
    mb.gemm(outs["full"], a, w, prefetch_first=warm)
    mb.gemm(outs["strips"], a, w, width=3)
    if warm:
        mb.prefetch(w8.tile(0, 0), fp8=True)
    mb.gemm(outs["w8"], a, w8, prefetch_first=warm)
    mb.attn_decode(outs["attn"], q, kT, v, valid_len=300,
                   scale=head_dim ** -0.5, k_new=kn, v_new=vn)
    mb.attn_decode(outs["attn_cache_only"], q, kT, v, valid_len=300,
                   scale=head_dim ** -0.5)
    mb.norm_rope(outs["rope"], q, hw, cos, sin)
    mb.add_norm(outs["x2"], a, b, nw, outs["xn"])
    comp = mb.compile(dtype=dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(h, scale=1.0):
        return torch.randn((h.rows, h.cols), generator=g, device="cuda") * scale

    feeds = {h: rnd(h) for h in (a, b, q, kn, vn, kT, v)}
    feeds.update({nw: rnd(nw, 0.1) + 1, hw: rnd(hw, 0.1) + 1, cos: rnd(cos),
                  sin: rnd(sin), w: rnd(w, 0.05), w8: rnd(w8, 0.05)})
    main, f8, _ = comp.split_feeds(feeds)
    ws0 = comp.make_workspace(main)
    ws8 = comp.make_workspace8(f8)
    kw = dict(num_exec=comp.num_exec, mat_specs=comp.mat_specs,
              head_dim=comp.head_dim)
    ws_k, ws_p = ws0.clone(), ws0.clone()
    launch = mk.cuda_launcher(comp.queue, ws_k, None, ws8=ws8,
                              live_rows=live_rows,
                              sync_before=comp.sync_before, **kw)
    launch()
    mk.run_queue_plain(comp.queue, ws_p, None, ws8=ws8, **kw)
    torch.cuda.synchronize()
    fp32 = dtype == torch.float32
    tol = TOL["megakernel_fp32" if fp32 else "megakernel_attn_bf16"]
    by_type, share, finite = {}, 0.0, True
    for tid, writes in enumerate(comp.task_writes):
        ty = mk.TaskType(int(comp.queue[comp.task_rows[tid], 0])).name
        idx = torch.tensor(list(writes), device="cuda")
        got = ws_k[idx, :live_rows].float()
        _, e = _errs(got, ws_p[idx, :live_rows].float(), tol)
        finite = finite and bool(torch.isfinite(got).all().item())
        by_type[ty] = max(by_type.get(ty, 0.0), e["max_abs_err"])
        share = max(share, e["tol_share"])
    untouched = bool((ws_k[:, live_rows:] == ws0[:, live_rows:]).all().item())
    rec = {"case": name, "dtype": _dtype_name(dtype),
           "shape": {"live_rows": live_rows, "k_tiles": 32, "n_tiles": 8,
                     "tasks": comp.num_exec,
                     "barriers": int(comp.sync_before.sum())},
           "max_abs_err": max(by_type.values()),
           "max_abs_err_by_writer": by_type, "tol": tol, "tol_share": share,
           "rows_past_live_untouched": untouched,
           "warms": sum(int(r[0]) in (int(mk.TaskType.PREFETCH),
                                      int(mk.TaskType.PREFETCH_W8))
                        for r in comp.queue[:comp.num_exec]),
           "ok": bool(finite and share <= 1.0 and untouched)}
    return rec, {k: comp.gather_output(ws_k, h) for k, h in outs.items()}


def phase_megakernel_cases(torch, mk, mkserv, builder, timer,
                           QWEN3_8B) -> dict:
    """The megakernel's cases by lane: ``megakernel`` (workspace-dtype
    pools, one row), ``megakernel_kv8`` (e4m3 pools: types 24/25),
    ``megakernel_window`` (the 4-row speculative window over both pool
    types), ``megakernel_rows`` (windows of 5, 8 and 128 rows, past the
    kernel's 4-row groups), ``megakernel_linear`` (the batch-1 linear
    decoder in the matrix layout, plus the hand-built program of the
    types no decoder emits, with and without PREFETCH / PREFETCH_W8
    warms) and ``megakernel_linear_w8`` (its fp8-weight tile layout)."""
    cfg = dataclasses.replace(QWEN3_8B, num_layers=2)
    bf16, f32, e4m3 = torch.bfloat16, torch.float32, torch.float8_e4m3fn

    def case(name, dtype, seed, **kw):
        return megakernel_case(torch, mk, mkserv, timer, name=name,
                               dtype=dtype, cfg=kw.pop("cfg", cfg),
                               seed=seed, time_it=kw.pop("time_it", False),
                               **kw)

    def lin(name, dtype, seed, **kw):
        return linear_case(torch, mk, mkserv, timer, name=name, dtype=dtype,
                           cfg=kw.pop("cfg", cfg), seed=seed, **kw)

    d64 = dataclasses.replace(cfg, hidden_size=1024, intermediate_size=3072,
                              num_heads=16, num_kv_heads=8, head_dim=64)
    win = dict(window=MK_WINDOW, lens=MK_WIN_LENS)
    cases = {
        "megakernel_linear": [
            lin("linear_2l_bf16", bf16, 30, time_it=True),
            lin("linear_2l_fp32", f32, 31, time_it=True),
            lin("linear_d64_fp32_final_norm", f32, 32, cfg=d64,
                final_norm=True),
            builder_ops_case(torch, mk, builder, name="ops_4rows_fp32",
                             dtype=f32, live_rows=4, seed=33),
            builder_ops_case(torch, mk, builder, name="ops_1row_bf16",
                             dtype=bf16, live_rows=1, seed=34),
            # PREFETCH / PREFETCH_W8 and live rows past one group.
            builder_ops_case(torch, mk, builder, name="ops_warm_8rows_bf16",
                             dtype=bf16, live_rows=8, seed=38, warm=True),
            builder_ops_case(torch, mk, builder,
                             name="ops_warm_128rows_fp32", dtype=f32,
                             live_rows=128, seed=39, warm=True),
        ],
        "megakernel_linear_w8": [
            lin("linear_w8_2l_bf16", bf16, 35, fp8_weights=True,
                time_it=True),
            lin("linear_w8_2l_fp32", f32, 36, fp8_weights=True),
            lin("linear_w8_d64_fp32", f32, 37, cfg=d64, fp8_weights=True),
        ],
        "megakernel": [
            case("step_2l_bf16", bf16, 20, time_it=True),
            case("step_2l_fp32", f32, 21),
            # The padded-head layout (head_dim 64 in 128-wide tiles), off
            # the Qwen3-8B path: the norm/rope sub-tile span of
            # NORM_ROPE_QKV.
            case("step_d64_fp32", f32, 22, cfg=d64),
        ],
        "megakernel_kv8": [
            case("step_2l_bf16_e4m3", bf16, 23, kv_dtype=e4m3, time_it=True),
            case("step_2l_fp32_e4m3", f32, 24, kv_dtype=e4m3),
        ],
        "megakernel_window": [
            case("window4_2l_bf16", bf16, 25, time_it=True, **win),
            case("window4_2l_fp32", f32, 26, **win),
            case("window4_2l_bf16_e4m3", bf16, 27, kv_dtype=e4m3, **win),
            case("window4_2l_fp32_e4m3", f32, 28, kv_dtype=e4m3, **win),
        ],
        # Windows of 5, 8 and 128 rows: the row groups of every handler.
        "megakernel_rows": [
            case(f"window{w}_2l_{dn}{'_e4m3' if kv else ''}", dt,
                 60 + 4 * i + j, window=w,
                 lens=MK_ROWS_LENS if w > 8 else MK_WIN_LENS,
                 kv_dtype=kv, time_it=(w, dt, kv) == (5, bf16, None))
            for i, w in enumerate(MK_ROWS_WINDOWS)
            for j, (dn, dt, kv) in enumerate((
                ("bf16", bf16, None), ("fp32", f32, None),
                ("bf16", bf16, e4m3), ("fp32", f32, e4m3)))],
    }
    torch.cuda.empty_cache()
    return cases


# ---------------------------------------------------------------------------
# The MoE decode program (Qwen3-30B-A3B): MOE_TOPK and MOE_FFN.
# ---------------------------------------------------------------------------

# Each MoE program is built at pos = MOE_MAX_SEQ - 1 and retargeted per
# position; batch 1 is the in-kernel-append form (as the linear decoder),
# batch 4 the host-fed form of the JAX package's MoE tests (the rows share
# the caches). The cases step it at these positions from caches whose every
# position holds data.
MOE_POSITIONS = [0, 1, 127, 1999]
MOE_MAX_SEQ = 2048


def moe_build(torch, mkmodels, cfg, *, batch: int, dtype):
    """The MoE decode program of every layer of ``cfg`` at ``batch`` rows,
    compiled for a ``dtype`` workspace: (program, compiled)."""
    prog = mkmodels.build_decode_step(
        hidden=cfg.hidden_size, hq_local=cfg.num_heads,
        hkv_local=cfg.num_kv_heads, ffn_local=cfg.moe_intermediate_size,
        num_layers=cfg.num_layers, max_seq=MOE_MAX_SEQ,
        pos=MOE_MAX_SEQ - 1, batch=batch, eps=cfg.rms_norm_eps,
        head_dim=cfg.head_dim, moe_experts=cfg.num_experts,
        moe_topk=cfg.num_experts_per_tok, inkernel_append=batch == 1,
        mat_prefetch=batch == 1)
    return prog, prog.mb.compile(dtype=dtype, head_dim=cfg.head_dim)


def moe_cache_tiles(prog) -> list:
    return sorted(t for h in prog.layers for c in h.kT + h.v
                  for t in c.tiles())


def moe_stage(torch, mkmodels, prog, comp, ws, cfg, x, pos: int):
    """Write one step's inputs — the rows ``x`` (B, hidden) and the rope
    tables at ``pos`` — and return the queue retargeted to ``pos``."""
    rows = torch.zeros((128, cfg.hidden_size), device=ws.device)
    rows[:x.shape[0]] = x.float()
    comp.scatter_input(ws, prog.x, rows)
    cos, sin = mkmodels.rope_tables(pos, cfg.head_dim, cfg.rope_theta)
    comp.scatter_input(ws, prog.cos, torch.from_numpy(cos))
    comp.scatter_input(ws, prog.sin, torch.from_numpy(sin))
    return mkmodels.advance_queue_pos(comp, pos)


def moe_active(mk, comp, queue, ws, batch: int) -> list:
    """Per layer (queue order), the experts a MOE_TOPK weight tile in
    ``ws`` gives weight to — those MOE_FFN streams."""
    out = []
    for row in queue[:comp.num_exec]:
        if row[0] == int(mk.TaskType.MOE_TOPK):
            wt = ws[int(row[1])][:int(row[6]), :batch].float()
            out.append(int((wt.sum(dim=1) > 0).sum().item()))
    return out


def _moe_bound(cfg, lens, batch: int, active: list, item: int):
    """Least time of one MoE step: each layer's attention weights, router
    and ACTIVE experts' weights read once, the valid KV once (``lens``: the
    positions each row attends), against the flops these rows need (each
    row's top-k experts only)."""
    d, h, f = cfg.head_dim, cfg.hidden_size, cfg.moe_intermediate_size
    attn = h * (cfg.num_heads + 2 * cfg.num_kv_heads) * d \
        + cfg.num_heads * d * h
    router = h * cfg.num_experts
    kv = 2 * max(lens) * cfg.num_kv_heads * d
    nbytes = sum(item * (attn + router + n * 3 * h * f + kv) for n in active)
    flops = len(active) * (2.0 * batch * (attn + router)
                           + 6.0 * h * f * batch * cfg.num_experts_per_tok
                           + 4.0 * cfg.num_heads * d * sum(lens))
    return nbytes, flops


def moe_replay(torch, mk, comp, ws_k, queue, tol, rows_live: int) -> dict:
    """The MoE tasks of one step rerun by the plain handlers on the inputs
    the kernel left: each MOE_TOPK on the kernel's logits tile (the same
    experts selected, every element; the weights within ``tol``), each
    MOE_FFN on the kernel's own weight tile and xn row (its output within
    ``tol``). A bf16 router selects from bf16 logits, so the whole step
    cannot hold the selection of the plain step; the replay holds each
    task."""
    T = mk.TaskType
    rows = queue[:comp.num_exec].tolist()
    ws_t, ws_f = ws_k.clone(), ws_k.clone()
    wts, outs, n_ffn = [], [], 0
    for row in rows:
        if row[0] == int(T.MOE_TOPK):
            mk._p_moe_topk(ws_t, row)
            wts.append(row[1])
        elif row[0] == int(T.MOE_FFN):
            mk._p_moe_ffn(ws_f, row)
            outs += [row[1] + j for j in range(row[4])]
            n_ffn += 1
    wt_idx = torch.tensor(wts, device=ws_k.device)
    sel_differ = ((ws_t[wt_idx] > 0) != (ws_k[wt_idx] > 0)).sum().item()
    _, wt_rec = _errs(ws_k[wt_idx].float(), ws_t[wt_idx].float(), tol)
    o_idx = torch.tensor(outs, device=ws_k.device)
    _, ffn_rec = _errs(ws_k[o_idx, :rows_live].float(),
                       ws_f[o_idx, :rows_live].float(), tol)
    return {"moe_topk_tasks": len(wts), "selection_elements_differing":
            int(sel_differ), "moe_topk": wt_rec,
            "moe_ffn_tasks": n_ffn, "moe_ffn": ffn_rec,
            "tol_share": max(wt_rec["tol_share"], ffn_rec["tol_share"])}


def moe_case(torch, mk, mkmodels, mkserv, timer, *, name, dtype, cfg, batch,
             seed, time_it=False) -> dict:
    """The MoE program of ``cfg`` (seeded random weights) at ``batch``
    rows, stepped at each of MOE_POSITIONS by the CUDA kernel and by
    run_queue_plain from the same staged workspace. fp32: the live rows of
    every tile and every cache tile under TOL. bf16: the per-task replays
    (attention and appends as ``mk_replay``; MOE_TOPK / MOE_FFN as
    ``moe_replay``), the whole-step error reported."""
    import types

    from triton_distributed_tpu_torch.models.dense import init_dense_llm

    cfg = dataclasses.replace(cfg, dtype=_dtype_name(dtype))
    params = init_dense_llm(
        cfg, generator=torch.Generator(device="cuda").manual_seed(seed))
    prog, comp = moe_build(torch, mkmodels, cfg, batch=batch, dtype=dtype)
    main, _, wm = comp.split_feeds(mkserv.weight_feeds(prog, cfg, params))
    ws0, wsm = comp.make_workspace(main), comp.make_workspace_mat(wm)
    caches = moe_cache_tiles(prog)
    caches_t = torch.tensor(caches, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    ws0[caches_t] = torch.randn((len(caches), 128, 128), generator=g,
                                device="cuda").to(dtype)
    cache_set = set(caches)
    rest_t = torch.tensor([t for t in range(comp.num_tiles)
                           if t not in cache_set], device="cuda")
    kw = dict(num_exec=comp.num_exec, mat_specs=comp.mat_specs,
              head_dim=comp.head_dim)
    fp32 = dtype == torch.float32
    tol = TOL["megakernel_fp32" if fp32 else "megakernel_bf16"]
    task_tol = TOL["fp32" if fp32 else "megakernel_attn_bf16"]
    dec = types.SimpleNamespace(comp=comp, prog=prog)

    def views(ws):
        return ws[caches_t].flatten().float(), \
            ws[rest_t, :batch].flatten().float()

    per_pos, share, ok, launch = [], 0.0, True, None
    for i, pos in enumerate(MOE_POSITIONS):
        ws_s = ws0.clone()
        toks = torch.randint(0, cfg.vocab_size, (batch,), generator=g,
                             device="cuda")
        queue = moe_stage(torch, mkmodels, prog, comp, ws_s, cfg,
                          params["embed"][toks], pos)
        ws_k, ws_p = ws_s.clone(), ws_s.clone()
        launch = mk.cuda_launcher(queue, ws_k, wsm, live_rows=batch,
                                  sync_before=comp.sync_before, **kw)
        launch()
        mk.run_queue_plain(queue, ws_p, wsm, **kw)
        torch.cuda.synchronize()
        (gc_, ga), (wc, wa) = views(ws_k), views(ws_p)
        _, act = _errs(ga, wa, tol)
        _, cache_rec = _errs(gc_, wc, tol)
        replay = mk_replay(torch, mk, dec, ws_s, ws_k, queue, task_tol,
                           rows_live=batch)
        mreplay = moe_replay(torch, mk, comp, ws_k, queue, task_tol, batch)
        s0c, s0a = views(ws_s)
        changed = ((s0c != wc).sum() + (s0a != wa).sum()).item()
        step_share = max(act["tol_share"], cache_rec["tol_share"])
        pos_share = max(replay["attn_tol_share"], mreplay["tol_share"],
                        step_share if fp32 else 0.0)
        pos_ok = bool(torch.isfinite(ga).all().item()
                      and torch.isfinite(gc_).all().item()
                      and pos_share <= 1.0 and changed > 0
                      and replay["append_elements_differing"] == 0
                      and mreplay["selection_elements_differing"] == 0)
        per_pos.append({"pos": pos, "activations": act, "caches": cache_rec,
                        "step_tol_share": step_share,
                        "step_held": fp32, "replay": replay,
                        "moe_replay": mreplay,
                        "active_experts": moe_active(mk, comp, queue, ws_k,
                                                     batch),
                        "tol_share": pos_share,
                        "elements_changed_by_step": changed, "ok": pos_ok})
        share, ok = max(share, pos_share), ok and pos_ok
        if i + 1 < len(MOE_POSITIONS):
            del ws_s, ws_k, ws_p
    rec = {"case": name, "dtype": _dtype_name(dtype),
           "shape": {"layers": cfg.num_layers, "hidden": cfg.hidden_size,
                     "experts": cfg.num_experts,
                     "topk": cfg.num_experts_per_tok,
                     "expert_ffn": cfg.moe_intermediate_size,
                     "heads": [cfg.num_heads, cfg.num_kv_heads],
                     "batch": batch, "max_seq": MOE_MAX_SEQ,
                     "positions": MOE_POSITIONS,
                     "form": ("in-kernel append" if batch == 1
                              else "host-fed caches"),
                     "tasks": comp.num_exec,
                     "barriers": int(comp.sync_before.sum())},
           "max_abs_err": max(max(p["moe_replay"]["moe_ffn"]["max_abs_err"],
                                  p["replay"]["attn_max_abs_err"],
                                  p["activations"]["max_abs_err"] if fp32
                                  else 0.0) for p in per_pos),
           "tol": tol, "task_tol": task_tol, "tol_share": share,
           "positions": per_pos, "ok": ok}
    if time_it:
        pos = MOE_POSITIONS[-1]
        active = per_pos[-1]["active_experts"]
        nbytes, flops = _moe_bound(cfg, [pos], batch, active,
                                   ws0.element_size())
        rec["bound_ms"], rec["bound_by"] = _bound_ms(nbytes, flops,
                                                     _dtype_name(dtype))
        rec["ms"] = timer.ms(launch)
        rec["plain_ms"] = timer.ms(lambda: mk.run_queue_plain(
            queue, ws_p, wsm, **kw), iters=2, warmup=1)
        rec["library_ms"] = None     # no single PyTorch call runs a step
    return rec


def moe_eager_case(torch, mk, mkmodels, mkserv, *, cfg, seed, batch=4,
                   pos=1999) -> dict:
    """fp32, one layer: the MoE program's output rows against the port's
    eager layer (rms_norm, attention over cache[:pos] plus each row's own
    k/v, o-proj, residual, rms_norm, ``ops/moe.moe_tp_fwd_local``,
    residual) on the same weights, caches and rows; the kernel's expert
    selection against the eager router's top-k."""
    from triton_distributed_tpu_torch.layers.common import (
        apply_rope, rms_norm, rope_cos_sin,
    )
    from triton_distributed_tpu_torch.models.dense import init_dense_llm
    from triton_distributed_tpu_torch.ops.moe import (
        moe_tp_fwd_local, route_and_sort,
    )

    cfg = dataclasses.replace(cfg, num_layers=1, dtype="float32")
    params = init_dense_llm(
        cfg, generator=torch.Generator(device="cuda").manual_seed(seed))
    prog, comp = moe_build(torch, mkmodels, cfg, batch=batch,
                           dtype=torch.float32)
    main, _, wm = comp.split_feeds(mkserv.weight_feeds(prog, cfg, params))
    ws, wsm = comp.make_workspace(main), comp.make_workspace_mat(wm)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    hkv, d, hq = cfg.num_kv_heads, cfg.head_dim, cfg.num_heads
    k_cache = torch.randn((MOE_MAX_SEQ, hkv, d), generator=g, device="cuda")
    v_cache = torch.randn((MOE_MAX_SEQ, hkv, d), generator=g, device="cuda")
    h = prog.layers[0]
    for kv in range(hkv):
        comp.scatter_input(ws, h.kT[kv], k_cache[:, kv].T)
        comp.scatter_input(ws, h.v[kv], v_cache[:, kv])
    toks = torch.randint(0, cfg.vocab_size, (batch,), generator=g,
                         device="cuda")
    x = params["embed"][toks]
    queue = moe_stage(torch, mkmodels, prog, comp, ws, cfg, x, pos)
    mk.cuda_launcher(queue, ws, wsm, live_rows=batch,
                     sync_before=comp.sync_before, num_exec=comp.num_exec,
                     mat_specs=comp.mat_specs, head_dim=comp.head_dim)()
    got = comp.gather_output(ws, prog.x_out)[:batch]

    lay, eps = params["layers"][0], cfg.rms_norm_eps
    a = lay["attn"]
    hn = rms_norm(x, lay["attn_norm"], eps)
    q = rms_norm((hn @ a["wq"]).reshape(batch, hq, d), a["q_norm"], eps)
    k = rms_norm((hn @ a["wk"]).reshape(batch, hkv, d), a["k_norm"], eps)
    v = (hn @ a["wv"]).reshape(batch, hkv, d)
    cos, sin = rope_cos_sin(torch.full((batch, 1), pos, device="cuda"), d,
                            cfg.rope_theta)
    q = apply_rope(q[:, None], cos, sin)[:, 0]
    k = apply_rope(k[:, None], cos, sin)[:, 0]
    outs = []
    for b in range(batch):
        keys = torch.cat([k_cache[:pos], k[b][None]])           # (pos+1, hkv, d)
        vals = torch.cat([v_cache[:pos], v[b][None]])
        kh = keys.repeat_interleave(hq // hkv, dim=1)           # (pos+1, hq, d)
        vh = vals.repeat_interleave(hq // hkv, dim=1)
        s = torch.einsum("hd,shd->hs", q[b], kh) * d ** -0.5
        outs.append(torch.einsum("hs,shd->hd", torch.softmax(s, -1), vh))
    x1 = x + torch.stack(outs).reshape(batch, hq * d) @ a["wo"]
    x1n = rms_norm(x1, lay["mlp_norm"], eps)
    m = lay["moe"]
    want = x1 + moe_tp_fwd_local(x1n, m["router"], m["w_gate"], m["w_up"],
                                 m["w_down"], cfg.num_experts_per_tok,
                                 num_ranks=1)
    _, _, gs, _, _ = route_and_sort(x1n, m["router"], cfg.num_experts_per_tok)
    eager_experts = sorted(torch.nonzero(gs).flatten().tolist())
    topk_row = next(r for r in queue[:comp.num_exec]
                    if r[0] == int(mk.TaskType.MOE_TOPK))
    wt = ws[int(topk_row[1])][:cfg.num_experts, :batch]
    kernel_experts = sorted(torch.nonzero(wt.sum(dim=1) > 0).flatten()
                            .tolist())
    torch.cuda.synchronize()
    tol = TOL["megakernel_fp32"]
    _, rec = _errs(got.float(), want.float(), tol)
    return {"case": "moe_1l_fp32_vs_eager_layer", "dtype": "float32",
            "shape": {"layers": 1, "batch": batch, "pos": pos,
                      "hidden": cfg.hidden_size, "experts": cfg.num_experts},
            **rec, "same_experts": kernel_experts == eager_experts,
            "active_experts": len(kernel_experts),
            "ok": bool(torch.isfinite(got).all().item()
                       and rec["tol_share"] <= 1.0
                       and kernel_experts == eager_experts)}


def phase_moe_cases(torch, mk, mkmodels, mkserv, timer, QWEN3_30B_A3B):
    """The MoE program at Qwen3-30B-A3B widths cut to 2 layers: bf16 and
    fp32, batch 1 (in-kernel appends) and 4, 8 and 32 (host-fed caches),
    each at MOE_POSITIONS; and the fp32 1-layer program against the eager
    layer."""
    cfg = dataclasses.replace(QWEN3_30B_A3B, num_layers=2)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = []
    for name, dtype, batch, seed, time_it in (
            ("moe_2l_bf16_b1", bf16, 1, 40, True),
            ("moe_2l_bf16_b4", bf16, 4, 41, True),
            ("moe_2l_fp32_b1", f32, 1, 42, False),
            ("moe_2l_fp32_b4", f32, 4, 43, False),
            # Batches past the 4 rows a MoE item holds sums for.
            ("moe_2l_bf16_b8", bf16, 8, 45, True),
            ("moe_2l_fp32_b8", f32, 8, 46, False),
            ("moe_2l_bf16_b32", bf16, 32, 47, False),
            ("moe_2l_fp32_b32", f32, 32, 48, False)):
        cases.append(moe_case(torch, mk, mkmodels, mkserv, timer, name=name,
                              dtype=dtype, cfg=cfg, batch=batch, seed=seed,
                              time_it=time_it))
        torch.cuda.empty_cache()
    cases.append(moe_eager_case(torch, mk, mkmodels, mkserv, cfg=cfg,
                                seed=44))
    torch.cuda.empty_cache()
    return {"megakernel_moe": cases}


def moe_fill(torch, comp, prog, cfg, seed):
    """The full-depth MoE workspaces with seeded random weights written
    straight into their tiles, layer by layer (no parameter tree beside
    them: the bf16 experts alone are ~58 GB): experts and router at the
    JAX initialiser's scales, norms 1, caches random. Returns (ws, wsm)."""
    dt = comp.dtype
    g = torch.Generator(device="cuda").manual_seed(seed)
    ws = torch.zeros((comp.num_tiles + comp._strip_pad, 128, 128), dtype=dt,
                     device="cuda")
    wsm = torch.zeros((comp.num_mrows, 1024), dtype=dt, device="cuda")
    h_, f_ = cfg.hidden_size, cfg.moe_intermediate_size

    def fill(t, scale):
        ws[t.base:t.base + t.rt * t.ct].normal_(generator=g).mul_(scale)

    for h in prog.layers:
        for t, scale in ((h.moe_w_gate, h_ ** -0.5), (h.moe_w_up, h_ ** -0.5),
                         (h.moe_w_down, f_ ** -0.5),
                         (h.moe_router, h_ ** -0.5)):
            fill(t, scale)
        for t in h.kT + h.v:
            fill(t, 1.0)
        for t in (h.attn_norm, h.mlp_norm, h.q_norm, h.k_norm):
            ws[t.base:t.base + t.rt * t.ct] = 1.0
        for m, k in ((h.wqkv, h_), (h.wo, cfg.num_heads * cfg.head_dim)):
            wsm[m.base:m.base + m.rows].normal_(generator=g).mul_(k ** -0.5)
    return ws, wsm


def moe_step_run(torch, mk, mkmodels, cfg, timer, *, batch, steps=8,
                 seed=50) -> dict:
    """The full-width MoE program at ``cfg``'s depth, bf16, ``batch``
    rows: ``steps`` launches at positions up to 1999 (fresh random rows
    each step, the in-kernel appends advancing the caches at batch 1) with
    the megakernel's count set to 0 just before and read just after; then
    the kernel alone at the last position, L2 flushed, against the byte
    bound of the experts it streamed; then MOE_TOPK and MOE_FFN alone as
    one-task programs on that step's layer-0 inputs."""
    bf16 = torch.bfloat16
    t0 = time.perf_counter()
    prog, comp = moe_build(torch, mkmodels, cfg, batch=batch, dtype=bf16)
    ws, wsm = moe_fill(torch, comp, prog, cfg, seed)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    kw = dict(num_exec=comp.num_exec, mat_specs=comp.mat_specs,
              head_dim=comp.head_dim)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    mega = mk.MEGA_KERNEL
    mega.launches, mega.plain_calls, mega.variant_launches = 0, 0, {}
    walls = []
    first = MOE_POSITIONS[-1] - steps + 1
    for pos in range(first, first + steps):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        x = torch.randn((batch, cfg.hidden_size), generator=g,
                        device="cuda") * 0.02
        queue = moe_stage(torch, mkmodels, prog, comp, ws, cfg, x, pos)
        launch = mk.cuda_launcher(queue, ws, wsm, live_rows=batch,
                                  sync_before=comp.sync_before, **kw)
        launch()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
    launches = mega.launches
    moe_launches = mega.variant_launches.get("moe", 0)
    check(launches == steps and moe_launches == steps
          and mega.plain_calls == 0,
          f"moe_step: {launches} launches ({moe_launches} of the MoE "
          f"program) for {steps} steps")
    out = ws[prog.x_out.base:prog.x_out.base + prog.x_out.ct, :batch]
    check(bool(torch.isfinite(out.float()).all()),
          "moe_step: non-finite output rows")
    active = moe_active(mk, comp, queue, ws, batch)
    pos = first + steps - 1
    nbytes, flops = _moe_bound(cfg, [pos], batch, active, 2)
    bound, bound_by = _bound_ms(nbytes, flops, "bfloat16")
    all_bytes, _ = _moe_bound(cfg, [pos], batch, [cfg.num_experts]
                              * cfg.num_layers, 2)
    ms = timer.ms(launch, iters=5)
    rec = {"batch": batch, "layers": cfg.num_layers,
           "form": "in-kernel append" if batch == 1 else "host-fed caches",
           "tasks": comp.num_exec, "barriers": int(comp.sync_before.sum()),
           "workspace_gb": (ws.numel() + wsm.numel()) * 2 / 1e9,
           "build_and_fill_s": build_s, "steps": steps,
           "launches": launches, "moe_launches": moe_launches,
           "step_ms_runs": [w * 1e3 for w in walls],
           "step_ms": _pct(walls[1:], 50) * 1e3, "kernel_pos": pos,
           "ms": ms, "bound_ms": bound, "bound_by": bound_by,
           "bound_bytes": nbytes, "all_experts_bytes": all_bytes,
           "active_experts_per_layer": active,
           "active_experts_mean": sum(active) / len(active),
           "grid_blocks": mk.grid_blocks(bf16, moe=True),
           "library_ms": None}     # no single PyTorch call runs a step
    rec["plain_ms"] = timer.ms(lambda: mk.run_queue_plain(
        queue, ws, wsm, **kw), iters=1, warmup=1)
    rec["tasks_alone"] = moe_tasks_alone(torch, mk, comp, prog, ws, queue,
                                         cfg, batch, timer)
    return rec


def moe_tasks_alone(torch, mk, comp, prog, ws, queue, cfg, batch, timer):
    """MOE_TOPK and MOE_FFN of layer 0 as one-task programs (the
    megakernel launched on a queue of that one row) on the tiles the step
    left: kernel time (L2 flushed), plain time, and the bound (MOE_FFN:
    the active experts' weights plus its rows; MOE_TOPK: two tiles)."""
    import numpy as np

    rows = [r for r in queue[:comp.num_exec].tolist()
            if r[0] in (int(mk.TaskType.MOE_TOPK), int(mk.TaskType.MOE_FFN))]
    out = {}
    h, f, E = cfg.hidden_size, cfg.moe_intermediate_size, cfg.num_experts
    for row in rows[:2]:
        q = np.asarray([row], np.int32)
        kw = dict(num_exec=1, mat_specs=(), head_dim=comp.head_dim)
        launch = mk.cuda_launcher(q, ws, None, live_rows=batch,
                                  sync_before=[0], **kw)
        name = mk.TaskType(row[0]).name
        if name == "MOE_TOPK":
            nbytes, flops = 2 * 128 * 128 * 2, 4.0 * 128 * batch * \
                cfg.num_experts_per_tok
            n_act = None
        else:
            wt = ws[row[3]][:E, :batch].float()
            n_act = int((wt.sum(dim=1) > 0).sum().item())
            nbytes = 2 * (n_act * 3 * h * f + 2 * batch * h + 128 * batch)
            flops = 6.0 * h * f * batch * cfg.num_experts_per_tok
        bound, bound_by = _bound_ms(nbytes, flops, "bfloat16")
        # The plain run rewrites the task's output from the same inputs
        # (MOE_TOPK: the same selection, the weights within a rounding).
        out[name] = {"ms": timer.ms(launch, iters=10),
                     "plain_ms": timer.ms(lambda: mk.run_queue_plain(
                         q, ws, None, **kw), iters=2, warmup=1),
                     "bound_ms": bound, "bound_by": bound_by,
                     "bound_bytes": nbytes, "active_experts": n_act,
                     "library_ms": None}
    return out


# ---------------------------------------------------------------------------
# Kernel B3 (ops/gemm.py): the tiled GEMM against its plain version.
# ---------------------------------------------------------------------------

# Tolerances of B3 against its plain version (the fp32 product of the same
# stored operands, then the same output cast), as |kernel - plain| <=
# atol + rtol * |plain| with atol in units of the output's spread
# s = sqrt(K) * rms(A) * rms(B). fp32 sums run in another order (the FMA
# lane sequentially over K; the tensor cores in their own order; the e4m3
# lane promotes each staged chunk's partial sum, the tensor core keeping
# about 14 bits, to fp32): the fp32 outputs differ by a small multiple of
# 2^-24 * sqrt(K) * s, and the e4m3 lane's by about 2^-14 * s. A rounded
# output may then flip one unit of its type: 2^-7 relative for bf16, 2^-3
# for e4m3 (plus 2^-9, its subnormal step). TF32 is off.
GEMM_TOL = {"fp32": dict(atol_s=2.0 ** -13, rtol=0.0),
            "bf16": dict(atol_s=2.0 ** -13, rtol=0.0),
            "mixed": dict(atol_s=2.0 ** -13, rtol=0.0),
            "e4m3": dict(atol_s=2.0 ** -10, rtol=0.0)}
GEMM_ROUND = {"bfloat16": dict(rtol=2.0 ** -7, atol=0.0),
              "float8_e4m3fn": dict(rtol=2.0 ** -3, atol=2.0 ** -9),
              "float32": dict(rtol=0.0, atol=0.0)}
# The Qwen3-8B decode step's B3 products (fp8_decode): (K, N) of wq/wo,
# wk/wv, w_gate/w_up and w_down, at M = 1.
QWEN3_8B_PRODUCTS = {"wq_wo": (4096, 4096), "wk_wv": (4096, 1024),
                     "gate_up": (4096, 12288), "down": (12288, 4096)}
MAIN_GEMM_CASE = "decode_m1_gate_up_e4m3"


def gemm_case(torch, gemm, timer, *, name, m, k, n, a_dt, b_dt, out_dt,
              seed, time_it=True, a_scale=1.0, tiles=None, route=None,
              repeat=False):
    """One B3 case: operands drawn on the card (e4m3 through the saturating
    cast), the kernel into a NaN-filled output against its plain version,
    the route it launched on (``variant_launches``) against the picker's
    and, when given, ``route``; with ``repeat`` a second call's bits
    against the first's. When timed its time, the plain version's, a
    one-call PyTorch yardstick where there is one (``torch.matmul`` for
    bf16 and fp32; ``torch._scaled_mm`` with unit scales for e4m3, its
    refusal of a shape recorded), and its bound."""
    from triton_distributed_tpu_torch.models.fp8 import saturate_cast

    e4m3 = torch.float8_e4m3fn
    g = torch.Generator(device="cuda").manual_seed(seed)
    b_scale = 1.0 if (a_dt == e4m3 and b_dt == e4m3) else k ** -0.5
    a = saturate_cast(torch.randn((m, k), generator=g, device="cuda")
                      * a_scale, a_dt)
    b = saturate_cast(torch.randn((k, n), generator=g, device="cuda")
                      * b_scale, b_dt)
    lane = gemm.gemm_lane(a_dt, b_dt)
    caps = tiles or (512, 1024, 512)
    tile = gemm.select_tile(lane, m, n, *caps,
                            aligned=gemm._aligned(a) and gemm._aligned(b))
    kw = dict(tile_m=caps[0], tile_n=caps[1], tile_k=caps[2],
              out_dtype=out_dt)
    got = torch.full((m, n), float("nan"), device="cuda").to(out_dt)
    before = dict(gemm.GEMM_KERNEL.variant_launches)
    gemm.pallas_matmul(a, b, **kw, out=got)
    took = [r for r in gemm.ROUTES
            if gemm.GEMM_KERNEL.variant_launches.get(r, 0)
            > before.get(r, 0)]
    want = gemm.matmul_plain(a, b, out_dt)
    torch.cuda.synchronize()
    spread = (k ** 0.5) * a.float().pow(2).mean().sqrt().item() \
        * b.float().pow(2).mean().sqrt().item()
    tol = GEMM_TOL[lane]
    rnd = GEMM_ROUND[_dtype_name(out_dt)]
    atol = tol["atol_s"] * spread + rnd["atol"]
    rtol = tol["rtol"] + rnd["rtol"]
    diff = (got.float() - want.float()).abs()
    mag = want.float().abs()
    share = (diff / (atol + rtol * mag)).max().item()
    route_ok = took == [tile.route] and route in (None, tile.route)
    rec = {"case": name, "lane": lane, "m": m, "k": k, "n": n,
           "a": _dtype_name(a_dt), "b": _dtype_name(b_dt),
           "out": _dtype_name(out_dt), "tile": list(tile.tiles),
           "route": tile.route, "routes_launched": took,
           "spread": spread, "max_abs_err": diff.max().item(),
           "max_err_over_spread": diff.max().item() / spread,
           "share_not_identical": (diff > 0).float().mean().item(),
           "nan_left": int(torch.isnan(got.float()).sum().item()),
           "saturated": (int((want.float().abs() == 448.0).sum().item())
                         if out_dt == e4m3 else 0),
           "tol": {"atol": atol, "rtol": rtol}, "tol_share": share,
           "ok": bool(torch.isfinite(got.float()).all().item()
                      and share <= 1.0 and route_ok)}
    if repeat:
        again = gemm.pallas_matmul(a, b, **kw)
        rec["bit_identical"] = bool(torch.equal(got.view(torch.uint8),
                                                again.view(torch.uint8)))
        rec["ok"] = rec["ok"] and rec["bit_identical"]
    if time_it:
        items = a.element_size(), b.element_size(), got.element_size()
        nbytes = m * k * items[0] + k * n * items[1] + m * n * items[2]
        peak = {"fp32": "float32", "bf16": "bfloat16", "mixed": "bfloat16",
                "e4m3": "float8_e4m3fn"}[lane]
        rec["bound_ms"], rec["bound_by"] = _bound_ms(nbytes, 2.0 * m * n * k,
                                                     peak)
        rec["ms"] = timer.ms(lambda: gemm.pallas_matmul(a, b, **kw))
        rec["plain_ms"] = timer.ms(lambda: gemm.matmul_plain(a, b, out_dt))
        rec["tflops"] = 2.0 * m * n * k / rec["ms"] / 1e9
        rec["library_ms"], rec["library"] = None, None
        if lane in ("bf16", "fp32") and a_dt == b_dt and out_dt == a_dt:
            rec["library"] = "torch.matmul"
            rec["library_ms"] = timer.ms(lambda: torch.matmul(a, b))
        elif lane == "e4m3" and out_dt != e4m3:
            bt = b.t().contiguous().t()            # column-major B
            one = torch.ones((), device="cuda")
            try:
                rec["library_ms"] = timer.ms(lambda: torch._scaled_mm(
                    a, bt, scale_a=one, scale_b=one, out_dtype=out_dt))
                rec["library"] = "torch._scaled_mm"
            except RuntimeError as e:        # the yardstick only
                rec["library_refused"] = str(e)[:200]
    return rec


def phase_gemm_cases(torch, gemm, timer) -> dict:
    """B3 in each lane: (a) the headline M=2048, K=N=5120; (b) the m=8
    decode shape; (c) the Qwen3-8B decode step's products at M=1 (e4m3,
    fp32 out, as ``fp8_dot`` runs them) and the Qwen3-30B-A3B expert
    products at 4 rows; (d) the wgmma route in bf16 and e4m3 into every
    output type on shapes off every tile edge (aligned), and an unaligned
    B on the mma.sync route; (e) the split-K route at 1, 4, 8 and 16 rows,
    K 4096 / 12288 and one no split divides, each called twice for
    identical bits; (f) every compiled tile and the reference's odd
    shapes. Each case checks the route it launched on."""
    bf16, f32, e4m3 = torch.bfloat16, torch.float32, torch.float8_e4m3fn
    cases = []

    def case(**kw):
        cases.append(gemm_case(torch, gemm, timer, **kw))

    head = dict(m=2048, k=5120, n=5120)
    case(name="headline_bf16", a_dt=bf16, b_dt=bf16, out_dt=bf16, seed=40,
         route="wgmma", **head)
    case(name="headline_e4m3", a_dt=e4m3, b_dt=e4m3, out_dt=e4m3, seed=41,
         a_scale=2.0, route="wgmma", **head)  # ~0.2% of products past 448
    case(name="headline_e4m3_bf16_out", a_dt=e4m3, b_dt=e4m3, out_dt=bf16,
         seed=42, route="wgmma", **head)
    case(name="headline_mixed", a_dt=bf16, b_dt=e4m3, out_dt=bf16, seed=43,
         route="mma", **head)
    case(name="headline_fp32", a_dt=f32, b_dt=f32, out_dt=f32, seed=44,
         route="fma", **head)
    case(name="m8_bf16", m=8, k=5120, n=5120, a_dt=bf16, b_dt=bf16,
         out_dt=bf16, seed=45, route="splitk", repeat=True)
    case(name="m8_e4m3", m=8, k=5120, n=5120, a_dt=e4m3, b_dt=e4m3,
         out_dt=f32, seed=46, route="splitk", repeat=True)
    for pname, (k, n) in QWEN3_8B_PRODUCTS.items():
        case(name=f"decode_m1_{pname}_e4m3", m=1, k=k, n=n, a_dt=e4m3,
             b_dt=e4m3, out_dt=f32, seed=47, route="splitk", repeat=True)
    for pname, (k, n) in (("gate_up", (2048, 768)), ("down", (768, 2048))):
        case(name=f"expert_m4_{pname}_e4m3", m=4, k=k, n=n, a_dt=e4m3,
             b_dt=e4m3, out_dt=f32, seed=48, route="splitk", repeat=True)
    # The wgmma route off every tile edge: 200 / 300 rows (one pair tile,
    # and two with the last CTA past M), K a k-step and a part, columns
    # not a tile's multiple; every output type, the headline in fp32 too.
    for out_dt in (bf16, f32):
        case(name=f"wgmma_bf16_200x1000x312_{_dtype_name(out_dt)}", m=200,
             k=1000, n=312, a_dt=bf16, b_dt=bf16, out_dt=out_dt, seed=52,
             route="wgmma", time_it=False)
    case(name="wgmma_bf16_300x1000x312_fp32", m=300, k=1000, n=312,
         a_dt=bf16, b_dt=bf16, out_dt=f32, seed=53, route="wgmma",
         time_it=False)
    case(name="wgmma_bf16_headline_fp32", a_dt=bf16, b_dt=bf16, out_dt=f32,
         seed=54, route="wgmma", time_it=False, **head)
    for out_dt in (e4m3, bf16, f32):
        case(name=f"wgmma_e4m3_200x1008x336_{_dtype_name(out_dt)}", m=200,
             k=1008, n=336, a_dt=e4m3, b_dt=e4m3, out_dt=out_dt, seed=55,
             route="wgmma", time_it=False)
    case(name="wgmma_e4m3_headline_fp32", a_dt=e4m3, b_dt=e4m3, out_dt=f32,
         seed=56, route="wgmma", time_it=False, **head)
    # An unaligned B (300 bf16 columns: 600 bytes a row) takes mma.sync.
    case(name="unaligned_bf16_256x1000x300", m=256, k=1000, n=300,
         a_dt=bf16, b_dt=bf16, out_dt=bf16, seed=57, route="mma",
         time_it=False)
    # Split-K: 1-16 rows, K 4096 / 12288 and 4000 (no split divides it),
    # N 1024-12288, every output type, twice each.
    for i, (m, k, n, dts) in enumerate([
            (1, 4096, 1024, (e4m3, f32)), (4, 12288, 4096, (e4m3, bf16)),
            (8, 4096, 12288, (e4m3, f32)), (16, 4000, 2048, (e4m3, e4m3)),
            (16, 12288, 1024, (e4m3, f32)), (1, 4096, 4096, (bf16, bf16)),
            (4, 4000, 12288, (bf16, f32)), (16, 12288, 1024, (bf16, bf16))]):
        case(name=f"splitk_{m}x{k}x{n}_{_dtype_name(dts[0])}_"
                  f"{_dtype_name(dts[1])}", m=m, k=k, n=n, a_dt=dts[0],
             b_dt=dts[0], out_dt=dts[1], seed=60 + i, route="splitk",
             repeat=True, time_it=False)
    # Every compiled tile at least once, on a shape that is ragged in all
    # three dimensions (aligned for the wgmma and split-K routes, at 16
    # rows for split-K).
    for lane, dts in (("bf16", (bf16, bf16, bf16)),
                      ("e4m3", (e4m3, e4m3, f32)), ("fp32", (f32, f32, f32))):
        for t in gemm.lane_tiles(lane):
            m, k, n = {"wgmma": (200, 1008, 336), "splitk": (16, 1008, 336)
                       }.get(t.route, (200, 1000, 300))
            case(name=f"tile_{lane}_{t.tile_m}x{t.tile_n}x{t.tile_k}",
                 m=m, k=k, n=n, a_dt=dts[0], b_dt=dts[1],
                 out_dt=dts[2], seed=49, time_it=False, tiles=t.tiles,
                 route=t.route)
    for i, (m, k, n) in enumerate([(20, 256, 384), (8, 136, 128),
                                   (24, 128, 136)]):
        for dts in ((f32, f32, f32), (bf16, bf16, bf16), (bf16, e4m3, f32),
                    (e4m3, e4m3, e4m3), (f32, e4m3, f32)):
            case(name=f"odd_{m}x{k}x{n}_{_dtype_name(dts[0])}"
                      f"x{_dtype_name(dts[1])}", m=m, k=k, n=n, a_dt=dts[0],
                 b_dt=dts[1], out_dt=dts[2], seed=50 + i, time_it=False)
    return {"gemm": cases}


def phase_gemm_tuned(torch, gemm, timer) -> dict:
    """``pallas_matmul_tuned`` at the headline bf16 shape, with the tuner's
    disk cache at a fresh file: the first call measures the top candidates
    (CUDA events, L2 warm), a second call and a cleared memory cache both
    hit the cache, and the tuned call's output holds against the plain
    version. The B3 launches of one tuned call on a hit are counted."""
    from triton_distributed_tpu_torch.runtime import autotuner
    from triton_distributed_tpu_torch.runtime.build import BUILD_DIR
    from triton_distributed_tpu_torch.runtime.perf_model import (
        rank_gemm_tiles,
    )

    m, k, n, bf16 = 2048, 5120, 5120, torch.bfloat16
    path = BUILD_DIR / f"autotune-{os.getpid()}.json"
    os.environ["TDTPU_AUTOTUNE_CACHE"] = str(path)
    os.environ.pop("TDTPU_AUTOTUNE", None)
    try:
        autotuner._memory_cache.clear()
        cands = rank_gemm_tiles(autotuner.gemm_tile_candidates(m, k, n, 2),
                                m, n, k, 2, top=4,
                                routes=gemm.tile_routes("bf16"))
        t0 = time.perf_counter()
        best = autotuner.tuned_matmul_tiles(m, k, n, bf16, device="cuda")
        tune_s = time.perf_counter() - t0
        report = autotuner.last_tune_report(m, k, n, bf16)
        check(best is not None and report is not None,
              "gemm_tuned: the first call did not measure")
        again = autotuner.tuned_matmul_tiles(m, k, n, bf16, device="cuda")
        check(again == best and autotuner.last_tune_report(m, k, n, bf16)
              is None, "gemm_tuned: the second call did not hit the cache")
        autotuner._memory_cache.clear()
        check(autotuner.tuned_matmul_tiles(m, k, n, bf16, device="cuda")
              == best and autotuner.last_tune_report(m, k, n, bf16) is None,
              "gemm_tuned: the disk cache was not read")
        g = torch.Generator(device="cuda").manual_seed(60)
        a = torch.randn((m, k), generator=g, device="cuda").to(bf16)
        b = (torch.randn((k, n), generator=g, device="cuda")
             * k ** -0.5).to(bf16)
        reset_counts([gemm.GEMM_KERNEL])
        out = gemm.pallas_matmul_tuned(a, b)
        launches = gemm.GEMM_KERNEL.launches
        routes = dict(gemm.GEMM_KERNEL.variant_launches)
        check(launches == 1, f"gemm_tuned: {launches} launches on a hit")
        check(routes.get("wgmma", 0) == 1,
              f"gemm_tuned: the tuned headline launched on {routes}, not "
              "the wgmma route")
        want = gemm.matmul_plain(a, b, bf16)
        err = (out.float() - want.float()).abs()
        spread = (k ** 0.5) * a.float().pow(2).mean().sqrt().item() \
            * b.float().pow(2).mean().sqrt().item()
        share = (err / (GEMM_TOL["bf16"]["atol_s"] * spread
                        + GEMM_ROUND["bfloat16"]["rtol"]
                        * want.float().abs())).max().item()
        check(share <= 1.0, f"gemm_tuned: tuned output off by {share}x tol")
        tm, tn, tk = best
        return {"phase": "gemm_tuned", "m": m, "k": k, "n": n,
                "dtype": "bfloat16", "candidates": [list(c) for c in cands],
                "timings_ms": [None if t is None else t * 1e3
                               for t in report.timings],
                "winner": list(best), "tune_s": tune_s,
                "cache_hits": 2, "launches_on_hit": launches,
                "routes_on_hit": routes,
                "tol_share": share,
                "winner_ms": timer.ms(lambda: gemm.pallas_matmul(
                    a, b, tile_m=tm, tile_n=tn, tile_k=tk)),
                "default_ms": timer.ms(lambda: gemm.pallas_matmul(a, b))}
    finally:
        os.environ.pop("TDTPU_AUTOTUNE_CACHE", None)
        path.unlink(missing_ok=True)


def phase_linear_engine(torch, kernels, gemm_k, Engine, params, cfg, *,
                        batch=2, prompt=1024, gen=64, reps=2) -> dict:
    """Full Qwen3-8B through ``Engine(cfg, params, max_seq=2048)`` with the
    reference's defaults (backend "auto", no page size): prefill by K1,
    then ``dense_decode_step`` over the linear cache (attention by plain
    ``_sdpa``, projections by ``torch.matmul``): K1 once per layer, K2 and
    B3 never, no plain version."""
    flash, paged = kernels[0], kernels[1]
    L = cfg.num_layers
    eng = Engine(cfg, params, max_seq=2048)
    check(eng.backend == "auto" and eng.page_size is None,
          "linear_engine: the defaults are not the reference's")
    g = torch.Generator(device="cuda").manual_seed(21)
    ids = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=g,
                        device="cuda", dtype=torch.int32)
    eng.serve(ids[:, :128], 4)                                  # warm-up
    serve_s, prefill_s, first = [], [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        reset_counts(list(kernels) + [gemm_k])
        t0 = time.perf_counter()
        out = eng.serve(ids, gen)
        torch.cuda.synchronize()
        serve_s.append(time.perf_counter() - t0)
        launches = {"flash_attention": flash.launches,
                    "paged_attention": paged.launches,
                    "gemm": gemm_k.launches}
        check(flash.launches == L and paged.launches == 0
              and gemm_k.launches == 0,
              f"linear_engine: launch counts {launches}")
        check(all(k.plain_calls == 0 for k in list(kernels) + [gemm_k]),
              "linear_engine: a plain version ran on the main path")
        check(tuple(out.shape) == (batch, gen)
              and bool(((out >= 0) & (out < cfg.vocab_size)).all()),
              "linear_engine: bad output")
        check(first is None or torch.equal(out, first),
              "linear_engine: a repeated serve gave other tokens")
        first = out
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.prefill(ids)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
    total, pre = min(serve_s), min(prefill_s)
    return {"phase": "linear_engine", "batch": batch, "prompt": prompt,
            "gen": gen, "layers": L, "serve_s_runs": serve_s,
            "prefill_ms_runs": [t * 1e3 for t in prefill_s],
            "prefill_ms": pre * 1e3,
            "decode_ms_per_step": (total - pre) * 1e3 / (gen - 1),
            "tokens_per_s": batch * gen / total, "launches": launches}


def phase_linear_engine_parity(torch, QWEN3_8B, init_dense_llm, Engine,
                               kernels) -> dict:
    """float32, Qwen3-8B widths cut to 2 layers: the default engine's
    tokens (linear cache) identical to the paged eager serve's and to
    ``Engine(backend="megakernel").serve``'s (the linear megakernel
    decoder, batch 1)."""
    cfg = dataclasses.replace(QWEN3_8B, num_layers=2, dtype="float32")
    params = init_dense_llm(
        cfg, generator=torch.Generator(device="cuda").manual_seed(3))
    engines = {"linear": Engine(cfg, params, max_seq=256),
               "paged": Engine(cfg, params, max_seq=256, page_size=16),
               "megakernel": Engine(cfg, params, max_seq=256,
                                    backend="megakernel")}
    g = torch.Generator().manual_seed(23)
    runs = []
    for n, gen in ((37, 24), (150, 40), (128, 16)):
        prompt = [torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist()]
        toks = {k: e.serve(prompt, gen)[0].tolist()
                for k, e in engines.items()}
        for other in ("paged", "megakernel"):
            if toks[other] != toks["linear"]:
                step, gap = _first_divergence(torch, engines["linear"],
                                              prompt[0], toks[other],
                                              toks["linear"])
                emit({"phase": "linear_engine_parity", "prompt": n,
                      "against": other, "diverged_at_step": step,
                      "top2_logit_gap": gap})
                raise RuntimeError("chip_smoke: the default engine diverged "
                                   f"from the {other} serve at step {step}")
        runs.append({"prompt": n, "gen": gen, "identical": True})
    return {"phase": "linear_engine_parity", "layers": 2,
            "dtype": "float32", "runs": runs}


# The names of B3's kernels (csrc/gemm.cu), as the profiler reports them
# after the namespace: every route's, the e4m3 wgmma route's pre-pass too.
B3_KERNELS = ("gemm_tc_kernel<", "gemm_fma_kernel<", "gemm_wgmma<",
              "gemm_splitk<", "transpose_b8(")


def _busy_share(torch, fn, steps: int, names: dict | None = None) -> dict:
    """Kernel time over wall time of ``steps`` calls of ``fn`` under
    ``torch.profiler`` (profiler overhead included), by kernel group:
    ``names`` maps a group to a substring of its kernels' names (the rest
    are "other"); by default B3 and the other matmuls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups: dict = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = (getattr(e, "self_device_time_total", None)
              or getattr(e, "self_cuda_time_total", 0))
        if names is not None:
            grp = next((g for g, sub in names.items() if sub in e.key),
                       "other")
        else:
            grp = "gemm_b3" if any(f"::{k}" in e.key for k in B3_KERNELS
                                   ) else (
                "other_matmul" if any(w in e.key.lower() for w in (
                    "gemm", "gemv", "cutlass", "nvjet", "xmma")) else "other")
        groups[grp] = groups.get(grp, 0.0) + us / 1e3 / steps
    if not groups:
        return {"measured": False,
                "reason": "profiler recorded no device time"}
    return {"measured": True, "steps": steps, "wall_ms_per_step":
            wall_ms / steps, "device_ms_per_step": groups,
            "busy_share": sum(groups.values()) * steps / wall_ms}


def phase_fp8_decode(torch, kernels, gemm_k, Engine, params, cfg, *,
                     prompt=1024, gen=64) -> dict:
    """Full Qwen3-8B with ``quantize_dense_weights``: a 1024-token prefill
    on the bf16 weights into the linear cache, then ``gen``
    ``dense_decode_step(dot_fn=fp8_dot)`` steps — B3's e4m3 lane for every
    projection, 7 per layer, 252 per step. Reports the step time against
    the byte bound of its B3 products and of the whole step, the launch
    count, and the device busy share from a short profile."""
    from triton_distributed_tpu_torch.models.dense import dense_decode_step
    from triton_distributed_tpu_torch.models.fp8 import (
        fp8_dot, quantize_dense_weights,
    )

    L = cfg.num_layers
    p8 = quantize_dense_weights(params)
    eng = Engine(cfg, params, max_seq=2048)
    g = torch.Generator(device="cuda").manual_seed(27)
    ids = torch.randint(0, cfg.vocab_size, (1, prompt), generator=g,
                        device="cuda", dtype=torch.int32)
    logits, cache = eng.prefill(ids)
    tok = logits.argmax(-1).to(torch.int32)
    for _ in range(2):                                      # warm-up
        lg, _ = dense_decode_step(p8, cfg, tok, cache, dot_fn=fp8_dot)
    torch.cuda.synchronize()
    reset_counts(list(kernels) + [gemm_k])
    toks, walls = [int(tok[0])], []
    t_run = time.perf_counter()
    for _ in range(gen):
        t0 = time.perf_counter()
        lg, cache = dense_decode_step(p8, cfg, tok, cache, dot_fn=fp8_dot)
        tok = lg.argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        toks.append(int(tok[0]))
    run_s = time.perf_counter() - t_run
    launches = gemm_k.launches
    check(launches == 7 * L * gen
          and gemm_k.variant_launches.get("e4m3", 0) == launches
          and gemm_k.variant_launches.get("splitk", 0) == launches
          and gemm_k.plain_calls == 0,
          f"fp8_decode: {launches} B3 launches for {gen} steps of {L} "
          f"layers (expected {7 * L * gen}, all e4m3 on split-K): "
          f"{gemm_k.variant_launches}")
    check(bool(torch.isfinite(lg.float()).all()) and all(
        0 <= t < cfg.vocab_size for t in toks), "fp8_decode: bad output")
    w8 = sum(t.numel() for layer in p8["layers"] for part in layer.values()
             if isinstance(part, dict) for t in part.values()
             if t.dtype == torch.float8_e4m3fn)
    head = params.get("lm_head", params["embed"])
    kv_bytes = 2 * L * (prompt + gen) * cfg.num_kv_heads * cfg.head_dim * 2
    b3_bound = w8 / HBM_BYTES_PER_S * 1e3
    step_bound = (w8 + head.numel() * head.element_size() + kv_bytes) \
        / HBM_BYTES_PER_S * 1e3
    prof = _busy_share(torch, lambda: dense_decode_step(
        p8, cfg, tok, cache._replace(offset=prompt), dot_fn=fp8_dot), 4)
    step_ms = _pct(walls[1:], 50) * 1e3
    del p8
    return {"phase": "fp8_decode", "layers": L, "prompt": prompt,
            "steps": gen, "launches": {"gemm": launches,
                                       "gemm_per_step": launches // gen,
                                       "gemm_routes":
                                           dict(gemm_k.variant_launches)},
            "decode_ms_per_step": step_ms, "run_s": run_s,
            "decode_tokens_per_s": gen / run_s,
            "e4m3_weight_bytes": w8, "b3_bound_ms": b3_bound,
            "step_bound_ms": step_bound, "step_over_bound": step_ms
            / step_bound, "profile": prof, "tokens_head": toks[:8]}


def phase_fp8_parity(torch, QWEN3_8B, init_dense_llm, Engine, gemm_k
                     ) -> dict:
    """float32 activations, Qwen3-8B widths cut to 2 layers, quantized
    weights: the tokens of ``dense_decode_step(dot_fn=fp8_dot)`` (B3's
    e4m3 lane, fp32 out) identical to ``fp8_emulated_dot``'s (both
    operands rounded to e4m3, an fp32 torch matmul), with B3 launched
    7 x 2 times a step."""
    from triton_distributed_tpu_torch.models.dense import dense_decode_step
    from triton_distributed_tpu_torch.models.fp8 import (
        fp8_dot, fp8_emulated_dot, quantize_dense_weights,
    )

    cfg = dataclasses.replace(QWEN3_8B, num_layers=2, dtype="float32")
    params = init_dense_llm(
        cfg, generator=torch.Generator(device="cuda").manual_seed(4))
    p8 = quantize_dense_weights(params)
    eng = Engine(cfg, params, max_seq=256)
    g = torch.Generator().manual_seed(29)
    runs = []
    for n, gen in ((37, 24), (128, 24)):
        ids = torch.randint(0, cfg.vocab_size, (1, n), generator=g)
        toks, gaps = {}, {}
        for name, dot in (("fp8_dot", fp8_dot),
                          ("emulated", fp8_emulated_dot)):
            logits, cache = eng.prefill(ids)
            tok = logits.argmax(-1).to(torch.int32)
            out, gap = [], []
            gemm_k.launches = 0
            for _ in range(gen):
                lg, cache = dense_decode_step(p8, cfg, tok, cache,
                                              dot_fn=dot)
                top = torch.topk(lg[0], 2).values
                gap.append(float(top[0] - top[1]))
                tok = lg.argmax(-1).to(torch.int32)
                out.append(int(tok[0]))
            if name == "fp8_dot":
                check(gemm_k.launches == 14 * gen,
                      f"fp8 parity: {gemm_k.launches} B3 launches")
            toks[name], gaps[name] = out, gap
        if toks["fp8_dot"] != toks["emulated"]:
            step = next(i for i, (a, b) in enumerate(
                zip(toks["fp8_dot"], toks["emulated"])) if a != b)
            emit({"phase": "fp8_parity", "prompt": n,
                  "diverged_at_step": step,
                  "top2_logit_gap": gaps["emulated"][step]})
            raise RuntimeError("chip_smoke: fp8 parity: fp8_dot diverged "
                               f"from fp8_emulated_dot at step {step}")
        runs.append({"prompt": n, "gen": gen, "identical": True,
                     "min_top2_gap": min(gaps["emulated"])})
    return {"phase": "fp8_parity", "layers": 2, "dtype": "float32",
            "runs": runs}


def phase_fp8_experts(torch, gemm, moe, QWEN3_30B_A3B, init_dense_llm,
                      *, batch=4) -> dict:
    """Qwen3-30B-A3B widths cut to 2 layers, e4m3 expert stacks: layer 0's
    ``moe_tp_fwd_local`` at a batch of 4 rows through B3 (one e4m3 launch
    per non-empty expert group and projection) against the same call with
    each product taken by B3's plain version; then one
    ``dense_decode_step(dot_fn=fp8_dot)`` of the quantized model, counted."""
    from triton_distributed_tpu_torch.models.dense import dense_decode_step
    from triton_distributed_tpu_torch.models.fp8 import (
        fp8_dot, quantize_dense_weights,
    )
    from triton_distributed_tpu_torch.models.kv_cache import init_kv_cache

    cfg = dataclasses.replace(QWEN3_30B_A3B, num_layers=2)
    params = quantize_dense_weights(init_dense_llm(
        cfg, generator=torch.Generator(device="cuda").manual_seed(5)))
    p = params["layers"][0]["moe"]
    g = torch.Generator(device="cuda").manual_seed(31)
    x = torch.randn((batch, cfg.hidden_size), generator=g,
                    device="cuda").to(torch.bfloat16)
    args = (x, p["router"], p["w_gate"], p["w_up"], p["w_down"],
            cfg.num_experts_per_tok)
    reset_counts([gemm.GEMM_KERNEL])
    got = moe.moe_tp_fwd_local(*args, num_ranks=1)
    launches = gemm.GEMM_KERNEL.launches
    routes = dict(gemm.GEMM_KERNEL.variant_launches)
    kernel_matmul = moe.pallas_matmul
    moe.pallas_matmul = (lambda a, b, out_dtype:
                         gemm.matmul_plain(a, b, out_dtype))
    try:
        want = moe.moe_tp_fwd_local(*args, num_ranks=1)
    finally:
        moe.pallas_matmul = kernel_matmul
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    # The gate/up products round to bf16 and the SwiGLU output is quantized
    # to e4m3 again for the down product: a one-unit bf16 flip next to an
    # e4m3 rounding boundary moves that activation one e4m3 step (2^-3),
    # about 2^-3 / sqrt(768 * 8) of the output's spread per flip. atol is
    # 2^-5 of the output's rms, rtol two bf16 units.
    rms = want.float().pow(2).mean().sqrt().item()
    tol = {"atol": 2.0 ** -5 * rms, "rtol": 2.0 ** -6}
    share = (diff / (tol["atol"] + tol["rtol"] * want.float().abs())
             ).max().item()
    check(share <= 1.0 and bool(torch.isfinite(got.float()).all()),
          f"fp8 experts: B3 off its plain version by {share}x tolerance")
    check(launches > 0 and launches % 3 == 0
          and routes.get("splitk", 0) == launches,
          f"fp8 experts: {launches} B3 launches for the MoE layer, by "
          f"route {routes} (all split-K at {batch} rows)")
    cache = init_kv_cache(cfg, batch, 64)._replace(offset=8)
    gemm.GEMM_KERNEL.launches = 0
    lg, _ = dense_decode_step(params, cfg, torch.zeros(
        (batch,), dtype=torch.int32, device="cuda"), cache, dot_fn=fp8_dot)
    step_launches = gemm.GEMM_KERNEL.launches
    check(step_launches > 4 * cfg.num_layers
          and bool(torch.isfinite(lg.float()).all()),
          f"fp8 experts: the MoE decode step launched B3 {step_launches}x")
    return {"phase": "fp8_experts", "layers": 2, "batch": batch,
            "moe_layer_launches": launches, "moe_layer_routes": routes,
            "max_abs_err":
            diff.max().item(), "out_rms": rms, "tol": tol,
            "tol_share": share,
            "decode_step_launches": step_launches}


# ---------------------------------------------------------------------------
# Phases 3-5: the main path.
# ---------------------------------------------------------------------------

def reset_counts(kernels) -> None:
    for k in kernels:
        k.launches = 0
        k.plain_calls = 0
        k.variant_launches = {}


def random_prompts(torch, vocab: int, lengths, seed: int) -> list:
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(0, vocab, (n,), generator=g).tolist()
            for n in lengths]


def phrase_prompts(torch, vocab: int, lengths, seed: int) -> list:
    """Prompts that repeat a random 7-token phrase — the traffic n-gram
    drafting feeds on (each its own phrase)."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for n in lengths:
        phrase = torch.randint(0, vocab, (7,), generator=g).tolist()
        out.append((phrase * (n // 7 + 1))[:n])
    return out


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


def decode_window(torch, se, target, name: str, steps: int = 8,
                  prompts=None) -> dict:
    """Decode-only steps of 4 running slots (prompts 100-1500 tokens,
    prefilled first), outside the counted run: each step's wall time
    (host sync included, the GPU idle at its start) and the host time of
    the lane's call that enqueues the step (``Engine.decode``,
    ``dense_verify_step_paged`` or ``PagedMegakernelDecoder.step``); equal
    numbers mean the device waits on the host. Then ``torch.profiler``
    over 4 more steps for the device's busy share. ``target.name`` is the
    lane's call, wrapped for the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    inner = getattr(target, name)
    own = name in vars(target)
    enqueue: list = []

    def timed(*a, **k):
        t0 = time.perf_counter()
        out = inner(*a, **k)
        enqueue.append(time.perf_counter() - t0)
        return out

    setattr(target, name, timed)
    if prompts is None:
        prompts = random_prompts(torch, se.cfg.vocab_size,
                                 (100, 1500, 640, 333), 14)
    for p in prompts:
        se.submit(p, steps + 32)
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
    calls = len(enqueue)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(4):
            se.step()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    if own:
        setattr(target, name, inner)
    else:
        delattr(target, name)
    busy = sum((getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0))
               for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA)
    med = sorted(walls)[len(walls) // 2]
    enq = sorted(enqueue[:calls])
    return {"slots": 4, "steps": steps, "step_ms_runs": [w * 1e3 for w in walls],
            "step_ms": med * 1e3,
            "enqueue_ms": enq[len(enq) // 2] * 1e3 if enq else "not measured",
            "enqueue_calls": calls,
            "profiled_busy_share": (busy / 1e6 / prof_wall if busy
                                    else "not measured")}


def _pct(values, p):
    v = sorted(values)
    return v[min(len(v) - 1, int(round(p / 100 * (len(v) - 1))))]


def run_serving(torch, se, kernels, prompts, gen, *, lane: str,
                variants: dict) -> dict:
    """Drive ``se`` over ``prompts`` (``gen`` new tokens each) with every
    count set to 0 just before and read just after; fail unless every
    request finished, K1 ran once per layer and prefill slice, each
    decode step was L K2 launches (``lane="eager"``) or one megakernel
    launch (``"megakernel"``), each named lane of ``variants`` (kernel
    name → variant) ran on every decode step, and no plain version ran.
    Returns the run's record."""
    from triton_distributed_tpu_torch.serving import RequestState

    flash, paged, mega = kernels
    L = se.cfg.num_layers
    torch.cuda.synchronize()
    reset_counts(kernels)
    reqs, steps, slices, wall = _drive(se, prompts, [gen] * len(prompts))
    torch.cuda.synchronize()
    check(all(r.state is RequestState.FINISHED and len(r.tokens) == gen
              for r in reqs), f"{lane}: not every request finished")
    check(flash.launches == L * slices,
          f"{lane}: K1 launched {flash.launches}, expected {L * slices}")
    if lane == "eager":
        check(paged.launches == L * steps and mega.launches == 0,
              f"{lane}: K2 launched {paged.launches}, expected {L * steps}")
    else:
        check(mega.launches == steps and paged.launches == 0,
              f"{lane}: {mega.launches} megakernel and {paged.launches} K2 "
              f"launches for {steps} decode steps")
    per_step = {"paged_attention": L, "megakernel": 1}
    for kname, variant in variants.items():
        k = paged if kname == "paged_attention" else mega
        n = k.variant_launches.get(variant, 0)
        check(n == per_step[kname] * steps,
              f"{lane}: {kname} lane {variant!r} launched {n} times in "
              f"{steps} decode steps")
    check(all(k.plain_calls == 0 for k in kernels),
          f"{lane}: a plain version ran on the main path")
    ttft = [r.ttft_s * 1e3 for r in reqs]
    pre = sum(r.preemptions for r in reqs)
    rec = {"requests": len(reqs), "prompt_lens": [len(p) for p in prompts],
           "gen": gen, "max_batch": se.max_batch, "prefill_chunk": se.chunk,
           "page_size": se.page, "pool_pages": se.num_pages,
           "kv_dtype": _dtype_name(se.kv_dtype) if se.kv_dtype else None,
           "spec_k": se.spec_k, "prefill_slices": slices,
           "decode_steps": steps, "wall_s": wall,
           "tokens_per_s": sum(len(r.tokens) for r in reqs) / wall,
           "ttft_ms_p50": _pct(ttft, 50), "ttft_ms_p99": _pct(ttft, 99),
           "preemptions": pre,
           "launches": {"flash_attention": flash.launches,
                        "paged_attention": paged.launches,
                        "megakernel": mega.launches,
                        "variants": {"paged_attention":
                                     dict(paged.variant_launches),
                                     "megakernel":
                                     dict(mega.variant_launches)}}}
    if se.spec_k:
        drafted = sum(r.drafted_tokens for r in reqs)
        accepted = sum(r.accepted_draft_tokens for r in reqs)
        rec.update(drafted_tokens=drafted, accepted_draft_tokens=accepted,
                   accept_rate=accepted / drafted if drafted else None,
                   decode_tokens_per_step=(
                       (sum(len(r.tokens) for r in reqs) - len(reqs)) / steps
                       if not pre else "not measured: preemptions"))
    return rec


def phase_serving(torch, eng, kernels, ServingEngine, *, name="serving",
                  prompts, gen: int = 32, **kw) -> dict:
    """The eager lane on ``eng`` (page 16): ``ServingEngine(max_batch=4,
    prefill_chunk=256, **kw)`` over ``prompts`` (``gen`` new tokens each),
    then the decode-only window."""
    from triton_distributed_tpu_torch.serving import loop

    torch.cuda.reset_peak_memory_stats()
    se = ServingEngine(eng, max_batch=4, prefill_chunk=256, **kw)
    variants = ({"paged_attention": "e4m3"} if eng.kv_dtype is not None
                else {})
    rec = {"phase": name, **run_serving(torch, se, kernels, prompts, gen,
                                        lane="eager", variants=variants)}
    rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if se.spec_k:
        rec["decode_window"] = decode_window(
            torch, se, loop, "dense_verify_step_paged",
            prompts=phrase_prompts(torch, eng.cfg.vocab_size,
                                   (100, 1500, 640, 333), 16))
    else:
        rec["decode_window"] = decode_window(torch, se, eng, "decode")
    return rec


def time_step_kernel(torch, mk, se, timer) -> dict:
    """The lane's kernel alone at the main path's shape: its own program
    and weights, 4 slots at MK_LENS on free pool pages (a window of
    ``spec_w`` rows on each busy slot), one step timed with CUDA events
    against its bound and its plain version."""
    dec, ws = se._mk, se._mk_ws
    W = dec.spec_w
    _, tables = mk_pages(MK_LENS, W, dec.max_pages)
    wins = [W if n else 1 for n in MK_LENS]
    toks = [[1 + i] * W for i in range(len(MK_LENS))]
    queue = dec.stage(ws, toks, MK_LENS, tables, wins if W > 1 else None)
    comp = dec.comp
    main, pool = dec._split(ws)
    wkv8 = pool if dec.kv_fp8 else None
    kw = dict(num_exec=comp.num_exec, mat_specs=comp.mat_specs,
              head_dim=comp.head_dim)
    launch = mk.cuda_launcher(queue, main, dec._wsm, live_rows=W,
                              sync_before=comp.sync_before, wkv8=wkv8, **kw)
    ms = timer.ms(launch, iters=5)
    plain_ms = timer.ms(lambda: mk.run_queue_plain(
        queue, main.clone(), dec._wsm,
        wkv8=None if wkv8 is None else wkv8.clone(), **kw),
        iters=1, warmup=1)
    nbytes, flops = _mk_bound(se.cfg, MK_LENS, main.element_size(),
                              len(MK_LENS) * W, 1 if dec.kv_fp8 else None)
    bound, bound_by = _bound_ms(nbytes, flops, _dtype_name(main.dtype))
    return {"kv_lens": MK_LENS, "wins": wins, "tasks": comp.num_exec,
            "barriers": int(comp.sync_before.sum()), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "grid_blocks": mk.grid_blocks(main.dtype), "library_ms": None}


def phase_megakernel_serving(torch, mk, kernels, Engine, ServingEngine,
                             params, cfg, *, name="megakernel_serving",
                             prompts, kv_dtype=None, **kw) -> dict:
    """Full Qwen3-8B (36 layers, bf16, the serving phases' seeded weights)
    on the megakernel lane (``Engine(backend="megakernel",
    page_size=128, kv_dtype=)``): every request finishes, one megakernel
    launch per decode step (of the kv8 lane over e4m3 pools, of the
    window program under ``spec_k``), K1 once per layer and prefill slice,
    K2 never, no plain version. Then the decode-only window, and the
    kernel alone at this shape against its bound and its plain version.
    The lane's workspaces are freed when the phase returns."""
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(cfg, params, max_seq=2048, page_size=128,
                 backend="megakernel", kv_dtype=kv_dtype)
    t0 = time.perf_counter()
    se = ServingEngine(eng, max_batch=4, prefill_chunk=256, **kw)
    torch.cuda.synchronize()
    build_lane_s = time.perf_counter() - t0
    variants = {}
    if kv_dtype is not None:
        variants["megakernel"] = "kv8"
    rec = {"phase": name, "build_lane_s": build_lane_s,
           **run_serving(torch, se, kernels, prompts, 32, lane="megakernel",
                         variants=variants)}
    if se.spec_k:
        n = kernels[2].variant_launches.get("window", 0)
        check(n == rec["decode_steps"], f"{name}: the window program ran "
              f"{n} times in {rec['decode_steps']} decode steps")
        n = kernels[2].variant_launches.get("rows", 0)
        want = rec["decode_steps"] if se.spec_k + 1 > 4 else 0
        check(n == want, f"{name}: {n} launches on more than 4 rows in "
              f"{rec['decode_steps']} decode steps")
        rec["launches_on_more_than_4_rows"] = n
    rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    win_prompts = (phrase_prompts(torch, cfg.vocab_size,
                                  (100, 1500, 640, 333), 16)
                   if se.spec_k else None)
    rec["decode_window"] = decode_window(torch, se, se._mk, "step",
                                         prompts=win_prompts)
    rec["step_kernel"] = time_step_kernel(torch, mk, se, Timer(torch, "cuda"))
    return rec


def linear_decode_run(torch, mk, dec, cache, tok, gen, mega, timer, cfg,
                      *, weight_item: int, profile_check: bool = False
                      ) -> dict:
    """``gen - 1`` steps of a linear decoder from a prefilled cache, with
    the megakernel's count set to 0 just before and read just after: the
    run's wall time and tokens/s, each step's wall (synced) and enqueue
    (host) time, then the kernel alone at the last position, L2 flushed,
    against its byte bound and its plain version. ``profile_check``: then
    one profiled step (``profile_stamp``)."""
    ws = dec.start(cache)
    pos = int(cache.offset)
    torch.cuda.synchronize()
    mega.launches, mega.plain_calls = 0, 0
    walls, enq, toks = [], [], [int(tok[0])]
    t_run = time.perf_counter()
    for _ in range(gen - 1):
        t0 = time.perf_counter()
        ws, tok = dec.step(ws, tok, pos)
        enq.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        toks.append(int(tok[0]))
        pos += 1
    run_s = time.perf_counter() - t_run
    launches = mega.launches
    check(launches == gen - 1 and mega.plain_calls == 0,
          f"linear decoder: {launches} megakernel launches and "
          f"{mega.plain_calls} plain runs for {gen - 1} decoded tokens")
    check(all(0 <= t < cfg.vocab_size for t in toks),
          "linear decoder: token ids out of range")
    comp = dec.comp
    kw = dict(num_exec=comp.num_exec, mat_specs=comp.mat_specs,
              head_dim=comp.head_dim)
    queue = dec.queue_at(pos - 1)
    dec.put_inputs(ws, tok, pos - 1)
    wsm, ws8 = dec.weights()
    launch = mk.cuda_launcher(queue, ws, wsm, ws8=ws8, live_rows=1,
                              sync_before=comp.sync_before, **kw)
    ms = timer.ms(launch, iters=5)
    plain_ms = timer.ms(lambda: mk.run_queue_plain(
        queue, ws.clone(), wsm, ws8=ws8, **kw), iters=1, warmup=1)
    nbytes, flops = _mk_bound(cfg, [pos - 1], weight_item, 1,
                              ws.element_size())
    bound, bound_by = _bound_ms(nbytes, flops, _dtype_name(ws.dtype))
    stamp = (profile_stamp(torch, mk, dec, ws, tok, pos - 1, launch, mega,
                           timer) if profile_check else None)
    return {"workspace_dtype": _dtype_name(ws.dtype),
            "weights": ("float8_e4m3fn tiles" if dec.fp8_weights
                        else _dtype_name(ws.dtype) + " matrix"),
            "tasks": comp.num_exec, "barriers": int(comp.sync_before.sum()),
            "decoded_tokens": gen - 1, "launches": launches,
            "first_step_ms": walls[0] * 1e3,
            "step_ms": _pct(walls[1:], 50) * 1e3,
            "enqueue_ms": _pct(enq[1:], 50) * 1e3,
            "decode_tokens_per_s": (gen - 2) / sum(walls[1:]),
            "run_s": run_s, "kernel_pos": pos - 1, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "bound_bytes": nbytes, "library_ms": None,
            "grid_blocks": mk.grid_blocks(ws.dtype, full=True),
            "tokens_head": toks[:8], "profile": stamp}


def profile_stamp(torch, mk, dec, ws, tok, pos, launch, mega, timer) -> dict:
    """One ``MegakernelDecoder.step`` with ``profile=True`` at ``pos``
    (the megakernel's count set to 0 just before and read just after):
    its dump must equal, word for word, the records
    ``obs.kernel_profile.records_from_queue`` decodes from the step's
    queue, and the same token as the unprofiled step. Then the stamp's
    cost: the profiled launch against the unprofiled one, in turns
    (unprofiled, profiled, profiled, unprofiled), L2 flushed."""
    from triton_distributed_tpu_torch.obs import kernel_profile as kp

    comp = dec.comp
    queue = dec.queue_at(pos)
    ws_a = ws.clone()
    _, tok_a = dec.step(ws_a, tok, pos)
    dec.profile = True
    mega.launches, mega.variant_launches = 0, {}
    ws_b = ws.clone()
    _, tok_b = dec.step(ws_b, tok, pos)
    launches = mega.variant_launches.get("profile", 0)
    dec.profile = False
    dump = dec.last_profile.cpu().numpy()
    got = [r.to_json() for r in kp.decode_records(dump)]
    want = [r.to_json() for r in kp.records_from_queue(queue, comp.num_exec)]
    check(launches == 1 and mega.launches == 1,
          f"profile: {launches} profiled launches for one step")
    check(got == want and (dump[:, 1 + 10:] == -1).all(),
          "profile: the dump is not the step's queue")
    check(int(tok_a[0]) == int(tok_b[0]),
          "profile: the profiled step gave another token")
    kw = dict(num_exec=comp.num_exec, mat_specs=comp.mat_specs,
              head_dim=comp.head_dim)
    wsm, ws8 = dec.weights()
    launch_p = mk.cuda_launcher(queue, ws_b, wsm, ws8=ws8, live_rows=1,
                                sync_before=comp.sync_before, profile=True,
                                **kw)
    runs = {"plain": [], "profiled": []}
    for name in ("plain", "profiled", "profiled", "plain"):
        runs[name].append(timer.ms(launch if name == "plain" else launch_p,
                                   iters=5))
    ms, ms_p = (sum(runs[k]) / 2 for k in ("plain", "profiled"))
    prof = kp.KernelProfile.from_dump(dump, itemsize=ws.element_size(),
                                      measured_step_s=ms_p / 1e3)
    return {"launches": launches, "tasks": comp.num_exec,
            "dump_equals_queue_records": True, "same_token": True,
            "step_ms_runs": runs, "step_ms": ms, "profiled_step_ms": ms_p,
            "stamp_cost_ms": ms_p - ms,
            "summary": prof.summary()}


def phase_megakernel_engine(torch, mk, mkserv, kernels, Engine, params, cfg,
                            timer, *, prompt=1024, gen=64) -> dict:
    """Full Qwen3-8B (36 layers, the serving phases' bf16 weights) through
    ``Engine(backend="megakernel", max_seq=2048).serve``: one 1024-token
    prompt, 64 tokens, the decoder as the engine builds it (float32 linear
    workspace, matrix layout). K1 once per layer for the prefill, one
    megakernel launch per decoded token (the first token comes from the
    prefill logits), K2 never, no plain version. Then the decoder alone
    from the same prefill with a bfloat16 workspace and with e4m3 weight
    tiles (bfloat16 activations and caches), and the eager
    ``Engine.serve`` at batch 1 in the same call for comparison. Each
    decoder is freed before the next is built."""
    import gc

    flash, paged, mega = kernels
    L = cfg.num_layers
    g = torch.Generator(device="cuda").manual_seed(17)
    ids = torch.randint(0, cfg.vocab_size, (1, prompt), generator=g,
                        device="cuda", dtype=torch.int32)
    rec = {"phase": "megakernel_engine", "prompt": prompt, "gen": gen,
           "layers": L, "max_seq": 2048}

    def timed_serve(eng, reps):
        runs, out = [], None
        for _ in range(reps):
            torch.cuda.synchronize()
            reset_counts(kernels)
            t0 = time.perf_counter()
            got = eng.serve(ids, gen)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
            check(out is None or torch.equal(out, got),
                  "megakernel_engine: a repeated serve gave other tokens")
            out = got
        return runs, out

    eager = Engine(cfg, params, max_seq=2048, page_size=16)
    eager.serve(ids[:, :128], 4)
    runs, _ = timed_serve(eager, 2)
    check(paged.launches == L * (gen - 1) and mega.launches == 0,
          "megakernel_engine: the eager serve's launch counts are off")
    rec["eager_batch1"] = {"serve_s_runs": runs, "serve_s": min(runs),
                           "tokens_per_s": gen / min(runs)}
    del eager

    torch.cuda.reset_peak_memory_stats()
    eng = Engine(cfg, params, max_seq=2048, backend="megakernel")
    t0 = time.perf_counter()
    eng.serve(ids[:, :128], 4)          # builds the decoder and its weights
    torch.cuda.synchronize()
    rec["first_serve_s"] = time.perf_counter() - t0
    runs, out = timed_serve(eng, 2)
    check(mega.launches == gen - 1,
          f"megakernel_engine: {mega.launches} megakernel launches for "
          f"{gen - 1} decoded tokens")
    check(paged.launches == 0, "megakernel_engine: K2 ran on the "
          "megakernel serve")
    check(flash.launches == L,
          f"megakernel_engine: K1 launched {flash.launches}, expected {L}")
    check(all(k.plain_calls == 0 for k in kernels),
          "megakernel_engine: a plain version ran on the main path")
    check(tuple(out.shape) == (1, gen) and out.dtype == torch.int32
          and bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          "megakernel_engine: bad output")
    rec["serve"] = {"serve_s_runs": runs, "serve_s": min(runs),
                    "tokens_per_s": gen / min(runs),
                    "launches": {"flash_attention": flash.launches,
                                 "paged_attention": paged.launches,
                                 "megakernel": mega.launches}}
    logits, cache = eng.prefill(ids)
    check(bool(torch.isfinite(logits).all()),
          "megakernel_engine: non-finite prefill logits")
    tok = logits.argmax(-1).to(torch.int32)
    forms = {"fp32": linear_decode_run(torch, mk, eng._mk, cache, tok, gen,
                                       mega, timer, cfg, weight_item=4)}
    forms["fp32"]["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    eng._mk = None
    for name, kw, item in (("bf16", {}, 2),
                           ("fp8_weights", {"fp8_weights": True}, 1)):
        run_kw = {"profile_check": name == "bf16"}
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        dec = mkserv.MegakernelDecoder(cfg, params, max_seq=2048,
                                       dtype=torch.bfloat16, **kw)
        forms[name] = linear_decode_run(torch, mk, dec, cache, tok, gen,
                                        mega, timer, cfg, weight_item=item,
                                        **run_kw)
        forms[name]["build_and_run_s"] = time.perf_counter() - t0
        forms[name]["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del dec
    rec["forms"] = forms
    return rec


def phase_moe_engine(torch, kernels, Engine, ServingEngine, cfg, prompts):
    """Qwen3-30B-A3B at full width and depth (48 layers, bf16, seeded
    random weights): ``Engine.serve`` of 2 x 1024-token prompts for 16 new
    tokens (K1 once per layer, K2 once per layer and decode step, no plain
    version; prefill ms, decode ms/step, tokens/s, peak memory, the decode
    profile; one timed serve), then ``ServingEngine`` (page 16) over the
    serving phases' six prompts x 8 tokens and its decode-only window.
    Returns the two records and the parameters (the EP and TP phases run
    on them)."""
    from triton_distributed_tpu_torch.models.dense import init_dense_llm

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_dense_llm(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = Engine(cfg, params, max_seq=2048, page_size=16)
    rec = phase_engine(torch, eng, kernels[:2], gen=16, reps=1)
    rec.update(phase="moe_engine", model="Qwen3-30B-A3B", init_s=init_s,
               params_gb=sum(t.numel() * t.element_size() for t in
                             _leaves(params)) / 1e9)
    serving = phase_serving(torch, eng, kernels, ServingEngine,
                            name="moe_serving", prompts=prompts, gen=8)
    serving["model"] = "Qwen3-30B-A3B"
    return rec, serving, params


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def phase_moe_step(torch, mk, mkmodels, cfg, timer) -> dict:
    """The full-width MoE decode program at all 48 layers, bf16, at batch
    1 (in-kernel appends) and batch 4 and 8 (host-fed caches): launches of a
    counted 8-step run, the kernel's time against the byte bound of the
    experts it streamed, the active experts per layer, and MOE_TOPK and
    MOE_FFN alone."""
    import gc

    rec = {"phase": "moe_step", "model": "Qwen3-30B-A3B",
           "dtype": "bfloat16"}
    for batch in (1, 4, 8):
        rec[f"batch_{batch}"] = moe_step_run(torch, mk, mkmodels, cfg, timer,
                                             batch=batch)
        gc.collect()
        torch.cuda.empty_cache()
    return rec


def phase_moe_parity(torch, QWEN3_30B_A3B, init_dense_llm, Engine,
                     ServingEngine, kernels) -> dict:
    """float32, Qwen3-30B-A3B widths cut to 2 layers, eager lane (page
    16): ``ServingEngine`` token-identical to the sequential
    ``Engine.serve`` — 4 requests through 2 slots, and through 3 slots
    over a pool small enough to preempt."""
    cfg = dataclasses.replace(QWEN3_30B_A3B, num_layers=2, dtype="float32")
    params = init_dense_llm(
        cfg, generator=torch.Generator(device="cuda").manual_seed(3))
    eng = Engine(cfg, params, max_seq=256, page_size=16)
    g = torch.Generator().manual_seed(23)
    runs = {"moe_two_slots": (dict(max_batch=2, prefill_chunk=64),
                              ([37, 100, 64, 150], [12, 8, 16, 10])),
            "moe_preempt": (dict(max_batch=3, num_pages=20, prefill_chunk=64),
                            ([90, 60, 75, 100], [40, 40, 40, 40]))}
    flash, paged, mega = kernels
    result = {"phase": "moe_parity", "layers": 2, "dtype": "float32"}
    for name, (kw, (lengths, gens)) in runs.items():
        prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist()
                   for n in lengths]
        golden = [eng.serve([p], n)[0].tolist() for p, n in zip(prompts, gens)]
        reset_counts(kernels)
        se = ServingEngine(eng, **kw)
        cuts = record_preemptions(se)
        reqs, steps, _, _ = _drive(se, prompts, gens)
        for r, p, want in zip(reqs, prompts, golden):
            if r.tokens != want:
                step, gap = _first_divergence(torch, eng, p, r.tokens, want)
                emit({"phase": "moe_parity", "run": name, "req": r.req_id,
                      "diverged_at_step": step, "top2_logit_gap": gap})
                raise RuntimeError(f"chip_smoke: moe parity {name}: "
                                   f"{r.req_id} diverged at step {step}")
        n_pre = sum(r.preemptions for r in reqs)
        if name.endswith("preempt"):
            check(n_pre >= 1, f"moe parity {name}: no preemption")
        check(paged.launches == cfg.num_layers * steps and mega.launches == 0
              and all(k.plain_calls == 0 for k in kernels),
              f"moe parity {name}: K2 launched {paged.launches} for {steps} "
              "steps (or a plain version ran)")
        result[name] = {"requests": len(reqs), "tokens": sum(gens),
                        "decode_steps": steps, "preemptions": n_pre,
                        "preempted_at_tokens": cuts, "identical": True}
        del se
    return result


def phase_linear_parity(torch, mkserv, QWEN3_8B, init_dense_llm, Engine,
                        kernels) -> dict:
    """float32, Qwen3-8B widths cut to 2 layers: ``Engine.serve`` on the
    megakernel (the linear decoder) token-identical to the eager serve,
    and the fp8-weight decoder token-identical to the eager engine on
    e4m3 pre-quantized weights (prefill on the quantized weights too)."""
    from triton_distributed_tpu_torch.models.fp8 import to_e4m3

    flash, paged, mega = kernels
    cfg = dataclasses.replace(QWEN3_8B, num_layers=2, dtype="float32")
    params = init_dense_llm(
        cfg, generator=torch.Generator(device="cuda").manual_seed(2))
    g = torch.Generator().manual_seed(19)
    result = {"phase": "linear_parity", "layers": 2, "dtype": "float32"}
    eager = Engine(cfg, params, max_seq=256, page_size=16)
    mk_eng = Engine(cfg, params, max_seq=256, backend="megakernel")
    runs = []
    for n, gen in ((37, 24), (150, 40), (128, 16)):
        prompt = [torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist()]
        want = eager.serve(prompt, gen)[0].tolist()
        reset_counts(kernels)
        got = mk_eng.serve(prompt, gen)[0].tolist()
        check(mega.launches == gen - 1 and paged.launches == 0
              and mega.plain_calls == 0,
              f"linear parity: {mega.launches} megakernel launches for "
              f"{gen - 1} decoded tokens")
        if got != want:
            step, gap = _first_divergence(torch, eager, prompt[0], got, want)
            emit({"phase": "linear_parity", "prompt": n,
                  "diverged_at_step": step, "top2_logit_gap": gap})
            raise RuntimeError("chip_smoke: linear parity: Engine.serve on "
                               f"the megakernel diverged at step {step}")
        runs.append({"prompt": n, "gen": gen, "identical": True})
    result["engine_serve"] = runs
    names = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")

    def quant(tree):
        if isinstance(tree, dict):
            return {k: (to_e4m3(v).to(v.dtype) if k in names else quant(v))
                    for k, v in tree.items()}
        return [quant(v) for v in tree] if isinstance(tree, list) else tree

    params_q = quant(params)
    eager_q = Engine(cfg, params_q, max_seq=256, page_size=16)
    dec = mkserv.MegakernelDecoder(cfg, params, max_seq=256, fp8_weights=True)
    runs = []
    for n, gen in ((37, 24), (128, 16)):
        prompt = torch.randint(0, cfg.vocab_size, (1, n), generator=g)
        want = eager_q.serve(prompt, gen)[0].tolist()
        logits, cache = eager_q.prefill(prompt)
        tok = logits.argmax(-1).to(torch.int32)
        ws, pos, got = dec.start(cache), n, [int(tok[0])]
        reset_counts(kernels)
        for _ in range(gen - 1):
            ws, tok = dec.step(ws, tok, pos)
            got.append(int(tok[0]))
            pos += 1
        check(mega.launches == gen - 1 and mega.plain_calls == 0,
              "linear parity: the fp8-weight decoder's launch count is off")
        if got != want:
            step, gap = _first_divergence(torch, eager_q, prompt[0].tolist(),
                                          got, want)
            emit({"phase": "linear_parity", "form": "fp8_weights",
                  "prompt": n, "diverged_at_step": step,
                  "top2_logit_gap": gap})
            raise RuntimeError("chip_smoke: linear parity: the fp8-weight "
                               f"decoder diverged at step {step}")
        runs.append({"prompt": n, "gen": gen, "identical": True})
    result["fp8_weight_decoder"] = runs
    return result


def _first_divergence(torch, eng, prompt, got, want):
    """Step and top-2 logit gap where ``got`` left ``want``."""
    step = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    ids = torch.tensor([list(prompt) + list(want[:step])], dtype=torch.int32)
    logits, _ = eng.prefill(ids)
    top = torch.topk(logits[0].float(), 2).values
    return step, float(top[0] - top[1])


def phase_parity(torch, QWEN3_8B, init_dense_llm, Engine, ServingEngine,
                 kernels):
    cfg = dataclasses.replace(QWEN3_8B, num_layers=2, dtype="float32")
    params = init_dense_llm(
        cfg, generator=torch.Generator(device="cuda").manual_seed(1))
    e4m3 = torch.float8_e4m3fn
    eng = Engine(cfg, params, max_seq=256, page_size=16)
    eng8 = Engine(cfg, params, max_seq=256, page_size=16, kv_dtype=e4m3)
    mk_eng = Engine(cfg, params, max_seq=256, page_size=128,
                    backend="megakernel")
    mk_eng8 = Engine(cfg, params, max_seq=256, page_size=128,
                     backend="megakernel", kv_dtype=e4m3)
    # torch.argmax on the card must return the FIRST maximum (jnp.argmax's
    # rule), or greedy token identity could not be relied on.
    x = torch.zeros((3, cfg.vocab_size), device="cuda")
    x[:, [5, cfg.vocab_size // 2, cfg.vocab_size - 1]] = 1.0
    check(torch.argmax(x, dim=-1).tolist() == [5, 5, 5],
          "parity: torch.argmax does not return the first maximum")
    g = torch.Generator().manual_seed(13)
    two = ([37, 100, 64, 150], [12, 8, 16, 10])
    pre = ([90, 60, 75, 100], [40, 40, 40, 40])
    small = dict(max_batch=3, num_pages=20, prefill_chunk=64)
    small_mk = dict(max_batch=3, num_pages=3, prefill_chunk=128)
    spec = dict(spec_k=SPEC_K)
    # name: (serving engine, ServingEngine kw, shape, golden engine,
    # phrase prompts?). Each golden is the sequential Engine.serve of the
    # eager lane (one-token decode) with the same pool dtype. Over e4m3
    # pools a preempted request's golden is taken per segment (see
    # segment_golden).
    runs = {
        # 4 requests through 2 slots, slices interleaving with decode.
        "two_slots": (eng, dict(max_batch=2, prefill_chunk=64), two, eng,
                      False),
        # An undersized pool: page growth preempts, resume recomputes.
        "preempt": (eng, small, pre, eng, False),
        # The same two shapes on the megakernel lane (page 128): slot
        # reuse, and a 3-page pool that preempts a request mid-decode
        # and recomputes it into its pool pages on resume.
        "megakernel_two_slots": (mk_eng, dict(max_batch=2,
                                              prefill_chunk=128), two, eng,
                                 False),
        "megakernel_preempt": (mk_eng, small_mk, pre, eng, False),
        # e4m3 pools on both lanes, against the sequential e4m3 serve.
        "fp8_preempt": (eng8, small, pre, eng8, False),
        "megakernel_fp8_preempt": (mk_eng8, small_mk, pre, eng8, False),
        # Speculative decode (spec_k = 3, phrase prompts so drafts are
        # proposed) against one-token decode, on both lanes; then spec
        # and e4m3 pools together on the megakernel lane.
        "spec_preempt": (eng, dict(small, **spec), pre, eng, True),
        "megakernel_spec_preempt": (mk_eng, dict(small_mk, **spec), pre,
                                    eng, True),
        "megakernel_spec_fp8_preempt": (mk_eng8, dict(small_mk, **spec), pre,
                                        eng8, True),
        # Windows past the kernel's 4-row groups: 5 and 8 rows.
        "megakernel_spec4_preempt": (mk_eng, dict(small_mk, spec_k=4), pre,
                                     eng, True),
        "megakernel_spec7_preempt": (mk_eng, dict(small_mk, spec_k=7), pre,
                                     eng, True),
    }
    flash, paged, mega = kernels
    result = {"phase": "parity", "layers": cfg.num_layers, "dtype": "float32"}
    for name, (engine, kw, (lengths, gens), gold_eng, phrases) in runs.items():
        if phrases:
            prompts = phrase_prompts(torch, cfg.vocab_size, lengths,
                                     int(torch.randint(0, 1 << 30, (1,),
                                                       generator=g)))
        else:
            prompts = [torch.randint(0, cfg.vocab_size, (n,),
                                     generator=g).tolist() for n in lengths]
        golden = [gold_eng.serve([p], n)[0].tolist()
                  for p, n in zip(prompts, gens)]
        reset_counts(kernels)
        se = ServingEngine(engine, **kw)
        cuts = record_preemptions(se)
        reqs, steps, _, _ = _drive(se, prompts, gens)
        mega_launches = mega.launches
        lanes = {"e4m3": paged.variant_launches.get("e4m3", 0),
                 "kv8": mega.variant_launches.get("kv8", 0),
                 "window": mega.variant_launches.get("window", 0),
                 "rows": mega.variant_launches.get("rows", 0)}
        uninterrupted = [r.tokens == want for r, want in zip(reqs, golden)]
        if engine.kv_dtype is not None:
            golden = [segment_golden(gold_eng, p, n, want,
                                     cuts.get(r.req_id, ()))
                      for r, p, n, want in zip(reqs, prompts, gens, golden)]
        for r, p, want in zip(reqs, prompts, golden):
            if r.tokens != want:
                step, gap = _first_divergence(torch, gold_eng, p, r.tokens,
                                              want)
                emit({"phase": "parity", "run": name, "req": r.req_id,
                      "diverged_at_step": step, "top2_logit_gap": gap})
                raise RuntimeError(f"chip_smoke: parity {name}: {r.req_id} "
                                   f"diverged at step {step}")
        n_pre = sum(r.preemptions for r in reqs)
        if name.endswith("preempt"):
            check(n_pre >= 1, f"parity {name}: the small pool forced no "
                  "preemption")
        mk_lane = engine.backend == "megakernel"
        check(mega_launches == (steps if mk_lane else 0),
              f"parity {name}: {mega_launches} megakernel launches for "
              f"{steps} steps")
        want_lanes = {
            "e4m3": engine.kv_dtype is not None and not mk_lane,
            "kv8": engine.kv_dtype is not None and mk_lane,
            "window": bool(kw.get("spec_k")) and mk_lane,
            "rows": kw.get("spec_k", 0) + 1 > 4 and mk_lane}
        for v, on in want_lanes.items():
            check((lanes[v] > 0) == on, f"parity {name}: lane {v!r} "
                  f"launched {lanes[v]} times")
        rec = {"requests": len(reqs), "tokens": sum(gens),
               "preemptions": n_pre, "identical": True,
               "identical_to_uninterrupted_serve": all(uninterrupted),
               "preempted_at_tokens": {k: v for k, v in cuts.items()}}
        if kw.get("spec_k"):
            rec["drafted_tokens"] = sum(r.drafted_tokens for r in reqs)
            rec["accepted_draft_tokens"] = sum(r.accepted_draft_tokens
                                               for r in reqs)
            check(rec["drafted_tokens"] > 0, f"parity {name}: nothing "
                  "was drafted")
        result[name] = rec
        del se
    return result


def record_preemptions(se) -> dict:
    """{req_id: [tokens held at each preemption]}, filled as ``se``'s
    scheduler preempts."""
    cuts: dict = {}
    preempt = se.sched._preempt

    def recording(req):
        cuts.setdefault(req.req_id, []).append(len(req.tokens))
        preempt(req)

    se.sched._preempt = recording
    return cuts


def segment_golden(eng, prompt, n, uninterrupted, cuts) -> list:
    """The golden of a request preempted after ``cuts`` tokens, over e4m3
    pools. Recompute-on-resume prefills ``prompt + tokens`` from the
    full-width linear buffer and quantizes only at the hand-off, while
    uninterrupted decode computed those tokens' k/v from the quantized
    context: the stored pages differ within one e4m3 step, so a near-tie
    may resolve otherwise (the JAX package shares this). Each resumed
    segment's golden is the sequential serve of its own text, as the
    serving loop recomputes it."""
    toks = list(uninterrupted)
    for k in cuts:
        if k:
            toks = toks[:k] + eng.serve([list(prompt) + toks[:k]],
                                        n - k)[0].tolist()
    return toks


# ---------------------------------------------------------------------------
# Tensor parallelism: the collective kernels (B4 ring AG, B5 one-shot and
# parity-stream AR, B6 ring RS) and ServingEngine on a TP group of virtual
# ranks on one card.
# ---------------------------------------------------------------------------

COLL_RANKS = (2, 4, 8)
COLL_ROWS = (4, 16, 64, 256, 2048)
COLL_COLS = 4096
TP = 4                     # the TP group of the serving phases
# New tokens of the TP serving and engine runs (cut from 32 and 64 to keep
# the whole run inside its time limit as the MoE phases came in).
# Depths cut to fit the 1200 s on a slow host (the host-bound phases).
TP_GEN = 4                 # tp_serving's new tokens (was 16)
TP_ENGINE_GEN = 12         # tp_engine's serves (was 24)
TP_TREE_GEN = 4            # tp_engine's 1 x 203 serve (was 8)
TP_MOE_GEN = 4             # tp_moe_engine's serves (was 16)
TP_MOE_SERVING_PROMPTS = 2  # tp_moe_serving's shortest prompts (was 4)
TP_MOE_SERVING_GEN = 4     # tp_moe_serving's new tokens (was 8)
TP_PROFILE_STEPS = 2       # the TP decode profiles' steps (was 4, 2)
TP_WINDOW_STEPS = 4        # the TP decode windows' steps (was 8, 4)
PARITY_CALLS = 200
# The collectives' main-path shapes (n = 4, bf16, rows): decode's parity
# AR over 4 slots, the verify step's one-shot over 4 x 4 rows, a 256-row
# prefill slice's two-shot (its RS in, its AG out of 256 rows).
COLL_MAIN = {"allreduce_parity": 4, "allreduce_one_shot": 16,
             "reduce_scatter_ring": 256, "allgather_ring": 256}


def virtual_devices(n: int) -> list:
    """n virtual ranks on cuda:0 — asked for explicitly."""
    return ["cuda:0"] * n


def coll_modules():
    import importlib

    names = ("ops._comm", "ops.allreduce", "ops.reduce_scatter",
             "ops.allgather", "runtime.context")
    return [importlib.import_module(f"triton_distributed_tpu_torch.{n}")
            for n in names]


def _coll_ms(torch, ctx, fn, iters: int) -> tuple:
    """Device time of one call of ``fn(rank)`` on every rank, without the
    host in it: each rank's stream is held by a hold kernel polling one
    page-locked host word while the rank threads enqueue ``iters`` calls
    (meeting on the host before each launch); the host then sets the word,
    so every rank's calls start at one instant and run back to back; CUDA
    events on each rank's stream around them, the slowest rank's span over
    ``iters``. The hold's deadline is twice the host time the calls took
    in a warm-up plus 50 ms; a measurement whose enqueue outlasted it is
    taken again with twice the deadline. L2 is not flushed: the calls
    follow each other, as on the main path. Returns (device ms a call,
    host ms a call)."""
    comm = coll_modules()[0]
    from triton_distributed_tpu_torch.runtime.build import (
        current_stream, ptr,
    )

    n = ctx.num_ranks
    t0 = time.perf_counter()
    ctx.run(lambda r: [fn(r) for _ in range(4)])
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) / 4
    deadline = 2 * host * iters + 0.05
    go = torch.zeros(1, dtype=torch.int32).pin_memory()
    for _ in range(3):
        go.zero_()
        evs = [(torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True)) for _ in range(n)]

        def body(r):
            comm.HOLD.launch(ptr(go), int(deadline * 1e9),
                             current_stream(ctx.devices[r]))
            evs[r][0].record()
            for _ in range(iters):
                fn(r)
            evs[r][1].record()

        t0 = time.perf_counter()
        ctx.run(body)
        enqueue = time.perf_counter() - t0
        go.fill_(1)
        torch.cuda.synchronize()
        ctx.raise_on_comm_error()
        if enqueue < deadline:
            ms = max(s.elapsed_time(e) for s, e in evs) / iters
            return ms, host * 1e3
        deadline *= 2
    return "not measured: the host outran every hold", host * 1e3


def coll_case(torch, timer, ctx, method: str, dtype, rows: int, seed: int,
              time_it: bool, hold=None) -> dict:
    """One collective on every rank of ``ctx`` against its plain version
    (bit for bit). ``rows``: the AR / RS input rows and the AG output
    rows of one rank. The double tree writes outputs filled with 0xFF
    bytes (NaN in both types) through ``out=``, so a sentinel left shows
    an element no writer reached, and must launch its kernel once a rank;
    ``hold``: (rank, ns) spun on that rank's stream before its call (a
    late parent or child)."""
    comm, ar, rs, ag, _ = coll_modules()
    from triton_distributed_tpu_torch.runtime.build import current_stream
    n = ctx.num_ranks
    g = torch.Generator(device="cuda").manual_seed(seed)
    cols = COLL_COLS
    in_rows = rows // n if method == "allgather_ring" else rows
    X = torch.randn((n, in_rows, cols), generator=g, device="cuda").to(dtype)
    xs = [X[r].to(ctx.devices[r]) for r in range(n)]     # views on one card
    item = X.element_size()
    if method in ("allreduce_one_shot", "allreduce_two_shot",
                  "allreduce_tree"):
        how = method.replace("allreduce_", "")

        def fn(r):
            return ar.all_reduce_local(xs[r], num_ranks=n, method=how)
    elif method == "allreduce_parity":
        ws, _ = ar.ar_stream_workspace(n, rows, cols, dtype, ctx=ctx,
                                       tag=f"smoke-{rows}")
        idx = [0] * n

        def fn(r):
            out, _, idx[r] = ar.all_reduce_stream(xs[r], ws, idx[r],
                                                  num_ranks=n)
            return out
    elif method == "reduce_scatter_ring":
        def fn(r):
            return rs.reduce_scatter_local(xs[r], num_ranks=n)
    else:
        def fn(r):
            return ag.all_gather_local(xs[r], num_ranks=n,
                                       method="ring_1d")

    xp = list(X)                 # the plain versions' inputs, one card

    def plain_all():
        if method in ("allreduce_one_shot", "allreduce_parity"):
            s = ar.reduce_slots_plain(xp)
            return [s] * n
        if method == "reduce_scatter_ring":
            return [rs.rs_ring_plain(xp, r) for r in range(n)]
        if method == "allgather_ring":
            return [ag.ag_plain(xp)] * n
        if method == "allreduce_tree":
            return [ar.tree_plain(xp)] * n
        full = ag.ag_plain([rs.rs_ring_plain(xp, c) for c in range(n)])
        return [full] * n

    tree = method == "allreduce_tree"
    outs = [torch.empty((rows, cols), dtype=dtype, device=ctx.devices[r])
            for r in range(n)] if tree else None
    for o in outs or ():
        o.view(torch.uint8).fill_(0xFF)
    k0 = comm.TREE_KERNEL.launches

    def checked(r):
        if hold is not None and r == hold[0]:
            comm.SPIN.launch(hold[1], current_stream(ctx.devices[r]))
        if tree:
            return ar.all_reduce_local(xs[r], num_ranks=n, method="tree",
                                       out=outs[r])
        return fn(r)

    res = ctx.run(checked)
    torch.cuda.synchronize()
    ctx.raise_on_comm_error()
    got = [o.to(X.device) for o in res]
    want = plain_all()
    errs = [_max_err(a, b) for a, b in zip(got, want)]
    same = all(torch.equal(_bits(torch, a), _bits(torch, b))
               for a, b in zip(got, want))
    ranks_same = all(torch.equal(got[0], o) for o in got[1:]) \
        if method != "reduce_scatter_ring" else True
    on_kernel = not tree or (comm.TREE_KERNEL.launches - k0 == n and all(
        g is o for g, o in zip(res, outs)))
    rec = {"case": f"{method}_n{n}_{_dtype_name(dtype)}_{rows}"
                   + (f"_held{hold[0]}" if hold else ""),
           "method": method, "n": n, "dtype": _dtype_name(dtype),
           "rows": rows, "cols": cols, "max_abs_err": max(errs),
           "bit_identical": same, "ranks_identical": ranks_same,
           "ok": bool(same and ranks_same and on_kernel
                      and all(torch.isfinite(o).all().item() for o in got))}
    if tree:
        rec["out_sentinel"] = "0xFF"
        rec["hold"] = list(hold) if hold else None
    if time_it:
        B = rows * cols * item           # one rank's full payload
        # The bytes every rank must move, all through the one card's HBM
        # (virtual ranks): each input read once, each output written once.
        nbytes = {"allreduce_one_shot": 2 * n * B, "allreduce_parity":
                  2 * n * B, "allreduce_two_shot": 2 * n * B,
                  "allreduce_tree": 2 * n * B,
                  "reduce_scatter_ring": n * B + B,
                  "allgather_ring": B + n * B}[method]
        adds = (n - 1) * rows * cols
        rec["bound_ms"], rec["bound_by"] = _bound_ms(nbytes, adds, "float32")
        rec["bound_note"] = ("bytes every rank moves, all through one "
                             "card's HBM at 3.35 TB/s (virtual ranks)")
        rec["ms"], rec["host_ms_per_call"] = _coll_ms(torch, ctx, fn, 20)
        rec["plain_ms"] = timer.ms(plain_all)
        if method == "allgather_ring":
            rec.update(library_every_rank(
                timer, n, lambda: torch.cat(xp),
                "torch.cat of the n chunks (one rank's gathered copy)"))
        elif method == "reduce_scatter_ring":
            rec.update(library_every_rank(
                timer, n, lambda: X.sum(0),
                "X.sum(0) over the stacked inputs (every rank's chunk)",
                outputs_per_call=n))
        else:
            rec.update(library_every_rank(
                timer, n, lambda: X.sum(0),
                "X.sum(0) over the stacked inputs (one rank's sum)"))
    return rec


def parity_stress(torch, ctx, dtype, rows: int, calls: int) -> dict:
    """``calls`` back-to-back parity ARs on every rank over one persistent
    workspace, new inputs every call, a rotating rank held back by a
    50 us spin on every third: every result must equal its plain sum."""
    comm, ar, _, _, _ = coll_modules()
    n = ctx.num_ranks
    g = torch.Generator(device="cuda").manual_seed(77)
    X = torch.randn((calls, n, rows, COLL_COLS), generator=g,
                    device="cuda").to(dtype)
    ws, _ = ar.ar_stream_workspace(n, rows, COLL_COLS, dtype, ctx=ctx,
                                   tag="stress")

    def loop(r):
        idx, outs = 0, []
        xr = X[:, r].to(ctx.devices[r])
        for t in range(calls):
            strag = ("rotate", 50_000) if t % 3 == 0 else None
            out, _, idx = ar.all_reduce_stream(xr[t], ws, idx,
                                               num_ranks=n, straggler=strag)
            outs.append(out)
        return torch.stack(outs)

    got = [o.to(X.device) for o in ctx.run(loop)]
    torch.cuda.synchronize()
    ctx.raise_on_comm_error()
    bad = [t for t in range(calls)
           if not all(torch.equal(got[r][t], ar.reduce_slots_plain(
               list(X[t]))) for r in range(n))]
    return {"calls": calls, "n": n, "rows": rows,
            "dtype": _dtype_name(dtype), "straggler": "rotate, 50 us, "
            "every third call", "calls_wrong": bad, "ok": not bad}


def tree_stream_case(torch, ctx, rows: int, calls: int, seed: int) -> dict:
    """``calls`` double-tree AllReduces on every rank in one run, new bf16
    data every call, no host sync between them: every call's result equal
    to ``tree_plain``'s on every rank (a child writes its parent's slot
    for call t+1 only after the parent freed it, i.e. after the parent's
    call t read it), and every call on the kernel."""
    comm, ar, _, _, _ = coll_modules()
    n = ctx.num_ranks
    X = _rand(torch, (calls, n, rows, COLL_COLS), torch.bfloat16, seed)
    k0 = comm.TREE_KERNEL.launches

    def loop(r):
        xr = X[:, r].to(ctx.devices[r])
        return [ar.all_reduce_local(xr[t], num_ranks=n, method="tree")
                for t in range(calls)]

    got = ctx.run(loop)
    torch.cuda.synchronize()
    ctx.raise_on_comm_error()
    bad = [t for t in range(calls) if not all(
        torch.equal(_bits(torch, got[r][t].to(X.device)),
                    _bits(torch, ar.tree_plain(list(X[t]))))
        for r in range(n))]
    launched = comm.TREE_KERNEL.launches - k0
    return {"case": f"allreduce_tree_stream{calls}_n{n}_bfloat16_{rows}",
            "method": "allreduce_tree", "n": n, "rows": rows,
            "calls": calls, "calls_wrong": bad[:8], "launches": launched,
            "max_abs_err": 0.0 if not bad else float("nan"),
            "bit_identical": not bad,
            "ok": not bad and launched == n * calls}


def tree_edge_cases(torch, timer, devices_for, seed: int) -> list:
    """B5's double tree on the push protocol at its edges (bf16 and fp32,
    outputs 0xFF-filled): n = 3 (the heap's lone child; tree 1 over
    reversed ranks) at 1, 7 and 203 rows; at n = 3 and 4 a held-back rank
    0 (tree 0's root: its children wait for the slots it frees and the
    address it publishes; tree 1's leaf) and a held-back rank n - 1 (tree
    0's leaf: its parent waits for its partial; tree 1's root), and the
    200-call stream without a sync. n = 2, 4 and 8 run at these rows in
    ``phase_fused``, at 4-2048 rows in ``phase_collectives``."""
    context = coll_modules()[4]
    out = []
    for n in (3, 4):
        ctx = context.DistContext(
            [torch.device(d) for d in devices_for(n)], wait_timeout_ms=20_000)
        if n == 3:
            for dtype in (torch.float32, torch.bfloat16):
                for rows in TREE_ROWS:
                    seed += 1
                    out.append(coll_case(torch, timer, ctx, "allreduce_tree",
                                         dtype, rows, seed, time_it=False))
        for held in (0, n - 1):
            seed += 1
            out.append(coll_case(torch, timer, ctx, "allreduce_tree",
                                 torch.bfloat16, TREE_MAIN_ROWS, seed,
                                 time_it=False, hold=(held, PUSH_HOLD_NS)))
        seed += 1
        out.append(tree_stream_case(torch, ctx, 7, PARITY_CALLS, seed))
        ctx.close()
        del ctx
        torch.cuda.empty_cache()
    return out


def timeout_case(torch, devices) -> dict:
    """No wait hangs (100 ms deadlines). A lost peer — rank n-1 never
    calls — leaves the others at the host meeting before the launch:
    ``ctx.run`` raises CommTimeoutError. A peer held back on the device
    past the deadline — rank n-1's stream spins 1 s before its parity AR
    — leaves the others' kernels spinning: they time out, write their
    error words and return, and ``raise_on_comm_error`` raises."""
    _, ar, _, _, context = coll_modules()
    out = {}
    for what in ("lost_peer", "held_back_peer"):
        ctx = context.DistContext([torch.device(d) for d in devices],
                                  wait_timeout_ms=100)
        n = ctx.num_ranks
        ws, _ = ar.ar_stream_workspace(n, 4, COLL_COLS, torch.float32,
                                       ctx=ctx, tag="timeout")
        t0 = time.perf_counter()
        raised = None
        try:
            if what == "lost_peer":
                ctx.run(lambda r: None if r == n - 1 else
                        ar.all_reduce_local(
                            torch.ones((4, COLL_COLS), device=ctx.devices[r]),
                            num_ranks=n, method="one_shot"))
            else:
                ctx.run(lambda r: ar.all_reduce_stream(
                    torch.ones((4, COLL_COLS), device=ctx.devices[r]), ws,
                    0, num_ranks=n, straggler=(n - 1, 1_000_000_000)))
            torch.cuda.synchronize()
            ctx.raise_on_comm_error()
        except context.CommTimeoutError as exc:
            raised = str(exc)
        torch.cuda.synchronize()
        out[what] = {"raised": raised, "wall_s": time.perf_counter() - t0}
        ctx.close()
    return {"n": len(devices), "timeout_ms": 100, **out,
            "ok": all(v["raised"] for v in out.values())}


def phase_collectives(torch, timer, fa, pa, *, devices_for=virtual_devices,
                      ranks=COLL_RANKS, name="collectives") -> dict:
    """Every collective kernel at n = 2, 4 and 8 ranks, fp32 and bf16, at
    4-2048 rows x 4096, against its plain version (bit for bit), timed;
    B6's push-protocol edge cases (``rs_edge_cases``) at those n and at
    n = 3; the 200-call parity stress; a lost peer's timeout; AUTO's
    choices;
    K1 and K2 at one rank's TP=4 heads (8 q, 2 kv: GQA group 4)."""
    comm, ar, rs, ag, context = coll_modules()
    from triton_distributed_tpu_torch.runtime.perf_model import chip_spec

    bf16, f32 = torch.bfloat16, torch.float32
    cases: dict = {}
    methods = ("allreduce_one_shot", "allreduce_parity",
               "reduce_scatter_ring", "allgather_ring",
               "allreduce_two_shot", "allreduce_tree")
    seed = 100
    for n in ranks:
        ctx = context.DistContext(
            [torch.device(d) for d in devices_for(n)], wait_timeout_ms=20_000)
        for dtype in (f32, bf16):
            for rows in COLL_ROWS:
                for method in methods:
                    if method not in ("allreduce_one_shot",
                                      "allreduce_parity",
                                      "allreduce_tree") and rows % n:
                        continue
                    seed += 1
                    try:
                        rec = coll_case(torch, timer, ctx, method, dtype,
                                        rows, seed, time_it=True)
                    except Exception as exc:
                        emit({"phase": name, "failed_case": {
                            "method": method, "n": n, "rows": rows,
                            "dtype": _dtype_name(dtype)},
                            "error": repr(exc)})
                        raise
                    cases.setdefault(method, []).append(rec)
        seed += 1
        cases["reduce_scatter_ring"] += push_edge_cases(torch, ctx,
                                                        ("rs_ring",), seed)
        if n == TP:
            stress = parity_stress(torch, ctx, bf16, 4, PARITY_CALLS)
        ctx.close()
        del ctx
        torch.cuda.empty_cache()
    # B6 at n = 3 too: a ring whose chunks no power of two divides evenly
    # over the ranks' reads.
    ctx = context.DistContext([torch.device(d) for d in devices_for(3)],
                              wait_timeout_ms=20_000)
    cases["reduce_scatter_ring"] += push_edge_cases(torch, ctx, ("rs_ring",),
                                                    seed + 50)
    ctx.close()
    del ctx
    torch.cuda.empty_cache()
    spec = chip_spec()
    auto = {f"{rows}x{COLL_COLS}_{_dtype_name(dt)}":
            ar.get_auto_allreduce_method(
                rows * COLL_COLS * torch.empty((), dtype=dt).element_size(),
                TP, tree_halves=ar._tree_halves(rows)).value
            for dt in (bf16, f32) for rows in (4, 16, 64, 256, 2048)}
    tmo = timeout_case(torch, devices_for(TP))
    g4 = dict(hq=32 // TP, hkv=8 // TP, d=128)
    k1 = [flash_case(torch, fa, timer, name="tp4_slice_256_at_768",
                     dtype=bf16, B=1, Sq=256, Sk=2048, q_off=768,
                     normalize=False, time_it=True, seed=21, **g4)]
    k2 = [paged_case(torch, pa, timer, name="tp4_decode_4", dtype=bf16,
                     lens=[0, 1, 17, 1999], page=16, normalize=True,
                     time_it=True, seed=22, **g4)]
    bad = [c["case"] for cs in cases.values() for c in cs if not c["ok"]]
    bad += [c["case"] for c in k1 + k2 if not c["ok"]]
    check(not bad, f"{name}: disagree with their plain versions: {bad}")
    check(stress["ok"], f"{name}: parity stress wrong at calls "
          f"{stress['calls_wrong']}")
    check(tmo["ok"], f"{name}: a lost peer did not raise CommTimeoutError")
    return {"phase": name, "devices": devices_for(TP),
            "ranks_note": "n virtual ranks on one card, asked for "
            "explicitly (devices=['cuda:0'] * n)"
            if devices_for(TP)[0] == devices_for(TP)[-1] else "one rank a card",
            "tolerance": "bit-identical to the plain version (same order "
            "and rounding)", "auto_method_n4": auto,
            "main_shapes": COLL_MAIN, "parity_stress": stress,
            "timeout": tmo, "cases": cases, "flash_attention_tp4": k1,
            "paged_attention_tp4": k2}


def coll_main_case(rec, method, dtype="bfloat16") -> dict:
    rows = COLL_MAIN[method]
    return next(c for c in rec["cases"][method] if "ms" in c
                and c["n"] == TP and c["dtype"] == dtype and c["rows"] == rows)


def _coll_counts(comm) -> dict:
    return {"allreduce_one_shot": comm.ONE_SHOT_KERNEL.launches,
            "allreduce_parity": comm.PARITY_KERNEL.launches,
            "reduce_scatter_ring": comm.RS_RING_KERNEL.launches,
            "allgather_ring": comm.AG_RING_KERNEL.launches,
            "allreduce_tree": comm.TREE_KERNEL.launches}


def tp_drive(torch, se, kernels, prompts, gen, *, name,
             slice_ar: str) -> dict:
    """Drive a TP ServingEngine with every count at 0 just before and read
    just after; fail unless every request finished and each kernel ran
    as often as the path predicts, per rank: K1 L per prefill slice, K2 L
    per decode or verify step, per reduction of a slice (2 L) the AR
    ``slice_ar`` the caller names for its payload ("two_shot", RS + AG,
    for Qwen3-8B's 2 MB slice; "one_shot" for Qwen3-30B-A3B's 1 MB) —
    AUTO must pick the same —, the parity AR per reduction of a one-token
    step (2 L: 72 at 36 layers), the one-shot per reduction of a verify
    step; no plain version."""
    from triton_distributed_tpu_torch.serving import RequestState

    comm, ar = coll_modules()[:2]
    item = torch.empty((), dtype=getattr(torch, se.cfg.dtype)).element_size()
    auto = ar.get_auto_allreduce_method(
        se.chunk * se.cfg.hidden_size * item, se.engine.n,
        tree_halves=ar._tree_halves(se.chunk),
        two_shot=se.chunk % se.engine.n == 0).value
    check(auto == slice_ar,
          f"{name}: AUTO picks {auto} for a slice, the path {slice_ar}")
    allk = list(kernels) + list(comm.COLLECTIVE_KERNELS)
    n, L = se.engine.n, se.cfg.num_layers
    torch.cuda.synchronize()
    reset_counts(allk)
    reqs, steps, slices, wall = _drive(se, prompts, [gen] * len(prompts))
    torch.cuda.synchronize()
    flash, paged, mega = kernels
    c = _coll_counts(comm)
    check(all(r.state is RequestState.FINISHED and len(r.tokens) == gen
              for r in reqs), f"{name}: not every request finished")
    check(flash.launches == n * L * slices,
          f"{name}: K1 launched {flash.launches}, expected {n * L * slices}")
    check(paged.launches == n * L * steps,
          f"{name}: K2 launched {paged.launches}, expected {n * L * steps}")
    pairs = 2 * n * L * slices if slice_ar == "two_shot" else 0
    check(c["reduce_scatter_ring"] == c["allgather_ring"] == pairs,
          f"{name}: {c} for {slices} slices ({slice_ar} per reduction)")
    one_shot = c["allreduce_one_shot"] - (2 * n * L * slices - pairs)
    verify = one_shot // (2 * n * L)
    check(c["allreduce_parity"] + one_shot == 2 * n * L * steps
          and one_shot % (2 * n * L) == 0,
          f"{name}: {c} for {steps} decode steps and {slices} slices")
    if not se.spec_k:
        check(one_shot == 0, f"{name}: one-shot off spec")
    check(all(k.plain_calls == 0 for k in allk) and mega.launches == 0,
          f"{name}: a plain version (or the megakernel) ran")
    ttft = [r.ttft_s * 1e3 for r in reqs]
    rec = {"requests": len(reqs), "gen": gen, "ranks": n,
           "max_batch": se.max_batch, "prefill_chunk": se.chunk,
           "spec_k": se.spec_k, "prefill_slices": slices,
           "decode_steps": steps, "verify_steps": verify, "wall_s": wall,
           "tokens_per_s": sum(len(r.tokens) for r in reqs) / wall,
           "ttft_ms_p50": _pct(ttft, 50), "ttft_ms_p99": _pct(ttft, 99),
           "preemptions": sum(r.preemptions for r in reqs),
           "launches": dict(c, flash_attention=flash.launches,
                            paged_attention=paged.launches),
           "launches_per_rank_per_step": {
               "allreduce_parity": (c["allreduce_parity"]
                                    / max(1, n * (steps - verify))),
               "two_shot_pairs_per_slice": c["reduce_scatter_ring"]
               / max(1, n * slices)}}
    if se.spec_k:
        rec["drafted_tokens"] = sum(r.drafted_tokens for r in reqs)
        rec["accepted_draft_tokens"] = sum(r.accepted_draft_tokens
                                           for r in reqs)
    return rec


def phase_tp_serving(torch, params, cfg, Engine, ServingEngine, kernels,
                     prompts, phrases) -> dict:
    """Qwen3-8B at full width and depth, bf16, on a TP group of 4 virtual
    ranks on cuda:0: ServingEngine(max_batch=4, prefill_chunk=256, page
    16) over the six prompts x TP_GEN tokens (two of them wait for a slot),
    launch counts as the path predicts, the decode-only window's step wall
    and busy share; then a spec_k=3 run over the six phrase prompts (its
    verify steps reduce through the one-shot AR)."""
    context = coll_modules()[4]
    ctx = context.initialize_distributed(devices=virtual_devices(TP),
                                         wait_timeout_ms=60_000)
    emit({"note": f"tp_serving: {TP} virtual ranks on cuda:0, asked for "
                  "explicitly: devices=['cuda:0'] * 4"})
    t0 = time.perf_counter()
    eng = Engine(cfg, params, ctx, max_seq=2048, page_size=16)
    shard_s = time.perf_counter() - t0
    se = ServingEngine(eng, max_batch=4, prefill_chunk=256)
    rec = {"phase": "tp_serving", "ranks": TP,
           "devices": [str(d) for d in ctx.devices], "layers": cfg.num_layers,
           "dtype": cfg.dtype, "shard_s": shard_s,
           "note": "4 ranks share one card's SMs and HBM: these times say "
                   "nothing of four cards"}
    rec["serve"] = tp_drive(torch, se, kernels, prompts, TP_GEN,
                            name="tp_serving", slice_ar="two_shot")
    del se
    se = ServingEngine(eng, max_batch=4, prefill_chunk=256)
    rec["decode_window"] = decode_window(torch, se, eng, "decode",
                                         steps=TP_WINDOW_STEPS)
    del se
    se = ServingEngine(eng, max_batch=4, prefill_chunk=256, spec_k=SPEC_K)
    rec["spec"] = tp_drive(torch, se, kernels, phrases, TP_GEN,
                           name="tp_spec_serving", slice_ar="two_shot")
    check(rec["spec"]["launches"]["allreduce_one_shot"] > 0,
          "tp_spec_serving: no verify step ran the one-shot AR")
    del se, eng
    ctx.close()
    return rec


def rank_logits(torch, eng, prompt) -> dict:
    """Every rank's logits, bit for bit: a 128-row prefill slice's last
    logits (two-shot in fp32 at 2 MB) and one paged decode step over a
    fresh parity workspace."""
    from triton_distributed_tpu_torch.models.dense import (
        dense_decode_step_paged, dense_last_logits, dense_prefill_slice,
    )
    from triton_distributed_tpu_torch.models.kv_cache import (
        init_kv_cache, init_paged_model_cache,
    )
    from triton_distributed_tpu_torch.ops.allreduce import (
        ar_stream_workspace,
    )

    cfg, n = eng.cfg, eng.n
    ids = eng.replicate(torch.tensor([(list(prompt) * 2)[:128]],
                                     dtype=torch.int32))
    kw = eng.tp_kwargs("ar")
    ws, _ = ar_stream_workspace(n, 1, cfg.hidden_size, torch.float32,
                                ctx=eng.ctx, tag="rank-logits")

    def run(r):
        cache = init_kv_cache(cfg, 1, 128, device=eng.rank_devices[r],
                              num_ranks=n)
        x, cache = dense_prefill_slice(eng.rank_params[r], cfg, ids[r],
                                       cache, 0, **kw)
        pre = dense_last_logits(eng.rank_params[r], cfg, x[-1:],
                                axis=eng.axis, num_ranks=n)
        paged = init_paged_model_cache(cfg, 1, page_size=16, max_pages=9,
                                       device=eng.rank_devices[r],
                                       num_ranks=n)
        pools = (paged.k_pools, paged.v_pools)
        for pool, lin in zip(pools, (cache.k, cache.v)):
            pool[:, :8] = lin[:, 0].reshape(cfg.num_layers, 8, 16,
                                            *lin.shape[3:])
        paged = paged._replace(kv_lens=torch.full(
            (1,), 128, dtype=torch.int32, device=eng.rank_devices[r]))
        tok = pre.argmax(-1).to(torch.int32)
        dec, _, _ = dense_decode_step_paged(eng.rank_params[r], cfg, tok,
                                            paged, ar_state=(ws, 0), **kw)
        return pre, dec

    outs = eng.run(run)
    torch.cuda.synchronize()
    eng.check_comm()
    same = all(torch.equal(outs[0][i], o[i].to(outs[0][i].device))
               for o in outs[1:] for i in (0, 1))
    return {"ranks": n, "prefill_and_decode_logits_bit_identical": same,
            "ok": same}


def divergence(torch, eng, one, prompt, got, want) -> dict:
    """Where a TP request left the TP=1 tokens: both engines replay the
    TP=1 history (whole-prompt prefill, then paged decode steps) up to the
    first differing step; the TP=1 logits' top-2 gap there and the two
    lanes' largest logit difference."""
    step = next(i for i, (x, y) in enumerate(zip(got.tokens, want.tokens))
                if x != y)
    hist = want.tokens[:step]

    from triton_distributed_tpu_torch.models.dense import (
        dense_last_logits, dense_prefill_slice,
    )
    from triton_distributed_tpu_torch.models.kv_cache import init_kv_cache

    def logits_at(e):
        # Prefill in 16-token slices (one-shot reductions at any n), the
        # last real row's logits, then paged decode steps on the history.
        C = 16
        ids = torch.zeros((1, -(-len(prompt) // C) * C), dtype=torch.int32)
        ids[0, :len(prompt)] = torch.tensor(prompt)
        idr = e.replicate(ids)
        kw = e.tp_kwargs("ar")
        lkw = {k: v for k, v in kw.items() if k != "mode"}
        row = (len(prompt) - 1) % C

        def prefill(r):
            cache = init_kv_cache(e.cfg, 1, e.max_seq,
                                  device=e.rank_devices[r], num_ranks=e.n)
            for start in range(0, ids.shape[1], C):
                x, cache = dense_prefill_slice(
                    e.rank_params[r], e.cfg, idr[r][:, start:start + C],
                    cache, start, **kw)
            logits = dense_last_logits(e.rank_params[r], e.cfg,
                                       x[row:row + 1], **lkw)
            return logits, cache._replace(offset=len(prompt))

        outs = e.run(prefill)
        logits, cache = outs[0][0], [o[1] for o in outs]
        cache = e.to_paged(cache if e.n > 1 else cache[0])
        for t in hist:
            tok = torch.tensor([t], dtype=torch.int32)
            if e.n == 1:
                logits, cache = e._decode_fn(e.params, e.cfg,
                                             tok.to(e.device), cache)
            else:
                toks = e.replicate(tok)
                outs = e.run(lambda r: e._decode_fn(
                    e.rank_params[r], e.cfg, toks[r], cache[r], **kw))
                logits, cache = outs[0][0], [o[1] for o in outs]
        return logits[0].float()

    l1, ln = logits_at(one), logits_at(eng)
    top = torch.topk(l1, 2).values
    return {"req": got.req_id, "step": step,
            "preemptions": got.preemptions,
            "tp1_top2_gap": float(top[0] - top[1]),
            "max_abs_logit_diff": float((l1 - ln).abs().max()),
            "argmax_tp1_tpn": [int(l1.argmax()), int(ln.argmax())]}


def phase_tp_parity(torch, QWEN3_8B, init_dense_llm, Engine, ServingEngine,
                    kernels, *, devices=None) -> dict:
    """float32 Qwen3-8B widths at 2 layers on a TP group of 4 ranks
    (virtual ranks on cuda:0 unless ``devices``): ServingEngine's tokens
    identical to the TP=1 eager lane's in the same call, each run with a
    preemption — workspace-dtype pools, e4m3 pools, spec_k=3 —, and every
    rank's logits bit-identical. 128-row slices: two-shot in fp32."""
    context = coll_modules()[4]
    comm = coll_modules()[0]
    cfg = dataclasses.replace(QWEN3_8B, num_layers=2, dtype="float32")
    params = init_dense_llm(
        cfg, generator=torch.Generator(device="cuda").manual_seed(2))
    devices = devices or virtual_devices(TP)
    ctx = context.initialize_distributed(devices=devices,
                                         wait_timeout_ms=60_000)
    e4m3 = torch.float8_e4m3fn
    g = torch.Generator().manual_seed(17)
    pre = ([90, 60, 75, 100], [40, 40, 40, 40])
    small = dict(max_batch=3, num_pages=20, prefill_chunk=128)
    result = {"phase": "tp_parity", "ranks": TP,
              "devices": [str(d) for d in ctx.devices],
              "layers": cfg.num_layers, "dtype": "float32"}
    runs = {"tp_preempt": (None, {}, False),
            "tp_fp8_preempt": (e4m3, {}, False),
            "tp_spec_preempt": (None, dict(spec_k=SPEC_K), True)}
    allk = list(kernels) + list(comm.COLLECTIVE_KERNELS)
    for name, (kv, extra, phrases) in runs.items():
        lengths, gens = pre
        if phrases:
            prompts = phrase_prompts(torch, cfg.vocab_size, lengths,
                                     int(torch.randint(0, 1 << 30, (1,),
                                                       generator=g)))
        else:
            prompts = [torch.randint(0, cfg.vocab_size, (n,),
                                     generator=g).tolist() for n in lengths]
        one = Engine(cfg, params, max_seq=256, page_size=16, kv_dtype=kv)
        se1 = ServingEngine(one, **small, **extra)
        want, _, _, _ = _drive(se1, prompts, gens)
        del se1, one
        eng = Engine(cfg, params, ctx, max_seq=256, page_size=16,
                     kv_dtype=kv)
        se = ServingEngine(eng, **small, **extra)
        reset_counts(allk)
        got, steps, slices, _ = _drive(se, prompts, gens)
        c = _coll_counts(comm)
        diverged = []
        for a, b, p in zip(got, want, prompts):
            if a.tokens != b.tokens:
                diverged.append(divergence(torch, eng, Engine(
                    cfg, params, max_seq=256, page_size=16, kv_dtype=kv),
                    p, a, b))
        if diverged:
            emit({"phase": "tp_parity", "run": name, "diverged": diverged})
        check(not diverged, f"tp_parity {name}: {len(diverged)} requests "
              "diverged from TP=1")
        n_pre = sum(r.preemptions for r in got)
        check(n_pre >= 1, f"tp_parity {name}: no preemption")
        check(c["reduce_scatter_ring"] > 0 and c["allgather_ring"] > 0
              and c["allreduce_parity"] > 0,
              f"tp_parity {name}: a kernel of the path never ran: {c}")
        if extra.get("spec_k"):
            check(c["allreduce_one_shot"] > 0,
                  f"tp_parity {name}: no verify step ran the one-shot")
        check(all(k.plain_calls == 0 for k in allk),
              f"tp_parity {name}: a plain version ran")
        result[name] = {"requests": len(got), "tokens": sum(gens),
                        "preemptions": n_pre, "identical_to_tp1": True,
                        "launches": c}
        if name == "tp_preempt":
            result["rank_logits"] = rank_logits(torch, eng, prompts[0])
            check(result["rank_logits"]["ok"],
                  "tp_parity: the ranks' logits differ")
        del se, eng
    ctx.close()
    return result


# ---------------------------------------------------------------------------
# The fused GEMM + communication kernels (B9 AG+GEMM, B10 GEMM+RS, B11
# GEMM+AR) and the double-tree AR (B5 tree) on n virtual ranks, and
# Engine.serve on a TP group with the reference's defaults.
# ---------------------------------------------------------------------------

# (name, rows a rank, K, N) of each fused kernel. Main path at n = 4, bf16:
# Qwen3-8B's 2 x 1024 prefill (B9: the 512 rows of a rank against wq, wk /
# wv and w_gate / w_up; B10: wo and w_down over all 2048 rows) and a batch-2
# decode step (B11: wo and w_down).
FUSED_MAIN = {
    "ag_gemm": (("wq", 512, 4096, 1024), ("wk_wv", 512, 4096, 256),
                ("gate_up", 512, 4096, 3072)),
    "gemm_rs": (("wo", 2048, 1024, 4096), ("down", 2048, 3072, 4096)),
    "gemm_ar": (("wo", 2, 1024, 4096), ("down", 2, 3072, 4096))}
# Small shapes at every n and type: a tall tile and an unaligned B (100
# columns), the short tile; rows that pad (B11 at 5 rows). The "_tall"
# cases keep bf16 on the tall mma.sync tile at every n (B9: 100 columns,
# sub-blocks of 128 rows; B10: chunks of 64-256 rows, B a contiguous view
# one element past a 16-byte boundary, as "offset_b" names).
FUSED_SMALL = {
    "ag_gemm": (("small", 64, 512, 384), ("unaligned", 48, 256, 100),
                ("unaligned_tall", 256, 512, 100)),
    "gemm_rs": (("small", 128, 256, 512), ("short", 32, 128, 256),
                ("offset_b_tall", 512, 256, 512)),
    "gemm_ar": (("small", 2, 256, 512), ("pad", 5, 128, 1024))}
# B9 and B10 on the wgmma route (bf16, every n), at the edges of its tile:
# rows of a sub-block not a multiple of 128 (B9 at sub 1, 2 and 4: the
# fifth entry; B10's chunks of m / n rows), K not a multiple of 64 and
# columns not a multiple of 128.
FUSED_EDGE = {
    "ag_gemm": (("m200_k1032_n1000_sub1", 200, 1032, 1000, 1),
                ("m144_k1032_n1000_sub2", 288, 1032, 1000, 2),
                ("m80_k512_n384_sub4", 320, 512, 384, 4)),
    "gemm_rs": (("m800_k1032_n1000", 800, 1032, 1000),
                ("m768_k512_n384", 768, 512, 384))}
# The held-back rank of the wgmma cases: rank n - 1's stream is held this
# long before its launch.
FUSED_HOLD_NS = 300_000
TREE_ROWS = (1, 7, 203)          # one tree, odd halves, the main path's
TREE_MAIN_ROWS = 203             # a 1 x 203 prompt's "ar" prefill
GEMM_AR_CALLS = 3                # both parities and back


def fused_modules():
    import importlib

    names = ("ops.allgather_gemm", "ops.gemm_reduce_scatter",
             "ops.gemm_allreduce", "runtime.symm")
    return [importlib.import_module(f"triton_distributed_tpu_torch.{n}")
            for n in names]


def _gemm_share(torch, got, want, spread, dtype) -> tuple:
    """(max |got - want|, largest share of B3's tolerance one element
    used): 2^-13 s (summation order, s = sqrt(K) rms(A) rms(B)) plus one
    unit of the output type."""
    lane = "fp32" if dtype == torch.float32 else "bf16"
    rnd = GEMM_ROUND[_dtype_name(dtype)]
    atol = GEMM_TOL[lane]["atol_s"] * spread + rnd["atol"]
    rtol = GEMM_TOL[lane]["rtol"] + rnd["rtol"]
    diff = (got.float() - want.float()).abs()
    share = (diff / (atol + rtol * want.float().abs())).max().item()
    return diff.max().item(), share


def _fused_routes(comm, op) -> dict:
    kern = {"ag_gemm": comm.AG_GEMM_KERNEL, "gemm_rs": comm.GEMM_RS_KERNEL,
            "gemm_ar": comm.GEMM_AR_KERNEL}[op]
    return dict(kern.variant_launches)


def _nan_fill(torch, buf) -> None:
    """The sentinel: every rank's copy of a fused kernel's workspace NaN,
    landed before any rank's stream launches (a tile that reads before its
    flag, or past a tail, then shows as NaN)."""
    for t in buf.tensors:
        t.fill_(float("nan"))
    torch.cuda.synchronize()


def _offset_view(torch, b):
    """``b``'s values in a contiguous view whose base is one element past a
    16-byte boundary (the fused kernels' B without 16-byte rows)."""
    flat = torch.empty(b.numel() + 1, dtype=b.dtype, device=b.device)
    view = flat[1:].view(b.shape)
    view.copy_(b)
    return view


def fused_case(torch, timer, ctx, op, dtype, shape, seed, time_it,
               hold_ns: int = 0) -> dict:
    """One fused kernel on every rank of ``ctx`` against its plain
    version: the communication bit for bit (B9's gathered A; B10's and
    B11's reductions of the kernel's own slots), the GEMM at B3's
    tolerance (B9's output rows; B10's and B11's partials in the slots),
    the replicas bit for bit (B11). B9's landing workspace and B10's slots
    are NaN before the checked call, and no output may hold a NaN; the
    route each launch took is recorded (``routes``). ``shape``: (name,
    rows a rank, K, N[, B9's sub-blocks]); ``hold_ns``: rank n - 1's
    stream held that long before the checked call."""
    agm, grs, gar, symm = fused_modules()
    comm = coll_modules()[0]
    name, m, k, ncols = shape[:4]
    n = ctx.num_ranks
    hold = (n - 1, hold_ns) if hold_ns else None
    g = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn((n, m, k), generator=g, device="cuda").to(dtype)
    W = (torch.randn((n, k, ncols), generator=g, device="cuda")
         * k ** -0.5).to(dtype)
    xs = [X[r].to(ctx.devices[r]) for r in range(n)]
    bs = [W[r].to(ctx.devices[r]) for r in range(n)]
    if name.startswith("offset_b"):
        bs = [_offset_view(torch, b) for b in bs]
    spread = (k ** 0.5 * X.float().pow(2).mean().sqrt().item()
              * W.float().pow(2).mean().sqrt().item())
    rec = {"case": f"{op}_{name}_n{n}_{_dtype_name(dtype)}", "op": op,
           "n": n, "dtype": _dtype_name(dtype), "rows": m, "k": k,
           "ncols": ncols, "spread": spread}
    if hold:
        rec["case"] += "_held"
        rec["held_back_rank"] = {"rank": n - 1, "ns": hold_ns}
    routes0 = _fused_routes(comm, op)
    if op == "ag_gemm":
        acfg = agm.AGGemmConfig(sub_chunks=(shape[4] if len(shape) > 4
                                            else 2))
        sub = agm._ag_sub_chunks(m, acfg.sub_chunks, dtype)
        _nan_fill(torch, symm.symm_zeros(ctx, (n * m, k), dtype,
                                         tag="ag_gemm"))
        outs = ctx.run(lambda r: agm.ag_gemm_local(
            xs[r], bs[r], num_ranks=n, return_gathered=True,
            cfg=dataclasses.replace(acfg, straggler=hold)))
        torch.cuda.synchronize()
        ctx.raise_on_comm_error()
        finite = all(bool(torch.isfinite(o).all()) for o, _ in outs)
        full = torch.cat(list(X))
        comm_ok = all(torch.equal(gat.to(full.device), full)
                      for _, gat in outs)
        errs = [_gemm_share(torch, o.to(full.device), agm.ag_gemm_plain(
            full, W[r], n, sub, r), spread, dtype)
                for r, (o, _) in enumerate(outs)]
        rec.update(sub_chunks=sub, gathered_bit_identical=comm_ok)
        ranks_same = True

        def fn(r):
            return agm.ag_gemm_local(xs[r], bs[r], num_ranks=n, cfg=acfg)

        def plain():
            return [agm.ag_gemm_plain(full, W[r], n, sub, r)
                    for r in range(n)]

        nbytes = (n * m * k + n * k * ncols + n * n * m * ncols) * \
            X.element_size()
        flops = n * 2.0 * n * m * k * ncols
        library = (lambda: torch.matmul(full.expand(n, n * m, k), W),
                   "torch.matmul of the gathered A by each rank's B, "
                   "batched over the ranks (no communication)")
    elif op == "gemm_rs":
        mc = m // n
        buf = symm.symm_zeros(ctx, (n, mc, ncols), dtype, tag="gemm_rs")
        _nan_fill(torch, buf)
        rcfg = grs.GemmRSConfig(straggler=hold)
        outs = ctx.run(lambda r: grs.gemm_rs_local(xs[r], bs[r],
                                                   num_ranks=n, cfg=rcfg))
        torch.cuda.synchronize()
        ctx.raise_on_comm_error()
        finite = all(bool(torch.isfinite(o).all()) for o in outs)
        slots = [t.to(X.device) for t in buf.tensors]
        comm_ok = all(torch.equal(gar.reduce_slots_plain(slots[r]),
                                  outs[r].to(X.device)) for r in range(n))
        parts = [dict(grs.gemm_rs_partials(X[j], W[j], n, j))
                 for j in range(n)]
        errs = [_gemm_share(torch, slots[r][j], parts[j][r], spread, dtype)
                for r in range(n) for j in range(n)]
        rec["out_max_abs_err_vs_plain"] = max(
            _max_err(outs[r].to(X.device),
                     grs.gemm_rs_plain(list(X), list(W), r))
            for r in range(n))
        rec["slot_reduction_bit_identical"] = comm_ok
        ranks_same = True

        def fn(r):
            return grs.gemm_rs_local(xs[r], bs[r], num_ranks=n)

        def plain():
            return [grs.gemm_rs_plain(list(X), list(W), r)
                    for r in range(n)]

        nbytes = (n * m * k + n * k * ncols + m * ncols) * X.element_size()
        flops = n * 2.0 * m * k * ncols
        library = (lambda: torch.matmul(X, W),
                   "torch.matmul of each rank's partials, batched over the "
                   "ranks (no reduce-scatter)")
    else:
        ws, idx0 = gar.gemm_ar_stream_workspace(
            n, m, ncols, dtype, ctx=ctx, tag=f"smoke-{name}-{m}-{k}-{ncols}")
        idx = [idx0] * n
        nch = ws.tensors[0].shape[1]
        comm_ok, ranks_same, errs, finite = True, True, [], True
        plain_out = gar.gemm_ar_plain(list(X), list(W))
        parts = [gar.gemm_ar_partials(X[j], W[j], nch) for j in range(n)]
        out_err = 0.0
        for _ in range(GEMM_AR_CALLS):
            p = idx[0] % 2

            def call(r):
                out, _, idx[r] = gar.gemm_ar_stream(xs[r], bs[r], ws, idx[r],
                                                    num_ranks=n)
                return out

            outs = [o.to(X.device) for o in ctx.run(call)]
            torch.cuda.synchronize()
            ctx.raise_on_comm_error()
            finite &= all(bool(torch.isfinite(o).all()) for o in outs)
            ranks_same &= all(torch.equal(outs[0], o) for o in outs[1:])
            for r in range(n):
                slab = ws.tensors[r][p].to(X.device)[:, :, :m]
                red = torch.cat([gar.reduce_slots_plain(slab[c])
                                 for c in range(nch)], dim=1)
                comm_ok &= torch.equal(red, outs[r])
                errs += [_gemm_share(torch, slab[c, j], parts[j][c], spread,
                                     dtype)
                         for c in range(nch) for j in range(n)]
            out_err = max(out_err, _max_err(outs[0], plain_out))
        rec.update(calls=GEMM_AR_CALLS, n_chunks=nch,
                   slot_reduction_bit_identical=comm_ok,
                   out_max_abs_err_vs_plain=out_err)

        def fn(r):
            out, _, idx[r] = gar.gemm_ar_stream(xs[r], bs[r], ws, idx[r],
                                                num_ranks=n)
            return out

        def plain():
            return gar.gemm_ar_plain(list(X), list(W))

        nbytes = (n * m * k + n * k * ncols + n * m * ncols) * \
            X.element_size()
        flops = n * 2.0 * m * k * ncols
        library = (lambda: torch.matmul(X, W),
                   "torch.matmul of each rank's partials, batched over the "
                   "ranks (no all-reduce)")
    share = max(s for _, s in errs)
    aligned = agm.aligned_rows(bs[0])
    tile = (agm.gemm_tile_for(m // sub, dtype, aligned) if op == "ag_gemm"
            else agm.gemm_tile_for(m // n, dtype, aligned)
            if op == "gemm_rs" else agm.gemm_tile_for(m))
    rec["route"] = comm.GEMM_ROUTES[tile]
    routes = _fused_routes(comm, op)
    rec["routes"] = {r: c - routes0.get(r, 0) for r, c in routes.items()
                     if c != routes0.get(r, 0)}
    rec.update(max_abs_err=max(e for e, _ in errs), gemm_tol_share=share,
               communication_bit_identical=comm_ok,
               ranks_identical=ranks_same, outputs_finite=finite,
               ok=bool(comm_ok and ranks_same and finite and share <= 1.0
                       and set(rec["routes"]) == {rec["route"]}))
    if time_it:
        peak = "float32" if dtype == torch.float32 else "bfloat16"
        rec["bound_ms"], rec["bound_by"] = _bound_ms(nbytes, flops, peak)
        rec["bound_note"] = ("every rank's work on the one card: each input "
                             "read and each output written once at 3.35 "
                             "TB/s, the products at the peak of the type")
        rec["ms"], rec["host_ms_per_call"] = _coll_ms(torch, ctx, fn, 10)
        rec["plain_ms"] = timer.ms(plain)
        rec["library_ms"] = timer.ms(library[0])
        rec["library_call"] = library[1]
    return rec


def gemm_ar_stress(torch, ctx, dtype, calls: int) -> dict:
    """``calls`` back-to-back B11 calls on every rank over one persistent
    workspace at the decode's wo shape, new inputs every call, a rotating
    rank held back 50 us on every third: each output must equal the sum
    of the kernel's own slots, on every rank alike."""
    _, _, gar, _ = fused_modules()
    n, k, ncols = ctx.num_ranks, 1024, 4096
    g = torch.Generator(device="cuda").manual_seed(78)
    X = torch.randn((calls, n, 2, k), generator=g, device="cuda").to(dtype)
    W = (torch.randn((n, k, ncols), generator=g, device="cuda")
         * k ** -0.5).to(dtype)
    ws, _ = gar.gemm_ar_stream_workspace(n, 2, ncols, dtype, ctx=ctx,
                                         tag="stress")
    nch = ws.tensors[0].shape[1]

    def loop(r):
        idx, outs, slabs = ws.epochs[r], [], []
        xr, w = X[:, r].to(ctx.devices[r]), W[r].to(ctx.devices[r])
        for t in range(calls):
            strag = ("rotate", 50_000) if t % 3 == 0 else None
            p = idx % 2
            out, _, idx = gar.gemm_ar_stream(xr[t], w, ws, idx, num_ranks=n,
                                             straggler=strag)
            outs.append(out)
            slabs.append(ws.tensors[r][p][:, :, :2].clone())
        return torch.stack(outs), slabs

    got = ctx.run(loop)
    torch.cuda.synchronize()
    ctx.raise_on_comm_error()
    bad = []
    for t in range(calls):
        ref = got[0][0][t]
        for r in range(n):
            slab = got[r][1][t]
            red = torch.cat([gar.reduce_slots_plain(slab[c])
                             for c in range(nch)], dim=1)
            if not (torch.equal(got[r][0][t].to(ref.device), ref)
                    and torch.equal(red, got[r][0][t])):
                bad.append(t)
                break
    return {"calls": calls, "n": n, "shape": [2, k, ncols],
            "dtype": _dtype_name(dtype), "straggler": "rotate, 50 us, "
            "every third call", "calls_wrong": bad, "ok": not bad}


def fused_timeouts(torch, devices) -> dict:
    """A lost peer raises CommTimeoutError for B9 and B11 (100 ms
    deadlines): rank n-1 never calls, and the others wait at the host
    meeting before the launch; rank n-1's stream held 1 s on the device
    before its call, and the others' kernels spin past their deadline
    (B9 in its entry barrier, B11 on its peers' flags), write the error
    word and return."""
    agm, _, gar, _ = fused_modules()
    context = coll_modules()[4]
    out = {}
    for op in ("ag_gemm", "gemm_ar"):
        for what in ("lost_peer", "held_back_peer"):
            ctx = context.DistContext([torch.device(d) for d in devices],
                                      wait_timeout_ms=100)
            n = ctx.num_ranks
            xs = [torch.ones((16, 256), device=d) for d in ctx.devices]
            ws_ = [torch.ones((256, 256), device=d) for d in ctx.devices]
            hold = (n - 1, 1_000_000_000) if what == "held_back_peer" \
                else None
            if op == "ag_gemm":
                cfg = agm.AGGemmConfig(straggler=hold)

                def fn(r):
                    return agm.ag_gemm_local(xs[r], ws_[r], num_ranks=n,
                                             cfg=cfg)
            else:
                ws, _ = gar.gemm_ar_stream_workspace(n, 16, 256,
                                                     torch.float32, ctx=ctx,
                                                     tag="timeout")

                def fn(r):
                    return gar.gemm_ar_stream(xs[r], ws_[r], ws, 0,
                                              num_ranks=n, straggler=hold)
            t0 = time.perf_counter()
            raised = None
            try:
                ctx.run(lambda r: None if what == "lost_peer" and r == n - 1
                        else fn(r))
                torch.cuda.synchronize()
                ctx.raise_on_comm_error()
            except context.CommTimeoutError as exc:
                raised = str(exc)
            torch.cuda.synchronize()
            out[f"{op}_{what}"] = {"raised": raised,
                                   "wall_s": time.perf_counter() - t0}
            ctx.close()
    return {"n": len(devices), "timeout_ms": 100, **out,
            "ok": all(v["raised"] for v in out.values())}


def phase_fused(torch, timer, *, devices_for=virtual_devices,
                ranks=COLL_RANKS, name="collectives_fused") -> dict:
    """B9, B10 and B11 at n = 2, 4 and 8 ranks, fp32 and bf16, on small
    shapes, and at the main path's shapes (n = 4, bf16) timed; B9 and B10
    on the wgmma route at the edges of its tile (bf16, every n), and with
    rank n - 1 held back (n = 4); each case's route checked against the
    picker's, the main shapes' against "wgmma", and bf16 on the tall
    mma.sync tile run for B9 and B10 (the "_tall" controls); the tree AR
    at 1, 7 and 203 rows into 0xFF-filled outputs, at n = 3 too, with a
    held-back rank and 200 calls without a sync (``tree_edge_cases``; its
    4-2048-row cases run with the other collectives); 200 back-to-back B11
    calls with a rotating straggler; a lost peer's CommTimeoutError for B9
    and B11."""
    context = coll_modules()[4]
    bf16, f32 = torch.bfloat16, torch.float32
    cases: dict = {}
    wgmma_routes: list = []      # (case, routes) of B9 / B10's wgmma cases
    bf16_tall: set = set()       # B9 / B10 launched bf16 on the tall tile
    seed = 500
    for n in ranks:
        ctx = context.DistContext(
            [torch.device(d) for d in devices_for(n)], wait_timeout_ms=20_000)
        for dtype in (f32, bf16):
            for op in ("ag_gemm", "gemm_rs", "gemm_ar"):
                shapes = [(sh, 0) for sh in FUSED_SMALL[op]]
                if dtype == bf16:
                    shapes += [(sh, 0) for sh in FUSED_EDGE.get(op, ())]
                if n == TP and dtype == bf16:
                    shapes += [(sh, 0) for sh in FUSED_MAIN[op]]
                    shapes += [(sh, FUSED_HOLD_NS)
                               for sh in FUSED_EDGE.get(op, ())[:1]]
                for shape, hold in shapes:
                    seed += 1
                    timed = n == TP and dtype == bf16 and \
                        shape in FUSED_MAIN[op]
                    try:
                        rec = fused_case(torch, timer, ctx, op, dtype, shape,
                                         seed, timed, hold_ns=hold)
                    except Exception as exc:
                        emit({"phase": name, "failed_case": {
                            "op": op, "n": n, "shape": shape,
                            "dtype": _dtype_name(dtype)},
                            "error": repr(exc)})
                        raise
                    cases.setdefault(op, []).append(rec)
                    if op != "gemm_ar" and (shape in FUSED_MAIN[op]
                                            or shape in FUSED_EDGE[op]):
                        wgmma_routes.append((rec["case"], rec["routes"]))
                    if op != "gemm_ar" and dtype == bf16 and \
                            set(rec["routes"]) == {"mma_tall"}:
                        bf16_tall.add(op)
            for rows in TREE_ROWS:
                seed += 1
                timed = n == TP and dtype == bf16 and rows == TREE_MAIN_ROWS
                cases.setdefault("allreduce_tree", []).append(coll_case(
                    torch, timer, ctx, "allreduce_tree", dtype, rows, seed,
                    time_it=timed))
        if n == TP:
            stress = gemm_ar_stress(torch, ctx, bf16, PARITY_CALLS)
        ctx.close()
        del ctx
        torch.cuda.empty_cache()
    cases["allreduce_tree"] += tree_edge_cases(torch, timer, devices_for,
                                               seed)
    tmo = fused_timeouts(torch, devices_for(TP))
    bad = [c["case"] for cs in cases.values() for c in cs if not c["ok"]]
    check(not bad, f"{name}: disagree with their plain versions: {bad}")
    off = [c for c, routes in wgmma_routes if set(routes) != {"wgmma"}]
    check(wgmma_routes and not off,
          f"{name}: the wgmma route was not launched at {off}")
    check(bf16_tall == {"ag_gemm", "gemm_rs"},
          f"{name}: bf16 on the tall mma.sync tile ran only for {bf16_tall}")
    check(stress["ok"], f"{name}: B11 stress wrong at calls "
          f"{stress['calls_wrong']}")
    check(tmo["ok"], f"{name}: a lost peer did not raise CommTimeoutError")
    return {"phase": name, "devices": devices_for(TP),
            "tolerance": "communication and replicas bit-identical to the "
            "plain version; each GEMM (B9's output rows, B10's and B11's "
            "slot partials) within B3's: 2^-13 sqrt(K) rms(A) rms(B) plus "
            "one unit of the type; no NaN from the sentinel in B9's "
            "landing workspace or B10's slots reaches an output",
            "main_shapes": FUSED_MAIN, "edge_shapes": FUSED_EDGE,
            "gemm_ar_stress": stress, "timeout": tmo, "cases": cases}


def fused_main_case(rec, op, which) -> dict:
    return next(c for c in rec["cases"][op] if c["n"] == TP
                and c["dtype"] == "bfloat16" and c["case"].startswith(
                    f"{op}_{which}_"))


def _tp_counts(comm) -> dict:
    return {"ag_gemm": comm.AG_GEMM_KERNEL.launches,
            "gemm_rs": comm.GEMM_RS_KERNEL.launches,
            "gemm_ar": comm.GEMM_AR_KERNEL.launches,
            "ag_full_mesh": comm.AG_FULL_MESH_KERNEL.launches,
            "a2a": comm.A2A_KERNEL.launches,
            "a2a_parity": comm.A2A_PARITY_KERNEL.launches,
            **_coll_counts(comm)}


def tp_engine_run(torch, eng, kernels, ids, gen, *, name, expect,
                  profile_steps=0) -> dict:
    """One ``Engine.serve`` on a TP group with every count at 0 just before
    and read just after; ``expect``: {kernel: launches per rank} for the
    prefill and per decode step, checked exactly (every other collective
    none); then the prefill alone, timed."""
    comm = coll_modules()[0]
    n, L = eng.n, eng.cfg.num_layers
    allk = list(kernels) + list(comm.COLLECTIVE_KERNELS)
    torch.cuda.synchronize()
    reset_counts(allk)
    t0 = time.perf_counter()
    out = eng.serve(ids, gen)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    c = dict(_tp_counts(comm), flash_attention=kernels[0].launches,
             paged_attention=kernels[1].launches)
    routes = {"ag_gemm": dict(comm.AG_GEMM_KERNEL.variant_launches),
              "gemm_rs": dict(comm.GEMM_RS_KERNEL.variant_launches)}
    steps = gen - 1
    want = {k: 0 for k in c}
    want["flash_attention"] = n * L
    for kname, (per_prefill, per_step) in expect.items():
        want[kname] = n * (per_prefill + per_step * steps)
    check(c == want, f"{name}: launches {c}, expected {want}")
    check(all(k.plain_calls == 0 for k in allk),
          f"{name}: a plain version ran on the main path")
    check(tuple(out.shape) == (ids.shape[0], gen) and bool(
        ((out >= 0) & (out < eng.cfg.vocab_size)).all()),
        f"{name}: bad output")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = eng.prefill(ids)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    eng.check_comm()
    check(bool(torch.isfinite(logits).all()), f"{name}: non-finite logits")
    rec = {"batch": ids.shape[0], "prompt": ids.shape[1], "gen": gen,
           "prefill_mode": eng._prefill_mode(*ids.shape),
           "serve_s": serve_s, "prefill_ms": prefill_s * 1e3,
           "decode_ms_per_step": (serve_s - prefill_s) * 1e3 / steps,
           "tokens_per_s": ids.shape[0] * gen / serve_s, "launches": c,
           "fused_routes": routes,
           "launches_per_rank": {
               k: {"per_prefill": p, "per_decode_step": s}
               for k, (p, s) in expect.items()}, "tokens": out}
    return rec


def tp_profile(torch, eng, ids, steps: int = 4) -> dict:
    """``profile_decode`` of the TP engine's linear decode steps after a
    prefill of ``ids``: each step's wall against its enqueue, and every
    rank's device time a step by kernel."""
    logits, caches = eng.prefill(ids)
    return profile_decode(torch, eng, logits.argmax(-1).to(torch.int32),
                          caches, steps=steps)


def phase_tp_engine(torch, params, cfg, Engine, kernels) -> dict:
    """Qwen3-8B at full width and depth, bf16, ``Engine(cfg, params, ctx of
    4 virtual ranks, max_seq=2048).serve`` with the reference's defaults
    (backend "auto", no page size): a 2 x 1024 prompt for TP_ENGINE_GEN
    tokens — the prefill in mode "overlap" (B9 5 a layer, B10 2 a layer,
    all on the wgmma route), the linear decode's reductions through the
    parity AR (2 a layer) —, again under TDTPU_GEMM_AR=1 (B11 in place of
    the parity AR), then a 1 x 203 prompt whose "ar" prefill reduces
    through the double tree (2 a layer); TP=1's Engine.serve of the same
    prompts in the same call."""
    context = coll_modules()[4]
    L = cfg.num_layers
    ctx = context.initialize_distributed(devices=virtual_devices(TP),
                                         wait_timeout_ms=60_000)
    eng = Engine(cfg, params, ctx, max_seq=2048)
    check(eng.backend == "auto" and eng.page_size is None and eng.n == TP,
          "tp_engine: the defaults are not the reference's")
    g = torch.Generator(device="cuda").manual_seed(31)
    ids = torch.randint(0, cfg.vocab_size, (2, 1024), generator=g,
                        device="cuda", dtype=torch.int32)
    tree_ids = torch.randint(0, cfg.vocab_size, (1, TREE_MAIN_ROWS),
                             generator=g, device="cuda", dtype=torch.int32)
    check(eng._prefill_mode(2, 1024) == "overlap",
          "tp_engine: the 2 x 1024 prefill does not take 'overlap'")
    check(eng._prefill_mode(1, TREE_MAIN_ROWS) == "ar",
          "tp_engine: the 203-row prefill does not take 'ar'")
    rec = {"phase": "tp_engine", "ranks": TP, "layers": L,
           "dtype": cfg.dtype, "devices": [str(d) for d in ctx.devices],
           "note": "4 ranks share one card's SMs and HBM: these times say "
                   "nothing of four cards"}
    prev = os.environ.pop("TDTPU_GEMM_AR", None)
    try:
        eng.serve(ids[:, :64], 2)                                # warm-up
        defaults = tp_engine_run(
            torch, eng, kernels, ids, TP_ENGINE_GEN, name="tp_engine",
            expect={"ag_gemm": (5 * L, 0), "gemm_rs": (2 * L, 0),
                    "allreduce_parity": (0, 2 * L)})
        defaults["decode_profile"] = tp_profile(torch, eng, ids,
                                                steps=TP_PROFILE_STEPS)
        for k in ("ag_gemm", "gemm_rs"):
            check(defaults["fused_routes"][k] ==
                  {"wgmma": defaults["launches"][k]},
                  f"tp_engine: {k} left the wgmma route: "
                  f"{defaults['fused_routes'][k]}")
        rec["defaults"] = defaults
        os.environ["TDTPU_GEMM_AR"] = "1"
        fused = tp_engine_run(
            torch, eng, kernels, ids, TP_ENGINE_GEN,
            name="tp_engine_gemm_ar",
            expect={"ag_gemm": (5 * L, 0), "gemm_rs": (2 * L, 0),
                    "gemm_ar": (0, 2 * L)})
        fused["decode_profile"] = tp_profile(torch, eng, ids,
                                             steps=TP_PROFILE_STEPS)
        rec["gemm_ar"] = fused
        os.environ.pop("TDTPU_GEMM_AR")
        rec["tree"] = tp_engine_run(
            torch, eng, kernels, tree_ids, TP_TREE_GEN,
            name="tp_engine_tree",
            expect={"allreduce_tree": (2 * L, 0),
                    "allreduce_parity": (0, 2 * L)})
    finally:
        if prev is None:
            os.environ.pop("TDTPU_GEMM_AR", None)
        else:
            os.environ["TDTPU_GEMM_AR"] = prev
    del eng
    ctx.close()
    one = Engine(cfg, params, max_seq=2048)
    one.serve(ids[:, :64], 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tp1 = one.serve(ids, TP_ENGINE_GEN)
    torch.cuda.synchronize()
    rec["tp1_serve_s"] = time.perf_counter() - t0
    rec["tp1_tokens_per_s"] = 2 * TP_ENGINE_GEN / rec["tp1_serve_s"]
    for k in ("defaults", "gemm_ar", "tree"):
        toks = rec[k].pop("tokens")
        want = tp1 if k != "tree" else one.serve(tree_ids, TP_TREE_GEN)
        rec[k]["bf16_tokens_equal_tp1"] = bool(torch.equal(toks, want))
    rec["note_tokens"] = ("bf16 tokens may leave TP=1's where two logits "
                          "differ by less than the summation order moves "
                          "them; tp_engine_parity holds the tokens in fp32")
    del one
    return rec


def tp_rank_logits(torch, eng, ids, fused: bool) -> bool:
    """Every rank's logits bit for bit: the engine's prefill in its mode,
    then one linear decode step over a fresh parity (or, ``fused``, B11)
    workspace."""
    from triton_distributed_tpu_torch.models.dense import dense_decode_step
    from triton_distributed_tpu_torch.models.kv_cache import init_kv_cache
    from triton_distributed_tpu_torch.ops.allreduce import (
        ar_stream_workspace,
    )
    from triton_distributed_tpu_torch.ops.gemm_allreduce import (
        gemm_ar_stream_workspace,
    )

    cfg, n = eng.cfg, eng.n
    batch, seq = ids.shape
    mode = eng._prefill_mode(batch, seq)
    idr = eng.replicate(ids.cpu())
    make = gemm_ar_stream_workspace if fused else ar_stream_workspace
    ws, i0 = make(n, batch, cfg.hidden_size, getattr(torch, cfg.dtype),
                  ctx=eng.ctx, tag=f"rank-logits-{fused}")

    def run(r):
        cache = init_kv_cache(cfg, batch, eng.max_seq,
                              device=eng.rank_devices[r], num_ranks=n)
        pre, cache = eng._prefill_fn(eng.rank_params[r], cfg, idr[r], cache,
                                     **eng.tp_kwargs(mode))
        tok = pre.argmax(-1).to(torch.int32)
        dec, _, _ = dense_decode_step(eng.rank_params[r], cfg, tok, cache,
                                      ar_state=(ws, i0), fused_gemm_ar=fused,
                                      **eng.tp_kwargs("ar"))
        return pre, dec

    outs = eng.run(run)
    torch.cuda.synchronize()
    eng.check_comm()
    return all(torch.equal(outs[0][i], o[i].to(outs[0][i].device))
               for o in outs[1:] for i in (0, 1))


def phase_tp_engine_parity(torch, QWEN3_8B, init_dense_llm, Engine, kernels,
                           *, devices=None) -> dict:
    """float32 Qwen3-8B widths at 2 layers: ``Engine.serve`` on 4 ranks
    (virtual on cuda:0 unless ``devices``) gives TP=1's tokens with the
    defaults (2 x 64 prompt: "overlap" prefill, linear decode over the
    parity AR), under TDTPU_GEMM_AR=1 (B11), on a 1 x 203 prompt (the
    tree) and on backend="xla"; every rank's prefill and decode logits
    bit-identical."""
    context = coll_modules()[4]
    comm = coll_modules()[0]
    cfg = dataclasses.replace(QWEN3_8B, num_layers=2, dtype="float32")
    params = init_dense_llm(
        cfg, generator=torch.Generator(device="cuda").manual_seed(4))
    ctx = context.initialize_distributed(devices=devices or
                                         virtual_devices(TP),
                                         wait_timeout_ms=60_000)
    g = torch.Generator().manual_seed(29)
    ids = torch.randint(0, cfg.vocab_size, (2, 64), generator=g,
                        dtype=torch.int32)
    tree_ids = torch.randint(0, cfg.vocab_size, (1, TREE_MAIN_ROWS),
                             generator=g, dtype=torch.int32)
    one = Engine(cfg, params, max_seq=256)
    allk = list(kernels) + list(comm.COLLECTIVE_KERNELS)
    runs = {"defaults": ("auto", None, ids, ("ag_gemm", "gemm_rs",
                                             "allreduce_parity")),
            "gemm_ar": ("auto", "1", ids, ("ag_gemm", "gemm_rs", "gemm_ar")),
            "tree": ("auto", None, tree_ids, ("allreduce_tree",
                                              "allreduce_parity")),
            "xla": ("xla", None, ids, ())}
    result = {"phase": "tp_engine_parity", "ranks": TP, "layers": 2,
              "dtype": "float32", "devices": [str(d) for d in ctx.devices]}
    prev = os.environ.pop("TDTPU_GEMM_AR", None)
    try:
        for name, (backend, flag, prompt, kerns) in runs.items():
            if flag is None:
                os.environ.pop("TDTPU_GEMM_AR", None)
            else:
                os.environ["TDTPU_GEMM_AR"] = flag
            want = one.serve(prompt.cuda(), 16)
            eng = Engine(cfg, params, ctx, max_seq=256, backend=backend)
            reset_counts(allk)
            got = eng.serve(prompt, 16)
            c = _tp_counts(comm)
            check(all(c[k] > 0 for k in kerns),
                  f"tp_engine_parity {name}: a kernel of the path never "
                  f"ran: {c}")
            check(all(k.plain_calls == 0 for k in allk),
                  f"tp_engine_parity {name}: a plain version ran")
            same = torch.equal(got.cpu(), want.cpu())
            if not same:
                emit({"phase": "tp_engine_parity", "run": name,
                      "tp4": got.tolist(), "tp1": want.tolist()})
            check(same, f"tp_engine_parity {name}: TP=4 tokens differ from "
                  "TP=1's")
            entry = {"prompt": list(prompt.shape), "gen": 16,
                     "prefill_mode": eng._prefill_mode(*prompt.shape),
                     "identical_to_tp1": True, "launches": c}
            if name in ("defaults", "gemm_ar"):
                entry["rank_logits_bit_identical"] = tp_rank_logits(
                    torch, eng, prompt, name == "gemm_ar")
                check(entry["rank_logits_bit_identical"],
                      f"tp_engine_parity {name}: the ranks' logits differ")
            result[name] = entry
            del eng
    finally:
        if prev is None:
            os.environ.pop("TDTPU_GEMM_AR", None)
        else:
            os.environ["TDTPU_GEMM_AR"] = prev
    ctx.close()
    return result


# ---------------------------------------------------------------------------
# MoE over ranks: B4's full-mesh push, B8's AllToAll (both forms), the EP
# layer, and Qwen3-30B-A3B on a TP group of 4 virtual ranks.
# ---------------------------------------------------------------------------

A2A_RANKS = (2, 4, 8)
A2A_H = 2048                  # Qwen3-30B-A3B's hidden
A2A_EPR = 4                   # experts a rank in the synthetic cases
A2A_EXPERTS, A2A_TOPK = 128, 8  # Qwen3-30B-A3B's routing, for the main cases
A2A_CAPS = (32, 256)
# Main-path shapes (bf16, h 2048): the EP decode's 4 tokens a rank x top-8
# on 4 ranks (cap 32, the parity form), the EP prefill's 512 tokens a rank
# (cap 4096, the barrier form), and the sequential "overlap" TP-MoE's 2 x
# 1024 prefill at n = 2 (1024 rows a rank, the full-mesh push).
A2A_MAIN = {"a2a": 4096, "a2a_parity": 32}
AG_MESH_ROWS = (4, 64, 1024)
AG_MESH_MAIN = 1024
A2A_CALLS = 200
EP_RANKS = 4
EP_DECODE_TOKENS = 4
EP_STEPS = 4                # the EP layer's stream steps (was 8)
EP_PREFILL_TOKENS = 512
# bf16 EP-MoE against the one-rank form on the same tokens: the expert
# products are the same rows, the top-k combine a sum in another order
# (one bf16 rounding of outputs of magnitude ~1).
EP_TOL = {"bfloat16": dict(atol=2.0 ** -5, rtol=2.0 ** -5),
          "float32": dict(atol=1e-5, rtol=1e-5)}


def _bits(torch, t):
    """A tensor's bytes, for bit-for-bit comparison in any type."""
    return t.contiguous().view(torch.uint8)


def a2a_modules():
    import importlib

    return (importlib.import_module("triton_distributed_tpu_torch.ops._comm"),
            importlib.import_module(
                "triton_distributed_tpu_torch.ops.all_to_all"),
            importlib.import_module(
                "triton_distributed_tpu_torch.ops.allgather"),
            importlib.import_module(
                "triton_distributed_tpu_torch.runtime.context"))


def a2a_inputs(torch, n: int, cap: int, dtype, kind: str, seed: int):
    """The n ranks' send slots S (n, n, cap, h) — [d, p] rank d's rows for
    rank p — and splits (n, n, epr) int32, on the card. ``kind``: "empty"
    (one live row in the call), "ragged" (counts off every block edge),
    "full" (every slot full), "main" (the EP layer's dispatch: cap / 8
    tokens a rank, each routed to 8 distinct experts of 128 drawn
    uniformly, so epr = 128 / n and a slot holds what its experts got)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    epr = A2A_EPR
    if kind == "main":
        epr = A2A_EXPERTS // n
        scores = torch.rand((n, cap // A2A_TOPK, A2A_EXPERTS), generator=g)
        ids = scores.topk(A2A_TOPK, dim=-1).indices.reshape(n, -1)
        splits = torch.stack([torch.bincount(i, minlength=A2A_EXPERTS)
                              for i in ids]).reshape(n, n, epr)
        splits = splits.to(torch.int32)
    elif kind == "empty":
        splits = torch.zeros((n, n, epr), dtype=torch.int32)
        splits[0, 1 % n, 0] = 1
    elif kind == "full":
        splits = torch.zeros((n, n, epr), dtype=torch.int32)
        splits[..., 0] = cap
    elif kind == "ragged":
        splits = torch.randint(0, cap // epr + 1, (n, n, epr), generator=g,
                               dtype=torch.int32)
        splits[..., -1] = torch.clamp(splits[..., -1] - 3, min=0)
    S = (torch.randn((n, n, cap, A2A_H), generator=torch.Generator(
        device="cuda").manual_seed(seed), device="cuda") * 4).to(dtype)
    return S, splits.cuda()


def _token_rows(splits, cap: int) -> int:
    """The rows the splits hold, every slot's count at most ``cap``."""
    return int(splits.sum(-1).clamp(max=cap).sum().item())


def _a2a_bytes(S, splits) -> int:
    """What an AllToAll of these counts must move: each slot's rows and
    the splits, read once and written once (the kernel's rounding up to
    whole blocks is its own choice, not work the function needs)."""
    cap, h = S.shape[2], S.shape[3]
    return 2 * (_token_rows(splits, cap) * h * S.element_size()
                + splits.numel() * splits.element_size())


def a2a_case(torch, timer, ctx, form: str, dtype, cap: int, kind: str,
             seed: int, time_it: bool) -> dict:
    """One AllToAll on every rank of ``ctx`` (the barrier form "a2a" or the
    parity stream "a2a_parity", two calls so both parities run) against
    ``a2a_plain``: live rows and splits bit for bit on every rank."""
    _, a2a, _, _ = a2a_modules()
    n = ctx.num_ranks
    S, spl = a2a_inputs(torch, n, cap, dtype, kind, seed)
    block = a2a.default_block_rows(dtype)
    sends = [S[r].to(ctx.devices[r]) for r in range(n)]
    splits = [spl[r].to(ctx.devices[r]) for r in range(n)]
    if form == "a2a":
        def fn(r):
            return a2a.fast_all_to_all_local(sends[r], splits[r],
                                             num_ranks=n)
    else:
        ws, _ = a2a.a2a_stream_workspace(n, cap, A2A_H, dtype, ctx=ctx,
                                         tag=f"smoke-{kind}-{seed}")
        idx = list(ws.epochs)

        def fn(r):
            out, rs, _, idx[r] = a2a.fast_all_to_all_stream(
                sends[r], splits[r], ws, idx[r], num_ranks=n)
            return out, rs
    want, want_rs = a2a.a2a_plain(S, spl, block)
    bad = []
    for call in range(1 if form == "a2a" else 2):
        got = ctx.run(fn)
        torch.cuda.synchronize()
        ctx.raise_on_comm_error()
        for d, (out, rs) in enumerate(got):
            if not torch.equal(rs.to(spl.device), want_rs[d]):
                bad.append(f"call {call} rank {d} splits")
            rows = a2a.live_rows(want_rs[d], cap, block)
            for p in range(n):
                if not torch.equal(_bits(torch, out[p, :rows[p]].to(S.device)),
                                   _bits(torch, want[d, p, :rows[p]])):
                    bad.append(f"call {call} recv[{d},{p}]")
    rec = {"case": f"{form}_n{n}_{_dtype_name(dtype)}_cap{cap}_{kind}",
           "form": form, "n": n, "dtype": _dtype_name(dtype), "cap": cap,
           "hidden": A2A_H, "kind": kind, "block": block,
           "epr": spl.shape[-1], "token_rows": _token_rows(spl, cap),
           "moved_rows": sum(sum(a2a.live_rows(spl[d], cap, block))
                             for d in range(n)),
           "max_abs_err": 0.0 if not bad else float("nan"),
           "bit_identical": not bad, "wrong": bad[:8], "ok": not bad}
    if time_it:
        rec["bound_ms"], rec["bound_by"] = _bound_ms(_a2a_bytes(S, spl), 0,
                                                     "float32")
        rec["bound_note"] = ("every slot's token rows (its splits' sum) and "
                             "the splits, read once and written once, every "
                             "rank, through one card's HBM at 3.35 TB/s")
        rec["ms"], rec["host_ms_per_call"] = _coll_ms(torch, ctx, fn, 20)
        rec["plain_ms"] = timer.ms(lambda: a2a.a2a_plain(S, spl, block))
        rec["library_ms"] = timer.ms(lambda: S.transpose(0, 1).contiguous())
        rec["library_call"] = ("S.transpose(0, 1).contiguous() of the "
                               "(n, n, cap, h) slot matrix (every row)")
    return rec


def ag_mesh_case(torch, timer, ctx, dtype, rows: int, seed: int,
                 time_it: bool) -> dict:
    """B4's full-mesh push on every rank against ``ag_plain``, bit for
    bit. ``rows``: one rank's input rows (x A2A_H columns)."""
    _, _, ag, _ = a2a_modules()
    n = ctx.num_ranks
    X = (torch.randn((n, rows, A2A_H), generator=torch.Generator(
        device="cuda").manual_seed(seed), device="cuda") * 4).to(dtype)
    xs = [X[r].to(ctx.devices[r]) for r in range(n)]

    def fn(r):
        return ag.all_gather_local(xs[r], num_ranks=n,
                                   method="full_mesh_push")

    got = ctx.run(fn)
    torch.cuda.synchronize()
    ctx.raise_on_comm_error()
    want = ag.ag_plain(list(X))
    same = all(torch.equal(_bits(torch, o.to(X.device)), _bits(torch, want))
               for o in got)
    rec = {"case": f"ag_full_mesh_n{n}_{_dtype_name(dtype)}_{rows}",
           "n": n, "dtype": _dtype_name(dtype), "rows": rows,
           "cols": A2A_H, "max_abs_err": 0.0 if same else float("nan"),
           "bit_identical": same, "ok": same}
    if time_it:
        B = rows * A2A_H * X.element_size()
        rec["bound_ms"], rec["bound_by"] = _bound_ms(n * (B + n * B), 0,
                                                     "float32")
        rec["bound_note"] = ("every rank reads its chunk and writes the n "
                             "gathered chunks, through one card's HBM")
        # The push protocol moves exactly the bound's bytes: each rank's
        # chunk read once and written into the n outputs (no gather
        # buffer, no copy out).
        rec["bytes_moved"] = rec["bound_bytes"] = n * (B + n * B)
        rec["ms"], rec["host_ms_per_call"] = _coll_ms(torch, ctx, fn, 20)
        rec["plain_ms"] = timer.ms(lambda: ag.ag_plain(list(X)))
        xp = list(X)
        rec.update(library_every_rank(
            timer, n, lambda: torch.cat(xp),
            "torch.cat of the n chunks (one rank's gathered copy)"))
    return rec


# The push protocol's edge cases (csrc/push.cuh, B4's push and B7):
# payloads from one 16-byte vector to ~4 MB a rank, under one block's
# share and with odd tails over many blocks (rows x cols a rank), a
# held-back rank (2 ms on its stream before its call), and 200 calls back
# to back without a sync.
PUSH_TAILS = {"float32": ((1, 4), (3, 12), (5, 1028), (1000, 1028)),
              "bfloat16": ((1, 8), (3, 24), (5, 2056), (1000, 2056))}
PUSH_HOLD_NS = 2_000_000
PUSH_STREAM_CALLS = 200


def _push_perm(n: int) -> list:
    """A permutation that is not a ring: a multicast (rank 0 to itself and
    1 at n = 2; to n-1 and 1 beyond, the middle ranks idle, n-1 back to
    0); at one rank (0, 0) under ``force_kernel``."""
    if n == 1:
        return [(0, 0)]
    if n == 2:
        return [(0, 0), (0, 1)]
    return [(0, n - 1), (0, 1), (n - 1, 0)]


def _push_call(kind: str, x, n: int, perm, out=None):
    """One call of a push-protocol kernel on the calling rank; at n = 1
    under ``force_kernel`` (the loopback)."""
    _, ag, p2p, _ = sppp_modules()
    one = n == 1
    if kind == "ag_full_mesh":
        return ag.all_gather_local(x, num_ranks=n, method="full_mesh_push",
                                   force_kernel=one, out=out)
    if kind == "p2p_shift":
        return p2p.p2p_shift_local(x, 1, num_ranks=n, force_kernel=one,
                                   out=out)
    return p2p.p2p_permute_local(x, perm, num_ranks=n, force_kernel=one,
                                 out=out)


def _push_want(kind: str, X, n: int, perm) -> list:
    _, ag, p2p, _ = sppp_modules()
    if kind == "ag_full_mesh":
        return [ag.ag_plain(list(X))] * n
    plan = ([(s, (s + 1) % n) for s in range(n)] if kind == "p2p_shift"
            else perm)
    return p2p.p2p_plain(list(X), plan)


def push_case(torch, ctx, kind: str, dtype, rows: int, cols: int,
              seed: int, *, what: str, perm=None, hold=None) -> dict:
    """One call of ``kind`` (``"ag_full_mesh"``, ``"p2p_shift"``,
    ``"p2p_permute"``) on every rank of ``ctx`` into outputs filled with
    0xFF bytes (NaN in every payload type) through ``out=``, against the
    plain version bit for bit: a NaN left shows an element no sender
    wrote. ``hold``: (rank, ns) spun on that rank's stream before its
    call — a receiver publishing its address late, a sender writing late.
    Each rank launches the kernel once."""
    comm, _, _, _ = sppp_modules()
    from triton_distributed_tpu_torch.runtime.build import current_stream

    n = ctx.num_ranks
    perm = perm or _push_perm(n)
    X = _rand(torch, (n, rows, cols), dtype, seed)
    xs = [X[r].to(ctx.devices[r]) for r in range(n)]
    shape = (n * rows, cols) if kind == "ag_full_mesh" else (rows, cols)
    outs = [torch.empty(shape, dtype=dtype, device=ctx.devices[r])
            for r in range(n)]
    for o in outs:
        o.view(torch.uint8).fill_(0xFF)
    kern = {"ag_full_mesh": comm.AG_FULL_MESH_KERNEL,
            "p2p_shift": comm.P2P_SHIFT_KERNEL,
            "p2p_permute": comm.P2P_PERMUTE_KERNEL}[kind]
    k0 = kern.launches

    def fn(r):
        if hold is not None and r == hold[0]:
            comm.SPIN.launch(hold[1], current_stream(ctx.devices[r]))
        return _push_call(kind, xs[r], n, perm, out=outs[r])

    got = ctx.run(fn)
    torch.cuda.synchronize()
    ctx.raise_on_comm_error()
    want = _push_want(kind, X, n, perm)
    same = all(torch.equal(_bits(torch, o.to(X.device)), _bits(torch, w))
               for o, w in zip(got, want))
    launched = kern.launches - k0
    ok = same and all(g is o for g, o in zip(got, outs)) and launched == n
    return {"case": f"{kind}_{what}_n{n}_{_dtype_name(dtype)}_{rows}x{cols}",
            "kernel": kind, "n": n, "dtype": _dtype_name(dtype),
            "rows": rows, "cols": cols,
            "bytes_a_rank": rows * cols * X.element_size(),
            "perm": perm if kind == "p2p_permute" else None,
            "hold": list(hold) if hold else None, "out_sentinel": "0xFF",
            "launches": launched,
            "max_abs_err": 0.0 if same else float("nan"),
            "bit_identical": same, "ok": ok}


def push_stream_case(torch, ctx, kind: str, seed: int) -> dict:
    """PUSH_STREAM_CALLS calls of ``kind`` on every rank in one run, new
    data every call, no host sync between them: every call's output equal
    to the plain version's (a fast sender of call t+1 never writes call
    t's output)."""
    n = ctx.num_ranks
    perm = _push_perm(n)
    calls = PUSH_STREAM_CALLS
    X = _rand(torch, (calls, n, 16, 256), torch.bfloat16, seed)

    def loop(r):
        xr = X[:, r].to(ctx.devices[r])
        return [_push_call(kind, xr[t], n, perm) for t in range(calls)]

    got = ctx.run(loop)
    torch.cuda.synchronize()
    ctx.raise_on_comm_error()
    bad = []
    for t in range(calls):
        want = _push_want(kind, X[t], n, perm)
        if not all(torch.equal(_bits(torch, got[r][t].to(X.device)),
                               _bits(torch, want[r])) for r in range(n)):
            bad.append(t)
    return {"case": f"{kind}_stream{calls}_n{n}_bfloat16_16x256",
            "kernel": kind, "n": n, "calls": calls, "calls_wrong": bad[:8],
            "max_abs_err": 0.0 if not bad else float("nan"),
            "bit_identical": not bad, "ok": not bad}


# B6 on the push protocol (the owner reads): chunks of 1-2048 rows (rows x
# cols a chunk, 16 bytes to ~8 MB), at n = 2, 3, 4 and 8.
RS_EDGE = {"float32": ((1, 4), (3, 12), (1000, 1028), (2048, 1028)),
           "bfloat16": ((1, 8), (3, 24), (1000, 2056), (2048, 2056))}
RS_NAN_CALLS = 20


def rs_case(torch, ctx, dtype, chunk: int, cols: int, seed: int, *,
            what: str, hold=None, calls: int = 1, nan_source=None) -> dict:
    """``calls`` ring reduce-scatters on every rank of ``ctx`` in one run,
    no host sync between them, new inputs every call, each rank's chunk
    against ``rs_ring_plain`` bit for bit, every call on the kernel.
    ``hold``: (rank, ns) spun on that rank's stream before each of its
    calls — a late source (its peers wait for its address) and a late
    owner (its peers' exits wait for its release). ``nan_source``: that
    rank fills its input with NaN on its own stream right after each
    call: a source whose kernel ended before an owner finished reading
    (a missing exit wait) would hand that owner NaN."""
    comm, _, rs, _, _ = coll_modules()
    from triton_distributed_tpu_torch.runtime.build import current_stream

    n = ctx.num_ranks
    X = _rand(torch, (calls, n, n * chunk, cols), dtype, seed)
    want = [[rs.rs_ring_plain(list(X[t]), r) for r in range(n)]
            for t in range(calls)]
    ins = [X[:, r].to(ctx.devices[r]).clone() for r in range(n)]
    k0 = comm.RS_RING_KERNEL.launches

    def loop(r):
        outs = []
        for t in range(calls):
            if hold is not None and r == hold[0]:
                comm.SPIN.launch(hold[1], current_stream(ctx.devices[r]))
            outs.append(rs.reduce_scatter_local(ins[r][t], num_ranks=n))
            if r == nan_source:
                ins[r][t].fill_(float("nan"))
        return outs

    got = ctx.run(loop)
    torch.cuda.synchronize()
    ctx.raise_on_comm_error()
    bad = [t for t in range(calls) if not all(
        torch.equal(_bits(torch, got[r][t].to(X.device)),
                    _bits(torch, want[t][r])) for r in range(n))]
    launched = comm.RS_RING_KERNEL.launches - k0
    return {"case": f"reduce_scatter_ring_{what}_n{n}_{_dtype_name(dtype)}"
                    f"_{chunk}x{cols}", "method": "reduce_scatter_ring",
            "n": n, "dtype": _dtype_name(dtype), "rows": n * chunk,
            "chunk_rows": chunk, "cols": cols, "calls": calls,
            "hold": list(hold) if hold else None, "nan_source": nan_source,
            "launches": launched, "calls_wrong": bad[:8],
            "max_abs_err": 0.0 if not bad else float("nan"),
            "bit_identical": not bad,
            "ok": not bad and launched == n * calls}


def rs_edge_cases(torch, ctx, seed: int) -> list:
    """B6's edge cases on ``ctx``: the chunks of RS_EDGE in fp32 and bf16;
    a held-back rank 0 and rank n - 1 (each a late source and a late
    owner); RS_NAN_CALLS calls with rank n - 1 filling its input with NaN
    after each and rank 0 held back 100 us before each (its reads of rank
    n - 1's chunk come late); PUSH_STREAM_CALLS calls without a sync."""
    n = ctx.num_ranks
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        for chunk, cols in RS_EDGE[_dtype_name(dtype)]:
            seed += 1
            out.append(rs_case(torch, ctx, dtype, chunk, cols, seed,
                               what="tail"))
    for held in (0, n - 1):
        seed += 1
        out.append(rs_case(torch, ctx, torch.bfloat16, 64, 4096, seed,
                           what=f"held{held}", hold=(held, PUSH_HOLD_NS)))
    seed += 1
    out.append(rs_case(torch, ctx, torch.bfloat16, 64, 4096, seed,
                       what="nan_after", calls=RS_NAN_CALLS,
                       hold=(0, 100_000), nan_source=n - 1))
    seed += 1
    out.append(rs_case(torch, ctx, torch.bfloat16, 16, 256, seed,
                       what="stream", calls=PUSH_STREAM_CALLS))
    return out


def a2a_sentinel_case(torch, ctx, dtype, cap: int, kind: str, seed: int,
                      hold=None) -> dict:
    """One parity-stream AllToAll on every rank of ``ctx`` into outputs and
    splits filled with 0xFF bytes (NaN in every payload type, -1 in the
    splits) through ``out=`` / ``out_splits=``, against ``a2a_plain``:
    live rows and splits bit for bit, each output the one handed in, one
    launch a rank (at one rank under ``force_kernel``: the loopback).
    ``hold``: (rank, ns) spun on that rank's stream before its call — a
    late receiver (its senders wait for its addresses) and a late sender."""
    comm, a2a, _, _ = a2a_modules()
    from triton_distributed_tpu_torch.runtime.build import current_stream

    n = ctx.num_ranks
    S, spl = a2a_inputs(torch, n, cap, dtype, kind, seed)
    block = a2a.default_block_rows(dtype)
    ws, _ = a2a.a2a_stream_workspace(n, cap, A2A_H, dtype, ctx=ctx,
                                     tag=f"sentinel-{kind}-{seed}")
    sends = [S[r].to(ctx.devices[r]) for r in range(n)]
    splits = [spl[r].to(ctx.devices[r]) for r in range(n)]
    outs = [torch.empty_like(x) for x in sends]
    osps = [torch.empty_like(x) for x in splits]
    for t in outs + osps:
        t.view(torch.uint8).fill_(0xFF)
    k0 = comm.A2A_PARITY_KERNEL.launches

    def fn(r):
        if hold is not None and r == hold[0]:
            comm.SPIN.launch(hold[1], current_stream(ctx.devices[r]))
        return a2a.fast_all_to_all_stream(
            sends[r], splits[r], ws, ws.epochs[r], num_ranks=n,
            force_kernel=n == 1, out=outs[r], out_splits=osps[r])

    got = ctx.run(fn)
    torch.cuda.synchronize()
    ctx.raise_on_comm_error()
    want, want_rs = a2a.a2a_plain(S, spl, block)
    bad = []
    for d, (out, rs, _, _) in enumerate(got):
        if out is not outs[d] or rs is not osps[d]:
            bad.append(f"rank {d} not its out=")
        if not torch.equal(rs.to(spl.device), want_rs[d]):
            bad.append(f"rank {d} splits")
        rows = a2a.live_rows(want_rs[d], cap, block)
        for p in range(n):
            if not torch.equal(_bits(torch, out[p, :rows[p]].to(S.device)),
                               _bits(torch, want[d, p, :rows[p]])):
                bad.append(f"recv[{d},{p}]")
    launched = comm.A2A_PARITY_KERNEL.launches - k0
    what = f"held{hold[0]}" if hold else "sentinel"
    return {"case": f"a2a_parity_{what}_n{n}_{_dtype_name(dtype)}_cap{cap}"
                    f"_{kind}", "form": "a2a_parity", "n": n,
            "dtype": _dtype_name(dtype), "cap": cap, "hidden": A2A_H,
            "kind": kind, "block": block, "out_sentinel": "0xFF",
            "hold": list(hold) if hold else None, "launches": launched,
            "max_abs_err": 0.0 if not bad else float("nan"),
            "bit_identical": not bad, "wrong": bad[:8],
            "ok": not bad and launched == n}


def a2a_edge_cases(torch, ctx, seed: int) -> list:
    """B8's parity stream on the push protocol at its edges on ``ctx``:
    empty, ragged and full slots in fp32, bf16 and e4m3 into 0xFF-filled
    outputs (cap 32); at n > 1 a held-back rank 0 and rank n - 1 (bf16,
    ragged, cap 256). ``a2a_stress`` (200 calls, a rotating straggler) and
    ``a2a_one_rank`` run beside these in ``phase_a2a``."""
    n = ctx.num_ranks
    out = []
    for dtype in (torch.float32, torch.bfloat16, torch.float8_e4m3fn):
        for kind in ("empty", "ragged", "full"):
            seed += 1
            out.append(a2a_sentinel_case(torch, ctx, dtype, 32, kind, seed))
    if n > 1:
        for held in (0, n - 1):
            seed += 1
            out.append(a2a_sentinel_case(torch, ctx, torch.bfloat16, 256,
                                         "ragged", seed,
                                         hold=(held, PUSH_HOLD_NS)))
    return out


def push_edge_cases(torch, ctx, kinds, seed: int) -> list:
    """The push protocol's edge cases for each kernel of ``kinds`` on
    ``ctx``: B6 (``"rs_ring"``: ``rs_edge_cases``) and B8's parity stream
    (``"a2a_parity"``: ``a2a_edge_cases``) their own; the copy kernels the
    tails of PUSH_TAILS in fp32 and bf16, a held-back receiver and a
    held-back sender, and the 200-call stream. At one rank the loopback
    (``force_kernel``): the tails and the stream."""
    n = ctx.num_ranks
    out = []
    for kind in kinds:
        if kind in ("rs_ring", "a2a_parity"):
            edge = rs_edge_cases if kind == "rs_ring" else a2a_edge_cases
            out += edge(torch, ctx, seed)
            seed += 50
            continue
        for dtype in (torch.float32, torch.bfloat16):
            for rows, cols in PUSH_TAILS[_dtype_name(dtype)]:
                seed += 1
                out.append(push_case(torch, ctx, kind, dtype, rows, cols,
                                     seed, what="tail"))
        if n > 1:
            # B7: a lone pair, so the receiver and the sender are distinct
            # ranks (rank 1 and rank 0); the push: every rank is both.
            pair = [(0, 1)] if kind == "p2p_permute" else None
            holds = ({"held_receiver": 1, "held_sender": 0}
                     if kind == "p2p_permute" else {"held_rank": n - 1})
            for what, rank in holds.items():
                seed += 1
                out.append(push_case(torch, ctx, kind, torch.bfloat16, 64,
                                     2048, seed, what=what, perm=pair,
                                     hold=(rank, PUSH_HOLD_NS)))
        seed += 1
        out.append(push_stream_case(torch, ctx, kind, seed))
    return out


def a2a_stress(torch, ctx, dtype, cap: int, calls: int) -> dict:
    """``calls`` parity AllToAlls on every rank over one workspace, new
    data and new counts every call (empty slots among them), a rotating
    rank held back 50 us on every third: every call's live rows and
    splits equal to the plain version's."""
    _, a2a, _, _ = a2a_modules()
    n = ctx.num_ranks
    block = a2a.default_block_rows(dtype)
    g = torch.Generator(device="cpu").manual_seed(91)
    spl = torch.randint(0, cap // A2A_EPR + 1, (calls, n, n, A2A_EPR),
                        generator=g, dtype=torch.int32)
    spl[::5, 0] = 0                                 # a silent rank
    X = (torch.randn((calls, n, n, cap, A2A_H), device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(92))
         ).to(dtype)
    spl_d = spl.cuda()
    ws, _ = a2a.a2a_stream_workspace(n, cap, A2A_H, dtype, ctx=ctx,
                                     tag="stress")
    comm = a2a_modules()[0]
    k0 = comm.A2A_PARITY_KERNEL.launches

    def loop(r):
        idx, outs = ws.epochs[r], []
        xr = X[:, r].to(ctx.devices[r])
        sr = spl_d[:, r].to(ctx.devices[r])
        for t in range(calls):
            strag = ("rotate", 50_000) if t % 3 == 0 else None
            out, rs, _, idx = a2a.fast_all_to_all_stream(
                xr[t], sr[t], ws, idx, num_ranks=n, straggler=strag)
            outs.append((out.to(X.device), rs.to(X.device)))
        return outs

    got = ctx.run(loop)
    torch.cuda.synchronize()
    ctx.raise_on_comm_error()
    bad = []
    for t in range(calls):
        want, want_rs = a2a.a2a_plain(X[t], spl_d[t], block)
        for d in range(n):
            out, rs = got[d][t]
            rows = a2a.live_rows(want_rs[d], cap, block)
            if not torch.equal(rs, want_rs[d]) or not all(
                    torch.equal(_bits(torch, out[p, :rows[p]]),
                                _bits(torch, want[d, p, :rows[p]]))
                    for p in range(n)):
                bad.append((t, d))
    launched = comm.A2A_PARITY_KERNEL.launches - k0
    return {"calls": calls, "n": n, "cap": cap, "dtype": _dtype_name(dtype),
            "straggler": "rotate, 50 us, every third call",
            "launches": launched, "calls_wrong": bad[:16],
            "ok": not bad and launched == n * calls}


def a2a_one_rank(torch, ctx) -> dict:
    """The parity stream on a group of one rank: without ``force_kernel``
    it hands its input back and launches nothing; with it, three calls
    (both parities) each launch the kernel once and return the live rows
    and splits bit for bit."""
    comm, a2a, _, _ = a2a_modules()
    S, spl = a2a_inputs(torch, 1, 32, torch.bfloat16, "ragged", 470)
    ws, idx = a2a.a2a_stream_workspace(1, 32, A2A_H, torch.bfloat16, ctx=ctx,
                                       tag="smoke-one-rank")
    block = a2a.default_block_rows(torch.bfloat16)
    x, sp = S[0], spl[0]
    before = comm.A2A_PARITY_KERNEL.launches

    def call(force):
        def fn(r):
            return a2a.fast_all_to_all_stream(x, sp, ws, idx, num_ranks=1,
                                              force_kernel=force)
        return ctx.run(fn)[0]

    out, rs, _, _ = call(False)         # leaves the workspace's index
    same = out is x and torch.equal(rs, sp)
    untouched = comm.A2A_PARITY_KERNEL.launches == before
    for _ in range(3):
        out, rs, _, idx = call(True)
        torch.cuda.synchronize()
        ctx.raise_on_comm_error()
        rows = a2a.live_rows(sp, 32, block)[0]
        same = (same and torch.equal(rs, sp)
                and torch.equal(_bits(torch, out[0, :rows]),
                                _bits(torch, x[0, :rows])))
    launched = comm.A2A_PARITY_KERNEL.launches - before
    return {"calls": 3, "launches": launched, "bit_identical": same,
            "ok": same and untouched and launched == 3}


def a2a_timeouts(torch, devices) -> dict:
    """100 ms deadlines. A lost peer — rank n-1 never calls the barrier
    form — leaves the others at the launch's host meeting: ``ctx.run``
    raises CommTimeoutError. A peer held back 1 s on the device before
    its parity call, or before its full-mesh push (its address published
    late), leaves the others' kernels spinning on its flags: they time
    out and ``raise_on_comm_error`` raises."""
    comm, a2a, ag, context = a2a_modules()
    from triton_distributed_tpu_torch.runtime.build import current_stream

    out = {}
    for what in ("lost_peer", "held_back_peer", "push_held_back_peer"):
        ctx = context.DistContext([torch.device(d) for d in devices],
                                  wait_timeout_ms=100)
        n = ctx.num_ranks
        x = torch.ones((n, 32, A2A_H), device="cuda")
        s = torch.full((n, A2A_EPR), 2, dtype=torch.int32, device="cuda")
        ws, _ = a2a.a2a_stream_workspace(n, 32, A2A_H, torch.float32,
                                         ctx=ctx, tag="timeout")
        t0 = time.perf_counter()
        raised = None
        try:
            if what == "lost_peer":
                ctx.run(lambda r: None if r == n - 1 else
                        a2a.fast_all_to_all_local(x.to(ctx.devices[r]),
                                                  s.to(ctx.devices[r]),
                                                  num_ranks=n))
            elif what == "push_held_back_peer":
                def held(r):
                    if r == n - 1:
                        comm.SPIN.launch(1_000_000_000,
                                         current_stream(ctx.devices[r]))
                    return ag.all_gather_local(x[r].to(ctx.devices[r]),
                                               num_ranks=n,
                                               method="full_mesh_push")

                ctx.run(held)
            else:
                ctx.run(lambda r: a2a.fast_all_to_all_stream(
                    x.to(ctx.devices[r]), s.to(ctx.devices[r]), ws, 0,
                    num_ranks=n, straggler=(n - 1, 1_000_000_000)))
            torch.cuda.synchronize()
            ctx.raise_on_comm_error()
        except context.CommTimeoutError as exc:
            raised = str(exc)
        torch.cuda.synchronize()
        out[what] = {"raised": raised, "wall_s": time.perf_counter() - t0}
        ctx.close()
    return {"n": len(devices), "timeout_ms": 100, **out,
            "ok": all(v["raised"] for v in out.values())}


def phase_a2a(torch, timer, *, devices_for=virtual_devices,
              ranks=A2A_RANKS, name="collectives_a2a") -> dict:
    """B8's two kernels and B4's full-mesh push at n = 2, 4 and 8, fp32,
    bf16 and e4m3, against their plain versions bit for bit: the
    AllToAll with empty, ragged and full slots at caps 32 and 256 (h
    2048), the full-mesh push at 4, 64 and 1024 rows a rank and the push
    protocol's edge cases of it and of the parity stream
    (``push_edge_cases``: tails / slots into 0xFF-filled outputs, held-back
    ranks, 200 calls without a sync; the loopback at one rank); each
    timed at its main-path shape
    (n = 4 for B8, n = 2 for the push; bf16); 200 parity calls with a
    rotating straggler; a lost and a held-back peer raising
    CommTimeoutError, for the push too."""
    _, _, _, context = a2a_modules()
    e4m3 = torch.float8_e4m3fn
    cases: dict = {"a2a": [], "a2a_parity": [], "ag_full_mesh": []}
    seed = 400
    stress = None
    for n in ranks:
        ctx = context.DistContext([torch.device(d) for d in devices_for(n)],
                                  wait_timeout_ms=20_000)
        for dtype in (torch.float32, torch.bfloat16, e4m3):
            dn = _dtype_name(dtype)
            for form in ("a2a", "a2a_parity"):
                for cap in A2A_CAPS:
                    for kind in ("empty", "ragged", "full"):
                        seed += 1
                        cases[form].append(a2a_case(
                            torch, timer, ctx, form, dtype, cap, kind, seed,
                            time_it=False))
                if n == EP_RANKS and dn == "bfloat16":
                    seed += 1
                    cases[form].append(a2a_case(
                        torch, timer, ctx, form, dtype, A2A_MAIN[form],
                        "main", seed, time_it=True))
            for rows in AG_MESH_ROWS:
                seed += 1
                cases["ag_full_mesh"].append(ag_mesh_case(
                    torch, timer, ctx, dtype, rows, seed,
                    time_it=(n == 2 and dn == "bfloat16"
                             and rows == AG_MESH_MAIN)))
        cases["ag_full_mesh"] += push_edge_cases(torch, ctx,
                                                 ("ag_full_mesh",), seed)
        cases["a2a_parity"] += push_edge_cases(torch, ctx, ("a2a_parity",),
                                               seed + 50)
        seed += 100
        if n == EP_RANKS:
            stress = a2a_stress(torch, ctx, torch.bfloat16, 32, A2A_CALLS)
        ctx.close()
        del ctx
        torch.cuda.empty_cache()
    tmo = a2a_timeouts(torch, devices_for(EP_RANKS))
    ctx = context.DistContext([torch.device(devices_for(1)[0])],
                              wait_timeout_ms=20_000)
    one = a2a_one_rank(torch, ctx)
    cases["ag_full_mesh"] += push_edge_cases(torch, ctx, ("ag_full_mesh",),
                                             seed)
    cases["a2a_parity"] += push_edge_cases(torch, ctx, ("a2a_parity",),
                                           seed + 50)
    ctx.close()
    bad = [c["case"] for cs in cases.values() for c in cs if not c["ok"]]
    check(not bad, f"{name}: disagree with their plain versions: {bad}")
    check(one["ok"], f"{name}: the parity stream at n = 1: {one}")
    check(stress is not None and stress["ok"],
          f"{name}: parity stress wrong at {stress and stress['calls_wrong']}")
    check(tmo["ok"], f"{name}: a lost or held-back peer did not raise "
          "CommTimeoutError")
    return {"phase": name, "devices": devices_for(EP_RANKS),
            "tolerance": "bit-identical to the plain version on every rank "
            "(live rows and splits; rows past a slot's count are "
            "unspecified)", "main_shapes": {
                "a2a": f"n = {EP_RANKS}, bf16, cap {A2A_MAIN['a2a']}",
                "a2a_parity": f"n = {EP_RANKS}, bf16, cap "
                              f"{A2A_MAIN['a2a_parity']}",
                "ag_full_mesh": f"n = 2, bf16, {AG_MESH_MAIN} rows a rank"},
            "parity_stress": stress, "timeout": tmo,
            "one_rank_force_kernel": one, "cases": cases}


def a2a_main_case(rec, form) -> dict:
    if form == "ag_full_mesh":
        return next(c for c in rec["cases"][form] if c["n"] == 2
                    and c["dtype"] == "bfloat16" and c["rows"] == AG_MESH_MAIN)
    return next(c for c in rec["cases"][form] if c["kind"] == "main")


def _moe_layer_views(params, r: int, n: int) -> list:
    """Rank r's EP shard of every MoE layer: dim-0 views of the expert
    stacks (no copy), the router shared."""
    out = []
    for layer in params["layers"]:
        p = layer["moe"]
        e = p["w_gate"].shape[0] // n
        out.append({"router": p["router"],
                    **{k: p[k][r * e:(r + 1) * e]
                       for k in ("w_gate", "w_up", "w_down")}})
    return out


def _close(torch, got, want, tol) -> dict:
    diff = (got.float() - want.float()).abs()
    share = (diff / (tol["atol"] + tol["rtol"] * want.float().abs())).max()
    return {"max_abs_err": diff.max().item(), "tol_share": share.item(),
            "ok": bool(torch.isfinite(got).all().item()
                       and share.item() <= 1.0)}


def ep_run(torch, ep, layers, ctx, x, *, topk, steps: int, stream: bool,
           name: str) -> dict:
    """Tokens ``x`` (n·t, h), t a rank, through every layer of ``layers``
    (x <- rms-normalised x + moe(x)) on the EP layer, ``steps`` times:
    the stream form threads one (ws, call_index) through every layer and
    step (two parity calls a layer), the barrier form launches two
    AllToAlls a layer.
    Each layer's output is held against ``ep_moe_fwd`` at n = 1 on the
    gathered tokens (``EP_TOL``). Returns errors, the EP time a layer
    (host clock around a synced run, all ranks), launches."""
    comm, a2a, _, _ = a2a_modules()
    n = ctx.num_ranks
    t = x.shape[0] // n
    h = x.shape[1]
    views = [_moe_layer_views({"layers": layers}, r, n) for r in range(n)]
    cap = -(-(t * topk) // 16) * 16
    ws, _ = a2a.a2a_stream_workspace(n, cap, h, x.dtype, ctx=ctx,
                                     tag=f"ep-{name}")
    idx = list(ws.epochs)
    tol = EP_TOL[_dtype_name(x.dtype)]
    worst = {"max_abs_err": 0.0, "tol_share": 0.0, "ok": True}
    reset_counts(comm.COLLECTIVE_KERNELS)
    ep_s = 0.0
    for _ in range(steps):
        for li, layer in enumerate(layers):
            xs = [x[r * t:(r + 1) * t].to(ctx.devices[r]) for r in range(n)]

            def body(r):
                if not stream:
                    return ep.ep_moe_fwd(views[r][li], xs[r], topk,
                                         num_ranks=n)
                y, (_, idx[r]) = ep.ep_moe_fwd(views[r][li], xs[r], topk,
                                               num_ranks=n,
                                               a2a_state=(ws, idx[r]))
                return y

            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ys = ctx.run(body)
            torch.cuda.synchronize()
            ep_s += time.perf_counter() - t0
            y = torch.cat([o.to(x.device) for o in ys])
            want = ep.ep_moe_fwd(layer["moe"], x, topk)
            c = _close(torch, y, want, tol)
            if c["tol_share"] >= worst["tol_share"]:
                worst = dict(c, layer=li)
            worst["ok"] = worst["ok"] and c["ok"]
            # The next layer's input: the residual sum at unit rms, so 48
            # layers of random experts neither vanish nor overflow.
            z = (x + y).float()
            x = (z * torch.rsqrt(z.pow(2).mean(-1, keepdim=True) + 1e-6)
                 ).to(x.dtype)
    ctx.raise_on_comm_error()
    calls = steps * len(layers)
    launches = {"a2a": comm.A2A_KERNEL.launches,
                "a2a_parity": comm.A2A_PARITY_KERNEL.launches}
    want_l = ({"a2a": 0, "a2a_parity": 2 * n * calls} if stream
              else {"a2a": 2 * n * calls, "a2a_parity": 0})
    check(launches == want_l, f"ep_moe {name}: launches {launches}, "
          f"expected {want_l}")
    check(all(k.plain_calls == 0 for k in comm.COLLECTIVE_KERNELS),
          f"ep_moe {name}: a plain version ran")
    check(worst["ok"], f"ep_moe {name}: disagrees with the one-rank form "
          f"({worst})")
    return {"tokens_per_rank": t, "layers": len(layers), "steps": steps,
            "form": "stream" if stream else "barrier", "cap": cap,
            "dtype": _dtype_name(x.dtype), "tol": tol, "vs_one_rank": worst,
            "ep_ms_per_layer": ep_s * 1e3 / calls, "launches": launches,
            "parity_calls_per_rank": launches["a2a_parity"] // n}


def phase_ep_moe(torch, params, cfg) -> dict:
    """The EP layer at Qwen3-30B-A3B's MoE widths (128 experts, h 2048,
    ffn 768, top-8) on 4 virtual ranks, 32 experts a rank as dim-0 views
    of the one-rank expert stacks (``params``, bf16, 48 layers): 4 tokens
    a rank through all 48 layers for EP_STEPS steps on the parity stream
    (2 x 48 parity calls a rank a step), then 512 tokens a rank through
    the barrier
    form; each layer held against the one-rank form on the gathered
    tokens; the layer's time against ``moe_tp_fwd_local`` on the same
    tokens at one rank. Then fp32 at 2 layers, both forms, tightly."""
    import importlib

    from triton_distributed_tpu_torch.layers.ep_moe import init_ep_moe

    ep = importlib.import_module("triton_distributed_tpu_torch.layers.ep_moe")
    moe = importlib.import_module("triton_distributed_tpu_torch.ops.moe")
    _, _, _, context = a2a_modules()
    topk, h = cfg.num_experts_per_tok, cfg.hidden_size
    ctx = context.DistContext([torch.device(d)
                               for d in virtual_devices(EP_RANKS)],
                              wait_timeout_ms=60_000)
    g = torch.Generator(device="cuda").manual_seed(61)
    rec = {"phase": "ep_moe", "ranks": EP_RANKS, "model": "Qwen3-30B-A3B",
           "experts_per_rank": cfg.num_experts // EP_RANKS,
           "note": "4 ranks share one card's SMs and HBM"}
    layers = params["layers"]
    x = torch.randn((EP_RANKS * EP_DECODE_TOKENS, h), generator=g,
                    device="cuda").to(torch.bfloat16)
    rec["decode_stream"] = ep_run(torch, ep, layers, ctx, x, topk=topk,
                                  steps=EP_STEPS, stream=True, name="decode")
    x = torch.randn((EP_RANKS * EP_PREFILL_TOKENS, h), generator=g,
                    device="cuda").to(torch.bfloat16)
    rec["prefill_barrier"] = ep_run(torch, ep, layers, ctx, x, topk=topk,
                                    steps=1, stream=False, name="prefill")
    # The TP-MoE at one rank on the same tokens, a layer.
    for key, rows in (("decode_stream", EP_DECODE_TOKENS),
                      ("prefill_barrier", EP_PREFILL_TOKENS)):
        xt = torch.randn((EP_RANKS * rows, h), generator=g,
                         device="cuda").to(torch.bfloat16)
        p = layers[0]["moe"]
        fn = lambda: moe.moe_tp_fwd_local(  # noqa: E731
            xt, p["router"], p["w_gate"], p["w_up"], p["w_down"], topk,
            num_ranks=1)
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        rec[key]["tp1_moe_ms_per_layer"] = (time.perf_counter() - t0) * 200
    # fp32, 2 layers: tight.
    f32 = [{"moe": init_ep_moe(h, cfg.moe_intermediate_size, cfg.num_experts,
                               torch.float32, generator=g)}
           for _ in range(2)]
    for form, rows in (("stream", EP_DECODE_TOKENS),
                       ("barrier", EP_PREFILL_TOKENS)):
        x = torch.randn((EP_RANKS * rows, h), generator=g, device="cuda")
        rec[f"fp32_{form}"] = ep_run(torch, ep, f32, ctx, x, topk=topk,
                                     steps=2, stream=form == "stream",
                                     name=f"fp32-{form}")
    ctx.close()
    return rec


def moe_overlap_layer(torch, cfg) -> dict:
    """The sequential "overlap" TP-MoE (``moe_tp_fwd_local(mode="overlap")``)
    on 2 virtual ranks at Qwen3-30B-A3B's MoE widths, one layer of fresh
    bf16 experts (ffn sharded 2 ways) on a 2 x 1024 prefill's 1024 rows a
    rank: the tokens gathered through B4's full-mesh push (AUTO's pick at
    n = 2, one launch a rank), held against the one-rank MoE on all 2048
    rows (``EP_TOL``); its time against the ring form's."""
    from triton_distributed_tpu_torch.layers.ep_moe import init_ep_moe
    from triton_distributed_tpu_torch.ops import moe

    comm, _, _, context = a2a_modules()
    n, h, topk = 2, cfg.hidden_size, cfg.num_experts_per_tok
    g = torch.Generator(device="cuda").manual_seed(71)
    p = init_ep_moe(h, cfg.moe_intermediate_size, cfg.num_experts,
                    torch.bfloat16, generator=g)
    x = torch.randn((2048, h), generator=g, device="cuda").to(torch.bfloat16)
    ctx = context.DistContext([torch.device(d) for d in virtual_devices(n)],
                              wait_timeout_ms=60_000)
    f = cfg.moe_intermediate_size // n
    shards = [(p["w_gate"][:, :, r * f:(r + 1) * f].contiguous(),
               p["w_up"][:, :, r * f:(r + 1) * f].contiguous(),
               p["w_down"][:, r * f:(r + 1) * f].contiguous())
              for r in range(n)]
    rows = x.shape[0] // n
    rec = {"ranks": n, "rows_per_rank": rows}
    want = moe.moe_tp_fwd_local(x, p["router"], p["w_gate"], p["w_up"],
                                p["w_down"], topk, num_ranks=1)
    for mode in ("overlap", "ring"):
        def body(r):
            return moe.moe_tp_fwd_local(x[r * rows:(r + 1) * rows],
                                        p["router"], *shards[r], topk,
                                        num_ranks=n, mode=mode)

        ctx.run(body)                                  # warm-up
        torch.cuda.synchronize()
        reset_counts(comm.COLLECTIVE_KERNELS)
        t0 = time.perf_counter()
        ys = ctx.run(body)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        ctx.raise_on_comm_error()
        c = _close(torch, torch.cat(ys), want, EP_TOL["bfloat16"])
        rec[mode] = dict(c, ms=ms, launches=_tp_counts(comm))
        check(c["ok"], f"moe_overlap_layer {mode}: disagrees with one rank "
              f"({c})")
        check(all(k.plain_calls == 0 for k in comm.COLLECTIVE_KERNELS),
              f"moe_overlap_layer {mode}: a plain version ran")
    check(rec["overlap"]["launches"]["ag_full_mesh"] == n,
          f"moe_overlap_layer: the full-mesh push launched "
          f"{rec['overlap']['launches']['ag_full_mesh']} times, expected {n}")
    check(rec["ring"]["launches"]["reduce_scatter_ring"] == n,
          "moe_overlap_layer: the ring form's RS did not run once a rank")
    ctx.close()
    return rec


def phase_tp_moe_engine(torch, params, cfg, Engine, kernels, ServingEngine,
                        prompts) -> tuple:
    """Qwen3-30B-A3B at full width and depth, bf16: TP=1's
    ``Engine(cfg, params, max_seq=2048).serve`` of a 2 x 1024 prompt for
    TP_MOE_GEN tokens, then ``params`` sharded over 4 virtual ranks leaf by
    leaf
    (``shard_params(consume=True)``: the full tree is emptied as its shards
    are made, 61 GB never held twice) and the TP engine's serve with the
    defaults — prefill "overlap" (B9 3 a layer: q, k, v; B10 1: o; the
    ring TP-MoE's RS 1), linear decode (the parity AR 2 a layer a step:
    attention's and the MoE combine's) — counts exact; the decode profile;
    the sequential "overlap" MoE layer at n = 2 (the full-mesh push).
    Then ``tp_moe_serving``: ServingEngine (page 16) on the same shards,
    the TP_MOE_SERVING_PROMPTS shortest serving prompts x
    TP_MOE_SERVING_GEN tokens, and a 2-step decode
    window.
    Returns the two records; ``params`` is empty afterwards."""
    from triton_distributed_tpu_torch.models.convert import shard_params

    comm, _, _, context = a2a_modules()
    L = cfg.num_layers
    g = torch.Generator(device="cuda").manual_seed(33)
    ids = torch.randint(0, cfg.vocab_size, (2, 1024), generator=g,
                        device="cuda", dtype=torch.int32)
    rec = {"phase": "tp_moe_engine", "ranks": TP, "layers": L,
           "model": "Qwen3-30B-A3B", "dtype": cfg.dtype,
           "note": "4 ranks share one card's SMs and HBM: these times say "
                   "nothing of four cards"}
    one = Engine(cfg, params, max_seq=2048)
    one.serve(ids[:, :64], 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tp1 = one.serve(ids, TP_MOE_GEN)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    one.prefill(ids)
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    rec["tp1"] = {"serve_s": serve_s, "prefill_ms": pre_s * 1e3,
                  "decode_ms_per_step":
                      (serve_s - pre_s) * 1e3 / (TP_MOE_GEN - 1),
                  "tokens_per_s": 2 * TP_MOE_GEN / serve_s}
    del one
    gc_collect(torch)
    ctx = context.initialize_distributed(devices=virtual_devices(TP),
                                         wait_timeout_ms=60_000)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    shards = shard_params(params, ctx, cfg, consume=True)
    torch.cuda.synchronize()
    rec["shard_s"] = time.perf_counter() - t0
    check(not params, "tp_moe_engine: the one-rank tree was not consumed")
    gc_collect(torch)
    eng = Engine(cfg, shards, ctx, max_seq=2048)
    check(eng.backend == "auto" and eng.page_size is None
          and eng._prefill_mode(2, 1024) == "overlap",
          "tp_moe_engine: the defaults are not the reference's")
    eng.serve(ids[:, :64], 2)                                     # warm-up
    rec["defaults"] = tp_engine_run(
        torch, eng, kernels, ids, TP_MOE_GEN, name="tp_moe_engine",
        expect={"ag_gemm": (3 * L, 0), "gemm_rs": (L, 0),
                "reduce_scatter_ring": (L, 0),
                "allreduce_parity": (0, 2 * L)})
    rec["defaults"]["decode_profile"] = tp_profile(
        torch, eng, ids, steps=TP_PROFILE_STEPS // 2)
    rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    toks = rec["defaults"].pop("tokens")
    rec["defaults"]["bf16_tokens_equal_tp1"] = bool(torch.equal(toks, tp1))
    rec["note_tokens"] = ("bf16 tokens may leave TP=1's where two logits "
                          "differ by less than the summation order moves "
                          "them; tp_moe_parity holds them in fp32")
    rec["moe_overlap_layer_n2"] = moe_overlap_layer(torch, cfg)
    # ServingEngine on the same shards (a paged engine beside this one).
    seng = Engine(cfg, shards, ctx, max_seq=2048, page_size=16)
    se = ServingEngine(seng, max_batch=4, prefill_chunk=256)
    srec = {"phase": "tp_moe_serving", "ranks": TP, "model": "Qwen3-30B-A3B",
            "serve": tp_drive(torch, se, kernels,
                              sorted(prompts, key=len)[
                                  :TP_MOE_SERVING_PROMPTS],
                              TP_MOE_SERVING_GEN, name="tp_moe_serving",
                              slice_ar="one_shot")}
    del se
    se = ServingEngine(seng, max_batch=4, prefill_chunk=256)
    srec["decode_window"] = decode_window(
        torch, se, seng, "decode", steps=TP_WINDOW_STEPS // 2,
        prompts=random_prompts(
            torch, cfg.vocab_size, (100, 400, 250, 150), 14))
    del se, seng, eng, shards
    ctx.close()
    gc_collect(torch)
    return rec, srec


def gc_collect(torch) -> None:
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def phase_tp_moe_parity(torch, QWEN3_30B_A3B, init_dense_llm, Engine,
                        ServingEngine, kernels, *, devices=None) -> dict:
    """float32, Qwen3-30B-A3B widths cut to 2 layers: TP=4 tokens identical
    to TP=1's in ``Engine.serve`` (the defaults: the ring TP-MoE in an
    "overlap" prefill, the parity stream in decode; and ``backend="xla"``)
    and in ``ServingEngine`` (page 16) with a preemption and with
    ``spec_k=3``; every rank's logits bit-identical."""
    _, _, _, context = a2a_modules()
    cfg = dataclasses.replace(QWEN3_30B_A3B, num_layers=2, dtype="float32")
    params = init_dense_llm(
        cfg, generator=torch.Generator(device="cuda").manual_seed(5))
    ctx = context.initialize_distributed(
        devices=devices or virtual_devices(TP), wait_timeout_ms=60_000)
    g = torch.Generator().manual_seed(27)
    ids = torch.randint(0, cfg.vocab_size, (2, 64), generator=g,
                        dtype=torch.int32)
    rec = {"phase": "tp_moe_parity", "layers": 2, "dtype": "float32",
           "ranks": TP, "devices": [str(d) for d in ctx.devices]}
    one = Engine(cfg, params, max_seq=256)
    want = one.serve(ids, 8).cpu()
    for backend in ("auto", "xla"):
        eng = Engine(cfg, params, ctx, max_seq=256, backend=backend)
        got = eng.serve(ids, 8).cpu()
        check(torch.equal(got, want), f"tp_moe_parity: Engine.serve "
              f"backend={backend} left TP=1's tokens")
        rec[f"engine_{backend}"] = {"prefill_mode": eng._prefill_mode(2, 64),
                                    "identical": True}
        if backend == "auto":
            check(rank_logits(torch, eng, ids[0].tolist())["ok"],
                  "tp_moe_parity: the ranks' logits differ")
        del eng
    del one
    runs = {"preempt": (dict(max_batch=3, num_pages=20, prefill_chunk=64),
                        ([90, 60, 75, 100], [40, 40, 40, 40]), 0),
            "spec_k3": (dict(max_batch=3, prefill_chunk=64),
                        ([40, 70, 55], [16, 16, 16]), SPEC_K)}
    one = Engine(cfg, params, max_seq=256, page_size=16)
    four = Engine(cfg, params, ctx, max_seq=256, page_size=16)
    for name, (kw, (lengths, gens), spec_k) in runs.items():
        prompts = (phrase_prompts(torch, cfg.vocab_size, lengths, 29)
                   if spec_k else
                   random_prompts(torch, cfg.vocab_size, lengths, 28))
        want = [r.tokens for r in _drive(ServingEngine(one, spec_k=spec_k,
                                                       **kw), prompts,
                                         gens)[0]]
        se = ServingEngine(four, spec_k=spec_k, **kw)
        reqs = _drive(se, prompts, gens)[0]
        check([r.tokens for r in reqs] == want,
              f"tp_moe_parity {name}: TP=4 left TP=1's tokens")
        pre = sum(r.preemptions for r in reqs)
        if name == "preempt":
            check(pre >= 1, "tp_moe_parity: no preemption")
        rec[name] = {"requests": len(reqs), "preemptions": pre,
                     "identical": True}
        if spec_k:
            rec[name]["accepted_draft_tokens"] = sum(
                r.accepted_draft_tokens for r in reqs)
        del se
    del one, four, params
    ctx.close()
    gc_collect(torch)
    return rec


# ---------------------------------------------------------------------------
# The megakernel on a TP group: its AllReduce task types 4 and 22.
# ---------------------------------------------------------------------------

MK_AR_RANKS = (2, 4, 8)
MK_AR_ROWS = (1, 4, 128)
MK_AR_TILES = 32           # a Qwen3-8B activation row: hidden 4096
MK_AR_TIMEOUT_MS = 20_000  # a rank whose kernel never co-runs ends here
MK_AR_MAIN = "allreduce_n4_bfloat16_1"
TP_MK_GEN = 64


def mk_ar_modules():
    import importlib

    names = ("megakernel.kernel", "megakernel.builder", "megakernel.tasks",
             "runtime.context", "ops._comm")
    return [importlib.import_module(f"triton_distributed_tpu_torch.{n}")
            for n in names]


def mk_ar_program(dtype, n: int, *, single: bool = True,
                  force_ar: bool = False, nt: int = MK_AR_TILES):
    """A hand-built program of the two AllReduce types, compiled for n
    ranks: ALLREDUCE_ROW over a row of ``nt`` tiles and (``single``) the
    one-tile ALLREDUCE of one more tile — placed by hand, as the builder
    no longer emits type 4."""
    _, builder, tasks, _, _ = mk_ar_modules()
    mb = builder.MegaKernelBuilder()
    mb.all_reduce(mb.tensor(tasks.TILE, nt * tasks.TILE))
    if single:
        t = mb.tensor(tasks.TILE, tasks.TILE).tile(0, 0)
        mb._emit(tasks.Task(tasks.TaskType.ALLREDUCE, t), [t], [t])
    return mb.compile(dtype=dtype, num_ranks=n, force_ar=force_ar)


def _mk_ar_plain(mk, comp, ws, r, n, force_ar, tag):
    group = mk.ar_group(comp.queue, comp.num_exec, ws, num_ranks=n,
                        axis="tp", max_ar=comp.max_ar, force_ar=force_ar,
                        ar_tag=tag)
    mk.run_queue_plain(comp.queue, ws, None, num_exec=comp.num_exec,
                       mat_specs=(), group=group)


def mk_ar_case(torch, timer, *, n: int, dtype, rows: int, seed: int,
               force_ar: bool = False, time_it: bool = False,
               devices_for=virtual_devices) -> dict:
    """Types 22 and 4 on n virtual ranks of cuda:0 (``force_ar``: one rank
    against itself) at ``rows`` live rows, each rank's tiles drawn from
    the seed, against the plain version on the same inputs: the live rows
    bit for bit, every rank's alike, the other rows untouched. A launch
    that did not run together with its peers' would leave every rank
    waiting until the deadline (``MK_AR_TIMEOUT_MS``) and raise
    CommTimeoutError. ``time_it``: ALLREDUCE_ROW alone at this shape, the
    slowest rank's device time a launch (back to back behind a held
    stream, L2 not flushed), its byte bound, the plain version's time and
    ``X.sum(0)`` over the stacked slabs. ``devices_for(n)``: the ranks'
    devices (one card, or a card a rank)."""
    mk, _, tasks, context, _ = mk_ar_modules()
    ctx = context.DistContext([torch.device(d) for d in devices_for(n)],
                              wait_timeout_ms=MK_AR_TIMEOUT_MS)
    comp = mk_ar_program(dtype, n, force_ar=force_ar)
    g = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn((n, comp.num_tiles, tasks.TILE, tasks.TILE),
                    generator=g, device="cuda").to(dtype)
    name = (f"{'force_ar' if force_ar else 'allreduce'}_n{n}_"
            f"{_dtype_name(dtype)}_{rows}")
    ws_k = [X[r].to(ctx.devices[r], copy=True) for r in range(n)]
    t0 = time.perf_counter()
    ctx.run(lambda r: comp.step(ws_k[r], live_rows=rows, ar_tag=name))
    torch.cuda.synchronize()
    ctx.raise_on_comm_error()
    wall = time.perf_counter() - t0
    ws_p = [X[r].to(ctx.devices[r], copy=True) for r in range(n)]
    ctx.run(lambda r: _mk_ar_plain(mk, comp, ws_p[r], r, n, force_ar,
                                   name + "-plain"))
    for d in set(ctx.devices):
        torch.cuda.synchronize(d)
    live = [w[:, :rows].to(X.device) for w in ws_k]
    want = [w[:, :rows].to(X.device) for w in ws_p]
    same = all(torch.equal(a, b) for a, b in zip(live, want))
    untouched = all(torch.equal(ws_k[r][:, rows:].to(X.device),
                                X[r][:, rows:]) for r in range(n))
    ranks_same = all(torch.equal(live[0], o) for o in live[1:])
    rec = {"case": name, "n": n, "dtype": _dtype_name(dtype), "rows": rows,
           "tiles": comp.num_tiles, "force_ar": force_ar,
           "max_abs_err": max(_max_err(a, b) for a, b in zip(live, want)),
           "bit_identical": same, "ranks_identical": ranks_same,
           "other_rows_untouched": untouched, "first_launch_wall_s": wall,
           "grid_blocks": mk.grid_blocks(
               dtype, full=True,
               ranks_on_card=ctx.devices.count(ctx.devices[0])),
           "ok": bool(same and ranks_same and untouched and all(
               torch.isfinite(o).all().item() for o in live))}
    if force_ar:
        # One rank sums its own slot: x to fp32 and back, exactly x.
        rec["equals_input"] = torch.equal(live[0], X[0][:, :rows])
        rec["ok"] = rec["ok"] and rec["equals_input"]
    if time_it:
        row = mk_ar_program(dtype, n, single=False, force_ar=force_ar)
        ws_t = [X[r][:row.num_tiles].to(ctx.devices[r], copy=True)
                for r in range(n)]
        launch = ctx.run(lambda r: mk.cuda_launcher(
            row.queue, ws_t[r], None, num_exec=row.num_exec, mat_specs=(),
            head_dim=tasks.TILE, sync_before=row.sync_before,
            live_rows=rows, group=mk.ar_group(
                row.queue, row.num_exec, ws_t[r], num_ranks=n, axis="tp",
                max_ar=row.max_ar, force_ar=force_ar, ar_tag=name + "-row")))
        rec["ms"], rec["host_ms_per_call"] = _coll_ms(
            torch, ctx, lambda r: launch[r](), 20)
        ctx.raise_on_comm_error()
        rec["plain_ms"] = timer.ms(lambda: ctx.run(
            lambda r: _mk_ar_plain(mk, row, ws_t[r], r, n, force_ar,
                                   name + "-row-plain")), iters=3)
        S = torch.stack([w[:, :rows].to(X.device) for w in ws_t])
        rec.update(library_every_rank(
            timer, n, lambda: S.sum(0),
            "X.sum(0) over the stacked slabs (one rank's sum)"))
        row_bytes = rows * MK_AR_TILES * tasks.TILE * X.element_size()
        # Each rank's live rows read once and its reduced rows written
        # once, all through the one card's HBM (virtual ranks); n - 1 adds
        # an element — as the collectives' AllReduce bounds count.
        rec["bound_ms"], rec["bound_by"] = _bound_ms(
            2 * n * row_bytes, (n - 1) * rows * MK_AR_TILES * tasks.TILE,
            "float32")
        rec["bound_note"] = ("each rank's live rows read once and written "
                             "once, one HBM at 3.35 TB/s")
    ctx.close()
    return rec


def mk_ar_timeout(torch, n: int = 4, devices_for=virtual_devices) -> dict:
    """A rank held back on the device (its stream spins 1 s before its
    launch) under 100 ms deadlines: the others' waits time out, write their
    error words and run the rest of the launch without waiting; every
    grid ends and ``raise_on_comm_error`` raises CommTimeoutError."""
    mk, _, tasks, context, comm = mk_ar_modules()
    from triton_distributed_tpu_torch.runtime.build import current_stream

    ctx = context.DistContext([torch.device(d) for d in devices_for(n)],
                              wait_timeout_ms=100)
    comp = mk_ar_program(torch.bfloat16, n)
    ws = [torch.ones((comp.num_tiles, tasks.TILE, tasks.TILE),
                     dtype=torch.bfloat16, device=d) for d in ctx.devices]

    def body(r):
        # The queue's upload goes first: a host copy queued behind the
        # spin would hold the rank's thread, and the host meeting (not
        # the kernel) would time out.
        launch = mk.cuda_launcher(
            comp.queue, ws[r], None, num_exec=comp.num_exec, mat_specs=(),
            head_dim=tasks.TILE, sync_before=comp.sync_before, live_rows=1,
            group=mk.ar_group(comp.queue, comp.num_exec, ws[r],
                              num_ranks=n, axis="tp", max_ar=comp.max_ar,
                              force_ar=False, ar_tag="held-back"))
        if r == n - 1:
            comm.SPIN.launch(1_000_000_000, current_stream(ctx.devices[r]))
        launch()

    t0 = time.perf_counter()
    raised = None
    try:
        ctx.run(body)
        torch.cuda.synchronize()
        ctx.raise_on_comm_error()
    except context.CommTimeoutError as exc:
        raised = str(exc)
    for d in set(ctx.devices):
        torch.cuda.synchronize(d)
    ctx.close()
    # The kernel's own deadline names a flag; the host meeting's, the
    # meeting.
    return {"n": n, "timeout_ms": 100, "held_back_s": 1.0,
            "raised": raised, "wall_s": time.perf_counter() - t0,
            "ok": raised is not None and "flag[" in raised}


def phase_megakernel_ar(torch, timer, *, devices_for=virtual_devices,
                        ranks=MK_AR_RANKS) -> tuple:
    """Types 4 and 22 on 2, 4 and 8 virtual ranks (``ranks``, on
    ``devices_for(n)``) in fp32 and bf16 at 1, 4 and 128 live rows and a
    Qwen3-8B row (32 tiles), bit for bit against the plain version;
    ``force_ar`` at one rank; the held-back rank. The main case (4 ranks,
    bf16, 1 row: a decode step's reduction) timed."""
    cases = []
    for n in ranks:
        for dt in (torch.float32, torch.bfloat16):
            for rows in MK_AR_ROWS:
                cases.append(mk_ar_case(
                    torch, timer, n=n, dtype=dt, rows=rows,
                    seed=100 * n + rows, devices_for=devices_for,
                    time_it=(n == TP and dt == torch.bfloat16
                             and rows == 1)))
    for dt in (torch.float32, torch.bfloat16):
        cases.append(mk_ar_case(torch, timer, n=1, dtype=dt, rows=1, seed=7,
                                force_ar=True, time_it=dt == torch.bfloat16,
                                devices_for=devices_for))
    return cases, mk_ar_timeout(torch, devices_for=devices_for)


def tp_step_vs_plain(torch, mk, dec, ws, tok, pos: int, ctx, tol) -> dict:
    """One step of a TP linear decoder at ``pos`` by the ranks' kernels
    (``dec.step``, as the main path launches them) and by the plain
    version, each rank from the same staged workspace, the plain ranks'
    AllReduce tasks meeting in slots of their own. Every rank's live row
    of every tile and its cache tiles in full, elementwise under ``tol``
    (the largest share one element used, and the final row's error
    apart); the ranks' final rows bit-identical. ``ws`` is left
    stepped."""
    comp = dec.comp
    queue = dec.queue_at(pos)
    ctx.run(lambda r: dec.put_inputs(ws[r], tok, pos, r))
    plain = [w.clone() for w in ws]
    dec.step(ws, tok, pos)          # stages the same inputs, then launches
    dec.check_comm()
    t0 = time.perf_counter()
    ctx.run(lambda r: mk.run_queue_plain(
        queue, plain[r], dec.weights(r)[0], num_exec=comp.num_exec,
        mat_specs=comp.mat_specs, head_dim=comp.head_dim,
        group=mk.ar_group(queue, comp.num_exec, plain[r], num_ranks=dec.n,
                          axis="tp", max_ar=comp.max_ar, force_ar=False,
                          ar_tag="plain")))
    for d in set(ctx.devices):
        torch.cuda.synchronize(d)
    plain_ms = (time.perf_counter() - t0) * 1e3
    cache = sorted(t for h in dec.prog.layers for c in h.kT + h.v
                   for t in c.tiles())
    rest = sorted(set(range(comp.num_tiles)) - set(cache))
    share, err, x_err, finite = 0.0, 0.0, 0.0, True
    for got, want in zip(ws, plain):
        ci = torch.tensor(cache, device=got.device)
        ri = torch.tensor(rest, device=got.device)
        for a, b in ((got[ci], want[ci]), (got[ri, 0], want[ri, 0])):
            _, e = _errs(a.float(), b.float(), tol)
            share = max(share, e["tol_share"])
            err = max(err, e["max_abs_err"])
        x_err = max(x_err, _max_err(comp.gather_output(got, dec.prog.x_out)[0],
                                    comp.gather_output(want,
                                                       dec.prog.x_out)[0]))
        finite = finite and bool(torch.isfinite(got[ri, 0]).all())
    rows = [r.to(ws[0].device) for r in dec.rank_rows(ws)]
    same = all(torch.equal(rows[0], r) for r in rows[1:])
    del plain
    return {"workspace_dtype": _dtype_name(ws[0].dtype), "ranks": dec.n,
            "layers": len(dec.prog.layers), "pos": pos, "tol": tol,
            "max_abs_err": err, "final_row_max_abs_err": x_err,
            "tol_share": share, "ranks_identical": same, "finite": finite,
            "plain_ms": plain_ms,
            "ok": bool(share <= 1.0 and same and finite)}


def tp_linear_decode_run(torch, mk, dec, caches, tok, gen, mega, cfg,
                         ctx) -> dict:
    """``gen - 1`` steps of a TP linear decoder from the ranks' prefilled
    caches, the megakernel's count set to 0 just before and read just
    after (one launch a rank a step); each step's wall (synced) and
    enqueue time; every rank's final row bit-identical; then one step's
    launches alone (the ranks' kernels back to back behind a held stream,
    the slowest rank's device time, L2 not flushed) against the one-rank
    step's byte bound — the 4 ranks stream the weights and KV once
    together, through one HBM — and the same step by the plain version
    (``tp_step_vs_plain``: at full depth in bf16 its error is reported;
    ``tp_megakernel_parity`` holds the step at 2 layers)."""
    ws = dec.start(caches)
    pos = int(caches[0].offset)
    torch.cuda.synchronize()
    reset_counts([mega])
    walls, enq, toks = [], [], [int(tok[0])]
    for _ in range(gen - 1):
        t0 = time.perf_counter()
        ws, tok = dec.step(ws, tok, pos)
        enq.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        toks.append(int(tok[0]))
        pos += 1
    dec.check_comm()
    n = dec.n
    launches = mega.launches
    check(launches == n * (gen - 1)
          and mega.variant_launches.get("allreduce", 0) == launches
          and mega.plain_calls == 0,
          f"tp linear decoder: {launches} megakernel launches "
          f"({mega.variant_launches}) and {mega.plain_calls} plain runs for "
          f"{gen - 1} tokens on {n} ranks")
    rows = dec.rank_rows(ws)
    check(all(torch.equal(rows[0], r) for r in rows[1:]),
          "tp linear decoder: the ranks' final rows differ")
    comp = dec.comp
    queue = dec.queue_at(pos - 1)
    ctx.run(lambda r: dec.put_inputs(ws[r], tok, pos - 1, r))
    launch = ctx.run(lambda r: mk.cuda_launcher(
        queue, ws[r], dec.weights(r)[0], live_rows=1,
        sync_before=comp.sync_before, num_exec=comp.num_exec,
        mat_specs=comp.mat_specs, head_dim=comp.head_dim,
        group=mk.ar_group(queue, comp.num_exec, ws[r], num_ranks=n,
                          axis="tp", max_ar=comp.max_ar, force_ar=False,
                          ar_tag=dec.ar_tag)))
    ms, host_ms = _coll_ms(torch, ctx, lambda r: launch[r](), 5)
    ctx.raise_on_comm_error()
    del launch
    vs = tp_step_vs_plain(torch, mk, dec, ws, tok, pos - 1, ctx,
                          TOL["megakernel_bf16"])
    nbytes, flops = _mk_bound(cfg, [pos - 1], ws[0].element_size(), 1)
    bound, bound_by = _bound_ms(nbytes, flops, _dtype_name(ws[0].dtype))
    return {"workspace_dtype": _dtype_name(ws[0].dtype), "ranks": n,
            "tasks_per_rank": comp.num_exec,
            "allreduce_rows_per_rank": sum(
                1 for t in comp.queue[:comp.num_exec, 0] if t in (4, 22)),
            "barriers": int(comp.sync_before.sum()),
            "decoded_tokens": gen - 1, "launches": launches,
            "first_step_ms": walls[0] * 1e3,
            "step_ms": _pct(walls[1:], 50) * 1e3,
            "enqueue_ms": _pct(enq[1:], 50) * 1e3,
            "decode_tokens_per_s": (gen - 2) / sum(walls[1:]),
            "kernel_pos": pos - 1, "ms": ms, "host_ms_per_step": host_ms,
            "plain_ms": vs["plain_ms"], "bound_ms": bound,
            "bound_by": bound_by, "bound_bytes": nbytes, "library_ms": None,
            "vs_plain": dict(vs, note="reported, not held: bf16 stores "
                                      "compound through every layer; "
                                      "tp_megakernel_parity holds the "
                                      "step at 2 layers, fp32 and bf16"),
            "grid_blocks": mk.grid_blocks(ws[0].dtype, full=True,
                                          ranks_on_card=n),
            "ranks_identical": True, "tokens_head": toks[:8]}


def force_ar_price(torch, mk, mkserv, mkmodels, cfg, params, cache, tok,
                   context) -> dict:
    """The in-kernel AllReduce rung's price on one card: the one-rank bf16
    linear step (36 layers) against the same step compiled with
    ``force_ar_tasks`` + ``force_ar`` (2 ALLREDUCE_ROW a layer, each run
    against the rank itself on a one-rank group), the same weight
    workspace, each timed back to back behind a held stream."""
    dec = mkserv.MegakernelDecoder(cfg, params, max_seq=2048,
                                   dtype=torch.bfloat16)
    ws = dec.start(cache)
    pos = int(cache.offset)
    prog = mkmodels.build_decode_step(
        hidden=cfg.hidden_size, hq_local=cfg.num_heads,
        hkv_local=cfg.num_kv_heads, ffn_local=cfg.intermediate_size,
        num_layers=cfg.num_layers, max_seq=2048, pos=2047,
        eps=cfg.rms_norm_eps, head_dim=cfg.head_dim, inkernel_append=True,
        mat_prefetch=True, force_ar_tasks=True)
    comp = prog.mb.compile(dtype=torch.bfloat16, head_dim=cfg.head_dim,
                           force_ar=True)
    check(comp.num_mrows == dec.comp.num_mrows,
          "force_ar: the weight workspace layout differs")
    feeds = mkserv.weight_feeds(prog, cfg, params, projections=False)
    feeds.update(mkserv.cache_feeds(prog, cache))
    ws_f = comp.make_workspace(comp.split_feeds(feeds)[0])
    del feeds
    queue = dec.queue_at(pos)
    dec.put_inputs(ws, tok, pos)
    wsm = dec.weights()[0]
    xt = ws_f[prog.x.base:prog.x.base + prog.x.ct]
    xt[:, 0, :] = dec.embeds[0][tok.long()].to(ws_f.dtype).view(prog.x.ct, -1)
    ws_f[prog.cos.base], ws_f[prog.sin.base] = dec._rope(pos, ws_f.device)
    queue_f = mkmodels.advance_queue_pos(comp.queue, pos,
                                         num_exec=comp.num_exec)
    ctx1 = context.DistContext([torch.device("cuda:0")],
                               wait_timeout_ms=60_000)
    # Both launchers made in the rank's thread: each launches on the
    # stream current where it was made, the one the timing holds.
    plain_launch = ctx1.run(lambda r: mk.cuda_launcher(
        queue, ws, wsm, live_rows=1, sync_before=dec.comp.sync_before,
        num_exec=dec.comp.num_exec, mat_specs=dec.comp.mat_specs,
        head_dim=dec.comp.head_dim))[0]
    force = ctx1.run(lambda r: mk.cuda_launcher(
        queue_f, ws_f, wsm, live_rows=1, sync_before=comp.sync_before,
        num_exec=comp.num_exec, mat_specs=comp.mat_specs,
        head_dim=comp.head_dim, group=mk.ar_group(
            queue_f, comp.num_exec, ws_f, num_ranks=1, axis="tp",
            max_ar=comp.max_ar, force_ar=True, ar_tag="force-ar")))[0]
    one_ms, _ = _coll_ms(torch, ctx1, lambda r: plain_launch(), 10)
    force_ms, _ = _coll_ms(torch, ctx1, lambda r: force(), 10)
    force_ms2, _ = _coll_ms(torch, ctx1, lambda r: force(), 10)
    one_ms2, _ = _coll_ms(torch, ctx1, lambda r: plain_launch(), 10)
    ctx1.raise_on_comm_error()
    x_one = dec.comp.gather_output(ws, dec.prog.x_out)[0].float()
    x_f = comp.gather_output(ws_f, prog.x_out)[0].float()
    ctx1.close()
    n_ar = int((comp.queue[:comp.num_exec, 0] == 22).sum())
    return {"one_rank_step_ms": [one_ms, one_ms2],
            "force_ar_step_ms": [force_ms, force_ms2],
            "allreduce_rows": n_ar,
            "price_ms_per_step": (force_ms + force_ms2 - one_ms - one_ms2) / 2,
            "price_ms_per_allreduce": (force_ms + force_ms2 - one_ms
                                       - one_ms2) / 2 / n_ar,
            "final_row_max_abs_diff": (x_f - x_one).abs().max().item(),
            "note": "force_ar stores the o-proj and down rows before the "
                    "AllReduce and adds the residual in ADD_NORM (no fused "
                    "epilogue), so its bf16 row may differ by rounding",
            "finite": bool(torch.isfinite(x_f).all())}


def phase_tp_megakernel_engine(torch, mk, mkserv, mkmodels, kernels, Engine,
                               params, cfg, *, one_rank_bf16_ms,
                               eager_tp_step_ms, prompt=1024,
                               gen=TP_MK_GEN) -> dict:
    """Qwen3-8B at full width and depth through ``Engine(cfg, params, ctx
    of 4 virtual ranks, backend="megakernel", max_seq=2048).serve``: one
    1024-token prompt, 64 tokens — the "ar" prefill (the reference's mode
    on the megakernel), then one megakernel launch a rank a step (float32
    workspaces, as the engine builds them), its AllReduce rows carrying
    the 72 reductions a step; no K2, no parity AR, no B11 in the decode.
    Then ``MegakernelDecoder(dtype=bfloat16, num_ranks=4)`` from the same
    prefill (step wall, enqueue, the launches alone against the bound),
    beside the one-rank linear decoder's and the eager TP engine's steps
    of this call, and the ``force_ar`` one-rank step's price."""
    comm, context = coll_modules()[0], coll_modules()[4]
    flash, paged, mega = kernels
    L = cfg.num_layers
    ctx = context.initialize_distributed(devices=virtual_devices(TP),
                                         wait_timeout_ms=60_000)
    g = torch.Generator(device="cuda").manual_seed(17)
    ids = torch.randint(0, cfg.vocab_size, (1, prompt), generator=g,
                        device="cuda", dtype=torch.int32)
    rec = {"phase": "tp_megakernel_engine", "ranks": TP, "layers": L,
           "prompt": prompt, "gen": gen, "max_seq": 2048,
           "note": "4 ranks share one card's SMs and HBM: these times say "
                   "nothing of four cards"}
    gc_collect(torch)
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(cfg, params, ctx, backend="megakernel", max_seq=2048)
    check(eng._prefill_mode(1, prompt) == "ar",
          "tp_megakernel_engine: the prefill does not take 'ar'")
    t0 = time.perf_counter()
    eng.serve(ids[:, :128], 4)          # builds the ranks' workspaces
    torch.cuda.synchronize()
    rec["first_serve_s"] = time.perf_counter() - t0
    allk = list(kernels) + list(comm.COLLECTIVE_KERNELS)
    torch.cuda.synchronize()
    reset_counts(allk)
    t0 = time.perf_counter()
    out = eng.serve(ids, gen)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    steps = gen - 1
    c = dict(_tp_counts(comm), flash_attention=flash.launches,
             paged_attention=paged.launches, megakernel=mega.launches,
             megakernel_allreduce=mega.variant_launches.get("allreduce", 0))
    check(c["megakernel"] == TP * steps
          and c["megakernel_allreduce"] == TP * steps,
          f"tp_megakernel_engine: {c['megakernel']} megakernel launches "
          f"for {steps} steps on {TP} ranks")
    check(c["paged_attention"] == 0 and c["allreduce_parity"] == 0
          and c["gemm_ar"] == 0 and c["flash_attention"] == TP * L,
          f"tp_megakernel_engine: launches {c}")
    check(all(k.plain_calls == 0 for k in allk),
          "tp_megakernel_engine: a plain version ran on the main path")
    check(tuple(out.shape) == (1, gen) and bool(
        ((out >= 0) & (out < cfg.vocab_size)).all()),
        "tp_megakernel_engine: bad output")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = eng.prefill(ids)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    eng.check_comm()
    check(bool(torch.isfinite(logits).all()),
          "tp_megakernel_engine: non-finite prefill logits")
    rec["engine"] = {"workspace_dtype": "float32", "serve_s": serve_s,
                     "prefill_ms": prefill_s * 1e3,
                     "decode_ms_per_step": (serve_s - prefill_s) * 1e3 / steps,
                     "tokens_per_s": gen / serve_s, "launches": c,
                     "launches_per_rank": {"megakernel": "1 a step",
                                           "allreduce_rows": f"{2 * L} a "
                                                             "step, in it"},
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "tokens_head": out[0, :8].tolist()}
    tok = logits.argmax(-1).to(torch.int32)
    eng._mk = None
    gc_collect(torch)
    torch.cuda.reset_peak_memory_stats()
    dec = mkserv.MegakernelDecoder(cfg, eng.rank_params, max_seq=2048,
                                   dtype=torch.bfloat16, ctx=ctx,
                                   num_ranks=TP)
    bf16 = tp_linear_decode_run(torch, mk, dec, caches, tok, gen, mega, cfg,
                                ctx)
    bf16["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    bf16["one_rank_linear_bf16_step_ms"] = one_rank_bf16_ms
    bf16["eager_tp_engine_step_ms"] = eager_tp_step_ms
    rec["bf16"] = bf16
    del dec, eng, caches
    ctx.close()
    gc_collect(torch)
    one = Engine(cfg, params, max_seq=2048)
    logits, cache = one.prefill(ids)
    rec["force_ar"] = force_ar_price(torch, mk, mkserv, mkmodels, cfg, params,
                                     cache, logits.argmax(-1).to(torch.int32),
                                     context)
    del one, cache
    gc_collect(torch)
    return rec


def tp_moe_program_case(torch, mk, mkserv, mkmodels, init_dense_llm,
                        QWEN3_30B_A3B, *, n=2, batch=4, pos=100,
                        devices=None) -> dict:
    """The MoE decode program on a TP group (reached through the builder,
    as in the reference): Qwen3-30B-A3B widths at 2 layers, fp32, host-fed
    caches at ``batch`` rows, n = 2 ranks (16/2 heads and 384 of each
    expert's 768 ffn columns a rank, the combine summed by ALLREDUCE_ROW)
    against the one-rank program on the same weights and cache: within
    the fp32 megakernel tolerance, the same experts in every layer, the
    ranks' rows bit-identical."""
    from triton_distributed_tpu_torch.models.kv_cache import init_kv_cache

    context = coll_modules()[4]
    cfg = dataclasses.replace(QWEN3_30B_A3B, num_layers=2, dtype="float32")
    params = init_dense_llm(
        cfg, generator=torch.Generator(device="cuda").manual_seed(23))
    S = 256
    g = torch.Generator(device="cuda").manual_seed(29)
    cache = init_kv_cache(cfg, 1, S)
    cache = cache._replace(
        k=torch.randn(cache.k.shape, generator=g, device="cuda") * 0.3,
        v=torch.randn(cache.v.shape, generator=g, device="cuda") * 0.3)
    x = torch.zeros((128, cfg.hidden_size), device="cuda")
    x[:batch] = torch.randn((batch, cfg.hidden_size), generator=g,
                            device="cuda") * 0.3
    cos, sin = (torch.from_numpy(t).cuda() for t in
                mkmodels.rope_tables(pos, cfg.head_dim, cfg.rope_theta))

    def run(num_ranks, ctx):
        prog = mkmodels.build_decode_step(
            hidden=cfg.hidden_size, hq_local=cfg.num_heads // num_ranks,
            hkv_local=cfg.num_kv_heads // num_ranks,
            ffn_local=cfg.moe_intermediate_size // num_ranks,
            num_layers=2, max_seq=S, pos=pos, batch=batch,
            eps=cfg.rms_norm_eps, head_dim=cfg.head_dim,
            moe_experts=cfg.num_experts, moe_topk=cfg.num_experts_per_tok,
            num_ranks=num_ranks)
        comp = prog.mb.compile(num_ranks=num_ranks)
        wss, wsms = [], []
        for r in range(num_ranks):
            feeds = mkserv.weight_feeds(prog, cfg, params, rank=r,
                                        num_ranks=num_ranks)
            feeds.update(mkserv.cache_feeds(prog, cache, rank=r,
                                            num_ranks=num_ranks))
            feeds.update({prog.x: x, prog.cos: cos, prog.sin: sin})
            main, _, wm = comp.split_feeds(feeds)
            dev = ctx.devices[r] if ctx is not None else None
            wss.append(comp.make_workspace(main, device=dev))
            wsms.append(comp.make_workspace_mat(wm, device=dev))
        step = (lambda r: comp.step(wss[r], wsm=wsms[r], live_rows=batch))
        if ctx is None:
            step(0)
        else:
            ctx.run(step)
            ctx.raise_on_comm_error()
        for d in {w.device for w in wss}:
            torch.cuda.synchronize(d)
        outs = [comp.gather_output(w, prog.x_out)[:batch].to(x.device)
                for w in wss]
        experts = [moe_active(mk, comp, comp.queue, w, batch) for w in wss]
        sel = [[w[int(row[1])][:cfg.num_experts, :batch].to(x.device) > 0
                for row in comp.queue[:comp.num_exec]
                if row[0] == int(mk.TaskType.MOE_TOPK)] for w in wss]
        return outs, experts, sel

    one, one_experts, one_sel = run(1, None)
    ctx = context.DistContext(
        [torch.device(d) for d in (devices or virtual_devices(n))],
        wait_timeout_ms=60_000)
    got, experts, sel = run(n, ctx)
    ctx.close()
    tol = TOL["fp32"]
    err = _max_err(got[0], one[0])
    share = ((got[0] - one[0]).abs()
             / (tol["atol"] + tol["rtol"] * one[0].abs())).max().item()
    same_sel = all(torch.equal(a, b) for s in sel
                   for a, b in zip(s, one_sel[0]))
    ranks_same = all(torch.equal(got[0], o) for o in got[1:])
    rec = {"ranks": n, "layers": 2, "batch": batch, "dtype": "float32",
           "max_abs_err": err, "tol": tol, "tol_share": share,
           "active_experts": experts[0], "one_rank_active": one_experts[0],
           "same_experts": same_sel, "ranks_identical": ranks_same,
           "ok": bool(share <= 1.0 and same_sel and ranks_same
                      and torch.isfinite(got[0]).all())}
    del params, cache
    return rec


def phase_tp_megakernel_parity(torch, mk, mkserv, mkmodels, QWEN3_8B,
                               QWEN3_30B_A3B, init_dense_llm, Engine,
                               kernels, devices_for=virtual_devices) -> dict:
    """float32, Qwen3-8B widths cut to 2 layers: ``Engine.serve`` on the
    megakernel at TP=4 token-identical to TP=1's megakernel serve and to
    the eager TP=4 serve (the defaults), with one launch a rank a step.
    Then one step of the engine's decoder, and of a bf16 decoder on the
    same shards, against the plain version (``tp_step_vs_plain``: every
    rank's rows under the megakernel's tolerance, the ranks' final rows
    bit-identical). Then the MoE program at n = 2 against one rank
    (``tp_moe_program_case``). ``devices_for(n)``: the ranks' devices
    (virtual ranks on one card, or a card a rank)."""
    context = coll_modules()[4]
    flash, paged, mega = kernels
    cfg = dataclasses.replace(QWEN3_8B, num_layers=2, dtype="float32")
    params = init_dense_llm(
        cfg, generator=torch.Generator(device="cuda").manual_seed(3))
    g = torch.Generator().manual_seed(43)
    rec = {"phase": "tp_megakernel_parity", "layers": 2, "dtype": "float32",
           "ranks": TP}
    ctx = context.initialize_distributed(devices=devices_for(TP),
                                         wait_timeout_ms=60_000)
    one = Engine(cfg, params, max_seq=512, backend="megakernel")
    mk4 = Engine(cfg, params, ctx, max_seq=512, backend="megakernel")
    eager4 = Engine(cfg, params, ctx, max_seq=512)
    runs = []
    for n_prompt, gen in ((37, 24), (203, 16)):
        prompt = torch.randint(0, cfg.vocab_size, (1, n_prompt), generator=g)
        want = one.serve(prompt, gen)
        reset_counts(kernels)
        got = mk4.serve(prompt, gen)
        check(mega.launches == TP * (gen - 1) and paged.launches == 0
              and mega.plain_calls == 0,
              f"tp_megakernel_parity: {mega.launches} megakernel launches")
        eager = eager4.serve(prompt, gen)
        same = bool(torch.equal(got, want)) and bool(torch.equal(eager, want))
        if not same:
            emit({"phase": "tp_megakernel_parity", "prompt": n_prompt,
                  "tp1": want.tolist(), "tp4_megakernel": got.tolist(),
                  "tp4_eager": eager.tolist()})
        check(same, f"tp_megakernel_parity: TP=4 tokens differ from TP=1's "
                    f"({n_prompt}-token prompt)")
        runs.append({"prompt": n_prompt, "gen": gen, "identical": True})
    rec["engine_serve"] = runs
    # One step of the engine's decoder (fp32), then of a bf16 decoder on
    # the same shards and caches, each held against its plain version.
    logits, caches = mk4.prefill(prompt)
    tok = logits.argmax(-1).to(torch.int32)
    pos = int(caches[0].offset)
    dec = mk4._mk
    dec16 = mkserv.MegakernelDecoder(cfg, mk4.rank_params, max_seq=512,
                                     dtype=torch.bfloat16, ctx=ctx,
                                     num_ranks=TP)
    for key, d, tol in (("step_vs_plain", dec, TOL["megakernel_fp32"]),
                        ("step_vs_plain_bf16", dec16,
                         TOL["megakernel_bf16"])):
        rec[key] = tp_step_vs_plain(torch, mk, d, d.start(caches), tok, pos,
                                    ctx, tol)
        check(rec[key]["ok"], f"tp_megakernel_parity: the TP={TP} step "
                              f"against its plain version: {rec[key]}")
    rec["ranks_identical"] = True
    del one, mk4, eager4, dec, dec16, caches, params
    ctx.close()
    gc_collect(torch)
    rec["moe_n2"] = tp_moe_program_case(torch, mk, mkserv, mkmodels,
                                        init_dense_llm, QWEN3_30B_A3B,
                                        devices=devices_for(2))
    check(rec["moe_n2"]["ok"],
          f"tp_megakernel_parity: the MoE program at n = 2: {rec['moe_n2']}")
    gc_collect(torch)
    return rec


# ---------------------------------------------------------------------------
# Sequence and pipeline parallelism: B4's parity AllGather, B7's shift and
# permutation, and the SP / PP paths over them.
# ---------------------------------------------------------------------------

SPPP_RANKS = (2, 4, 8)
AGP_ROWS = (1, 7, 64, 2048)
AGP_COLS = 256
# The SP decode's partials payload: (B·hq, d + 2) fp32 at Qwen3-8B's 32 q
# heads, d 128, B = 4.
AGP_MAIN = (128, 130)
P2P_ROWS, P2P_COLS = 8, 256
P2P_MAIN = (512, 4096)           # one PP microbatch of Qwen3-8B, bf16
SP_N = 4
SP_B, SP_HQ, SP_HKV, SP_D = 4, 32, 8, 128
SP_SHARD = 8192                  # 32768 tokens over 4 ranks
SP_LENS = [8192, 8192, 3001, 0]
SP_STEPS = 16
SP_PREFILL_S = 8192
PP_N, PP_MB, PP_MB_ROWS, PP_CHUNKS = 4, 8, 512, 3


def sppp_modules():
    import importlib

    return [importlib.import_module(f"triton_distributed_tpu_torch.{n}")
            for n in ("ops._comm", "ops.allgather", "ops.p2p",
                      "runtime.context")]


def _rand(torch, shape, dtype, seed):
    x = torch.randn(shape, generator=torch.Generator(
        device="cuda").manual_seed(seed), device="cuda") * 4
    return x.to(dtype)


def agp_case(torch, timer, ctx, dtype, rows: int, cols: int, seed: int,
             time_it: bool) -> dict:
    """B4's parity AllGather on every rank of ``ctx``, two calls over one
    workspace (both parities, new data each), against ``ag_plain`` bit for
    bit on every rank."""
    _, ag, _, _ = sppp_modules()
    n = ctx.num_ranks
    X = [_rand(torch, (n, rows, cols), dtype, seed + t) for t in range(2)]
    ws, _ = ag.ag_stream_workspace(n, rows, cols, dtype, ctx=ctx,
                                   tag=f"smoke-{rows}x{cols}-{seed}")
    idx = list(ws.epochs)
    xs = [[X[t][r].to(ctx.devices[r]) for r in range(n)] for t in range(2)]
    cur = [0]

    def fn(r):
        out, _, idx[r] = ag.all_gather_stream(xs[cur[0]][r], ws, idx[r],
                                              num_ranks=n)
        return out

    same = True
    for t in range(2):
        cur[0] = t
        got = ctx.run(fn)
        torch.cuda.synchronize()
        ctx.raise_on_comm_error()
        want = ag.ag_plain(list(X[t]))
        same = same and all(torch.equal(_bits(torch, o.to(want.device)),
                                        _bits(torch, want)) for o in got)
    rec = {"case": f"ag_parity_n{n}_{_dtype_name(dtype)}_{rows}x{cols}",
           "n": n, "dtype": _dtype_name(dtype), "rows": rows, "cols": cols,
           "calls": 2, "max_abs_err": 0.0 if same else float("nan"),
           "bit_identical": same, "ok": same}
    if time_it:
        B = rows * cols * X[0].element_size()
        rec["bound_ms"], rec["bound_by"] = _bound_ms(n * (B + n * B), 0,
                                                     "float32")
        rec["bound_note"] = ("every rank reads its chunk once and writes the "
                             "n gathered chunks once, through one card's "
                             "HBM at 3.35 TB/s")
        rec["ms"], rec["host_ms_per_call"] = _coll_ms(torch, ctx, fn, 20)
        rec["plain_ms"] = timer.ms(lambda: ag.ag_plain(list(X[0])))
        x0 = list(X[0])
        rec.update(library_every_rank(
            timer, n, lambda: torch.cat(x0),
            "torch.cat of the n chunks (one rank's gathered copy)"))
    return rec


def p2p_case(torch, timer, ctx, name: str, dtype, rows: int, cols: int,
             seed: int, *, shift: int | None = None, perm=None,
             force: bool = False, time_it: bool = False) -> dict:
    """One B7 call on every rank (two calls: the pad's words reused)
    against ``p2p_plain`` bit for bit; a ring permutation must launch the
    shift kernel and not the permutation."""
    comm, _, p2p, _ = sppp_modules()
    n = ctx.num_ranks
    X = _rand(torch, (n, rows, cols), dtype, seed)
    xs = [X[r].to(ctx.devices[r]) for r in range(n)]
    if shift is not None:
        plan = [(s, (s + shift) % n) for s in range(n)]

        def fn(r):
            return p2p.p2p_shift_local(xs[r], shift, num_ranks=n,
                                       force_kernel=force)
    else:
        plan = perm

        def fn(r):
            return p2p.p2p_permute_local(xs[r], perm, num_ranks=n,
                                         force_kernel=force)
    want = p2p.p2p_plain(list(X), plan)
    k0 = (comm.P2P_SHIFT_KERNEL.launches, comm.P2P_PERMUTE_KERNEL.launches)
    same = True
    for _ in range(2):
        got = ctx.run(fn)
        torch.cuda.synchronize()
        ctx.raise_on_comm_error()
        same = same and all(torch.equal(_bits(torch, o.to(X.device)),
                                        _bits(torch, w))
                            for o, w in zip(got, want))
    launched = {"p2p_shift": comm.P2P_SHIFT_KERNEL.launches - k0[0],
                "p2p_permute": comm.P2P_PERMUTE_KERNEL.launches - k0[1]}
    ring = shift is not None or (p2p._as_shift(perm, n) is not None
                                 and not (force and n == 1))
    which = "p2p_shift" if ring else "p2p_permute"
    right = launched[which] == 2 * n and sum(launched.values()) == 2 * n
    rec = {"case": f"{name}_n{n}_{_dtype_name(dtype)}_{rows}x{cols}",
           "n": n, "dtype": _dtype_name(dtype), "rows": rows, "cols": cols,
           "perm": plan, "kernel": which, "launches": launched,
           "max_abs_err": 0.0 if same else float("nan"),
           "bit_identical": same, "ok": same and right}
    if time_it:
        B = rows * cols * X.element_size()
        senders = len({s for s, _ in plan})
        nbytes = senders * B + n * B
        rec["bound_ms"], rec["bound_by"] = _bound_ms(nbytes, 0, "float32")
        rec["bound_note"] = ("each sender reads its block once and every "
                             "rank writes its output once (the receivers "
                             "the block, the others zeros), through one "
                             "card's HBM at 3.35 TB/s")
        # The push protocol moves exactly these bytes: the senders write
        # the receivers' outputs (no receive buffer, no copy out).
        rec["bytes_moved"] = rec["bound_bytes"] = nbytes
        rec["ms"], rec["host_ms_per_call"] = _coll_ms(torch, ctx, fn, 20)
        rec["plain_ms"] = timer.ms(lambda: p2p.p2p_plain(list(X), plan))
        Y = torch.empty_like(X)
        rec["library_ms"] = timer.ms(lambda: Y.copy_(X))
        rec["library_call"] = "Y.copy_(X): one copy of every rank's block"
    return rec


def agp_stress(torch, ctx, calls: int) -> dict:
    """``calls`` parity AllGathers on every rank over one workspace at the
    SP decode's payload, new data every call, a rotating rank held back
    50 us on every third: every gather equal to the plain version's."""
    _, ag, _, _ = sppp_modules()
    n = ctx.num_ranks
    rows, cols = AGP_MAIN
    X = _rand(torch, (calls, n, rows, cols), torch.float32, 88)
    ws, _ = ag.ag_stream_workspace(n, rows, cols, torch.float32, ctx=ctx,
                                   tag="stress")

    def loop(r):
        idx, outs = ws.epochs[r], []
        xr = X[:, r].to(ctx.devices[r])
        for t in range(calls):
            strag = ("rotate", 50_000) if t % 3 == 0 else None
            out, _, idx = ag.all_gather_stream(xr[t], ws, idx, num_ranks=n,
                                               straggler=strag)
            outs.append(out)
        return torch.stack(outs), idx

    got = ctx.run(loop)
    torch.cuda.synchronize()
    ctx.raise_on_comm_error()
    bad = [t for t in range(calls)
           if not all(torch.equal(got[r][0][t].to(X.device),
                                  ag.ag_plain(list(X[t])))
                      for r in range(n))]
    return {"calls": calls, "n": n, "rows": rows, "cols": cols,
            "straggler": "rotate, 50 us, every third call",
            "index_after": [g[1] for g in got], "calls_wrong": bad,
            "ok": not bad and all(g[1] == calls for g in got)}


def sppp_timeouts(torch, devices) -> dict:
    """100 ms deadlines. The parity AllGather with rank n-1 held back 1 s
    on the device: its peers' kernels spin on its flags, time out and
    ``raise_on_comm_error`` raises. The ring shift with rank n-1's stream
    held the same way: its source waits for its address, its destination
    for its data."""
    comm, ag, p2p, context = sppp_modules()
    from triton_distributed_tpu_torch.runtime.build import current_stream

    out = {}
    for what in ("ag_parity", "p2p_shift"):
        ctx = context.DistContext([torch.device(d) for d in devices],
                                  wait_timeout_ms=100)
        n = ctx.num_ranks
        x = torch.ones((4, 256), device="cuda")
        ws, _ = ag.ag_stream_workspace(n, 4, 256, torch.float32, ctx=ctx,
                                       tag="timeout")

        def fn(r):
            if what == "ag_parity":
                return ag.all_gather_stream(
                    x.to(ctx.devices[r]), ws, 0, num_ranks=n,
                    straggler=(n - 1, 1_000_000_000))
            if r == n - 1:
                comm.SPIN.launch(1_000_000_000,
                                 current_stream(ctx.devices[r]))
            return p2p.p2p_shift_local(x.to(ctx.devices[r]), 1, num_ranks=n)

        t0 = time.perf_counter()
        raised = None
        try:
            ctx.run(fn)
            torch.cuda.synchronize()
            ctx.raise_on_comm_error()
        except context.CommTimeoutError as exc:
            raised = str(exc)
        torch.cuda.synchronize()
        out[what] = {"raised": raised, "wall_s": time.perf_counter() - t0}
        ctx.close()
    return {"n": len(devices), "timeout_ms": 100, **out,
            "ok": all(v["raised"] for v in out.values())}


def phase_collectives_sp_pp(torch, timer, *, devices_for=virtual_devices,
                            ranks=SPPP_RANKS,
                            name="collectives_sp_pp") -> dict:
    """B4's parity AllGather and B7's two kernels at n = 2, 4 and 8 against
    their plain versions, bit for bit on every rank: the AllGather in
    fp32, bf16 and e4m3 at 1-2048 rows (and the SP decode's 128 x 130 fp32
    payload at n = 4, timed); the shift by +1 and -1 (and 2 at n = 4), a
    partial permutation with a multicast, a butterfly and a full ring
    (which must take the shift kernel) in fp32 and bf16; both kernels at
    one rank under ``force_kernel``; B7's push-protocol edge cases
    (``push_edge_cases``: tails into NaN-filled outputs, a held-back
    receiver and sender, 200 calls without a sync; the loopback at one
    rank); the PP microbatch (512 x 4096 bf16, n = 4)
    timed through each. 200 parity calls with a rotating straggler;
    held-back ranks raising CommTimeoutError."""
    _, _, _, context = sppp_modules()
    cases: dict = {"ag_parity": [], "p2p_shift": [], "p2p_permute": []}
    seed, stress = 700, None
    for n in ranks:
        ctx = context.DistContext([torch.device(d) for d in devices_for(n)],
                                  wait_timeout_ms=20_000)
        for dtype in (torch.float32, torch.bfloat16, torch.float8_e4m3fn):
            for rows in AGP_ROWS:
                seed += 1
                cases["ag_parity"].append(agp_case(
                    torch, timer, ctx, dtype, rows, AGP_COLS, seed, False))
        if n == SP_N:
            seed += 1
            cases["ag_parity"].append(agp_case(
                torch, timer, ctx, torch.float32, *AGP_MAIN, seed, True))
        # Rank 0 multicasts (to itself at n = 2); at n > 2 the middle
        # ranks are idle and rank n-1 sends back to 0.
        perms = {"partial_multicast": [(0, 0), (0, 1)] if n == 2 else
                 [(0, n - 1), (0, 1), (n - 1, 0)],
                 "butterfly": [(s, s ^ 1) for s in range(n)],
                 "ring_as_perm": [(s, (s + 1) % n) for s in range(n)]}
        if n == 2:
            perms["butterfly"] = [(1, 0)]          # 2's butterfly is a ring
        for dtype in (torch.float32, torch.bfloat16):
            shifts = (1, -1, 2) if n == SP_N else (1, -1)
            for sh in shifts:
                seed += 1
                cases["p2p_shift"].append(p2p_case(
                    torch, timer, ctx, f"shift{sh:+d}", dtype, P2P_ROWS,
                    P2P_COLS, seed, shift=sh))
            for pname, perm in perms.items():
                seed += 1
                rec = p2p_case(torch, timer, ctx, pname, dtype, P2P_ROWS,
                               P2P_COLS, seed, perm=perm)
                cases[rec["kernel"]].append(rec)
        for rec in push_edge_cases(torch, ctx, ("p2p_shift", "p2p_permute"),
                                   seed):
            cases[rec["kernel"]].append(rec)
        seed += 100
        if n == PP_N:
            seed += 1
            cases["p2p_shift"].append(p2p_case(
                torch, timer, ctx, "main_shift+1", torch.bfloat16,
                *P2P_MAIN, seed, shift=1, time_it=True))
            seed += 1
            cases["p2p_permute"].append(p2p_case(
                torch, timer, ctx, "main_butterfly", torch.bfloat16,
                *P2P_MAIN, seed, perm=[(s, s ^ 1) for s in range(n)],
                time_it=True))
            stress = agp_stress(torch, ctx, PARITY_CALLS)
        ctx.close()
        del ctx
        torch.cuda.empty_cache()
    ctx = context.DistContext([torch.device(devices_for(1)[0])],
                              wait_timeout_ms=20_000)
    for dtype in (torch.float32, torch.bfloat16):
        seed += 1
        cases["p2p_shift"].append(p2p_case(
            torch, timer, ctx, "force_kernel_shift", dtype, P2P_ROWS,
            P2P_COLS, seed, shift=1, force=True))
        seed += 1
        cases["p2p_permute"].append(p2p_case(
            torch, timer, ctx, "force_kernel_permute", dtype, P2P_ROWS,
            P2P_COLS, seed, perm=[(0, 0)], force=True))
        seed += 1
        cases["ag_parity"].append(agp_force_one(torch, ctx, dtype, seed))
    for rec in push_edge_cases(torch, ctx, ("p2p_shift", "p2p_permute"),
                               seed):
        cases[rec["kernel"]].append(rec)
    ctx.close()
    tmo = sppp_timeouts(torch, devices_for(SP_N))
    bad = [c["case"] for cs in cases.values() for c in cs if not c["ok"]]
    check(not bad, f"{name}: disagree with their plain versions (or took "
          f"the wrong kernel): {bad}")
    check(stress is not None and stress["ok"],
          f"{name}: parity stress wrong: {stress}")
    check(tmo["ok"], f"{name}: a held-back rank did not raise "
          f"CommTimeoutError: {tmo}")
    return {"phase": name, "devices": devices_for(SP_N),
            "tolerance": "bit-identical to the plain version on every rank",
            "main_shapes": {
                "ag_parity": f"n = {SP_N}, fp32, {AGP_MAIN[0]} x "
                             f"{AGP_MAIN[1]} (the SP decode's partials)",
                "p2p": f"n = {PP_N}, bf16, {P2P_MAIN[0]} x {P2P_MAIN[1]} "
                       "(one PP microbatch)"},
            "parity_stress": stress, "timeout": tmo, "cases": cases}


def agp_force_one(torch, ctx, dtype, seed: int) -> dict:
    """The parity AllGather at one rank: without ``force_kernel`` its
    input back and no launch; with it, three calls (both parities) each
    one launch, bit for bit."""
    comm, ag, _, _ = sppp_modules()
    x = _rand(torch, (16, AGP_COLS), dtype, seed)
    ws, idx = ag.ag_stream_workspace(1, 16, AGP_COLS, dtype, ctx=ctx,
                                     tag=f"smoke-one-{seed}")
    before = comm.AG_PARITY_KERNEL.launches
    same = ctx.run(lambda r: ag.all_gather_stream(x, ws, idx,
                                                  num_ranks=1)[0])[0] is x
    untouched = comm.AG_PARITY_KERNEL.launches == before
    for _ in range(3):
        out, _, idx = ctx.run(lambda r: ag.all_gather_stream(
            x, ws, idx, num_ranks=1, force_kernel=True))[0]
        torch.cuda.synchronize()
        ctx.raise_on_comm_error()
        same = same and torch.equal(_bits(torch, out), _bits(torch, x))
    launched = comm.AG_PARITY_KERNEL.launches - before
    ok = same and untouched and launched == 3 and idx == 3
    return {"case": f"ag_parity_force_kernel_n1_{_dtype_name(dtype)}",
            "n": 1, "dtype": _dtype_name(dtype), "launches": launched,
            "max_abs_err": 0.0 if same else float("nan"),
            "bit_identical": same, "ok": ok}


def sp_reference(torch, pa, q, ks, vs, lens):
    """One-rank K2 (normalized) over the concatenation of the shards'
    valid rows, padded to whole 128-row pages (past kv_len, never
    read)."""
    k = torch.cat([x[:, :n] for x, n in zip(ks, lens)], dim=1)
    v = torch.cat([x[:, :n] for x, n in zip(vs, lens)], dim=1)
    b, s, hkv, d = k.shape
    pages = -(-s // 128)
    kp = torch.zeros((b, pages * 128, hkv, d), dtype=k.dtype, device=k.device)
    vp = torch.zeros_like(kp)
    kp[:, :s], vp[:, :s] = k, v
    cache = pa.PagedKVCache(
        kp.reshape(b * pages, 128, hkv, d), vp.reshape(b * pages, 128, hkv, d),
        torch.arange(b * pages, dtype=torch.int32,
                     device=k.device).reshape(b, pages),
        torch.full((b,), s, dtype=torch.int32, device=k.device))
    return pa.paged_decode_attention(q, cache)


def phase_sp_decode(torch, pa, *, devices=None, layers=36,
                    steps=SP_STEPS, name="sp_decode") -> dict:
    """SP decode at Qwen3-8B's attention widths (32 / 8 heads, d 128,
    bf16): B = 4 sequences of 32768 tokens sharded over 4 ranks (8192 rows
    a rank, ragged shard lengths with an empty one), ``layers`` layers of
    KV. ``steps`` decode steps through ``SpFlashDecodeAttention`` on the
    parity stream (K2's partials, the parity AllGather of the (B·hq,
    d + 2) partials, the combine), the last step's outputs held against
    one-rank K2 over the valid rows; then one layer through
    ``flash_decode`` with ``method="pallas"`` (B4's push) and ``"xla"``."""
    comm, _, _, context = sppp_modules()
    from triton_distributed_tpu_torch.layers.decode_layers import (
        SpFlashDecodeAttention,
    )
    from triton_distributed_tpu_torch.ops.flash_decode import flash_decode

    devices = devices or virtual_devices(SP_N)
    n = len(devices)
    ctx = context.DistContext([torch.device(d) for d in devices],
                              tp_axis="sp", wait_timeout_ms=20_000)
    bf16 = torch.bfloat16
    B, hq, hkv, d = SP_B, SP_HQ, SP_HKV, SP_D
    ks = [[_rand(torch, (B, SP_SHARD, hkv, d), bf16, 1000 + 2 * (r * layers
                                                               + i))
           .div_(4).to(devices[r]) for i in range(layers)] for r in range(n)]
    vs = [[_rand(torch, (B, SP_SHARD, hkv, d), bf16, 1001 + 2 * (r * layers
                                                               + i))
           .div_(4).to(devices[r]) for i in range(layers)] for r in range(n)]
    qs = _rand(torch, (steps, layers, B, hq, d), bf16, 999).div_(4)
    layer = SpFlashDecodeAttention(axis="sp", num_ranks=n)
    states = [None] * n
    last = [None] * n

    def decode(r, nsteps, first):
        if states[r] is None:
            states[r] = layer.init_state(B, hq, d)
        state, outs = states[r], []
        q = qs.to(devices[r])
        for t in range(first, first + nsteps):
            for i in range(layers):
                out, state = layer(q[t % steps, i], ks[r][i], vs[r][i],
                                   SP_LENS[r], state)
                if t == first + nsteps - 1:
                    outs.append(out)
        states[r] = state
        last[r] = outs
        return state[1]

    ctx.run(lambda r: decode(r, 1, 0))                  # warm-up
    torch.cuda.synchronize()
    kernels = (comm.AG_PARITY_KERNEL, pa.PAGED_KERNEL)
    reset_counts(kernels)
    t0 = time.perf_counter()
    ctx.run(lambda r: decode(r, steps, 0))
    torch.cuda.synchronize()
    ctx.raise_on_comm_error()
    wall = time.perf_counter() - t0
    launches = {"ag_parity": comm.AG_PARITY_KERNEL.launches,
                "paged_attention": pa.PAGED_KERNEL.launches}
    plain = comm.AG_PARITY_KERNEL.plain_calls + pa.PAGED_KERNEL.plain_calls
    want_l = n * layers * steps
    check(launches == {"ag_parity": want_l, "paged_attention": want_l},
          f"{name}: launches {launches}, expected {want_l} of each")
    check(plain == 0, f"{name}: a plain version ran on the card")
    tol = TOL["paged_attention"]
    held = []
    for i in range(layers):
        ref = sp_reference(torch, pa, qs[steps - 1, i].to(devices[0]),
                           [ks[r][i].to(devices[0]) for r in range(n)],
                           [vs[r][i].to(devices[0]) for r in range(n)],
                           SP_LENS)
        rec = _close(torch, last[0][i], ref, tol)
        rec["ranks_identical"] = all(torch.equal(last[r][i].to(ref.device),
                                                 last[0][i])
                                     for r in range(1, n))
        held.append(rec)
    # Two profiled steps (the parity index goes on from the timed run).
    first = [steps]

    def one_step():
        ctx.run(lambda r: decode(r, 1, first[0]))
        first[0] += 1

    split = _busy_share(torch, one_step, 2, {
        "paged_attention": "paged_decode", "ag_parity": "ag_parity"})
    if split.get("measured"):
        split["device_ms_per_layer_call"] = {
            g: ms / layers for g, ms in split["device_ms_per_step"].items()}
    one = {}
    for method in ("pallas", "xla"):
        reset_counts(kernels + (comm.AG_FULL_MESH_KERNEL,))
        outs = flash_decode(qs[0, 0], [ks[r][0] for r in range(n)],
                            [vs[r][0] for r in range(n)], SP_LENS, ctx,
                            axis="sp", method=method)
        torch.cuda.synchronize()
        ref = sp_reference(torch, pa, qs[0, 0].to(devices[0]),
                           [ks[r][0].to(devices[0]) for r in range(n)],
                           [vs[r][0].to(devices[0]) for r in range(n)],
                           SP_LENS)
        one[method] = dict(_close(torch, outs[0].to(ref.device), ref, tol),
                           launches={
                               "paged_attention": pa.PAGED_KERNEL.launches,
                               "ag_full_mesh":
                                   comm.AG_FULL_MESH_KERNEL.launches})
        one[method]["ranks_identical"] = all(
            torch.equal(o.to(ref.device), outs[0].to(ref.device))
            for o in outs)
    check(one["pallas"]["launches"]["ag_full_mesh"] == n
          and one["xla"]["launches"]["ag_full_mesh"] == 0,
          f"{name}: flash_decode's exchanges: {one}")
    bad = [(i, h) for i, h in enumerate(held)
           if not (h["ok"] and h["ranks_identical"])]
    bad += [(m, h) for m, h in one.items()
            if not (h["ok"] and h["ranks_identical"])]
    check(not bad, f"{name}: outside K2's tolerance of one rank, or the "
          f"ranks differ (layer or method, record): {bad[:4]}")
    kv_gb = 2 * n * layers * B * SP_SHARD * hkv * d * 2 / 2**30
    peak = torch.cuda.max_memory_allocated() / 1e9
    ctx.close()
    del ks, vs, states, last
    gc_collect(torch)
    return {"phase": name, "devices": devices, "layers": layers,
            "steps": steps, "batch": B, "heads": [hq, hkv], "head_dim": d,
            "shard_rows": SP_SHARD, "shard_lens": SP_LENS,
            "kv_gib": kv_gb, "peak_mem_gb": peak,
            "wall_ms_per_layer_call": wall * 1e3 / (layers * steps),
            "wall_ms_per_step": wall * 1e3 / steps,
            "device_split": split, "launches": launches,
            "launches_per_rank_and_step": {
                k: v / (n * steps) for k, v in launches.items()},
            "tolerance": tol,
            "max_abs_err": max(h["max_abs_err"] for h in held),
            "tol_share": max(h["tol_share"] for h in held),
            "one_layer": one}


def phase_sp_prefill(torch, fa, timer, *, devices=None, seq=SP_PREFILL_S,
                     name="sp_prefill") -> dict:
    """The SP prefill family at Qwen3-8B's attention widths, B = 1, S =
    ``seq``, bf16, causal, on 4 ranks: ``ring_attention``,
    ``sp_ag_attention`` and ``ulysses_attention`` each held against K1 on
    one rank over the whole sequence (K1's bf16 tolerance), timed, K1's
    launches a rank counted."""
    comm, _, _, context = sppp_modules()
    import importlib

    ops = {m: importlib.import_module(f"triton_distributed_tpu_torch.ops.{m}")
           for m in ("ring_attention", "sp_ag_attention", "ulysses")}
    devices = devices or virtual_devices(SP_N)
    n = len(devices)
    ctx = context.DistContext([torch.device(d) for d in devices],
                              tp_axis="sp", wait_timeout_ms=20_000)
    bf16 = torch.bfloat16
    q = _rand(torch, (1, seq, SP_HQ, SP_D), bf16, 31).div_(4)
    k = _rand(torch, (1, seq, SP_HKV, SP_D), bf16, 32).div_(4)
    v = _rand(torch, (1, seq, SP_HKV, SP_D), bf16, 33).div_(4)
    ref = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    shards = [list(torch.chunk(x, n, dim=1)) for x in (q, k, v)]
    shards = [[s.to(devices[r]).contiguous() for r, s in enumerate(p)]
              for p in shards]
    per_rank = {"ring_attention": n, "sp_ag_attention": n + 1,
                "ulysses_attention": 1}
    out = {}
    for fname, mod in (("ring_attention", "ring_attention"),
                       ("sp_ag_attention", "sp_ag_attention"),
                       ("ulysses_attention", "ulysses")):
        fn = getattr(ops[mod], fname)

        def call():
            return fn(*shards, ctx, axis="sp", causal=True)

        call()                                           # warm-up
        torch.cuda.synchronize()
        reset_counts((fa.FLASH_KERNEL,) + tuple(comm.COLLECTIVE_KERNELS))
        got = call()
        torch.cuda.synchronize()
        ctx.raise_on_comm_error()
        rec = _close(torch, torch.cat([g.to(ref.device) for g in got], dim=1),
                     ref, TOL["flash_attention"])
        rec["k1_launches"] = fa.FLASH_KERNEL.launches
        rec["k1_launches_per_rank"] = fa.FLASH_KERNEL.launches / n
        rec["ag_launches"] = {"ag_ring": comm.AG_RING_KERNEL.launches,
                              "ag_full_mesh":
                                  comm.AG_FULL_MESH_KERNEL.launches}
        check(rec["k1_launches"] == n * per_rank[fname],
              f"{name}: {fname} launched K1 {rec['k1_launches']} times, "
              f"expected {n * per_rank[fname]}")
        check(fa.FLASH_KERNEL.plain_calls == 0,
              f"{name}: K1's plain version ran")
        walls = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            call()
            end.record()
            torch.cuda.synchronize()
            walls.append(((time.perf_counter() - t0) * 1e3,
                          start.elapsed_time(end)))
        rec["wall_ms_runs"] = [w for w, _ in walls]
        rec["event_ms_runs"] = [e for _, e in walls]
        rec["ms"] = sorted(w for w, _ in walls)[1]
        out[fname] = rec
    one_rank_ms = timer.ms(lambda: fa.flash_attention(q, k, v, causal=True),
                           iters=3, warmup=1)
    bad = [f for f, r in out.items() if not r["ok"]]
    check(not bad, f"{name}: outside K1's tolerance of one rank: "
          f"{ {f: out[f] for f in bad} }")
    ctx.close()
    del q, k, v, ref, shards
    gc_collect(torch)
    return {"phase": name, "devices": devices, "seq": seq, "batch": 1,
            "heads": [SP_HQ, SP_HKV], "head_dim": SP_D, "dtype": "bfloat16",
            "tolerance": TOL["flash_attention"],
            "one_rank_k1_ms": one_rank_ms, "ops": out}


def pp_layers_fn(cfg, layers):
    """The stage function of the PP phases: ``layers`` decoder layers over
    one microbatch (rows, hidden) of one sequence, as
    ``models/dense.dense_prefill`` applies them at one rank —
    ``tp_attn_prefill`` at n = 1 without a KV slice, then the MLP, each
    behind its RMSNorm and added to the residual."""
    from triton_distributed_tpu_torch.layers.common import rms_norm
    from triton_distributed_tpu_torch.layers.tp_attn import tp_attn_prefill
    from triton_distributed_tpu_torch.layers.tp_mlp import tp_mlp_fwd

    def stage(x):
        for layer in layers:
            h = rms_norm(x, layer["attn_norm"], cfg.rms_norm_eps)
            attn, _ = tp_attn_prefill(layer["attn"], cfg, h, 1, x.shape[0],
                                      num_ranks=1)
            x = x + attn
            h = rms_norm(x, layer["mlp_norm"], cfg.rms_norm_eps)
            x = x + tp_mlp_fwd(layer["mlp"], h, num_ranks=1)
        return x

    return stage


def _on(tree, dev):
    """``tree``'s tensors on ``dev`` (the same tensors when already
    there: the stages share one copy of the weights on one card)."""
    if isinstance(tree, dict):
        return {k: _on(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_on(v, dev) for v in tree]
    return tree.to(dev)


def phase_pp_forward(torch, params, cfg, fa, *, devices=None,
                     num_mb=PP_MB, rows=PP_MB_ROWS, chunks=PP_CHUNKS,
                     name="pp_forward") -> dict:
    """``pp_pipeline_forward`` over ``cfg`` on 4 stages of L/4 decoder
    layers (each stage its slice of ``params["layers"]``, no copy on one
    card), ``num_mb`` microbatches of one ``rows``-token sequence, then
    ``pp_pipeline_interleaved`` with ``chunks`` chunks (4·chunks virtual
    stages of L/(4·chunks) layers). The last stage's outputs against the
    L layers run on one rank over the same microbatches (expected
    bit-identical); B7's shift launches a rank; the device's busy share;
    one ``CommOp.exchange`` with a permutation that is not a ring."""
    comm, _, p2p, context = sppp_modules()
    from triton_distributed_tpu_torch.layers.pp import (
        CommOp, pp_pipeline_forward, pp_pipeline_interleaved,
    )

    devices = devices or virtual_devices(PP_N)
    n = len(devices)
    L = len(params["layers"])
    per, per_c = L // n, L // (n * chunks)
    check(per * n == L and per_c * n * chunks == L,
          f"{name}: {L} layers do not split over {n} x {chunks}")
    ctx = context.DistContext([torch.device(d) for d in devices],
                              tp_axis="pp", wait_timeout_ms=60_000)
    dt = params["layers"][0]["attn_norm"].dtype
    x = (torch.randn((num_mb, rows, cfg.hidden_size), device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(41))
         * 0.5).to(dt)
    xs = [x.to(d) for d in devices]
    gpipe = [pp_layers_fn(cfg, _on(params["layers"][r * per:(r + 1) * per],
                                   devices[r])) for r in range(n)]
    inter = [[pp_layers_fn(cfg, _on(params["layers"][
        (c * n + r) * per_c:(c * n + r + 1) * per_c], devices[r]))
        for c in range(chunks)] for r in range(n)]
    whole = pp_layers_fn(cfg, params["layers"])
    ref = torch.stack([whole(x[i]) for i in range(num_mb)])
    torch.cuda.synchronize()

    def run_gpipe():
        return ctx.run(lambda r: pp_pipeline_forward(
            gpipe[r], xs[r], axis="pp", num_ranks=n))

    def run_inter():
        return ctx.run(lambda r: pp_pipeline_interleaved(
            lambda c, mb: inter[r][c](mb), xs[r], chunks=chunks, axis="pp",
            num_ranks=n))

    kernels = (fa.FLASH_KERNEL, comm.P2P_SHIFT_KERNEL,
               comm.P2P_PERMUTE_KERNEL)
    out = {}
    for form, run, shifts in (
            ("gpipe", run_gpipe, num_mb + n - 2),
            ("interleaved", run_inter, (num_mb + chunks * n - 2) * chunks)):
        run()                                             # warm-up
        torch.cuda.synchronize()
        reset_counts(kernels)
        t0 = time.perf_counter()
        got = run()
        torch.cuda.synchronize()
        ctx.raise_on_comm_error()
        wall = (time.perf_counter() - t0) * 1e3
        last = got[n - 1].to(ref.device)
        same = torch.equal(last, ref)
        rec = {"ms": wall, "bit_identical_to_one_rank": same,
               "max_abs_err": _max_err(last, ref),
               "shift_launches": comm.P2P_SHIFT_KERNEL.launches,
               "shift_launches_per_rank":
                   comm.P2P_SHIFT_KERNEL.launches / n,
               "expected_per_rank": shifts,
               "k1_launches": fa.FLASH_KERNEL.launches,
               "others_zero": all(not g.any() for g in got[:n - 1])}
        check(rec["shift_launches"] == n * shifts,
              f"{name}: {form} launched the shift {rec['shift_launches']} "
              f"times, expected {n * shifts}")
        check(rec["k1_launches"] == num_mb * L,
              f"{name}: {form} launched K1 {rec['k1_launches']} times, "
              f"expected {num_mb * L} (each layer once a microbatch)")
        check(comm.P2P_SHIFT_KERNEL.plain_calls == 0,
              f"{name}: B7's plain version ran")
        check(bool(torch.isfinite(last).all()) and rec["others_zero"],
              f"{name}: {form} non-finite output or other stages not zero")
        rec["busy"] = _busy_share(torch, run, 1)
        out[form] = rec
    one_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(num_mb):
            whole(x[i])
        torch.cuda.synchronize()
        one_ms.append((time.perf_counter() - t0) * 1e3)
    perm = [(s, s ^ 1) for s in range(n)]
    reset_counts(kernels)
    ys = [xs[r][0] for r in range(n)]
    ex = ctx.run(lambda r: CommOp(axis="pp", num_ranks=n).exchange(ys[r],
                                                                   perm))
    torch.cuda.synchronize()
    ctx.raise_on_comm_error()
    want = p2p.p2p_plain([y.to(x.device) for y in ys], perm)
    exchange = {"perm": perm, "shape": [rows, cfg.hidden_size],
                "launches": {"p2p_permute": comm.P2P_PERMUTE_KERNEL.launches,
                             "p2p_shift": comm.P2P_SHIFT_KERNEL.launches},
                "bit_identical": all(torch.equal(_bits(torch, e.to(x.device)),
                                                 _bits(torch, w))
                                     for e, w in zip(ex, want))}
    check(exchange["bit_identical"]
          and exchange["launches"] == {"p2p_permute": n, "p2p_shift": 0},
          f"{name}: CommOp.exchange: {exchange}")
    ctx.close()
    del gpipe, inter, xs
    gc_collect(torch)
    return {"phase": name, "devices": devices, "stages": n, "layers": L,
            "layers_per_stage": per, "chunks": chunks,
            "layers_per_virtual_stage": per_c, "microbatches": num_mb,
            "microbatch": [rows, cfg.hidden_size], "dtype": str(dt),
            "one_rank_ms_runs": one_ms, **out,
            "comm_op_exchange": exchange,
            "bit_identical": all(out[f]["bit_identical_to_one_rank"]
                                 for f in out)}


def phase_sp_pp_parity(torch, *, devices_for=virtual_devices,
                       ranks=(2, 4), name="sp_pp_parity") -> dict:
    """Every new entry point at n = 2 and 4, fp32, small shapes, on the
    card (its kernels) against the same call on CPU rank threads (the
    plain versions): byte moves bit for bit (the parity AllGather, B7's
    shift and permutation, ``CommOp``, ``PPStream``, both pipelines,
    ``AllGatherLayer``), attention (``flash_decode`` in its three
    exchanges, ``SpFlashDecodeAttention``, the SP prefill family) and
    ``GemmARLayer`` within the fp32 tolerance."""
    _, ag, p2p, context = sppp_modules()
    import importlib

    mods = {m: importlib.import_module(f"triton_distributed_tpu_torch.{m}")
            for m in ("ops.flash_decode", "ops.ring_attention",
                      "ops.sp_ag_attention", "ops.ulysses",
                      "ops.low_latency_allgather", "layers.decode_layers",
                      "layers.pp")}
    fd, dl, pp = (mods["ops.flash_decode"], mods["layers.decode_layers"],
                  mods["layers.pp"])
    tol = TOL["fp32"]
    g = torch.Generator().manual_seed(5)
    results = []
    for n in ranks:
        gpu = context.DistContext([torch.device(d) for d in devices_for(n)],
                                  tp_axis="sp", wait_timeout_ms=20_000)
        cpu = context.DistContext([torch.device("cpu")] * n, tp_axis="sp",
                                  wait_timeout_ms=60_000)
        x = torch.randn((n, 16, 256), generator=g)
        q = torch.randn((2, 8, 128), generator=g)
        kv = torch.randn((2, n, 2, 64, 2, 128), generator=g)
        qs = torch.randn((1, 64 * n, 8, 128), generator=g)
        ks = torch.randn((2, 1, 64 * n, 4, 128), generator=g)
        w = torch.randn((n, 64, 256), generator=g)
        lens = [64, 0, 17, 40][:n]
        mb = torch.randn((5, 16, 256), generator=g)

        def entry(ctx, what):
            dev = ctx.devices

            def on(t, r):
                return t.to(dev[r])

            def body(r):
                if what == "all_gather_stream":
                    ws, idx = ag.ag_stream_workspace(n, 16, 256,
                                                     torch.float32,
                                                     tag="parity")
                    outs = []
                    for t in range(3):
                        o, ws, idx = ag.all_gather_stream(
                            on(x[r], r) * (t + 1), ws, idx, num_ranks=n,
                            axis="sp")
                        outs.append(o)
                    return torch.stack(outs)
                if what == "p2p_shift":
                    return p2p.p2p_shift_local(on(x[r], r), -1, axis="sp",
                                               num_ranks=n)
                if what == "p2p_permute":
                    return p2p.p2p_permute_local(
                        on(x[r], r), [(0, n - 1), (n - 1, 0), (0, 1)]
                        if n > 2 else [(1, 0)], axis="sp", num_ranks=n)
                if what == "comm_op":
                    op = pp.CommOp(axis="sp", num_ranks=n)
                    return op.send(on(x[r], r), 1, 0) + op.exchange(
                        on(x[r], r), [(s, (s + 1) % n) for s in range(n)])
                if what == "pp_stream":
                    st = pp.PPStream(axis="sp", num_ranks=n)
                    return st.send_prev(st.send_next(on(x[r], r)))
                if what == "pp_forward":
                    return pp.pp_pipeline_forward(
                        lambda t: t * 1.5 + r, on(mb, r), axis="sp",
                        num_ranks=n)
                if what == "pp_interleaved":
                    return pp.pp_pipeline_interleaved(
                        lambda c, t: t * 0.5 + (10.0 * c + r), on(mb, r),
                        chunks=2, axis="sp", num_ranks=n)
                if what.startswith("flash_decode_"):
                    m = what[len("flash_decode_"):]
                    args = (on(q, r), on(kv[0, r], r), on(kv[1, r], r),
                            lens[r])
                    if m != "stream":
                        return fd.flash_decode_local(*args, axis="sp",
                                                     num_ranks=n, method=m)
                    layer = dl.SpFlashDecodeAttention(axis="sp",
                                                      num_ranks=n)
                    st = layer.init_state(2, 8, 128, tag="parity")
                    outs = []
                    for _ in range(3):
                        o, st = layer(*args, st)
                        outs.append(o)
                    return torch.stack(outs)
                if what == "gemm_ar_layer":
                    layer = dl.GemmARLayer(axis="sp", num_ranks=n)
                    st = layer.init_state(16, 256, tag="parity")
                    o1, st = layer(on(x[r][:, :64], r), on(w[r], r), st)
                    return torch.stack([o1, layer(on(x[r][:, :64], r),
                                                  on(w[r], r))])
                sh = [on(t[:, r * 64:(r + 1) * 64].contiguous(), r)
                      for t in (qs, ks[0], ks[1])]
                if what == "ring_attention":
                    return mods["ops.ring_attention"].ring_attention_local(
                        *sh, axis="sp", num_ranks=n)
                if what == "sp_ag_attention":
                    return mods["ops.sp_ag_attention"].sp_ag_attention_local(
                        *sh, axis="sp", num_ranks=n)
                return mods["ops.ulysses"].ulysses_attention_local(
                    *sh, axis="sp", num_ranks=n)

            if what == "allgather_layer":
                return mods["ops.low_latency_allgather"].AllGatherLayer(
                    ctx, axis="sp")(list(x[:, :5]))
            outs = ctx.run(body)
            ctx.raise_on_comm_error()
            return outs

        byte_moves = ("all_gather_stream", "p2p_shift", "p2p_permute",
                      "comm_op", "pp_stream", "pp_forward", "pp_interleaved",
                      "allgather_layer")
        for what in byte_moves + (
                "flash_decode_xla", "flash_decode_pallas",
                "flash_decode_stream", "gemm_ar_layer", "ring_attention",
                "sp_ag_attention", "ulysses_attention"):
            got = entry(gpu, what)
            torch.cuda.synchronize()
            want = entry(cpu, what)
            rec = {"case": f"{what}_n{n}", "n": n}
            if what in byte_moves:
                same = all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
                rec.update(bit_identical=same, ok=same,
                           max_abs_err=0.0 if same else float("nan"))
            else:
                closes = [_close(torch, a.cpu(), b, tol)
                          for a, b in zip(got, want)]
                rec.update(max_abs_err=max(c["max_abs_err"] for c in closes),
                           tol_share=max(c["tol_share"] for c in closes),
                           ok=all(c["ok"] for c in closes))
            results.append(rec)
        gpu.close()
        cpu.close()
    bad = [r["case"] for r in results if not r["ok"]]
    check(not bad, f"{name}: disagree with their plain versions: {bad}")
    return {"phase": name, "devices_at_4": devices_for(4),
            "tolerance": {"byte moves": "bit-identical", "attention and "
                          "GemmARLayer (fp32)": tol}, "cases": results}


# ---------------------------------------------------------------------------
# The two-tier rank group: B12's torus AllGather / AllReduce, B13's page
# pack / scatter under kv_migrate_local, and Engine.serve on (dcn, tp).
# ---------------------------------------------------------------------------

GRIDS_2D = ((2, 4), (4, 2), (2, 2))
DEGENERATE_2D = ((8, 1), (1, 8))
ROWS_2D = (1, 16, 256, 2048)
ROWS_2D_ODD = (3, 1000)       # shards off the blocks' shares (AG only)
COLS_2D = 4096
# The main shapes (bf16, (2, 4) = 8 virtual ranks): a 256-row shard a
# rank gathered (a 2 x 1024 prefill's rows over both tiers), a 16-row
# AllReduce (a verify step's rows), each through the tuple-axis entry
# points a layer would call.
MAIN_2D = {"ag_torus": 256, "ar_torus": 16}
# kv_migrate_local at Qwen3-8B widths on (dcn=2, tp=4): one 1024-token
# request, pages of 16 rows, C = 36 layers x (k, v) x 2 kv heads a tp rank
# x 128 = 18432 bf16 columns; 64 pages in two blocks, from a pool of 80
# into one of 96 at rewritten ids.
MIG_PAGE_ROWS, MIG_COLS = 16, 36 * 2 * 2 * 128
MIG_PAGES, MIG_SRC_POOL, MIG_DST_POOL = 64, 80, 96
TP2D_LAYERS = 4
TP2D_GEN = 8


def twotier_modules():
    import importlib

    names = ("ops._comm", "ops.multi_axis", "ops.allgather", "ops.allreduce",
             "runtime.context", "disagg.migrate")
    return [importlib.import_module(f"triton_distributed_tpu_torch.{n}")
            for n in names]


def grid_ctx(torch, shape, devices_for=virtual_devices, timeout_ms=20_000):
    """A (dcn, tp) group of ``shape``: virtual ranks on cuda:0, or with
    ``devices_for`` one rank a card."""
    context = twotier_modules()[4]
    return context.DistContext(
        [torch.device(d) for d in devices_for(shape[0] * shape[1])],
        mesh_shape=shape, axis_names=("dcn", "tp"),
        wait_timeout_ms=timeout_ms)


def two_shot_plain(xs, n0: int, n1: int):
    """The plain two-shot over an (n0, n1) grid: B6's ring RS along the
    outer axis on n0 super-chunks, then along the inner axis (each add in
    the payload type, in the ring's order), then every chunk gathered in
    joint order — the bits every rank must end with."""
    rs = importlib_module("ops.reduce_scatter")
    mids = {(a, b): rs.rs_ring_plain([xs[u * n1 + b] for u in range(n0)], a)
            for a in range(n0) for b in range(n1)}
    import torch

    return torch.cat([rs.rs_ring_plain([mids[(a, v)] for v in range(n1)], b)
                      for a in range(n0) for b in range(n1)])


def torus_case(torch, timer, ctx, op: str, dtype, rows: int, seed: int, *,
               method: str = "one_shot", time_it: bool = False,
               hold=None) -> dict:
    """B12 on every rank of a 2-axis group (two calls: the pad's and the
    buffers' reuse) through the tuple-axis entry points, against the plain
    version bit for bit on every rank: the AllGather against ``torch.cat``
    of the shards in joint order — on a real grid into outputs filled with
    0xFF bytes (NaN in both types) through ``out=``, so a sentinel left
    shows an element no writer reached —, the AllReduce against
    ``ar_torus_plain`` (each grid row in order, then the rows, fp32 sums
    and one cast each) or, for two-shot, against the RS-then-AG plain
    composition. ``hold``: (rank, ns) spun on that rank's stream before
    each of its calls (its writers wait for its address; its receivers
    for its shard)."""
    comm, ma, ag, ar, _, _ = twotier_modules()
    from triton_distributed_tpu_torch.runtime.build import current_stream

    n = ctx.num_ranks
    n0, n1 = ctx.mesh_shape
    axes = tuple(ctx.axis_names)
    X = _rand(torch, (n, rows, COLS_2D), dtype, seed)
    xs = [X[r].to(ctx.devices[r]) for r in range(n)]
    sentinel = op == "ag_torus" and n0 > 1 and n1 > 1
    outs = None

    def fn(r):
        if op == "ag_torus":
            return ag.all_gather_local(xs[r], axis=axes, num_ranks=(n0, n1),
                                       out=outs[r] if outs else None)
        return ar.all_reduce_local(xs[r], axis=axes, num_ranks=(n0, n1),
                                   method=method)

    def checked(r):
        if hold is not None and r == hold[0]:
            comm.SPIN.launch(hold[1], current_stream(ctx.devices[r]))
        return fn(r)

    if op == "ag_torus":
        want = ag.ag_plain(list(X))
    elif method == "two_shot":
        want = two_shot_plain(list(X), n0, n1)
    else:
        want = ma.ar_torus_plain(list(X), n0, n1)
    k0 = {k.symbol: k.launches for k in (comm.AG_TORUS_KERNEL,
                                         comm.AR_TORUS_KERNEL)}
    same = True
    for _ in range(2):
        if sentinel:
            outs = [torch.empty((n * rows, COLS_2D), dtype=dtype,
                                device=ctx.devices[r]) for r in range(n)]
            for o in outs:
                o.view(torch.uint8).fill_(0xFF)
        got = ctx.run(checked)
        torch.cuda.synchronize()
        ctx.raise_on_comm_error()
        same = same and all(torch.equal(_bits(torch, o.to(want.device)),
                                        _bits(torch, want)) for o in got)
        if sentinel:
            same = same and all(g is o for g, o in zip(got, outs))
    outs = None
    kern = comm.AG_TORUS_KERNEL if op == "ag_torus" else comm.AR_TORUS_KERNEL
    degenerate = n0 == 1 or n1 == 1
    launched = kern.launches - k0[kern.symbol]
    # A degenerate grid takes the 1-D op; two-shot's halves are B6 and B12.
    right = launched == (0 if degenerate else 2 * n)
    if op == "ar_torus" and method == "two_shot" and not degenerate:
        right = (launched == 0 and comm.AG_TORUS_KERNEL.launches
                 - k0[comm.AG_TORUS_KERNEL.symbol] == 2 * n)
    rec = {"case": f"{op}_{method if op == 'ar_torus' else 'ring'}_"
                   f"{n0}x{n1}_{_dtype_name(dtype)}_{rows}"
                   + (f"_held{hold[0]}" if hold else ""),
           "grid": [n0, n1], "op": op, "dtype": _dtype_name(dtype),
           "rows": rows, "cols": COLS_2D, "launches": launched,
           "max_abs_err": 0.0 if same else float("nan"),
           "bit_identical": same, "ok": same and right}
    if op == "ar_torus":
        rec["method"] = method
    if sentinel:
        rec["out_sentinel"] = "0xFF"
    if hold:
        rec["hold"] = list(hold)
    if time_it:
        B = rows * COLS_2D * X.element_size()
        nbytes = n * (B + n * B) if op == "ag_torus" else n * 2 * B
        rec["bound_ms"], rec["bound_by"] = _bound_ms(nbytes, 0, "float32")
        rec["bound_note"] = ("every rank reads its input once and writes "
                             "its output once, all through one card's HBM "
                             "at 3.35 TB/s")
        rec["ms"], rec["host_ms_per_call"] = _coll_ms(torch, ctx, fn, 20)
        if op == "ag_torus":
            rec["plain_ms"] = timer.ms(lambda: ag.ag_plain(list(X)))
            xp = list(X)
            rec.update(library_every_rank(
                timer, n, lambda: torch.cat(xp),
                "torch.cat of the n shards (one rank's gathered copy)"))
        else:
            rec["plain_ms"] = timer.ms(
                lambda: ma.ar_torus_plain(list(X), n0, n1))
            rec.update(library_every_rank(
                timer, n, lambda: X.sum(0),
                "X.sum(0) over the stacked inputs (one rank's sum)"))
    return rec


def torus_stream_case(torch, ctx, calls: int, seed: int) -> dict:
    """``calls`` torus AllGathers on every rank of a 2-axis group in one
    run, new bf16 data every call (16 x 256 a rank), no host sync between
    them: every call's output equal to ``torch.cat`` of its shards on
    every rank (a fast writer of call t+1 never writes call t's output),
    and every call on the kernel."""
    comm, _, ag, _, _, _ = twotier_modules()
    n = ctx.num_ranks
    dims = tuple(ctx.mesh_shape)
    axes = tuple(ctx.axis_names)
    X = _rand(torch, (calls, n, 16, 256), torch.bfloat16, seed)
    k0 = comm.AG_TORUS_KERNEL.launches

    def loop(r):
        xr = X[:, r].to(ctx.devices[r])
        return [ag.all_gather_local(xr[t], axis=axes, num_ranks=dims)
                for t in range(calls)]

    got = ctx.run(loop)
    torch.cuda.synchronize()
    ctx.raise_on_comm_error()
    bad = [t for t in range(calls) if not all(
        torch.equal(_bits(torch, got[r][t].to(X.device)),
                    _bits(torch, X[t].reshape(n * 16, 256)))
        for r in range(n))]
    launched = comm.AG_TORUS_KERNEL.launches - k0
    return {"case": f"ag_torus_stream{calls}_{dims[0]}x{dims[1]}"
                    "_bfloat16_16x256",
            "grid": list(dims), "op": "ag_torus", "calls": calls,
            "calls_wrong": bad[:8], "launches": launched,
            "max_abs_err": 0.0 if not bad else float("nan"),
            "bit_identical": not bad, "ok": not bad and launched == n * calls}


def phase_collectives_2d(torch, timer, *, devices_for=virtual_devices,
                         grids=GRIDS_2D + DEGENERATE_2D,
                         name="collectives_2d") -> dict:
    """B12 (``csrc/multi_axis.cu``) on 2-axis groups of virtual ranks on
    cuda:0: ``ag_torus`` and ``ar_torus`` at (2, 4), (4, 2) and (2, 2),
    fp32 and bf16, 1-2048 rows x 4096, bit-identical to their plain
    versions on every rank; two-shot (RS over both axes, then the torus
    AG) at the rows that divide; the degenerate (8, 1) and (1, 8) grids
    through the 1-D ops (no torus launch). The AllGather writes
    0xFF-filled outputs on every real grid; on each real grid also 3 and
    1000 rows, a held-back rank 0 and rank n - 1 (bf16, 256 rows) and 200
    calls without a sync. Then the main run — every count at 0, the
    tuple-axis AllGather and AllReduce at the main shapes on (2, 4),
    counts read — and each kernel timed there."""
    comm = twotier_modules()[0]
    cases: dict = {"ag_torus": [], "ar_torus": []}
    seed = 1300
    for shape in grids:
        ctx = grid_ctx(torch, shape, devices_for)
        for dtype in (torch.float32, torch.bfloat16):
            for rows in ROWS_2D:
                if shape in DEGENERATE_2D and rows not in (16, 256):
                    continue
                seed += 1
                cases["ag_torus"].append(torus_case(
                    torch, timer, ctx, "ag_torus", dtype, rows, seed))
                seed += 1
                cases["ar_torus"].append(torus_case(
                    torch, timer, ctx, "ar_torus", dtype, rows, seed))
                if rows % (shape[0] * shape[1]) == 0 and rows <= 256:
                    seed += 1
                    cases["ar_torus"].append(torus_case(
                        torch, timer, ctx, "ar_torus", dtype, rows, seed,
                        method="two_shot"))
        if shape not in DEGENERATE_2D:
            for dtype in (torch.float32, torch.bfloat16):
                for rows in ROWS_2D_ODD:
                    seed += 1
                    cases["ag_torus"].append(torus_case(
                        torch, timer, ctx, "ag_torus", dtype, rows, seed))
            for held in (0, shape[0] * shape[1] - 1):
                seed += 1
                cases["ag_torus"].append(torus_case(
                    torch, timer, ctx, "ag_torus", torch.bfloat16, 256, seed,
                    hold=(held, PUSH_HOLD_NS)))
            seed += 1
            cases["ag_torus"].append(torus_stream_case(
                torch, ctx, PUSH_STREAM_CALLS, seed))
        ctx.close()
        torch.cuda.empty_cache()
    main = grids[0]
    ctx = grid_ctx(torch, main, devices_for)
    n = ctx.num_ranks
    axes = tuple(ctx.axis_names)
    _, _, ag, ar, _, _ = twotier_modules()
    X = {op: [x.to(d) for x, d in zip(
        _rand(torch, (n, rows, COLS_2D), torch.bfloat16, 1399 + i),
        ctx.devices)] for i, (op, rows) in enumerate(MAIN_2D.items())}
    torch.cuda.synchronize()
    reset_counts(comm.COLLECTIVE_KERNELS)
    ctx.run(lambda r: (ag.all_gather_local(X["ag_torus"][r], axis=axes,
                                           num_ranks=main),
                       ar.all_reduce_local(X["ar_torus"][r], axis=axes,
                                           num_ranks=main)))
    torch.cuda.synchronize()
    ctx.raise_on_comm_error()
    main_launches = {"ag_torus": comm.AG_TORUS_KERNEL.launches,
                     "ar_torus": comm.AR_TORUS_KERNEL.launches}
    check(main_launches == {"ag_torus": n, "ar_torus": n},
          f"{name}: the main run launched {main_launches}")
    check(all(k.plain_calls == 0 for k in comm.COLLECTIVE_KERNELS),
          f"{name}: a plain version ran on the main run")
    for op, rows in MAIN_2D.items():
        rec = torus_case(torch, timer, ctx, op, torch.bfloat16, rows,
                         1390 + len(cases[op]), time_it=True)
        rec["main"] = True
        cases[op].append(rec)
    ctx.close()
    bad = [c["case"] for cs in cases.values() for c in cs if not c["ok"]]
    check(not bad, f"{name}: disagree with their plain versions "
          f"(or took the wrong kernel): {bad}")
    return {"phase": name, "main_grid": list(main),
            "devices": devices_for(main[0] * main[1]),
            "tolerance": "bit-identical to the plain version on every "
                         "rank (two-shot: B6's ring RS along each axis, "
                         "then the gather)",
            "main_shapes": {op: f"{main}, bf16, {rows} x {COLS_2D} a rank, "
                                "through the tuple-axis entry points"
                            for op, rows in MAIN_2D.items()},
            "main_launches": main_launches, "cases": cases}


def torus_main_case(rec, op) -> dict:
    return next(c for c in rec["cases"][op] if c.get("main"))


def _mig_pools(torch, ctx, seed: int):
    """Each rank's source pool (80 pages) and destination pool (96
    pages), bf16, seeded; the page lists: 64 distinct source pages and 64
    distinct, rewritten destination ids."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = MIG_PAGE_ROWS
    src = [torch.randn((MIG_SRC_POOL * rows, MIG_COLS), generator=g,
                       device="cuda").to(torch.bfloat16).to(d)
           for d in ctx.devices]
    dst = [torch.randn((MIG_DST_POOL * rows, MIG_COLS), generator=g,
                       device="cuda").to(torch.bfloat16).to(d)
           for d in ctx.devices]
    gh = torch.Generator().manual_seed(seed)
    src_pages = torch.randperm(MIG_SRC_POOL, generator=gh)[:MIG_PAGES]
    dst_pages = torch.randperm(MIG_DST_POOL, generator=gh)[:MIG_PAGES]
    return src, dst, src_pages.tolist(), dst_pages.tolist()


def migrate_stream_case(torch, mig, pool, dst_pool) -> dict:
    """A ``MigrationStream`` over card tensors: two blocks of 32 pages,
    each packed by ``migrate_pack`` into (k, v) halves, a copy standing
    for the hop, landed by ``migrate_scatter``; its checksums verified;
    a dropped and a corrupted block raising the named errors, and a
    stalled clock the deadline's."""
    rows = MIG_PAGE_ROWS
    half = MIG_COLS // 2
    pages = list(range(MIG_PAGES))
    dst = list(range(MIG_DST_POOL - 1, MIG_DST_POOL - 1 - MIG_PAGES, -1))
    blocks = []
    for s in (0, MIG_PAGES // 2):
        buf = mig.pack_pages(pool, pages[s:s + MIG_PAGES // 2], rows)
        blocks.append((buf[:, :half].contiguous(), buf[:, half:].contiguous()))
    dst_groups = [dst[:MIG_PAGES // 2], dst[MIG_PAGES // 2:]]
    state = {"pool": dst_pool}

    def put(kv):
        return tuple(t.clone() for t in kv)

    def land(i, kv, ids):
        state["pool"] = mig.scatter_pages(state["pool"], torch.cat(kv, 1),
                                          ids, rows)

    stream = mig.MigrationStream("smoke", blocks, dst_groups, put=put,
                                 verify=True)
    rounds = 0
    while not stream.advance(land):
        rounds += 1
    torch.cuda.synchronize()
    landed = state["pool"].view(-1, rows, MIG_COLS)
    src3 = pool.view(-1, rows, MIG_COLS)
    exact = all(torch.equal(_bits(torch, landed[d]), _bits(torch, src3[p]))
                for p, d in zip(pages, dst))
    errors = {}
    for what, hook in (("dropped", lambda i, kv: None if i == 1 else kv),
                       ("corrupted", lambda i, kv: (kv[0] + 1, kv[1])
                        if i == 0 else kv)):
        s = mig.MigrationStream("smoke", blocks, dst_groups, put=put,
                                verify=True, chaos_hook=hook)
        try:
            while not s.advance(lambda i, kv, ids: None):
                pass
            errors[what] = None
        except mig.MigrationError as exc:
            errors[what] = type(exc).__name__
    t = [0.0]
    s = mig.MigrationStream("smoke", blocks, dst_groups, put=put,
                            verify=False, timeout_s=1.0, clock=lambda: t[0])
    s.advance(lambda i, kv, ids: None)
    t[0] = 2.0
    try:
        s.advance(lambda i, kv, ids: None)
        errors["deadline"] = None
    except mig.MigrationError as exc:
        errors["deadline"] = type(exc).__name__
    ok = (exact and stream.pages_moved == MIG_PAGES and errors == {
        "dropped": "MigrationError", "corrupted": "MigrationIntegrityError",
        "deadline": "MigrationTimeoutError"})
    return {"blocks": 2, "rotations": rounds + 1,
            "pages_moved": stream.pages_moved,
            "bytes_moved": stream.bytes_moved, "pages_exact": exact,
            "errors": errors, "ok": ok}


def phase_migrate(torch, timer, *, devices_for=virtual_devices,
                  grid=(2, 4), name="migrate") -> dict:
    """``kv_migrate_local`` on a (dcn=2, tp=4) group of virtual ranks:
    one 1024-token request's KV at Qwen3-8B widths (64 pages of 16 rows x
    18432 bf16 columns, ~36 MiB a rank) from slice 0's pools into slice
    1's at rewritten ids, in two blocks. Every count at 0 before the run;
    then: every destination page bit for bit the source page of the same
    tp rank, untargeted pages and slice 0's pools unchanged, the input
    pools unchanged; the validation errors raised; B13's two kernels
    timed against their byte bounds and ``index_select`` /
    ``index_copy``; a ``MigrationStream`` over card tensors."""
    _, _, _, _, _, mig = twotier_modules()
    ctx = grid_ctx(torch, grid, devices_for)
    n, rows = ctx.num_ranks, MIG_PAGE_ROWS
    senders = n // 2
    src, dst, src_pages, dst_pages = _mig_pools(torch, ctx, 1350)
    src_copy = [t.clone() for t in src]
    dst_copy = [t.clone() for t in dst]
    torch.cuda.synchronize()
    reset_counts(mig.MIGRATE_KERNELS)

    def fn(r):
        return mig.kv_migrate_local(src[r], dst[r], src_pages, dst_pages,
                                    inter_axis="dcn", n_inter=2,
                                    page_rows=rows)

    t0 = time.perf_counter()
    got = ctx.run(fn)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = {"migrate_pack": mig.MIGRATE_PACK_KERNEL.launches,
                "migrate_scatter": mig.MIGRATE_SCATTER_KERNEL.launches}
    check(launches == {"migrate_pack": 2 * senders,
                       "migrate_scatter": 2 * senders},
          f"{name}: launches {launches} ({senders} senders x 2 blocks each "
          "way)")
    check(all(k.plain_calls == 0 for k in mig.MIGRATE_KERNELS),
          f"{name}: a plain version ran")
    landed_ok, untouched_ok = True, True
    targets = set(dst_pages)
    for r in range(n):
        a, b = ctx.coords(r)
        if a == 0:
            untouched_ok = untouched_ok and got[r] is dst[r]
            continue
        peer = ctx.fiber_members(r, "dcn")[0]
        out3 = got[r].view(-1, rows, MIG_COLS)
        src3 = src_copy[peer].to(got[r].device).view(-1, rows, MIG_COLS)
        old3 = dst_copy[r].view(-1, rows, MIG_COLS)
        landed_ok = landed_ok and all(
            torch.equal(_bits(torch, out3[d]), _bits(torch, src3[s]))
            for s, d in zip(src_pages, dst_pages))
        rest = [p for p in range(MIG_DST_POOL) if p not in targets]
        idx = torch.tensor(rest, device=got[r].device)
        untouched_ok = untouched_ok and torch.equal(
            _bits(torch, out3.index_select(0, idx)),
            _bits(torch, old3.index_select(0, idx)))
    inputs_kept = all(torch.equal(_bits(torch, s), _bits(torch, c))
                      for s, c in zip(src + dst, src_copy + dst_copy))
    errors = {}
    for what, args in (("pair", ((0, 1), (2,))),
                       ("duplicate", ((0, 1), (2, 2))),
                       ("range", ((MIG_SRC_POOL,), (0,)))):
        try:
            mig.kv_migrate_local(src[0], dst[0], *args, inter_axis="dcn",
                                 n_inter=2, page_rows=rows)
            errors[what] = None
        except ValueError as exc:
            errors[what] = str(exc)[:80]
    check(all(errors.values()), f"{name}: validation not raised: {errors}")
    check(landed_ok and untouched_ok and inputs_kept,
          f"{name}: landed {landed_ok}, untouched {untouched_ok}, inputs "
          f"kept {inputs_kept}")
    del src_copy, dst_copy
    # B13 alone at the main path's call, one block of 32 pages, on rank
    # 0's card (its destination pool is one the run kept).
    pool, dpool = src[0], dst[0]
    blk = src_pages[:MIG_PAGES // 2]
    ids_blk = torch.tensor(blk, device="cuda")
    dids = torch.tensor(dst_pages[:MIG_PAGES // 2], device="cuda")
    buf = mig.pack_pages(pool, blk, rows)
    page_bytes = rows * MIG_COLS * pool.element_size()
    pool3 = pool.view(-1, rows, MIG_COLS)
    dpool3 = dpool.view(-1, rows, MIG_COLS)
    buf3 = buf.view(-1, rows, MIG_COLS)
    pack = {"case": "pack_32_pages", "pages": len(blk),
            "page_bytes": page_bytes,
            "max_abs_err": 0.0 if torch.equal(
                buf, mig.pack_plain(pool, blk, rows)) else float("nan")}
    pack["bound_ms"], pack["bound_by"] = _bound_ms(
        2 * len(blk) * page_bytes, 0, "float32")
    # The kernel's time: its launch on device ids made beforehand (the
    # wrapper's call also builds and uploads the ids on the host, which
    # the events would count as device idle: ``wrapper_ms``).
    from triton_distributed_tpu_torch.runtime.build import (
        current_stream, ptr,
    )

    ids32, dids32 = ids_blk.to(torch.int32), dids.to(torch.int32)
    out_p, out_s = torch.empty_like(buf), torch.empty_like(dpool)

    def pack_launch():
        mig.MIGRATE_PACK_KERNEL.launch(
            ptr(pool), ptr(ids32), ptr(out_p), page_bytes, len(blk),
            MIG_SRC_POOL, current_stream(pool.device))

    def scatter_launch():
        mig.MIGRATE_SCATTER_KERNEL.launch(
            ptr(dpool), ptr(buf), ptr(dids32), ptr(out_s), page_bytes,
            len(blk), MIG_DST_POOL, current_stream(dpool.device))

    pack["ms"] = timer.ms(pack_launch)
    pack["wrapper_ms"] = timer.ms(lambda: mig.pack_pages(pool, blk, rows))
    pack["plain_ms"] = timer.ms(lambda: mig.pack_plain(pool, blk, rows))
    pack["library_ms"] = timer.ms(lambda: pool3.index_select(0, ids_blk))
    pack["library_call"] = "pool.view(P, 16, C).index_select(0, pages)"
    scat = {"case": "scatter_32_pages_into_96", "pages": len(blk),
            "pool_pages": MIG_DST_POOL, "page_bytes": page_bytes,
            "max_abs_err": 0.0 if torch.equal(
                mig.scatter_pages(dpool, buf, dst_pages[:32], rows),
                mig.scatter_plain(dpool, buf, dst_pages[:32], rows))
            else float("nan")}
    scat["bound_ms"], scat["bound_by"] = _bound_ms(
        2 * MIG_DST_POOL * page_bytes, 0, "float32")
    scat["bound_note"] = ("the pool's untargeted pages and the buffer read "
                          "once, the whole new pool written once")
    scat["ms"] = timer.ms(scatter_launch)
    scat["wrapper_ms"] = timer.ms(lambda: mig.scatter_pages(
        dpool, buf, dst_pages[:32], rows))
    torch.cuda.synchronize()
    pack["launch_equals_wrapper"] = bool(torch.equal(out_p, buf))
    scat["launch_equals_wrapper"] = bool(torch.equal(
        out_s, mig.scatter_pages(dpool, buf, dst_pages[:32], rows)))
    scat["plain_ms"] = timer.ms(lambda: mig.scatter_plain(
        dpool, buf, dst_pages[:32], rows))
    scat["library_ms"] = timer.ms(lambda: dpool3.index_copy(0, dids, buf3))
    scat["library_call"] = ("pool.view(P, 16, C).index_copy(0, pages, "
                            "buf): out of place, one call")
    for c in (pack, scat):
        c["ok"] = c["max_abs_err"] == 0.0 and c["launch_equals_wrapper"]
    check(pack["ok"] and scat["ok"], f"{name}: B13 differs from its plain "
                                     "version")
    stream = migrate_stream_case(torch, mig, src[0], dst[0])
    check(stream["ok"], f"{name}: MigrationStream wrong: {stream}")
    ctx.close()
    return {"phase": name, "grid": list(grid),
            "devices": devices_for(n),
            "request": {"tokens": MIG_PAGES * rows, "pages": MIG_PAGES,
                        "page_rows": rows, "cols": MIG_COLS,
                        "dtype": "bfloat16", "blocks": 2,
                        "bytes_a_rank": MIG_PAGES * page_bytes},
            "wall_ms": wall_ms, "launches": launches,
            "landed_bit_identical": landed_ok,
            "untargeted_and_prefill_slice_kept": untouched_ok,
            "inputs_unchanged": inputs_kept, "validation": errors,
            "cases": {"migrate_pack": [pack], "migrate_scatter": [scat]},
            "stream": stream}


def _twotier_counts(comm, gemm) -> dict:
    return {"ag_gemm": comm.AG_GEMM_KERNEL.launches,
            "gemm_rs": comm.GEMM_RS_KERNEL.launches,
            "allgather_ring": comm.AG_RING_KERNEL.launches,
            "reduce_scatter_ring": comm.RS_RING_KERNEL.launches,
            "gemm": gemm.GEMM_KERNEL.launches,
            "ag_torus": comm.AG_TORUS_KERNEL.launches,
            "ar_torus": comm.AR_TORUS_KERNEL.launches,
            "others": sum(k.launches for k in comm.COLLECTIVE_KERNELS
                          if k not in (comm.AG_GEMM_KERNEL,
                                       comm.GEMM_RS_KERNEL,
                                       comm.AG_RING_KERNEL,
                                       comm.RS_RING_KERNEL,
                                       comm.AG_TORUS_KERNEL,
                                       comm.AR_TORUS_KERNEL))}


def _layers_cut(params, cfg, layers: int):
    """A config and a parameter dict of the first ``layers`` layers (the
    tensors shared, not copied)."""
    cut = dict(params, layers=params["layers"][:layers])
    return dataclasses.replace(cfg, num_layers=layers), cut


def _serve_timed(torch, eng, ids, gen: int) -> dict:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.serve(ids, gen)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    logits, _ = eng.prefill(ids)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    eng.check_comm()
    check(bool(torch.isfinite(logits).all()), "tp2d_engine: non-finite "
                                              "logits")
    return {"serve_s": serve_s, "prefill_ms": prefill_s * 1e3,
            "decode_ms_per_step": (serve_s - prefill_s) * 1e3 / (gen - 1),
            "tokens_per_s": ids.shape[0] * gen / serve_s, "tokens": out}


def _rms(t) -> float:
    return t.float().pow(2).mean().sqrt().item()


def tp2d_fused_case(torch, eng, seed: int, m: int = 256) -> dict:
    """B9, B10 and B3 (on each landed slice block) under
    ``ag_gemm_2d_local`` / ``gemm_rs_2d_local`` on the engine's (dcn, tp)
    group at its prefill's shapes: ``m`` rows a rank and each rank's own
    layer-0 weights, every rank's output held against the plain
    composition. AG+GEMM: the rows gathered in global order times the
    rank's columns in fp32, one cast; B3's tolerance (2^-13 s plus one
    unit of the output type). GEMM+RS: each rank's fp32 partial cast to
    the payload type, each slice's partials of the rank's rows summed in
    slot order in fp32 and cast, the slice sums added in the inter ring's
    order (me+1, ..., me) in the payload type; the tolerance is B3's
    2^-13 s_j for each of the N partials plus one unit of the output type
    at each rounding of the path, of the value rounded there (the N
    partials, the n_inter slice sums, the n_inter - 1 ring sums)."""
    hier = importlib_module("ops.hierarchical")
    ar = importlib_module("ops.allreduce")
    ctx, n1, n0 = eng.ctx, eng.n, eng.n_inter
    N = n0 * n1
    axes = (eng.inter_axis, eng.axis)
    kw = dict(intra_axis=eng.axis, inter_axis=eng.inter_axis, n_intra=n1,
              n_inter=n0)
    gidx = [ctx.axis_index(r, axes) for r in range(N)]
    rank_at = {g: r for r, g in enumerate(gidx)}
    layers = [eng.rank_params[r]["layers"][0] for r in range(N)]
    dt, dev = layers[0]["attn"]["wq"].dtype, layers[0]["attn"]["wq"].device
    unit = GEMM_ROUND[_dtype_name(dt)]["rtol"]
    atol_s = GEMM_TOL["fp32" if dt == torch.float32 else "bf16"]["atol_s"]
    gen = torch.Generator(device=dev).manual_seed(seed)
    h = eng.cfg.hidden_size
    X = torch.randn((N, m, h), generator=gen, device=dev).to(dt)
    full = X.reshape(N * m, h)
    cases = []
    for sub, name in (("attn", "wq"), ("attn", "wk"), ("attn", "wv"),
                      ("mlp", "w_gate"), ("mlp", "w_up")):
        ws = [lp[sub][name] for lp in layers]
        outs = ctx.run(lambda r: hier.ag_gemm_2d_local(
            X[gidx[r]].to(ctx.devices[r]), ws[r], **kw))
        torch.cuda.synchronize()
        ctx.raise_on_comm_error()
        errs = [_gemm_share(
            torch, outs[r].to(full.device),
            (full.float() @ ws[r].float().to(full.device)).to(dt),
            h ** 0.5 * _rms(full) * _rms(ws[r]), dt) for r in range(N)]
        share = max(s for _, s in errs)
        cases.append({"case": f"ag_gemm_2d_{name}", "rows_a_rank": m,
                      "k": h, "ncols": ws[0].shape[1],
                      "max_abs_err": max(e for e, _ in errs),
                      "tol_share": share, "ok": share <= 1.0})
    slice_rows = n1 * m
    for sub, name in (("attn", "wo"), ("mlp", "w_down")):
        ws = [lp[sub][name] for lp in layers]
        k = ws[0].shape[0]
        A = torch.randn((N, N * m, k), generator=gen, device=dev).to(dt)
        outs = ctx.run(lambda r: hier.gemm_rs_2d_local(
            A[r].to(ctx.devices[r]), ws[r], **kw))
        torch.cuda.synchronize()
        ctx.raise_on_comm_error()
        parts = [(A[r].float() @ ws[r].float().to(A.device)).to(dt)
                 for r in range(N)]
        s_sum = sum(atol_s * k ** 0.5 * _rms(A[r]) * _rms(ws[r])
                    for r in range(N))
        err, share = 0.0, 0.0
        for r in range(N):
            a, b = divmod(gidx[r], n1)
            rows = slice(a * slice_rows + b * m, a * slice_rows + (b + 1) * m)
            mine = [[parts[rank_at[s * n1 + j]][rows] for j in range(n1)]
                    for s in range(n0)]
            slices = [ar.reduce_slots_plain(p) for p in mine]
            mag = sum(p.float().abs() for ps in mine for p in ps)
            mag = mag + sum(s.float().abs() for s in slices)
            acc = slices[(a + 1) % n0]
            for t in range(2, n0 + 1):
                acc = acc + slices[(a + t) % n0]
                mag = mag + acc.float().abs()
            diff = (outs[r].to(acc.device).float() - acc.float()).abs()
            err = max(err, diff.max().item())
            share = max(share, (diff / (s_sum + unit * mag)).max().item())
        cases.append({"case": f"gemm_rs_2d_{name}", "rows_a_rank": m,
                      "rows_in": N * m, "k": k, "ncols": ws[0].shape[1],
                      "max_abs_err": err, "tol_share": share,
                      "ok": share <= 1.0})
        del A, parts
    bad = [c["case"] for c in cases if not c["ok"]]
    check(not bad, f"tp2d_engine: the fused 2-D ops disagree with their "
                   f"plain composition: {bad}")
    return {"cases": cases, "tol": "AG+GEMM: 2^-13 s + one unit of the "
            "output type of the value (B3's); GEMM+RS: 2^-13 s_j summed "
            "over the N partials + one unit of the output type at each "
            "rounding of the path, of the value rounded there"}


def phase_tp2d_engine(torch, params, cfg, Engine, kernels) -> dict:
    """Qwen3-8B at full width, cut to 4 layers, bf16: ``Engine.serve`` on
    a (dcn=2, tp=4) group of 8 virtual ranks (the TP group spans both
    tiers: 8 kv heads over 8 joint ranks, one a rank) with the defaults,
    a 2 x 1024 prompt for 8 tokens — the prefill in "overlap2d" (256 rows
    a rank: B9 5 a layer, B10 2 a layer and slice chunk, B3 5 a layer for
    the remote slice's rows), the decode through the two-tier
    ``tp_reduce`` — every count at 0 before and read after; then B9, B10
    and B3 under the 2-D fused ops at the prefill's shapes against their
    plain composition (:func:`tp2d_fused_case`) and every rank's prefill
    logits bit-identical; then the one-axis TP=4 engine's serve of the
    same prompt in the same call."""
    comm = twotier_modules()[0]
    gemm = importlib_module("ops.gemm")
    context = twotier_modules()[4]
    cfg4, params4 = _layers_cut(params, cfg, TP2D_LAYERS)
    L = TP2D_LAYERS
    ctx = context.initialize_distributed(
        devices=virtual_devices(8), mesh_shape=(2, 4),
        axis_names=("dcn", "tp"), wait_timeout_ms=60_000)
    eng = Engine(cfg4, params4, ctx, max_seq=2048)
    check(eng.hierarchical and eng.n_total == 8 and eng.n_inter == 2,
          "tp2d_engine: the engine did not take the two-tier layout")
    g = torch.Generator(device="cuda").manual_seed(37)
    ids = torch.randint(0, cfg.vocab_size, (2, 1024), generator=g,
                        device="cuda", dtype=torch.int32)
    mode = eng._prefill_mode(2, 1024)
    check(mode == "overlap2d", f"tp2d_engine: the 2 x 1024 prefill took "
                               f"{mode!r}")
    eng.serve(ids[:, :64], 2)                                  # warm-up
    allk = list(kernels) + list(comm.COLLECTIVE_KERNELS) + [gemm.GEMM_KERNEL]
    torch.cuda.synchronize()
    reset_counts(allk)
    t0 = time.perf_counter()
    out = eng.serve(ids, TP2D_GEN)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    c = _twotier_counts(comm, gemm)
    nr = ctx.num_ranks
    want = {"ag_gemm": nr * 5 * L, "gemm_rs": nr * 2 * 2 * L,
            "gemm": nr * 5 * L, "allgather_ring": 0,
            "reduce_scatter_ring": 0, "ag_torus": 0, "ar_torus": 0,
            "others": 0}
    check(c == want, f"tp2d_engine: launches {c}, expected {want}")
    check(all(k.plain_calls == 0 for k in allk),
          "tp2d_engine: a plain version ran on the main path")
    check(tuple(out.shape) == (2, TP2D_GEN) and bool(
        ((out >= 0) & (out < cfg.vocab_size)).all()),
        "tp2d_engine: bad output")
    timed = _serve_timed(torch, eng, ids, TP2D_GEN)
    toks2d = timed.pop("tokens")
    fused = tp2d_fused_case(torch, eng, seed=43)
    idr = eng.replicate(ids)
    caches = eng.new_cache(2)
    logits = eng.run(lambda r: eng._prefill_fn(
        eng.rank_params[r], cfg4, idr[r], caches[r],
        **eng.tp_kwargs(mode))[0])
    torch.cuda.synchronize()
    eng.check_comm()
    replicas = all(torch.equal(x, logits[0]) for x in logits[1:])
    check(replicas, "tp2d_engine: the ranks' prefill logits differ")
    del eng, caches, logits
    ctx.close()
    gc_collect(torch)
    ctx4 = context.initialize_distributed(devices=virtual_devices(TP),
                                          wait_timeout_ms=60_000)
    eng4 = Engine(cfg4, params4, ctx4, max_seq=2048)
    eng4.serve(ids[:, :64], 2)
    tp4 = _serve_timed(torch, eng4, ids, TP2D_GEN)
    toks4 = tp4.pop("tokens")
    tp4["prefill_mode"] = eng4._prefill_mode(2, 1024)
    del eng4
    ctx4.close()
    gc_collect(torch)
    return {"phase": "tp2d_engine", "grid": {"dcn": 2, "tp": 4},
            "layers": L, "dtype": cfg.dtype, "batch": 2, "prompt": 1024,
            "gen": TP2D_GEN, "prefill_mode": mode, "rows_a_rank": 256,
            "serve_s": serve_s, **timed,
            "launches": c,
            "launches_per_rank": {
                "ag_gemm": {"per_prefill": 5 * L, "per_decode_step": 0},
                "gemm_rs": {"per_prefill": 4 * L, "per_decode_step": 0},
                "gemm": {"per_prefill": 5 * L, "per_decode_step": 0},
                "allgather_ring": {"per_prefill": 0, "per_decode_step": 0},
                "reduce_scatter_ring": {"per_prefill": 0,
                                        "per_decode_step": 0}},
            "decode_note": "the decode's 2-row reductions do not divide "
                           "over the 4 tp ranks, so the two-tier tp_reduce "
                           "takes the plain sums (as the reference's)",
            "fused_2d_vs_plain": fused,
            "rank_logits_bit_identical": replicas,
            "tp4_one_axis": tp4,
            "bf16_tokens_equal_tp4": bool(torch.equal(toks2d, toks4)),
            "bf16_tokens_note": "recorded, not checked: the two layouts "
                                "sum in different orders in bf16; "
                                "tp2d_parity holds the tokens at fp32",
            "note": "8 ranks share one card's SMs and HBM, and the inter "
                    "hop is a handover on one host: these times say "
                    "nothing of two hosts"}


def importlib_module(name: str):
    import importlib

    return importlib.import_module(f"triton_distributed_tpu_torch.{name}")


def phase_tp2d_parity(torch, QWEN3_8B, init_dense_llm, Engine, kernels
                      ) -> dict:
    """float32 Qwen3-8B widths at 2 layers: ``Engine.serve`` on (dcn=2,
    tp=4) gives the one-rank engine's tokens (``backend="overlap"``, which
    takes "overlap2d" whenever the rows divide over both tiers: a 2 x 64
    prompt; and 1 x 12, whose rows do not: "ar", its reductions through
    the two-tier AllReduce's B6 and B4), every rank's prefill logits
    bit-identical."""
    comm = twotier_modules()[0]
    context = twotier_modules()[4]
    cfg = dataclasses.replace(QWEN3_8B, num_layers=2, dtype="float32")
    params = init_dense_llm(
        cfg, generator=torch.Generator(device="cuda").manual_seed(6))
    ctx = context.initialize_distributed(
        devices=virtual_devices(8), mesh_shape=(2, 4),
        axis_names=("dcn", "tp"), wait_timeout_ms=60_000)
    one = Engine(cfg, params, max_seq=256)
    eng = Engine(cfg, params, ctx, max_seq=256, backend="overlap")
    check(eng.hierarchical, "tp2d_parity: not the two-tier layout")
    g = torch.Generator().manual_seed(41)
    result = {"phase": "tp2d_parity", "grid": {"dcn": 2, "tp": 4},
              "layers": 2, "dtype": "float32"}
    allk = list(kernels) + list(comm.COLLECTIVE_KERNELS)
    for name, shape in (("overlap2d", (2, 64)), ("ar", (1, 12))):
        prompt = torch.randint(0, cfg.vocab_size, shape, generator=g,
                               dtype=torch.int32)
        check(eng._prefill_mode(*shape) == name,
              f"tp2d_parity: {shape} took {eng._prefill_mode(*shape)}")
        want = one.serve(prompt.cuda(), 16)
        reset_counts(allk)
        got = eng.serve(prompt, 16)
        c = _tp_counts(comm)
        kerns = (("ag_gemm", "gemm_rs") if name == "overlap2d" else
                 ("reduce_scatter_ring", "allgather_ring"))
        check(all(c[k] > 0 for k in kerns),
              f"tp2d_parity {name}: a kernel of the path never ran: {c}")
        check(all(k.plain_calls == 0 for k in allk),
              f"tp2d_parity {name}: a plain version ran")
        same = torch.equal(got.cpu(), want.cpu())
        if not same:
            emit({"phase": "tp2d_parity", "run": name, "tp2d": got.tolist(),
                  "one": want.tolist()})
        check(same, f"tp2d_parity {name}: tokens differ from one rank's")
        ids = eng.replicate(prompt)
        caches = eng.new_cache(shape[0])
        mode = eng._prefill_mode(*shape)
        logits = eng.run(lambda r: eng._prefill_fn(
            eng.rank_params[r], cfg, ids[r], caches[r],
            **eng.tp_kwargs(mode))[0])
        torch.cuda.synchronize()
        replicas = all(torch.equal(x, logits[0]) for x in logits)
        check(replicas, f"tp2d_parity {name}: the ranks' logits differ")
        result[name] = {"prompt": list(shape), "gen": 16,
                        "identical_to_one_rank": True,
                        "rank_logits_bit_identical": replicas,
                        "launches": c}
    ctx.close()
    return result


def _summary_entry(kernel, name, replaces, cases, main_case, launches,
                   root) -> dict:
    return {"name": name, "route": "cuda",
            "source": str(kernel.source_path.relative_to(root)),
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"]}


def main() -> int:
    import gc

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
    mkbuilder = importlib.import_module(
        "triton_distributed_tpu_torch.megakernel.builder")
    mkmodels = importlib.import_module(
        "triton_distributed_tpu_torch.megakernel.models")
    gemm = importlib.import_module("triton_distributed_tpu_torch.ops.gemm")
    moe = importlib.import_module("triton_distributed_tpu_torch.ops.moe")
    from triton_distributed_tpu_torch.models.config import (
        QWEN3_8B, QWEN3_30B_A3B,
    )
    from triton_distributed_tpu_torch.models.dense import init_dense_llm
    from triton_distributed_tpu_torch.models.engine import Engine
    from triton_distributed_tpu_torch.models.kv_cache import (
        kv_pool_pages_for_budget,
    )
    from triton_distributed_tpu_torch.runtime import build
    from triton_distributed_tpu_torch.serving import ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = (fa.FLASH_KERNEL, pa.PAGED_KERNEL, mk.MEGA_KERNEL)
    e4m3 = torch.float8_e4m3fn
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    t_start = time.perf_counter()

    def emit_phase(rec):
        rec["nvidia_smi"] = smi
        rec["elapsed_s"] = time.perf_counter() - t_start
        emit(rec)
        return rec

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
    cases.update(phase_megakernel_cases(torch, mk, mkserv, mkbuilder, timer,
                                        QWEN3_8B))
    cases.update(phase_moe_cases(torch, mk, mkmodels, mkserv, timer,
                                 QWEN3_30B_A3B))
    cases.update(phase_gemm_cases(torch, gemm, timer))
    cases["megakernel_ar"], ar_timeout = phase_megakernel_ar(torch, timer)
    check(ar_timeout["ok"], f"megakernel_ar: the held-back rank did not "
                            f"raise the kernel's CommTimeoutError: "
                            f"{ar_timeout}")
    L = QWEN3_8B.num_layers
    emit_phase({"phase": "kernels", "tol_reason": TOL_REASON,
                "launches_per_step": {
                    "flash_attention": f"{L} per prefill or prefill slice "
                                       "(one per layer)",
                    "paged_attention": f"{L} per decode or verify step (one "
                                       "per layer) on the eager lane",
                    "paged_attention_e4m3": "the same, over e4m3 pools",
                    "megakernel": "1 per decode step on the megakernel lane",
                    "megakernel_kv8": "the same, over e4m3 pools",
                    "megakernel_window": "the same, under speculative "
                                         "decode",
                    "megakernel_rows": "the same, with windows of more "
                                       "than 4 rows (spec_k >= 4)",
                    "megakernel_linear": "1 per decoded token of "
                                         "Engine.serve(backend='megakernel')",
                    "megakernel_linear_w8": "the same, on the fp8-weight "
                                            "decoder",
                    "flash_attention_g8": "48 per prefill or slice of "
                                          "Qwen3-30B-A3B",
                    "paged_attention_g8": "48 per decode step of "
                                          "Qwen3-30B-A3B on the eager lane",
                    "megakernel_moe": "1 per step of the MoE decode "
                                      "program (MOE_TOPK and MOE_FFN once "
                                      "per layer)",
                    "gemm": f"{7 * L} per step of the fp8 decode "
                            "(dense_decode_step(dot_fn=fp8_dot)); per "
                            "non-empty expert group and projection over "
                            "e4m3 expert stacks",
                    "megakernel_ar": f"1 launch a rank a step of "
                                     f"Engine.serve(backend='megakernel') "
                                     f"on a TP group, {2 * L} "
                                     "ALLREDUCE_ROW rows in it"},
                "megakernel_ar_timeout": ar_timeout,
                "cases": cases})
    bad = [c["case"] for cs in cases.values() for c in cs if not c["ok"]]
    check(not bad, f"kernels disagree with their plain versions: {bad}")
    tuned_rec = emit_phase(phase_gemm_tuned(torch, gemm, timer))
    emit({"note": "collectives: n virtual ranks on cuda:0 for n = 2, 4, "
                  "8, asked for explicitly: devices=['cuda:0'] * n"})
    coll_rec = emit_phase(phase_collectives(torch, timer, fa, pa))
    gc.collect()
    torch.cuda.empty_cache()
    a2a_rec = emit_phase(phase_a2a(torch, timer))
    gc.collect()
    torch.cuda.empty_cache()
    fused_rec = emit_phase(phase_fused(torch, timer))
    gc.collect()
    torch.cuda.empty_cache()
    sppp_rec = emit_phase(phase_collectives_sp_pp(torch, timer))
    gc.collect()
    torch.cuda.empty_cache()
    spd_rec = emit_phase(phase_sp_decode(torch, pa))
    emit_phase(phase_sp_prefill(torch, fa, timer))
    gc.collect()
    torch.cuda.empty_cache()
    c2d_rec = emit_phase(phase_collectives_2d(torch, timer))
    gc.collect()
    torch.cuda.empty_cache()
    mig_rec = emit_phase(phase_migrate(torch, timer))
    gc.collect()
    torch.cuda.empty_cache()

    # One set of seeded Qwen3-8B weights serves every full-size phase.
    params = init_dense_llm(
        QWEN3_8B, generator=torch.Generator(device="cuda").manual_seed(0))
    eng = Engine(QWEN3_8B, params, max_seq=2048, page_size=16)
    emit_phase(phase_engine(torch, eng, kernels[:2]))
    vocab = QWEN3_8B.vocab_size
    prompts = random_prompts(torch, vocab, SERVING_LENGTHS, 12)
    phrases = phrase_prompts(torch, vocab, SERVING_LENGTHS, 15)
    serving_rec = emit_phase(phase_serving(torch, eng, kernels,
                                           ServingEngine, prompts=prompts))
    budget_pages = {f"page_{pg}": {
        dt: kv_pool_pages_for_budget(QWEN3_8B, page_size=pg,
                                     hbm_bytes=KV_BUDGET, kv_dtype=kv)
        for dt, kv in (("bfloat16", None), ("float8_e4m3fn", e4m3))}
        for pg in (16, 128)}
    eng8 = Engine(QWEN3_8B, params, max_seq=2048, page_size=16,
                  kv_dtype=e4m3)
    fp8_rec = phase_serving(torch, eng8, kernels, ServingEngine,
                            name="fp8_serving", prompts=prompts,
                            kv_hbm_budget=KV_BUDGET)
    fp8_rec["kv_hbm_budget"] = KV_BUDGET
    fp8_rec["pool_pages_at_budget"] = budget_pages
    check(fp8_rec["pool_pages"] == budget_pages["page_16"]["float8_e4m3fn"],
          "fp8 serving: the pool is not what the budget buys")
    emit_phase(fp8_rec)
    spec_rec = emit_phase(phase_serving(torch, eng, kernels, ServingEngine,
                                        name="spec_serving", prompts=phrases,
                                        spec_k=SPEC_K))
    del eng, eng8
    gc.collect()
    torch.cuda.empty_cache()
    tp_rec = phase_tp_serving(torch, params, QWEN3_8B, Engine, ServingEngine,
                              kernels, prompts, phrases)
    tp_rec["tp1_serving"] = {k: serving_rec[k] for k in (
        "tokens_per_s", "ttft_ms_p50", "decode_window")}
    emit_phase(tp_rec)
    gc.collect()
    torch.cuda.empty_cache()
    tpe_rec = emit_phase(phase_tp_engine(torch, params, QWEN3_8B, Engine,
                                         kernels))
    gc.collect()
    torch.cuda.empty_cache()
    emit_phase(phase_tp2d_engine(torch, params, QWEN3_8B, Engine, kernels))
    gc.collect()
    torch.cuda.empty_cache()

    mk_args = (torch, mk, kernels, Engine, ServingEngine, params, QWEN3_8B)
    mk_rec = phase_megakernel_serving(*mk_args, prompts=prompts)
    mk_rec["eager_lane"] = {k: serving_rec[k] for k in (
        "tokens_per_s", "ttft_ms_p50", "decode_window")}
    emit_phase(mk_rec)
    gc.collect()
    torch.cuda.empty_cache()
    mk8_rec = phase_megakernel_serving(*mk_args, name="fp8_megakernel_serving",
                                       prompts=prompts, kv_dtype=e4m3,
                                       kv_hbm_budget=KV_BUDGET)
    mk8_rec["kv_hbm_budget"] = KV_BUDGET
    mk8_rec["pool_pages_at_budget"] = budget_pages
    emit_phase(mk8_rec)
    gc.collect()
    torch.cuda.empty_cache()
    mks_rec = emit_phase(phase_megakernel_serving(
        *mk_args, name="spec_megakernel_serving", prompts=phrases,
        spec_k=SPEC_K))
    gc.collect()
    torch.cuda.empty_cache()
    # The window past one row group (W = 5), beside the W = 4 run above.
    mks4_rec = phase_megakernel_serving(
        *mk_args, name="spec4_megakernel_serving", prompts=phrases,
        spec_k=SPEC_K_ROWS)
    mks4_rec["window_4_lane"] = {k: mks_rec[k] for k in (
        "tokens_per_s", "ttft_ms_p50", "decode_window", "step_kernel")}
    emit_phase(mks4_rec)
    del mk_args
    gc.collect()
    torch.cuda.empty_cache()
    lin_rec = emit_phase(phase_megakernel_engine(
        torch, mk, mkserv, kernels, Engine, params, QWEN3_8B, timer))
    bf16_prof = lin_rec["forms"]["bf16"]["profile"]
    gc.collect()
    torch.cuda.empty_cache()
    emit_phase(phase_linear_engine(torch, kernels, gemm.GEMM_KERNEL, Engine,
                                   params, QWEN3_8B))
    fp8_dec_rec = emit_phase(phase_fp8_decode(
        torch, kernels, gemm.GEMM_KERNEL, Engine, params, QWEN3_8B))
    gc.collect()
    torch.cuda.empty_cache()
    tpmk_rec = emit_phase(phase_tp_megakernel_engine(
        torch, mk, mkserv, mkmodels, kernels, Engine, params, QWEN3_8B,
        one_rank_bf16_ms=lin_rec["forms"]["bf16"]["ms"],
        eager_tp_step_ms=tpe_rec["defaults"]["decode_ms_per_step"]))
    pp_rec = emit_phase(phase_pp_forward(torch, params, QWEN3_8B, fa))
    del params
    gc.collect()
    torch.cuda.empty_cache()

    emit_phase(phase_parity(torch, QWEN3_8B, init_dense_llm, Engine,
                            ServingEngine, kernels))
    emit_phase(phase_linear_parity(torch, mkserv, QWEN3_8B, init_dense_llm,
                                   Engine, kernels))
    emit_phase(phase_linear_engine_parity(torch, QWEN3_8B, init_dense_llm,
                                          Engine, kernels))
    emit_phase(phase_fp8_parity(torch, QWEN3_8B, init_dense_llm, Engine,
                                gemm.GEMM_KERNEL))
    gc.collect()
    torch.cuda.empty_cache()
    emit_phase(phase_tp_parity(torch, QWEN3_8B, init_dense_llm, Engine,
                               ServingEngine, kernels))
    gc.collect()
    torch.cuda.empty_cache()
    emit_phase(phase_tp_engine_parity(torch, QWEN3_8B, init_dense_llm,
                                      Engine, kernels))
    gc.collect()
    torch.cuda.empty_cache()
    emit_phase(phase_sp_pp_parity(torch))
    gc.collect()
    torch.cuda.empty_cache()
    emit_phase(phase_tp2d_parity(torch, QWEN3_8B, init_dense_llm, Engine,
                                 kernels))
    gc.collect()
    torch.cuda.empty_cache()
    tpmkp_rec = emit_phase(phase_tp_megakernel_parity(
        torch, mk, mkserv, mkmodels, QWEN3_8B, QWEN3_30B_A3B, init_dense_llm,
        Engine, kernels))

    # Qwen3-MoE: the eager lane at full size, the EP layer and the TP group
    # on the same weights (sharded without a second copy), the MoE decode
    # program at full depth, then fp32 token parity.
    moe_rec, moe_serving_rec, moe_params = phase_moe_engine(
        torch, kernels, Engine, ServingEngine, QWEN3_30B_A3B, prompts)
    emit_phase(moe_rec)
    emit_phase(moe_serving_rec)
    gc.collect()
    torch.cuda.empty_cache()
    ep_rec = emit_phase(phase_ep_moe(torch, moe_params, QWEN3_30B_A3B))
    gc.collect()
    torch.cuda.empty_cache()
    tpm_rec, tpms_rec = phase_tp_moe_engine(
        torch, moe_params, QWEN3_30B_A3B, Engine, kernels, ServingEngine,
        prompts)
    tpm_rec["tp1_moe_engine_paged"] = {k: moe_rec.get(k) for k in (
        "prefill_ms", "decode_ms_per_step", "tokens_per_s")}
    emit_phase(tpm_rec)
    tpms_rec["tp1_moe_serving"] = {k: moe_serving_rec[k] for k in (
        "tokens_per_s", "ttft_ms_p50")}
    emit_phase(tpms_rec)
    del moe_params
    gc.collect()
    torch.cuda.empty_cache()
    moe_step_rec = emit_phase(phase_moe_step(torch, mk, mkmodels,
                                             QWEN3_30B_A3B, timer))
    gc.collect()
    torch.cuda.empty_cache()
    emit_phase(phase_moe_parity(torch, QWEN3_30B_A3B, init_dense_llm, Engine,
                                ServingEngine, kernels))
    gc.collect()
    torch.cuda.empty_cache()
    emit_phase(phase_tp_moe_parity(torch, QWEN3_30B_A3B, init_dense_llm,
                                   Engine, ServingEngine, kernels))
    emit_phase(phase_fp8_experts(torch, gemm, moe, QWEN3_30B_A3B,
                                 init_dense_llm))

    tpu = "triton_distributed_tpu/"
    root = build.PKG_DIR.parent

    def kernel_case(name):
        return next(c for c in cases[name] if c["case"] == MAIN_CASE[name])

    summary = [
        _summary_entry(fa.FLASH_KERNEL, "flash_attention",
                       tpu + "ops/flash_attention.py:157",
                       cases["flash_attention"],
                       kernel_case("flash_attention"),
                       serving_rec["launches"]["flash_attention"], root),
        _summary_entry(pa.PAGED_KERNEL, "paged_attention",
                       tpu + "ops/paged_attention.py:160",
                       cases["paged_attention"],
                       kernel_case("paged_attention"),
                       serving_rec["launches"]["paged_attention"], root),
        # K2's e4m3 pool lane (the TPU kernel widens e4m3 pages at
        # :192-193): launches from the fp8 serving run.
        _summary_entry(pa.PAGED_KERNEL, "paged_attention_e4m3",
                       tpu + "ops/paged_attention.py:192",
                       cases["paged_attention_e4m3"],
                       kernel_case("paged_attention_e4m3"),
                       fp8_rec["launches"]["variants"]["paged_attention"]
                       .get("e4m3", 0), root),
        # The megakernel's lanes, each timed at the main path's shape (36
        # layers, 4 slots at MK_LENS) with the serving lane's own program.
        _summary_entry(mk.MEGA_KERNEL, "megakernel",
                       tpu + "megakernel/kernel.py:39",
                       cases["megakernel"], mk_rec["step_kernel"],
                       mk_rec["launches"]["megakernel"], root),
        _summary_entry(mk.MEGA_KERNEL, "megakernel_kv8",
                       tpu + "megakernel/kernel.py:870",
                       cases["megakernel_kv8"], mk8_rec["step_kernel"],
                       mk8_rec["launches"]["variants"]["megakernel"]
                       .get("kv8", 0), root),
        _summary_entry(mk.MEGA_KERNEL, "megakernel_window",
                       tpu + "megakernel/kernel.py:813",
                       cases["megakernel_window"], mks_rec["step_kernel"],
                       mks_rec["launches"]["variants"]["megakernel"]
                       .get("window", 0), root),
        # The linear decoder behind Engine.serve(backend="megakernel"), at
        # 36 layers and the serve's last position: as the engine builds
        # it (fp32 matrix workspace; launches of the counted serve), then
        # the decoder alone over a bf16 workspace and over e4m3 weight
        # tiles (launches of their own counted runs).
        # Windows past one 4-row group (spec_k = 4, W = 5): launches of
        # the spec4 serving run, the kernel timed at the main shape.
        _summary_entry(mk.MEGA_KERNEL, "megakernel_rows",
                       tpu + "megakernel/kernel.py:39",
                       cases["megakernel_rows"], mks4_rec["step_kernel"],
                       mks4_rec["launches_on_more_than_4_rows"], root),
        _summary_entry(mk.MEGA_KERNEL, "megakernel_linear",
                       tpu + "megakernel/kernel.py:889",
                       cases["megakernel_linear"], lin_rec["forms"]["fp32"],
                       lin_rec["serve"]["launches"]["megakernel"], root),
        _summary_entry(mk.MEGA_KERNEL, "megakernel_linear_bf16",
                       tpu + "megakernel/kernel.py:889",
                       cases["megakernel_linear"], lin_rec["forms"]["bf16"],
                       lin_rec["forms"]["bf16"]["launches"], root),
        _summary_entry(mk.MEGA_KERNEL, "megakernel_linear_w8",
                       tpu + "megakernel/kernel.py:257",
                       cases["megakernel_linear_w8"],
                       lin_rec["forms"]["fp8_weights"],
                       lin_rec["forms"]["fp8_weights"]["launches"], root),
        # The profile stamp: the bf16 linear decoder's profiled step
        # (launches of that counted step), timed profiled.
        _summary_entry(mk.MEGA_KERNEL, "megakernel_profile",
                       tpu + "megakernel/kernel.py:1356",
                       cases["megakernel_linear"],
                       dict(lin_rec["forms"]["bf16"],
                            ms=bf16_prof["profiled_step_ms"]),
                       bf16_prof["launches"], root),
        # The in-kernel AllReduce: ALLREDUCE_ROW (type 22) timed alone at
        # the decode shape (4 ranks, bf16, 1 live row x 4096); its cases
        # hold type 4 (:569) too. Launches: the megakernel launches of the
        # TP=4 Engine.serve(backend="megakernel") that ran its AllReduce
        # rows (72 a launch at Qwen3-8B).
        _summary_entry(mk.MEGA_KERNEL, "megakernel_allreduce",
                       tpu + "megakernel/kernel.py:601",
                       cases["megakernel_ar"],
                       next(c for c in cases["megakernel_ar"]
                            if c["case"] == MK_AR_MAIN),
                       tpmk_rec["engine"]["launches"]
                       ["megakernel_allreduce"], root),
        # The TP=4 linear decode step (36 layers, bf16 workspaces), the
        # ranks' launches timed together; launches of its counted run;
        # the error of the held TP=4 steps (2 layers, fp32 and bf16).
        _summary_entry(mk.MEGA_KERNEL, "megakernel_tp_linear_bf16",
                       tpu + "megakernel/kernel.py:39",
                       [tpmkp_rec["step_vs_plain"],
                        tpmkp_rec["step_vs_plain_bf16"]],
                       tpmk_rec["bf16"], tpmk_rec["bf16"]["launches"], root),
    ]
    b1, b8 = moe_step_rec["batch_1"], moe_step_rec["batch_8"]
    moe_cases = cases["megakernel_moe"]
    summary += [
        # Qwen3-30B-A3B's GQA group 8, launches of the MoE serving run.
        _summary_entry(fa.FLASH_KERNEL, "flash_attention_g8",
                       tpu + "ops/flash_attention.py:157",
                       cases["flash_attention_g8"],
                       kernel_case("flash_attention_g8"),
                       moe_serving_rec["launches"]["flash_attention"], root),
        _summary_entry(pa.PAGED_KERNEL, "paged_attention_g8",
                       tpu + "ops/paged_attention.py:160",
                       cases["paged_attention_g8"],
                       kernel_case("paged_attention_g8"),
                       moe_serving_rec["launches"]["paged_attention"], root),
        # The MoE decode program (48 layers, bf16, batch 1) and its two
        # handlers alone (one-task programs on that step's layer-0
        # tiles); launches of the counted moe_step run at batch 1.
        _summary_entry(mk.MEGA_KERNEL, "megakernel_moe",
                       tpu + "megakernel/kernel.py:39", moe_cases, b1,
                       b1["moe_launches"], root),
        # The MoE program past one 4-row group: batch 8, 48 layers.
        _summary_entry(mk.MEGA_KERNEL, "megakernel_moe_b8",
                       tpu + "megakernel/kernel.py:1004",
                       [c for c in moe_cases
                        if c["shape"].get("batch", 0) > 4], b8,
                       b8["moe_launches"], root),
        dict(_summary_entry(mk.MEGA_KERNEL, "megakernel_moe_topk",
                            tpu + "megakernel/kernel.py:964", moe_cases,
                            b1["tasks_alone"]["MOE_TOPK"],
                            b1["moe_launches"], root),
             max_abs_err=max(p["moe_replay"]["moe_topk"]["max_abs_err"]
                             for c in moe_cases for p in c.get("positions",
                                                               []))),
        dict(_summary_entry(mk.MEGA_KERNEL, "megakernel_moe_ffn",
                            tpu + "megakernel/kernel.py:1004", moe_cases,
                            b1["tasks_alone"]["MOE_FFN"],
                            b1["moe_launches"], root),
             max_abs_err=max(p["moe_replay"]["moe_ffn"]["max_abs_err"]
                             for c in moe_cases for p in c.get("positions",
                                                               []))),
    ]
    gemm_cases = cases["gemm"]
    summary += [
        # B3's e4m3 lane, timed at the fp8 decode's largest product (w_gate
        # / w_up at M=1); launches of the counted fp8_decode run (7 per
        # layer and step).
        _summary_entry(gemm.GEMM_KERNEL, "gemm_e4m3", tpu + "ops/gemm.py:32",
                       [c for c in gemm_cases if c["lane"] == "e4m3"],
                       next(c for c in gemm_cases
                            if c["case"] == MAIN_GEMM_CASE),
                       fp8_dec_rec["launches"]["gemm"], root),
        # B3's bf16 lane at the headline shape; launches of the counted
        # pallas_matmul_tuned call.
        _summary_entry(gemm.GEMM_KERNEL, "gemm_bf16", tpu + "ops/gemm.py:32",
                       [c for c in gemm_cases if c["lane"] == "bf16"],
                       next(c for c in gemm_cases
                            if c["case"] == "headline_bf16"),
                       tuned_rec["launches_on_hit"], root),
    ]
    comm = coll_modules()[0]
    serve, spec = tp_rec["serve"], tp_rec["spec"]
    coll_replaces = {
        # B5 one-shot: the verify steps of the spec_k=3 TP run.
        "allreduce_one_shot": (comm.ONE_SHOT_KERNEL, "ops/allreduce.py:68",
                               spec),
        # B5 parity stream: every one-token decode step, 72 a rank.
        "allreduce_parity": (comm.PARITY_KERNEL, "ops/allreduce.py:104",
                             serve),
        # B6 ring RS and B4 ring AG: the two-shot of every 256-row slice.
        "reduce_scatter_ring": (comm.RS_RING_KERNEL,
                                "ops/reduce_scatter.py:52", serve),
        "allgather_ring": (comm.AG_RING_KERNEL, "ops/allgather.py:91",
                           serve)}
    for cname, (kern, rep, run) in coll_replaces.items():
        summary.append(_summary_entry(
            kern, cname, tpu + rep, coll_rec["cases"][cname],
            coll_main_case(coll_rec, cname), run["launches"][cname], root))
    summary += [
        # K1 / K2 at one rank's TP=4 heads (8 q, 2 kv), launches of the
        # TP serving run (every rank's).
        _summary_entry(fa.FLASH_KERNEL, "flash_attention_tp4",
                       tpu + "ops/flash_attention.py:157",
                       coll_rec["flash_attention_tp4"],
                       coll_rec["flash_attention_tp4"][0],
                       serve["launches"]["flash_attention"], root),
        _summary_entry(pa.PAGED_KERNEL, "paged_attention_tp4",
                       tpu + "ops/paged_attention.py:160",
                       coll_rec["paged_attention_tp4"],
                       coll_rec["paged_attention_tp4"][0],
                       serve["launches"]["paged_attention"], root),
    ]
    tree_main = next(c for c in fused_rec["cases"]["allreduce_tree"]
                     if c["n"] == TP and c["dtype"] == "bfloat16"
                     and c["rows"] == TREE_MAIN_ROWS)
    summary += [
        # B5's double tree: the 1 x 203 prompt's "ar" prefill of tp_engine
        # (72 a rank), timed at 203 x 4096.
        _summary_entry(comm.TREE_KERNEL, "allreduce_tree",
                       tpu + "ops/allreduce.py:169",
                       coll_rec["cases"]["allreduce_tree"]
                       + fused_rec["cases"]["allreduce_tree"], tree_main,
                       tpe_rec["tree"]["launches"]["allreduce_tree"], root),
        # B9 and B10: tp_engine's 2 x 1024 "overlap" prefills (180 and 72 a
        # rank each), timed at wq and wo.
        _summary_entry(comm.AG_GEMM_KERNEL, "ag_gemm",
                       tpu + "ops/allgather_gemm.py:88",
                       fused_rec["cases"]["ag_gemm"],
                       fused_main_case(fused_rec, "ag_gemm", "wq"),
                       tpe_rec["defaults"]["launches"]["ag_gemm"], root),
        _summary_entry(comm.GEMM_RS_KERNEL, "gemm_rs",
                       tpu + "ops/gemm_reduce_scatter.py:57",
                       fused_rec["cases"]["gemm_rs"],
                       fused_main_case(fused_rec, "gemm_rs", "wo"),
                       tpe_rec["defaults"]["launches"]["gemm_rs"], root),
        # B11: tp_engine's decode under TDTPU_GEMM_AR=1 (72 a rank a step),
        # timed at wo.
        _summary_entry(comm.GEMM_AR_KERNEL, "gemm_ar",
                       tpu + "ops/gemm_allreduce.py:47",
                       fused_rec["cases"]["gemm_ar"],
                       fused_main_case(fused_rec, "gemm_ar", "wo"),
                       tpe_rec["gemm_ar"]["launches"]["gemm_ar"], root),
    ]
    summary += [
        # B4's full-mesh push: the sequential "overlap" TP-MoE layer at
        # n = 2 (one launch a rank), timed at its 1024 rows a rank.
        _summary_entry(comm.AG_FULL_MESH_KERNEL, "ag_full_mesh",
                       tpu + "ops/allgather.py:66",
                       a2a_rec["cases"]["ag_full_mesh"],
                       a2a_main_case(a2a_rec, "ag_full_mesh"),
                       tpm_rec["moe_overlap_layer_n2"]["overlap"]["launches"]
                       ["ag_full_mesh"], root),
        # B8: the EP layer's 512-token barrier run (2 a layer a rank) and
        # its 8-step decode on the parity stream (768 a rank), timed at
        # cap 4096 and cap 32.
        _summary_entry(comm.A2A_KERNEL, "a2a", tpu + "ops/all_to_all.py:65",
                       a2a_rec["cases"]["a2a"], a2a_main_case(a2a_rec, "a2a"),
                       ep_rec["prefill_barrier"]["launches"]["a2a"], root),
        _summary_entry(comm.A2A_PARITY_KERNEL, "a2a_parity",
                       tpu + "ops/all_to_all.py:180",
                       a2a_rec["cases"]["a2a_parity"],
                       a2a_main_case(a2a_rec, "a2a_parity"),
                       ep_rec["decode_stream"]["launches"]["a2a_parity"],
                       root),
    ]
    sppp = sppp_rec["cases"]
    summary += [
        # B4's parity stream: the SP decode's 36 layers x 16 steps (36 a
        # rank and step), timed at its (B·hq, d + 2) = 128 x 130 fp32
        # partials on 4 ranks.
        _summary_entry(comm.AG_PARITY_KERNEL, "ag_parity",
                       tpu + "ops/allgather.py:192", sppp["ag_parity"],
                       next(c for c in sppp["ag_parity"] if "ms" in c),
                       spd_rec["launches"]["ag_parity"], root),
        # B7's shift: both pipeline schedules of pp_forward (10 and 54 a
        # rank), timed at one 512 x 4096 bf16 microbatch on 4 ranks.
        _summary_entry(comm.P2P_SHIFT_KERNEL, "p2p_shift",
                       tpu + "ops/p2p.py:30", sppp["p2p_shift"],
                       next(c for c in sppp["p2p_shift"] if "ms" in c),
                       pp_rec["gpipe"]["shift_launches"]
                       + pp_rec["interleaved"]["shift_launches"], root),
        # B7's permutation: pp_forward's CommOp.exchange (a butterfly) at
        # that shape, one a rank.
        _summary_entry(comm.P2P_PERMUTE_KERNEL, "p2p_permute",
                       tpu + "ops/p2p.py:102", sppp["p2p_permute"],
                       next(c for c in sppp["p2p_permute"] if "ms" in c),
                       pp_rec["comm_op_exchange"]["launches"]["p2p_permute"],
                       root),
    ]
    mig = twotier_modules()[5]
    summary += [
        # B12: the main run of collectives_2d — the tuple-axis AllGather and
        # AllReduce on (dcn=2, tp=4), one launch a rank each — timed there
        # (256 and 16 rows x 4096 bf16 a rank).
        _summary_entry(comm.AG_TORUS_KERNEL, "ag_torus",
                       tpu + "ops/multi_axis.py:60",
                       c2d_rec["cases"]["ag_torus"],
                       torus_main_case(c2d_rec, "ag_torus"),
                       c2d_rec["main_launches"]["ag_torus"], root),
        _summary_entry(comm.AR_TORUS_KERNEL, "ar_torus",
                       tpu + "ops/multi_axis.py:169",
                       c2d_rec["cases"]["ar_torus"],
                       torus_main_case(c2d_rec, "ar_torus"),
                       c2d_rec["main_launches"]["ar_torus"], root),
        # B13: kv_migrate_local's run on (dcn=2, tp=4) (2 blocks, 4
        # senders and 4 receivers), timed at one 32-page block.
        _summary_entry(mig.MIGRATE_PACK_KERNEL, "migrate_pack",
                       tpu + "disagg/migrate.py:249",
                       mig_rec["cases"]["migrate_pack"],
                       mig_rec["cases"]["migrate_pack"][0],
                       mig_rec["launches"]["migrate_pack"], root),
        _summary_entry(mig.MIGRATE_SCATTER_KERNEL, "migrate_scatter",
                       tpu + "disagg/migrate.py:277",
                       mig_rec["cases"]["migrate_scatter"],
                       mig_rec["cases"]["migrate_scatter"][0],
                       mig_rec["launches"]["migrate_scatter"], root),
    ]
    check(all(e["launches"] > 0 for e in summary),
          f"a kernel of the path was never launched: "
          f"{[e['name'] for e in summary if not e['launches']]}")
    check(spec_rec["launches"]["paged_attention"] > 0,
          "spec serving: K2 never ran on the verify path")
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
