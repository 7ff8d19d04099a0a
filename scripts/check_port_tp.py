#!/usr/bin/env python3
"""Check the PyTorch/CUDA port's tensor-parallel path on CUDA cards, for
the tree in the current directory.

Builds ``csrc/collectives.cu``, ``csrc/all_to_all.cu``,
``csrc/gemm_comm.cu`` (and the attention kernels), prints ptxas's
register report, then runs ``chip_smoke.phase_collectives`` (the
AllReduce — one-shot, parity, double tree —, reduce-scatter and
all-gather kernels at n = 2, 4 and 8 ranks against their plain versions,
timed; the parity stress; a lost peer's timeout),
``chip_smoke.phase_a2a`` (the AllToAll's barrier and parity forms and
the all-gather's full-mesh push in fp32, bf16 and e4m3, bit for bit,
timed at their main-path shapes; 200 parity calls with a rotating
straggler; a lost and a held-back peer) and ``chip_smoke.phase_fused``
(the fused AG+GEMM, GEMM+RS and GEMM+AR kernels and the tree's odd
shapes, the B11 stress, the lost peers of B9 and B11) and, with
``--parity``, ``chip_smoke.phase_tp_parity`` (float32 2-layer serving on
4 ranks token-identical to one rank, each rank's logits bit-identical),
``chip_smoke.phase_tp_engine_parity`` (float32 2-layer ``Engine.serve``
on 4 ranks with the reference's defaults, ``TDTPU_GEMM_AR=1``, a tree
prompt and ``backend="xla"``, token-identical to one rank) and
``chip_smoke.phase_tp_moe_parity`` (float32 2-layer Qwen3-30B-A3B on 4
ranks: ``Engine.serve`` with the defaults and on ``backend="xla"``,
``ServingEngine`` with a preemption and with ``spec_k=3``,
token-identical to one rank). Ranks are virtual ranks on ``cuda:0``
unless ``--cards``: then rank r lives on ``cuda:r`` (4 cards, peer
access; the kernels at n = 2 and 4; their ``bound_ms`` stays the one-card
HBM bound). ``--moe`` runs only the MoE-over-ranks phases
(``collectives_a2a`` and, with ``--parity``, ``tp_moe_parity``); with
``--sp`` / ``--pp`` too, after those (B7 and B4's full-mesh push in one
run).
``--megakernel`` runs only the megakernel on a TP group:
``chip_smoke.phase_megakernel_ar`` (its AllReduce task types 4 and 22 at
n = 2, 4 and 8 — 2 and 4 with ``--cards`` — in fp32 and bf16, bit for bit
against the plain version, every rank alike; ``force_ar`` at one rank; a
held-back rank's CommTimeoutError) and, with ``--parity``,
``chip_smoke.phase_tp_megakernel_parity`` (float32 2-layer
``Engine.serve(backend="megakernel")`` on 4 ranks token-identical to one
rank and to the eager TP serve; one step, fp32 and bf16, against the
plain version on every rank, the ranks' final rows bit-identical; the
MoE program at n = 2 against one rank). ``--sp`` and ``--pp`` run only
the sequence- and pipeline-parallel path: ``chip_smoke.
phase_collectives_sp_pp`` (B4's parity AllGather and B7's shift and
permutation at n = 2, 4 and 8 — 2 and 4 with ``--cards`` — bit for bit
against their plain versions, timed; the parity stress; held-back
ranks), then with ``--sp`` ``chip_smoke.phase_sp_decode`` (36 layers x
16 steps of ``SpFlashDecodeAttention`` on 4 ranks against one-rank K2)
and ``phase_sp_prefill`` (ring, SP-AG and Ulysses attention against
one-rank K1), with ``--pp`` ``chip_smoke.phase_pp_forward`` (Qwen3-8B,
bf16, GPipe on 4 stages and the interleaved schedule against the 36
layers on one rank; with ``--cards`` each stage's layers on its card),
and with ``--parity`` ``chip_smoke.phase_sp_pp_parity`` (every new entry
point, fp32, against the CPU rank threads' plain versions). ``--twod``
runs only the two-tier group: ``chip_smoke.phase_collectives_2d`` (B12's
torus AllGather and AllReduce on (dcn, tp) grids — (2, 4), (4, 2), (2, 2)
and the degenerate ones on virtual ranks, (2, 2) one rank a card with
``--cards`` — bit for bit on every rank, timed) and
``chip_smoke.phase_migrate`` (``kv_migrate_local`` through B13 from slice
0 into slice 1, on (2, 4) virtual ranks or, with ``--cards``, across the
pairs of cards of a (2, 2) group), on virtual ranks
``chip_smoke.phase_tp2d_engine`` (Qwen3-8B cut to 4 layers, bf16:
``Engine.serve`` on (2, 4) in "overlap2d", B9 / B10 / B3 under the 2-D
fused ops against their plain composition, the ranks' logits bit for
bit), and with ``--parity`` ``chip_smoke.phase_tp2d_parity`` (virtual
ranks only: float32 2-layer ``Engine.serve`` on (2, 4) token-identical
to one rank). Prints one JSON
line per phase, then the cards' names and power limits. About four
minutes with the build (``--moe``: about one and a half):

    python3 scripts/check_port_tp.py [--parity] [--cards] [--moe]
    python3 scripts/check_port_tp.py --megakernel [--parity] [--cards]
    python3 scripts/check_port_tp.py --sp --pp [--parity] [--cards]
    python3 scripts/check_port_tp.py --twod [--parity] [--cards]
"""
import importlib
import json
import os
import sys
import time

sys.path.insert(0, ".")
os.environ["CUDA_DEVICE_MAX_CONNECTIONS"] = "32"

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from triton_distributed_tpu_torch.runtime import build  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("check_port_tp: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    cards = "--cards" in sys.argv
    if cards and torch.cuda.device_count() < 4:
        print("check_port_tp --cards: needs 4 cards", file=sys.stderr)
        return 1
    fa = importlib.import_module(
        "triton_distributed_tpu_torch.ops.flash_attention")
    pa = importlib.import_module(
        "triton_distributed_tpu_torch.ops.paged_attention")
    comm = importlib.import_module("triton_distributed_tpu_torch.ops._comm")
    from triton_distributed_tpu_torch.megakernel import kernel as mk

    megakernel = "--megakernel" in sys.argv
    sp, pp = "--sp" in sys.argv, "--pp" in sys.argv
    twod = "--twod" in sys.argv
    t0 = time.perf_counter()
    srcs = [comm.ONE_SHOT_KERNEL.source_path,
            comm.P2P_SHIFT_KERNEL.source_path,
            comm.AG_TORUS_KERNEL.source_path,
            build.CSRC_DIR / "migrate.cu"]
    if not (sp or pp) or "--moe" in sys.argv:
        srcs += [comm.A2A_KERNEL.source_path, comm.AG_GEMM_KERNEL.source_path,
                 mk.MEGA_KERNEL.source_path]
    build.build(srcs + [fa.FLASH_KERNEL.source_path,
                        pa.PAGED_KERNEL.source_path])
    ptxas = {}
    for src in srcs:
        log = build.library_path(src).with_suffix(".log").read_text()
        ptxas[src.name] = [ln.strip() for ln in log.splitlines()
                           if "registers" in ln or "spill" in ln]
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "count": torch.cuda.device_count(), "ptxas": ptxas}),
          flush=True)
    timer = cs.Timer(torch, "cuda")
    failed = []

    def run(name, fn):
        try:
            print(json.dumps(fn()), flush=True)
        except Exception as e:          # report every phase, then fail
            print(json.dumps({"phase": name, "error": repr(e)}), flush=True)
            failed.append(name)

    if cards:
        def devices_for(n):
            return [f"cuda:{r}" for r in range(n)]
        ranks = (2, 4)
    else:
        devices_for, ranks = cs.virtual_devices, cs.COLL_RANKS
    moe = "--moe" in sys.argv
    if twod:
        suffix = "_cards" if cards else ""
        grids = ((2, 2),) if cards else cs.GRIDS_2D + cs.DEGENERATE_2D
        run("collectives_2d", lambda: cs.phase_collectives_2d(
            torch, timer, devices_for=devices_for, grids=grids,
            name="collectives_2d" + suffix))
        run("migrate", lambda: cs.phase_migrate(
            torch, timer, devices_for=devices_for,
            grid=(2, 2) if cards else (2, 4), name="migrate" + suffix))
        if not cards:
            import dataclasses

            from triton_distributed_tpu_torch.models.config import QWEN3_8B
            from triton_distributed_tpu_torch.models.dense import (
                init_dense_llm,
            )
            from triton_distributed_tpu_torch.models.engine import Engine

            kernels = (fa.FLASH_KERNEL, pa.PAGED_KERNEL)
            cut = dataclasses.replace(QWEN3_8B, num_layers=cs.TP2D_LAYERS)
            params = init_dense_llm(cut, generator=torch.Generator(
                device="cuda").manual_seed(0))
            run("tp2d_engine", lambda: cs.phase_tp2d_engine(
                torch, params, QWEN3_8B, Engine, kernels))
            del params
            if "--parity" in sys.argv:
                run("tp2d_parity", lambda: cs.phase_tp2d_parity(
                    torch, QWEN3_8B, init_dense_llm, Engine, kernels))
        if not (sp or pp):
            print(cs.nvidia_smi_all(), flush=True)
            return 1 if failed else 0
    if sp or pp:
        suffix = "_cards" if cards else ""
        run("collectives_sp_pp", lambda: cs.phase_collectives_sp_pp(
            torch, timer, devices_for=devices_for, ranks=ranks,
            name="collectives_sp_pp" + suffix))
        if sp:
            run("sp_decode", lambda: cs.phase_sp_decode(
                torch, pa, devices=devices_for(cs.SP_N),
                name="sp_decode" + suffix))
            run("sp_prefill", lambda: cs.phase_sp_prefill(
                torch, fa, timer, devices=devices_for(cs.SP_N),
                name="sp_prefill" + suffix))
        if pp:
            from triton_distributed_tpu_torch.models.config import QWEN3_8B
            from triton_distributed_tpu_torch.models.dense import (
                init_dense_llm,
            )

            def pp_forward():
                params = init_dense_llm(QWEN3_8B, generator=torch.Generator(
                    device="cuda").manual_seed(0))
                return cs.phase_pp_forward(
                    torch, params, QWEN3_8B, fa,
                    devices=devices_for(cs.PP_N), name="pp_forward" + suffix)

            run("pp_forward", pp_forward)
        if "--parity" in sys.argv:
            run("sp_pp_parity", lambda: cs.phase_sp_pp_parity(
                torch, devices_for=devices_for,
                name="sp_pp_parity" + suffix))
        if not moe:
            print(cs.nvidia_smi_all(), flush=True)
            return 1 if failed else 0
    if megakernel:
        def megakernel_ar():
            cases, timeout = cs.phase_megakernel_ar(
                torch, timer, devices_for=devices_for, ranks=ranks)
            bad = [c["case"] for c in cases if not c["ok"]]
            if bad or not timeout["ok"]:
                raise RuntimeError(f"megakernel_ar: {bad} {timeout}")
            return {"phase": "megakernel_ar_cards" if cards
                    else "megakernel_ar", "cases": cases,
                    "timeout": timeout}

        run("megakernel_ar", megakernel_ar)
    if not moe and not megakernel:
        run("collectives", lambda: cs.phase_collectives(
            torch, timer, fa, pa, devices_for=devices_for, ranks=ranks,
            name="collectives_cards" if cards else "collectives"))
    if not megakernel:
        run("collectives_a2a", lambda: cs.phase_a2a(
            torch, timer, devices_for=devices_for, ranks=ranks,
            name="collectives_a2a_cards" if cards else "collectives_a2a"))
    if not moe and not megakernel:
        run("collectives_fused", lambda: cs.phase_fused(
            torch, timer, devices_for=devices_for, ranks=ranks,
            name="collectives_fused_cards" if cards else "collectives_fused"))
    if "--parity" in sys.argv:
        from triton_distributed_tpu_torch.megakernel import models as mkmodels
        from triton_distributed_tpu_torch.megakernel import serving as mkserv
        from triton_distributed_tpu_torch.models.config import (
            QWEN3_8B, QWEN3_30B_A3B,
        )
        from triton_distributed_tpu_torch.models.dense import init_dense_llm
        from triton_distributed_tpu_torch.models.engine import Engine
        from triton_distributed_tpu_torch.serving import ServingEngine

        kernels = (fa.FLASH_KERNEL, pa.PAGED_KERNEL, mk.MEGA_KERNEL)
        if megakernel:
            run("tp_megakernel_parity", lambda: cs.phase_tp_megakernel_parity(
                torch, mk, mkserv, mkmodels, QWEN3_8B, QWEN3_30B_A3B,
                init_dense_llm, Engine, kernels, devices_for=devices_for))
        if not moe and not megakernel:
            run("tp_parity", lambda: cs.phase_tp_parity(
                torch, QWEN3_8B, init_dense_llm, Engine, ServingEngine,
                kernels, devices=devices_for(cs.TP)))
            run("tp_engine_parity", lambda: cs.phase_tp_engine_parity(
                torch, QWEN3_8B, init_dense_llm, Engine, kernels,
                devices=devices_for(cs.TP)))
        if not megakernel:
            run("tp_moe_parity", lambda: cs.phase_tp_moe_parity(
                torch, QWEN3_30B_A3B, init_dense_llm, Engine, ServingEngine,
                kernels, devices=devices_for(cs.TP)))
    print(cs.nvidia_smi_all(), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
