#!/usr/bin/env python3
"""Check the PyTorch/CUDA port's kernel B3 (the tiled GEMM, ``ops/gemm.py``)
on one CUDA card, for the tree in the current directory.

Builds ``csrc/gemm.cu`` alone, prints ptxas's register and spill report,
then runs ``chip_smoke.phase_gemm_cases`` (every lane against its plain
version, timed at the headline, decode and expert shapes) and
``chip_smoke.phase_gemm_tuned``; with ``--parity`` also the float32
2-layer phases ``fp8_parity`` and ``linear_engine_parity``; with
``--paths`` the full-size ``linear_engine`` and ``fp8_decode`` phases
(Qwen3-8B, seeded random weights) and ``fp8_experts``. Prints one JSON line
per phase, then the card's name and power limit. A short check of a B3
change (about a minute with the build; ``--paths`` adds about two):

    python3 scripts/check_port_gemm.py [--parity] [--paths]
"""
import importlib
import json
import sys
import time

sys.path.insert(0, ".")

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from triton_distributed_tpu_torch.runtime import build  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("check_port_gemm: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    gemm = importlib.import_module("triton_distributed_tpu_torch.ops.gemm")
    src = gemm.GEMM_KERNEL.source_path
    t0 = time.perf_counter()
    build.build([src])
    log = build.library_path(src).with_suffix(".log").read_text()
    print(json.dumps({"build_s": time.perf_counter() - t0, "ptxas": [
        ln.strip() for ln in log.splitlines()
        if "registers" in ln or "spill" in ln]}), flush=True)
    timer = cs.Timer(torch, "cuda")
    cases = cs.phase_gemm_cases(torch, gemm, timer)["gemm"]
    for c in cases:
        print(json.dumps(c), flush=True)
    failed = [c["case"] for c in cases if not c["ok"]]

    def run(name, fn):
        try:
            print(json.dumps(fn()), flush=True)
        except Exception as e:          # report every phase, then fail
            print(json.dumps({"phase": name, "error": repr(e)}), flush=True)
            failed.append(name)

    run("gemm_tuned", lambda: cs.phase_gemm_tuned(torch, gemm, timer))
    from triton_distributed_tpu_torch.megakernel import kernel as mk
    from triton_distributed_tpu_torch.models.config import (
        QWEN3_8B, QWEN3_30B_A3B,
    )
    from triton_distributed_tpu_torch.models.dense import init_dense_llm
    from triton_distributed_tpu_torch.models.engine import Engine
    from triton_distributed_tpu_torch.ops import flash_attention as fa
    from triton_distributed_tpu_torch.ops import moe
    from triton_distributed_tpu_torch.ops import paged_attention as pa

    kernels = (fa.FLASH_KERNEL, pa.PAGED_KERNEL, mk.MEGA_KERNEL)
    if "--paths" in sys.argv:
        params = init_dense_llm(
            QWEN3_8B, generator=torch.Generator(device="cuda").manual_seed(0))
        run("linear_engine", lambda: cs.phase_linear_engine(
            torch, kernels, gemm.GEMM_KERNEL, Engine, params, QWEN3_8B))
        run("fp8_decode", lambda: cs.phase_fp8_decode(
            torch, kernels, gemm.GEMM_KERNEL, Engine, params, QWEN3_8B))
        del params
        torch.cuda.empty_cache()
        run("fp8_experts", lambda: cs.phase_fp8_experts(
            torch, gemm, moe, QWEN3_30B_A3B, init_dense_llm))
    if "--parity" in sys.argv:
        run("fp8_parity", lambda: cs.phase_fp8_parity(
            torch, QWEN3_8B, init_dense_llm, Engine, gemm.GEMM_KERNEL))
        run("linear_engine_parity", lambda: cs.phase_linear_engine_parity(
            torch, QWEN3_8B, init_dense_llm, Engine, kernels))
    print(cs.nvidia_smi(), flush=True)
    if failed:
        print(f"check_port_gemm: failed: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
