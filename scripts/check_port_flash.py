#!/usr/bin/env python3
"""Check the PyTorch/CUDA port's kernel K1 (flash-attention prefill,
``ops/flash_attention.py``) on one CUDA card, for the tree in the current
directory.

Builds ``csrc/flash_attention.cu`` alone, prints ptxas's register, shared
memory and spill report of both lanes (bf16 on ``wgmma`` + TMA, fp32 on
FMA), then runs ``chip_smoke.k1_cases`` (every K1 case against its plain
version, timed at the main shapes beside SDPA) and prints one JSON line per
case, then the card's name and power limit. A short check of a K1 change
(under a minute with the build):

    python3 scripts/check_port_flash.py
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
        print("check_port_flash: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    fa = importlib.import_module(
        "triton_distributed_tpu_torch.ops.flash_attention")
    src = fa.FLASH_KERNEL.source_path
    t0 = time.perf_counter()
    build.build([src])
    log = build.library_path(src).with_suffix(".log").read_text()
    print(json.dumps({"build_s": time.perf_counter() - t0, "ptxas": [
        ln.strip() for ln in log.splitlines()
        if "registers" in ln or "spill" in ln or "smem" in ln
        or "Compiling" in ln or "warning" in ln]}), flush=True)
    timer = cs.Timer(torch, "cuda")
    k1, k1_g8 = cs.k1_cases(torch, fa, timer)
    for c in k1 + k1_g8:
        print(json.dumps(c), flush=True)
    failed = [c["case"] for c in k1 + k1_g8 if not c["ok"]]
    print(json.dumps({"launches": fa.FLASH_KERNEL.launches,
                      "lanes": fa.FLASH_KERNEL.variant_launches,
                      "failed": failed}), flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
