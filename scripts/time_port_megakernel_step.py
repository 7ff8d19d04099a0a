#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's paged megakernel step for the tree in the
current directory, on one CUDA card.

Runs ``chip_smoke.megakernel_case`` for the one-row step and the 4-row
speculative window step at Qwen3-8B widths cut to 2 layers (bf16, 4 slots
at kv_lens [0, 1, 127, 1999]), three times each, L2 flushed before every
launch, and prints one JSON line with the six times in ms, the card's
name and power limit, and ptxas's register and spill report for
``megakernel.cu``.

To compare two commits, unpack the other one (``git archive <commit>
chip_smoke.py triton_distributed_tpu_torch | tar -x -C <dir>``) into a
git-ignored directory and run this script from each root inside ONE
process sequence on the same card — parent, change, change, parent —
since a card's speed differs from one run to the next:

    cd <root of a tree> && python3 <path to>/time_port_megakernel_step.py [label]
"""
import dataclasses
import importlib
import json
import sys

sys.path.insert(0, ".")

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from triton_distributed_tpu_torch.models.config import QWEN3_8B  # noqa: E402
from triton_distributed_tpu_torch.runtime import build  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("time_port_megakernel_step: needs a CUDA card", file=sys.stderr)
        return 1
    mk = importlib.import_module(
        "triton_distributed_tpu_torch.megakernel.kernel")
    mkserv = importlib.import_module(
        "triton_distributed_tpu_torch.megakernel.serving")
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    ptxas = []
    for src in build.sources():
        log = build.library_path(src).with_suffix(".log")
        if src.name == "megakernel.cu" and log.exists():
            ptxas = [line.strip() for line in log.read_text().splitlines()
                     if "registers" in line or "spill" in line]
    timer = cs.Timer(torch, "cuda")
    cfg = dataclasses.replace(QWEN3_8B, num_layers=2)
    step, window = [], []
    for _ in range(3):
        step.append(cs.megakernel_case(
            torch, mk, mkserv, timer, name="step_2l_bf16",
            dtype=torch.bfloat16, cfg=cfg, seed=20, time_it=True)["ms"])
        window.append(cs.megakernel_case(
            torch, mk, mkserv, timer, name="window4_2l_bf16",
            dtype=torch.bfloat16, cfg=cfg, seed=25, time_it=True,
            window=cs.MK_WINDOW, lens=cs.MK_WIN_LENS)["ms"])
    print(json.dumps({"tree": sys.argv[1] if len(sys.argv) > 1 else ".",
                      "step_2l_bf16_ms": step, "window4_2l_bf16_ms": window,
                      "nvidia_smi": cs.nvidia_smi(), "ptxas": ptxas}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
