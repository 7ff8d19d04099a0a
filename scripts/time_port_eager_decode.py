#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's eager paged decode step for the tree in the
current directory, on one CUDA card, and count its kernel launches.

For Qwen3-8B at full depth (36 layers) and Qwen3-30B-A3B cut to 8 layers
(bf16, seeded random weights, ``Engine(page_size=16)``, two 1024-token
prompts): prefill, hand the cache to the paged pools, decode 2 warm-up
steps, then 3 runs of 16 steps each timed on the host clock with the card
synced (ms per step), and 4 steps under ``torch.profiler`` (device kernels
and memory copies per step, device ms per step, busy share). Prints one
JSON line per model with the card's name and power limit.

To compare two commits, unpack the other one (``git archive <commit>
chip_smoke.py triton_distributed_tpu_torch | tar -x -C <dir>``) into a
git-ignored directory and run this script from each root in ONE call on
the same card — parent, change, change, parent:

    cd <root of a tree> && python3 <path to>/time_port_eager_decode.py [label]
"""
import dataclasses
import json
import subprocess
import sys
import time

sys.path.insert(0, ".")

import torch  # noqa: E402

from triton_distributed_tpu_torch.models.config import (  # noqa: E402
    QWEN3_8B, QWEN3_30B_A3B,
)
from triton_distributed_tpu_torch.models.dense import (  # noqa: E402
    init_dense_llm,
)
from triton_distributed_tpu_torch.models.engine import Engine  # noqa: E402


def decode_steps(eng, tok, cache, n):
    for _ in range(n):
        tok, cache = eng.decode(tok, cache)
    return tok, cache


def time_model(cfg, name, batch=2, prompt=1024, steps=16, runs=3) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    params = init_dense_llm(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0))
    eng = Engine(cfg, params, max_seq=2048, page_size=16)
    g = torch.Generator(device="cuda").manual_seed(11)
    ids = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=g,
                        device="cuda", dtype=torch.int32)
    logits, cache = eng.prefill(ids)
    tok = logits.argmax(-1).to(torch.int32)
    tok, cache = decode_steps(eng, tok, eng.to_paged(cache), 2)
    torch.cuda.synchronize()
    ms = []
    for _ in range(runs):
        t0 = time.perf_counter()
        tok, cache = decode_steps(eng, tok, cache, steps)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3 / steps)
    prof_steps = 4
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tok, cache = decode_steps(eng, tok, cache, prof_steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = copies = 0
    device_us = 0.0
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        low = e.key.lower()
        if "memcpy" in low or "memset" in low:
            copies += e.count
        else:
            kernels += e.count
        device_us += (getattr(e, "self_device_time_total", None)
                      or getattr(e, "self_cuda_time_total", 0))
    rec = {"model": name, "layers": cfg.num_layers, "batch": batch,
           "prompt": prompt, "decode_ms_per_step_runs": ms,
           "decode_ms_per_step": min(ms),
           "kernels_per_step": kernels / prof_steps,
           "copies_per_step": copies / prof_steps,
           "device_ms_per_step": device_us / 1e3 / prof_steps,
           "busy_share": device_us / 1e3 / wall_ms}
    del eng, params, cache, logits
    torch.cuda.empty_cache()
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("time_port_eager_decode: needs a CUDA card", file=sys.stderr)
        return 1
    label = sys.argv[1] if len(sys.argv) > 1 else "tree"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    for cfg, name in ((QWEN3_8B, "Qwen3-8B"),
                      (dataclasses.replace(QWEN3_30B_A3B, num_layers=8),
                       "Qwen3-30B-A3B")):
        rec = time_model(cfg, name)
        rec.update(label=label, nvidia_smi=smi)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
