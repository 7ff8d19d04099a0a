#!/usr/bin/env python3
"""Time the port's kernel K1 (flash-attention prefill) of one tree at the
main path's shapes on one CUDA card.

Builds the tree's ``csrc/flash_attention.cu`` and times its bf16 K1 with
CUDA events, the L2 cache flushed before each launch (as
``chip_smoke.Timer``): the Qwen3-8B prefill (B = 2 and 1, 1024 tokens,
32 / 8 heads, d 128, causal, normalized), GQA group 8 (32 / 4 heads), d 64,
a 256-row slice at 768 of a 2048-row buffer and a non-causal 512-row shard
(both as partials), each beside SDPA where one PyTorch call computes the
same function, and checks each output against the tree's plain version.
Prints one JSON line per case, with the SHA-256 of the kernel's outputs
(inputs drawn from one seed, so two trees whose K1 computes the same bits
print the same digests), then the card's name and power limit.

To compare two commits on one card, unpack the other one's tree with
``git archive`` into a git-ignored directory and run, in one call, parent,
change, change, parent:

    python3 scripts/time_port_flash.py [--tree DIR] [--label NAME]
"""
import argparse
import hashlib
import importlib
import json
import os
import statistics
import subprocess
import sys

# (name, B, Sq, Sk, hq, hkv, d, q_offset, k_offset, causal, normalize)
CASES = [
    ("prefill_2x1024", 2, 1024, 1024, 32, 8, 128, 0, 0, True, True),
    ("prefill_1024", 1, 1024, 1024, 32, 8, 128, 0, 0, True, True),
    ("prefill_2x1024_g8", 2, 1024, 1024, 32, 4, 128, 0, 0, True, True),
    ("prefill_2x1024_d64", 2, 1024, 1024, 32, 8, 64, 0, 0, True, True),
    ("slice_256_at_768_of_2048", 1, 256, 2048, 32, 8, 128, 768, 0, True,
     False),
    ("shard_512_at_k512_noncausal", 1, 512, 512, 32, 8, 128, 1024, 512,
     False, False),
]


def timed_ms(torch, flush, fn, iters: int = 20) -> float:
    """Median CUDA-event time of ``fn`` over ``iters`` launches, the L2
    cache flushed before each."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=".", help="root of the tree to time")
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    root = os.path.abspath(args.tree)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("time_port_flash: needs a CUDA card", file=sys.stderr)
        return 1
    fa = importlib.import_module(
        "triton_distributed_tpu_torch.ops.flash_attention")
    if not fa.__file__.startswith(root):
        print(f"time_port_flash: imported {fa.__file__}, not {root}'s",
              file=sys.stderr)
        return 1
    from triton_distributed_tpu_torch.runtime import build

    build.build([fa.FLASH_KERNEL.source_path])
    label = args.label or root
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = torch.Generator(device="cuda").manual_seed(0)
    failed = []
    for name, b, sq, sk, hq, hkv, d, qo, ko, causal, norm in CASES:
        q = torch.randn((b, sq, hq, d), generator=g, device="cuda").bfloat16()
        k = torch.randn((b, sk, hkv, d), generator=g, device="cuda").bfloat16()
        v = torch.randn((b, sk, hkv, d), generator=g, device="cuda").bfloat16()
        got = fa._flash_cuda(q, k, v, qo, ko, causal=causal, normalize=norm)
        want = fa._flash_plain(q, k, v, qo, ko, causal=causal, normalize=norm)
        out, ref = got[0].float(), want[0].float()
        if not norm:
            out = out / got[2].clamp(min=1e-30)[..., None]
            ref = ref / want[2].clamp(min=1e-30)[..., None]
        err = (out - ref).abs().max().item()
        # chip_smoke's K1 tolerance: atol 4e-3, rtol 1.6e-2.
        ok = bool(((out - ref).abs() <= 4e-3 + 1.6e-2 * ref.abs()).all())
        digest = hashlib.sha256()
        for t in got:
            if t is not None:
                digest.update(t.contiguous().view(torch.uint8).cpu()
                              .numpy().tobytes())
        rec = {"tree": label, "case": name, "max_abs_err": err, "ok": ok,
               "sha256": digest.hexdigest(),
               "ms": timed_ms(torch, flush, lambda: fa._flash_cuda(
                   q, k, v, qo, ko, causal=causal, normalize=norm))}
        if norm and qo == ko and sq == sk:
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            rec["sdpa_ms"] = timed_ms(torch, flush, lambda: sdpa(
                qt, kt, vt, is_causal=causal, enable_gqa=True))
        print(json.dumps(rec), flush=True)
        if not ok:
            failed.append(name)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
