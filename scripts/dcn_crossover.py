#!/usr/bin/env python3
"""Where the perf model's AUTO pick turns to the two-tier "overlap2d"
prefill, and how far that row count moves with the inter tier's hop
latency (``ChipSpec.dcn_latency_s``, an estimate, not a measurement).

For Qwen3-8B's widths on a (dcn, tp) group it resolves
``layers/tp_mlp.pick_mode("auto", ...)`` the way
``Engine._prefill_mode`` does on a two-tier engine (anything but
"overlap2d" is the replicated "ar") for every prompt row count that
divides over the group, at half, once and twice the latency, and prints
one JSON line per (grid, latency): the first row count that takes
"overlap2d", the last that does not, the share that does, how often the
choice changes along the rows, and the choice at 512-8192 rows. A pure
model computation on the H100 spec; it runs anywhere, no card needed:

    python3 scripts/dcn_crossover.py [--max-rows 8192]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from triton_distributed_tpu_torch.layers.tp_mlp import pick_mode  # noqa: E402
from triton_distributed_tpu_torch.models.config import QWEN3_8B  # noqa: E402
from triton_distributed_tpu_torch.runtime.perf_model import (  # noqa: E402
    chip_spec,
)


def choices(cfg, n_intra: int, n_inter: int, spec, max_rows: int) -> list:
    """(rows, mode) for every row count that divides over the group."""
    N = n_intra * n_inter
    out = []
    for rows in range(N, max_rows + 1, N):
        m = pick_mode("auto", rows, n_intra, hidden=cfg.hidden_size,
                      ffn=cfg.intermediate_size, itemsize=2,
                      n_inter=n_inter, spec=spec)
        out.append((rows, "overlap2d" if m == "overlap2d" else "ar"))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--max-rows", type=int, default=8192)
    args = ap.parse_args()
    base = chip_spec("h100")
    for n_inter, n_intra in ((2, 4), (4, 2)):
        for scale in (0.5, 1.0, 2.0):
            spec = dataclasses.replace(
                base, dcn_latency_s=base.dcn_latency_s * scale)
            picks = choices(QWEN3_8B, n_intra, n_inter, spec, args.max_rows)
            flips = sum(m != prev for (_, m), (_, prev)
                        in zip(picks[1:], picks))
            two = [r for r, m in picks if m == "overlap2d"]
            ar = [r for r, m in picks if m == "ar"]
            pick = dict(picks)
            print(json.dumps({
                "grid": {"dcn": n_inter, "tp": n_intra},
                "dcn_latency_s": spec.dcn_latency_s,
                "dcn_gbps": spec.dcn_gbps, "dtype": "bfloat16",
                "hidden": QWEN3_8B.hidden_size,
                "ffn": QWEN3_8B.intermediate_size,
                "rows_checked": [picks[0][0], picks[-1][0]],
                "first_overlap2d_rows": two[0] if two else None,
                "last_ar_rows": ar[-1] if ar else None,
                "overlap2d_share": len(two) / len(picks),
                "changes": flips,
                "at_rows": {r: pick[r] for r in (512, 1024, 2048, 4096,
                                                 8192) if r in pick}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
