"""Timing, comparison and profiling helpers — counterpart of the JAX
package's ``runtime/utils.py`` (``cdiv``, ``round_up``, ``PerfStats``,
``perf_func``, ``assert_allclose``, ``group_profile``).

``perf_func`` times a CUDA callable with CUDA events, one pair per call
after a warm-up (the device time of the call, launch gaps included), and
anything else with the host clock. ``group_profile`` wraps
``torch.profiler`` and writes one Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable

import numpy as np
import torch


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


def percentile(samples, q: float):
    """Nearest-rank percentile (q in [0, 100]); None on no samples."""
    xs = sorted(samples)
    if not xs:
        return None
    rank = min(max(1, -(-int(q) * len(xs) // 100)), len(xs))
    return xs[rank - 1]


class PerfStats(float):
    """Per-iteration timing statistics that still *is* the mean (ms), with
    ``samples``, ``p50``, ``p95``, ``min`` and ``max``."""

    __slots__ = ("samples", "p50", "p95", "min", "max")

    def __new__(cls, samples_ms):
        samples_ms = [float(s) for s in samples_ms]
        if not samples_ms:
            raise ValueError("PerfStats needs at least one sample")
        self = super().__new__(cls, sum(samples_ms) / len(samples_ms))
        self.samples = tuple(samples_ms)
        self.p50 = percentile(samples_ms, 50)
        self.p95 = percentile(samples_ms, 95)
        self.min = min(samples_ms)
        self.max = max(samples_ms)
        return self

    @property
    def mean(self) -> float:
        return float(self)

    def __getnewargs__(self):
        return (list(self.samples),)

    def __repr__(self) -> str:
        return (f"PerfStats(mean={float(self):.4f} ms, p50={self.p50:.4f}, "
                f"p95={self.p95:.4f}, min={self.min:.4f}, "
                f"n={len(self.samples)})")


def _on_cuda(out) -> bool:
    if isinstance(out, torch.Tensor):
        return out.is_cuda
    if isinstance(out, dict):
        return any(_on_cuda(v) for v in out.values())
    if isinstance(out, (list, tuple)):
        return any(_on_cuda(v) for v in out)
    return False


def perf_func(fn: Callable[[], Any], iters: int = 10,
              warmup_iters: int = 3) -> tuple[Any, PerfStats]:
    """Time ``fn`` per call (ms) after ``warmup_iters`` calls. If its
    output lives on the card, each sample is the CUDA-event time of one
    call; otherwise the host clock around it. Returns (last output,
    :class:`PerfStats`)."""
    out = None
    for _ in range(max(warmup_iters, 1)):
        out = fn()
    cuda = _on_cuda(out)
    samples = []
    for _ in range(max(iters, 1)):
        if cuda:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            out = fn()
            samples.append((time.perf_counter() - t0) * 1e3)
    return out, PerfStats(samples)


def assert_allclose(x, y, atol: float = 1e-3, rtol: float = 1e-3,
                    verbose: bool = True):
    """Golden comparison: raises with the count and the first mismatches."""
    x, y = (a.detach().float().cpu().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a) for a in (x, y))
    if x.shape != y.shape:
        raise AssertionError(f"shape mismatch {x.shape} vs {y.shape}")
    if not np.allclose(x, y, atol=atol, rtol=rtol):
        bad = ~np.isclose(x, y, atol=atol, rtol=rtol)
        idx = np.argwhere(bad)[:5]
        raise AssertionError(
            f"allclose failed: {int(bad.sum())}/{x.size} mismatches "
            f"(atol={atol}, rtol={rtol}); first bad idx {idx.tolist()}; "
            f"x={x[bad][:5].tolist()} y={y[bad][:5].tolist()}")
    if verbose:
        print(f"allclose ok shape={x.shape} dtype={x.dtype}")


@contextlib.contextmanager
def group_profile(name: str | None = None, do_prof: bool = False,
                  log_dir: str = "prof"):
    """``torch.profiler`` over the block (CPU, and CUDA when present),
    written to ``<log_dir>/<name>/trace.json``; a no-op unless ``do_prof``
    and ``name`` are given."""
    if not do_prof or name is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    path = os.path.join(log_dir, name)
    os.makedirs(path, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(path, "trace.json"))
