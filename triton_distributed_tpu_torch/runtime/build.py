"""Build the hand-written CUDA kernels at first use and bind them with ctypes.

The port's stand-in for the JAX package's Pallas launch plumbing
(``language/core.py`` ``kernel_call``). Each ``csrc/*.cu`` source is compiled
by ``nvcc`` for ``sm_90a`` into its own shared library with a plain C
interface; pointers and the stream cross as ``c_void_p``, and every C entry
point returns its ``cudaError_t``, which :meth:`CudaKernel.launch` raises
on. Libraries land in ``_build/`` next to this package (git-ignored),
named by a hash of the source, the headers in ``csrc/`` and the flags, so
an edited source rebuilds and an unchanged one loads at once.

Nothing builds at import time: the CPU tests import every module, and a
machine without ``nvcc`` only fails when a kernel is actually launched.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# One build at a time in this process: the rank threads of a tensor-
# parallel group reach their first kernel together, and two nvcc runs of
# one source would race on its temporary file.
_BUILD_LOCK = threading.Lock()


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused a source; the message carries the
    compiler's output."""


class CudaKernelError(RuntimeError):
    """A C entry point returned a CUDA error (a refused launch, a bad
    argument) — raised by the wrapper, never swallowed."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise KernelBuildError(
        "nvcc not found on PATH or under CUDA_HOME — the CUDA kernels are "
        "built from csrc/ at first use and need the CUDA toolkit")


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path(source: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(source.read_bytes())
    for hdr in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def build(srcs: list[Path] | None = None) -> dict[str, Path]:
    """Compile every source whose library is missing: one ``nvcc`` per
    source, all started together. Returns {source name: library path}.
    The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) is kept beside each library as ``<name>.log``."""
    srcs = sources() if srcs is None else list(srcs)
    with _BUILD_LOCK:
        return _build_locked(srcs)


def _build_locked(srcs: list[Path]) -> dict[str, Path]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in srcs:
        out = library_path(src)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((src, out, tmp, proc))
    failures = []
    for src, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{src.name} (nvcc exit {proc.returncode}):\n"
                            f"{log[-4000:]}")
            continue
        os.replace(tmp, out)
    if failures:
        raise KernelBuildError("kernel build failed: " + "\n".join(failures))
    return {src.name: library_path(src) for src in srcs}


def build_all() -> float:
    """Build every kernel of the package; returns the wall seconds."""
    t0 = time.perf_counter()
    build()
    return time.perf_counter() - t0


class CudaKernel:
    """One C entry point of a ``csrc/*.cu`` library plus its launch count.

    ``launches`` is a plain integer: :meth:`launch` adds one after each
    launch the CUDA runtime accepted, and nothing else touches it but a
    caller resetting it to 0 — so a run can show that its main path went
    through the kernel. ``plain_calls`` counts calls of the kernel's plain
    PyTorch version (the module holding both increments it), so a run on
    the card can also show the plain version never stood in.
    ``variant_launches`` counts the launches of each named lane of the
    kernel (K2's ``"e4m3"`` pools; the megakernel's ``"kv8"`` pools,
    speculative ``"window"`` and ``"full"`` instantiation), so a run can
    show which lanes its path took.

    Thread-safe: the rank threads of a tensor-parallel group launch the
    same kernel at once, so the counts move under a lock (a bare ``+=``
    loses counts between threads) and the first-use build and load run
    once, under another."""

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.plain_calls = 0
        self.variant_launches: dict[str, int] = {}
        self._lib = None
        self._fn = None
        self._count_lock = threading.Lock()
        self._load_lock = threading.Lock()

    @property
    def source_path(self) -> Path:
        return CSRC_DIR / self.source

    def _load(self):
        if self._fn is None:
            with self._load_lock:
                if self._fn is None:
                    path = build([self.source_path])[self.source]
                    lib = ctypes.CDLL(str(path))
                    fn = getattr(lib, self.symbol)
                    fn.argtypes = self.argtypes
                    fn.restype = ctypes.c_int
                    err_str = lib.tdt_error_string
                    err_str.argtypes = [ctypes.c_int]
                    err_str.restype = ctypes.c_char_p
                    self._lib = lib
                    self._fn = fn
        return self._fn

    def library(self):
        """The loaded shared library (built at first use), for the
        source's other entry points."""
        self._load()
        return self._lib

    def count_plain(self) -> None:
        """Count one call of the kernel's plain version."""
        with self._count_lock:
            self.plain_calls += 1

    def launch(self, *args, variants: tuple = ()) -> None:
        """Call the C entry point (``args``: its arguments, the stream
        last); count the launch, and under each of ``variants``."""
        err = self._load()(*args)
        if err != 0:
            msg = self._lib.tdt_error_string(err).decode()
            raise CudaKernelError(f"{self.symbol}: CUDA error {err} ({msg})")
        with self._count_lock:
            self.launches += 1
            for v in variants:
                self.variant_launches[v] = (self.variant_launches.get(v, 0)
                                            + 1)


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a tensor (None → NULL) for a ``c_void_p`` slot."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def current_stream(device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device`` as a ``c_void_p``: the raw
    handle where this torch exposes it (0.2 us a call on an H100 host,
    against 7.5 for building a ``torch.cuda.Stream``), else the stream
    object's."""
    import torch

    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        dev = torch.device(device)
        index = torch.cuda.current_device() if dev.index is None \
            else dev.index
        return ctypes.c_void_p(raw(index))
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
