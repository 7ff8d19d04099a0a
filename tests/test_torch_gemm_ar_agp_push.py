"""B11's split-K weight stream (``csrc/gemm_comm.cu`` gemm_ar_splitk) and
B4's parity AllGather on the push protocol (``csrc/collectives.cu``
ag_parity, ``csrc/push.cuh``) on the CPU: the host side of the card's
launches — B11's route picker and strip plan, its per-block flags, the
parity AllGather's pad and grid, both argument lists, the buffers asked
for — computed in Python so that it is checked here; and both plain
versions through the rank threads.

The port's ranks are CPU threads. Tolerance: bit for bit everywhere — the
AllGather moves bytes, and B11's stream keeps its plain version's
rounding (each partial chunk one fp32 product cast once, the n slots
summed in rank order from 0 in fp32, one cast).
``tests/test_torch_tp_overlap.py`` and ``tests/test_torch_collectives.py``
hold both plain versions against the JAX package's kernels.
"""

import types

import numpy as np
import pytest
import torch

from triton_distributed_tpu_torch.ops import _comm
from triton_distributed_tpu_torch.ops import allgather as tag
from triton_distributed_tpu_torch.ops import gemm_allreduce as tgar
from triton_distributed_tpu_torch.runtime.context import DistContext
from triton_distributed_tpu_torch.runtime.symm import SIGNAL_WORDS

BF, F32 = torch.bfloat16, torch.float32
H100_SMS = 132
_CTX: dict = {}


def tctx(n: int) -> DistContext:
    if n not in _CTX:
        _CTX[n] = DistContext([torch.device("cpu")] * n,
                              wait_timeout_ms=60_000)
    return _CTX[n]


def _x(shape, dtype, seed) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32)).to(dtype)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.uint8)


# ---------------------------------------------------------------------------
# B11: the route and the plan.
# ---------------------------------------------------------------------------

# (m, k, nc, dtype, B aligned, route): bf16 at m <= 16 with every operand
# whole 16-byte units goes to split-K; fp32, 17 rows, an unaligned B, a
# chunk of 4 columns and a K whose rows do not fit a block's shared memory
# keep the mma.sync tiles (the short one below 64 rows).
ROUTES = [(1, 1024, 1024, BF, True, "splitk"),
          (2, 1024, 1024, BF, True, "splitk"),
          (2, 3072, 1024, BF, True, "splitk"),
          (5, 1000, 1000, BF, True, "splitk"),
          (16, 3072, 1024, BF, True, "splitk"),
          (16, 1000, 128, BF, True, "splitk"),
          (2, 1024, 1024, F32, True, "mma_short"),
          (17, 1024, 1024, BF, True, "mma_short"),
          (64, 1024, 1024, BF, True, "mma_tall"),
          (2, 1024, 1024, BF, False, "mma_short"),
          (2, 1024, 4, BF, True, "mma_short"),
          (16, 8192, 1024, BF, True, "mma_short")]


@pytest.mark.parametrize("m,k,nc,dtype,aligned,route", ROUTES,
                         ids=[f"m{r[0]}_k{r[1]}_nc{r[2]}_{r[3]}_{r[4]}"
                              for r in ROUTES])
def test_b11_route_picker(m, k, nc, dtype, aligned, route):
    got = _comm.GEMM_ROUTES[tgar.gemm_ar_route(m, k, nc, dtype, aligned)]
    assert got == route
    if got == "splitk":
        assert tgar.splitk_smem(m, k) <= tgar.MAX_SMEM
    if (m, k) == (16, 8192):
        assert tgar.splitk_smem(m, k) > tgar.MAX_SMEM


def test_b11_smem_of_the_main_shapes():
    """The kernel's shared memory (``sk_smem``): A's rows of all of K with
    16 bytes more a row, the warps' float4 partials and the strip's sums;
    at the decode's two shapes well under a block's 227 KiB and under the
    120 KiB every fused kernel reserves (one block an SM)."""
    assert tgar.splitk_smem(2, 1024) == 2 * 2064 + 16384 + 2048
    assert tgar.splitk_smem(2, 3072) == 2 * 6160 + 16384 + 2048
    assert tgar.splitk_smem(16, 3072) == 16 * 6160 + 32768 + 2048
    assert tgar.splitk_smem(16, 3072) > tgar.RESERVE_SMEM
    assert tgar.splitk_smem(2, 3072) < tgar.RESERVE_SMEM


PLANS = [("wo", 4096, 4), ("down", 4096, 4), ("small", 512, 4),
         ("pad", 1024, 4), ("n512", 512, 4), ("n1000", 1000, 4),
         ("n64", 64, 1), ("n8", 8, 1)]


@pytest.mark.parametrize("r", [1, 4, 8])
@pytest.mark.parametrize("name,ncols,n_chunks", PLANS,
                         ids=[p[0] for p in PLANS])
def test_b11_strip_plan(name, ncols, n_chunks, r):
    """Every column of every chunk lies in exactly one strip, every strip
    has exactly one block, the plan is the same on every rank (a function
    of the shape and the card's share alone), the grid is within 1/r of
    an H100's SMs and the kernel's 128 blocks, and a chunk's last strip
    is cut at nc (1000 columns: 15 strips of 64 and one of 40)."""
    cap = H100_SMS // r
    plans = [tgar.splitk_plan(ncols, n_chunks, cap) for _ in range(r)]
    assert all(p == plans[0] for p in plans)
    plan = plans[0]
    nch, nc = plan["n_chunks"], plan["nc"]
    assert nch * nc == ncols and nch == tgar._gemm_ar_chunks(ncols, n_chunks)
    cover = np.zeros((nch, nc), dtype=np.int32)
    for c, c0, cols in plan["strips"]:
        assert 0 < cols <= tgar.SPLITK_COLS and cols % 8 == 0
        cover[c, c0:c0 + cols] += 1
    assert (cover == 1).all()
    owners = {}
    for b, strips in enumerate(plan["blocks"]):
        for s in strips:
            owners.setdefault(s, []).append(b)
    assert sorted(owners) == list(range(len(plan["strips"])))
    assert all(len(v) == 1 for v in owners.values())
    assert 1 <= plan["grid"] <= min(cap, tgar.MAX_GEMM_BLOCKS)
    assert plan["grid"] == min(len(plan["strips"]), cap)
    if name == "n1000":
        assert [s[2] for s in plan["strips"]] == [64] * 15 + [40]
    if name == "wo" and r == 4:
        # 64 strips over 33 blocks: 31 blocks take two strips, 2 one.
        assert plan["grid"] == 33
        assert sorted(len(s) for s in plan["blocks"]) == [1] * 2 + [2] * 31


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_b11_flags_raised_by_the_writers(n):
    """Block b of each rank raises one word a parity, (p, rank, b), on
    every rank, and waits for the n words (p, s, b): each waited word has
    exactly one raiser, block b of source s, which wrote exactly the
    strips block b reduces (the plan is every rank's). The words of both
    parities at every grid lie inside the pad, above the barrier flags,
    all apart."""
    plan = tgar.splitk_plan(4096, 4, H100_SMS // n)
    G = plan["grid"]
    for p in (0, 1):
        raised = {}
        for s in range(n):
            for b in range(G):
                raised.setdefault(tgar.splitk_flag(p, s, b), []).append(
                    (s, b, tuple(plan["blocks"][b])))
        assert all(len(v) == 1 for v in raised.values())
        for me in range(n):
            for b in range(G):
                waits = [tgar.splitk_flag(p, s, b) for s in range(n)]
                assert len(set(waits)) == n
                for s, w in enumerate(waits):
                    (src, blk, strips), = raised[w]
                    assert (src, blk) == (s, b)
                    assert strips == tuple(plan["blocks"][b])
    words = [tgar.splitk_flag(p, s, b) for p in (0, 1) for s in range(8)
             for b in range(tgar.MAX_GEMM_BLOCKS)]
    assert len(set(words)) == len(words)
    assert min(words) == tgar.GEMM_FLAG_BASE and max(words) < SIGNAL_WORDS


# ---------------------------------------------------------------------------
# The parity AllGather: its pad and grid.
# ---------------------------------------------------------------------------

def test_agp_pad_words_fit_and_stay_apart(monkeypatch):
    """The parity stream launches on PUSH_LAYOUT: every word of n = 1-8
    ranks at every grid inside the pad, the kinds apart. Its pad is its
    own — one per (tag, shape, dtype), never the full-mesh push's
    ``"ag_full_mesh"`` or B7's ``"p2p"`` — so its epochs (the call index
    + 1) are the stream's alone."""
    lay = _comm.PUSH_LAYOUT
    for n in range(1, 9):
        for grid in (1, 9, _comm.PUSH_MAX_BLOCKS):
            words = lay.words(n, grid)
            flat = [w for ws in words.values() for w in ws]
            assert len(flat) == len(set(flat)) == 2 * n + n * grid
            assert 0 <= min(flat) and max(flat) < SIGNAL_WORDS
    tags = []
    monkeypatch.setattr(tag, "symm_pad", lambda ctx, tag: (
        tags.append(tag) or types.SimpleNamespace(
            epochs=[0] * ctx.num_ranks, call_index=lambda: 0)))
    ctx = types.SimpleNamespace(num_ranks=4, is_cuda=True)
    for shape in ((128, 130, F32), (128, 130, BF), (64, 130, F32)):
        tag.ag_stream_workspace(4, *shape, ctx=ctx)
        tag.ag_stream_workspace(4, *shape, ctx=ctx, tag="other")
    assert len(set(tags)) == len(tags) == 6
    assert not {"ag_full_mesh", "p2p"} & set(tags)


@pytest.mark.parametrize("ranks_on_card", [1, 4, 8])
def test_agp_grid(ranks_on_card):
    """A block per AGP_BLOCK_BYTES of a rank's chunk, the same on every
    rank, within 1/r of the SMs: the SP decode's 128 x 130 fp32 chunk (65
    KiB) takes 9 blocks; a one-row chunk one; 2048 x 256 fp32 (2 MiB) the
    cap (and at most the pad's PUSH_MAX_BLOCKS data words a source)."""
    cap = H100_SMS // ranks_on_card
    for nbytes, want in ((128 * 130 * 4, 9), (256 * 4, 1),
                         (2048 * 256 * 4, _comm.PUSH_MAX_BLOCKS)):
        grids = {_comm.push_grid(nbytes, [cap], _comm.AGP_BLOCK_BYTES)
                 for _ in range(ranks_on_card)}
        assert grids == {min(want, cap)}


# ---------------------------------------------------------------------------
# Both launches on stand-ins for CUDA tensors.
# ---------------------------------------------------------------------------

class _FakeCuda:
    """A stand-in for a CUDA tensor: what the wrappers read of it."""

    def __init__(self, shape, dtype=BF, ptr=4096):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.device = types.SimpleNamespace(type="cuda")
        self._ptr = ptr

    def dim(self):
        return len(self.shape)

    def element_size(self):
        return torch.empty((), dtype=self.dtype).element_size()

    def numel(self):
        return int(np.prod(self.shape))

    def contiguous(self):
        return self

    def data_ptr(self):
        return self._ptr


class _TorchOut:
    """``torch`` for a wrapper module under test, whose ``empty`` returns
    the string "out" (the stand-ins have no memory to allocate on)."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def empty(*args, **kwargs):
        return "out"


def _meeting(monkeypatch):
    seen = []

    def fake(kernel, buf, rank, dev, what, args, variants=()):
        seen.append((kernel, list(args), variants))

    monkeypatch.setattr(_comm, "_launch_at_meeting", fake)
    monkeypatch.setattr(_comm, "_sm_caps", lambda ctx: [33])
    monkeypatch.setattr(_comm, "current_stream", lambda dev: "stream")
    monkeypatch.setattr(_comm, "ptr", lambda t: t)
    return seen


def _fake_ctx(n):
    return types.SimpleNamespace(
        num_ranks=n, devices=[torch.device("cuda:0")] * n, timeout_s=1.0,
        error_word=lambda r: None, ranks_on=lambda dev: n, is_cuda=True)


@pytest.mark.parametrize("m,ptr,route", [(2, 4096, "splitk"),
                                         (17, 4096, "mma_short"),
                                         (2, 4098, "mma_short")])
def test_b11_launch_arguments(monkeypatch, m, ptr, route):
    """``gemm_ar_stream``'s CUDA path on stand-ins: one launch of the C
    entry with one argument per declared type — op 2, the shape (m, its
    padded rows, K, a chunk's columns, B's row, the chunks), bf16, the
    route the picker gives (a B one element off 16 bytes stays on the
    short tile), vec_b, the 4 ranks on the card, the GPU's scope — counted
    under that route; the workspace's shape is unchanged, (2, chunks, n,
    mp, nc)."""
    n, k, ncols = 4, 1024, 4096
    seen = _meeting(monkeypatch)
    ctx = _fake_ctx(n)
    monkeypatch.setattr(tgar, "rank_of", lambda axis, num: (ctx, 1, n))
    monkeypatch.setattr(tgar, "check_payload", lambda c, r, x, *a, **kw: x)
    monkeypatch.setattr(tgar, "check_weight", lambda c, r, x, b, w: b)
    mp = tgar._padded_rows(m, BF)
    ws = types.SimpleNamespace(
        ctx=ctx, tensors=[torch.empty((2, 4, n, mp, 1024), dtype=BF)] * n,
        table=[None] * n, signal_table=[None] * n, epochs=[5] * n)
    x, b = _FakeCuda((m, k)), _FakeCuda((k, ncols), ptr=ptr)
    monkeypatch.setattr(tgar, "torch", _TorchOut())
    out, _, idx = tgar.gemm_ar_stream(x, b, ws, 5, num_ranks=n)
    assert out == "out" and idx == 6 and ws.epochs[1] == 6
    (kernel, args, variants), = seen
    assert kernel is _comm.GEMM_AR_KERNEL
    assert len(args) == len(_comm.GEMM_AR_KERNEL.argtypes)
    assert args[3:6] == [1, n, 5]                  # rank, n, call index
    assert args[7:10] == [x, b, "out"]
    assert args[11:18] == [2, m, mp, k, 1024, ncols, 4]
    assert args[18] == _comm.DTYPE_CODE[BF]
    assert _comm.GEMM_ROUTES[args[19]] == route == variants[0]
    assert args[20] == int(ptr % 16 == 0)
    assert args[21:23] == [n, 0] and args[-1] == "stream"


def test_agp_launch_arguments_and_no_slab(monkeypatch):
    """The parity AllGather's CUDA path asks for a pad and no slab
    (``symm_zeros`` never called), and launches its own C entry on the
    push protocol: the epoch the pad's next (the call index + 1), the
    chunk's bytes, the grid (9 blocks of 8 KiB at the SP decode's 65 KiB),
    the GPU's scope, PUSH_LAYOUT's words, the stream last."""
    n, rows, cols = 4, 128, 130
    seen = _meeting(monkeypatch)
    monkeypatch.setattr(tag, "symm_zeros", lambda *a, **kw: pytest.fail(
        "the CUDA path asked for a slab"))
    ctx = _fake_ctx(n)
    epochs = [0] * n

    def next_epoch(r):
        epochs[r] += 1
        return epochs[r]

    pad = types.SimpleNamespace(ctx=ctx, table=[None] * n,
                                signal_table=[None] * n, epochs=epochs,
                                next_epoch=next_epoch,
                                call_index=lambda: epochs[0])
    monkeypatch.setattr(tag, "symm_pad", lambda c, tag: pad)
    ws, idx = tag.ag_stream_workspace(n, rows, cols, F32, ctx=ctx)
    assert idx == 0 and ws.buf is pad and ws.shape == (2, n * rows, cols)
    monkeypatch.setattr(tag, "rank_of", lambda axis, num: (ctx, 2, n))
    monkeypatch.setattr(tag, "check_payload", lambda c, r, x, *a, **kw: x)
    x = _FakeCuda((rows, cols), F32)
    monkeypatch.setattr(tag, "torch", _TorchOut())
    for call in range(2):
        out, _, idx = tag.all_gather_stream(x, ws, idx, num_ranks=n)
        assert out == "out" and idx == call + 1
    assert [s[0] for s in seen] == [_comm.AG_PARITY_KERNEL] * 2
    for call, (_, args, _) in enumerate(seen):
        assert len(args) == len(_comm.AG_PARITY_KERNEL.argtypes)
        assert args[3:6] == [2, n, call + 1]
        assert args[7:10] == [x, "out", rows * cols * 4]
        assert args[10:-1] == [9, 0, *_comm.PUSH_LAYOUT.args()]
        assert args[-1] == "stream"


# ---------------------------------------------------------------------------
# The plain versions through the rank threads.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,ncols", [(2, 256, 512), (5, 128, 1000),
                                       (16, 64, 256)])
@pytest.mark.parametrize("n", [2, 4])
def test_gemm_ar_stream_plain_equals_gemm_ar_plain(n, m, k, ncols):
    """The rank threads' B11 stream (the plain version through the
    workspace's slots) gives every rank ``gemm_ar_plain``'s sum bit for
    bit, over three calls (both parities and back), in bf16 and fp32; the
    slots hold each rank's partial chunks."""
    ctx = tctx(n)
    for dtype in (BF, F32):
        xs = [_x((m, k), dtype, 10 * n + r) for r in range(n)]
        bs = [_x((k, ncols), dtype, 50 + r) * k ** -0.5 for r in range(n)]
        want = tgar.gemm_ar_plain(xs, bs)
        ws, idx0 = tgar.gemm_ar_stream_workspace(
            n, m, ncols, dtype, ctx=ctx, tag=f"plain-{m}-{k}-{ncols}")
        nch = ws.tensors[0].shape[1]

        def body(r):
            idx, outs = idx0, []
            for _ in range(3):
                out, _, idx = tgar.gemm_ar_stream(xs[r], bs[r], ws, idx,
                                                  num_ranks=n)
                outs.append(out)
            return outs, idx

        got = ctx.run(body)
        for outs, idx in got:
            assert idx == idx0 + 3
            assert all(torch.equal(_bits(o), _bits(want)) for o in outs)
        parts = tgar.gemm_ar_partials(xs[1], bs[1], nch)
        slab = ws.tensors[0][(idx0 + 2) % 2]
        for c in range(nch):
            assert torch.equal(_bits(slab[c, 1, :m]), _bits(parts[c]))


@pytest.mark.parametrize("dtype", [F32, BF, torch.float8_e4m3fn])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_all_gather_stream_plain_into_sentinel(n, dtype):
    """The parity stream's plain version writes a harness's 0xFF-filled
    ``out=`` (at n = 1 under ``force_kernel``: the loopback) and returns
    it, equal to ``ag_plain`` bit for bit on every rank over three calls
    (both parities); the call index advances by one a call; ``out=``
    without the kernel at one rank is refused."""
    m, cols = 7, 64
    ctx = tctx(n) if n > 1 else DistContext([torch.device("cpu")],
                                            wait_timeout_ms=60_000)
    calls = [[_x((m, cols), F32, 100 * t + r).to(dtype) for r in range(n)]
             for t in range(3)]
    ws, idx0 = tag.ag_stream_workspace(n, m, cols, dtype, ctx=ctx,
                                       tag=f"sentinel-{dtype}")

    def body(r):
        idx, res = idx0, []
        for xs in calls:
            out = torch.empty((n * m, cols), dtype=dtype)
            out.view(torch.uint8).fill_(0xFF)
            got, _, idx = tag.all_gather_stream(xs[r], ws, idx, num_ranks=n,
                                                force_kernel=n == 1, out=out)
            assert got is out
            res.append(got)
        if n == 1:
            with pytest.raises(ValueError, match="out= needs the kernel"):
                tag.all_gather_stream(calls[0][0], ws, idx, num_ranks=1,
                                      out=torch.empty_like(calls[0][0]))
        return idx, res

    outs = ctx.run(body)
    for r, (idx, res) in enumerate(outs):
        assert idx == idx0 + 3
        for xs, got in zip(calls, res):
            assert torch.equal(_bits(got), _bits(tag.ag_plain(xs)))
    if n == 1:
        ctx.close()
