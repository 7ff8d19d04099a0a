"""The port's KV-migration transport (``disagg/migrate``: kernel B13's plain
versions under ``kv_migrate_local``, and ``MigrationStream``) against the
JAX package's on the conftest's 8-device CPU mesh as (dcn=2, tp=4), on
``tests/test_disagg.py``'s shapes: the pools land bit for bit (a byte
copy); the stream's double buffer, accounting and named errors as the
reference's tests hold them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as JP

import triton_distributed_tpu_torch.disagg as tdisagg
from triton_distributed_tpu.disagg import migrate as jmig
from triton_distributed_tpu_torch.disagg import migrate as tmig
from triton_distributed_tpu_torch.runtime.context import DistContext

PAGE_ROWS = 8
_CTX: dict = {}


def tctx() -> DistContext:
    if "2d" not in _CTX:
        _CTX["2d"] = DistContext([torch.device("cpu")] * 8,
                                 mesh_shape=(2, 4), axis_names=("dcn", "tp"),
                                 wait_timeout_ms=60_000)
    return _CTX["2d"]


def _pools():
    src = np.arange(4 * PAGE_ROWS * 128, dtype=np.float32).reshape(
        4 * PAGE_ROWS, 128)
    dst = -np.ones((6 * PAGE_ROWS, 128), np.float32)
    return src, dst


@pytest.mark.parametrize("block_pages", [1, None])
def test_kv_migrate_local_vs_jax(block_pages):
    """Pages land on the decode slice at REWRITTEN ids, the prefill
    slice's pool is untouched, untargeted pages keep their bytes — the
    JAX package's pools bit for bit, one block a page and the default two
    blocks."""
    src_pages, dst_pages = (1, 3, 0), (5, 0, 2)
    src, dst = _pools()
    devs = np.array(jax.devices()[:8]).reshape(2, 4)
    fn = functools.partial(jmig.kv_migrate_local, src_pages=src_pages,
                           dst_pages=dst_pages, inter_axis="dcn", n_inter=2,
                           page_rows=PAGE_ROWS, block_pages=block_pages)
    out = jax.jit(jax.shard_map(
        fn, mesh=Mesh(devs, ("dcn", "tp")), in_specs=(JP(), JP()),
        out_specs=JP("dcn"), check_vma=False))(jnp.asarray(src),
                                               jnp.asarray(dst))
    out = np.asarray(out)
    rows = 6 * PAGE_ROWS
    ctx = tctx()
    pools = [(torch.from_numpy(src.copy()), torch.from_numpy(dst.copy()))
             for _ in range(8)]
    before = (tmig.MIGRATE_PACK_KERNEL.plain_calls,
              tmig.MIGRATE_SCATTER_KERNEL.plain_calls)
    got = ctx.run(lambda r: tmig.kv_migrate_local(
        pools[r][0], pools[r][1], src_pages, dst_pages, inter_axis="dcn",
        n_inter=2, page_rows=PAGE_ROWS, block_pages=block_pages))
    blocks = 3 if block_pages == 1 else 2
    # The 4 senders pack each block, the 4 receivers land each.
    assert tmig.MIGRATE_PACK_KERNEL.plain_calls == before[0] + 4 * blocks
    assert tmig.MIGRATE_SCATTER_KERNEL.plain_calls == before[1] + 4 * blocks
    for r, o in enumerate(got):
        a = ctx.axis_index(r, "dcn")
        np.testing.assert_array_equal(o.numpy(),
                                      out[a * rows:(a + 1) * rows])
        if a == 0:
            assert o is pools[r][1]
        # Neither input pool moved.
        np.testing.assert_array_equal(pools[r][0].numpy(), src)
        np.testing.assert_array_equal(pools[r][1].numpy(), dst)


def test_kv_migrate_local_validation():
    src, dst = (torch.from_numpy(a) for a in _pools())
    kw = dict(inter_axis="dcn", n_inter=2, page_rows=PAGE_ROWS)
    with pytest.raises(ValueError, match="pair one-to-one"):
        tmig.kv_migrate_local(src, dst, (0, 1), (2,), **kw)
    with pytest.raises(ValueError, match="duplicate destination"):
        tmig.kv_migrate_local(src, dst, (0, 1), (2, 2), **kw)
    with pytest.raises(ValueError, match="outside the pool"):
        tmig.kv_migrate_local(src, dst, (9,), (0,), **kw)
    with pytest.raises(ValueError, match="page_rows required"):
        tmig.kv_migrate_local(src, dst, (0,), (1,), inter_axis="dcn",
                              n_inter=2)
    with pytest.raises(ValueError, match="n_inter required"):
        tmig.kv_migrate_local(src, dst, (0,), (1,), page_rows=PAGE_ROWS)
    with pytest.raises(ValueError, match="block_pages = 0"):
        tmig.kv_migrate_local(src, dst, (0,), (1,), block_pages=0, **kw)
    # Empty stream is a no-op, not an error.
    assert tmig.kv_migrate_local(src, dst, (), (), **kw) is dst


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float8_e4m3fn])
def test_pack_scatter_byte_copies(dtype):
    """B13's plain versions move bytes in any type: a pack of listed pages
    in list order, a scatter that leaves its input pool alone."""
    pool = torch.randn(5 * PAGE_ROWS, 64).to(dtype)
    buf = tmig.pack_plain(pool, [4, 0, 2], PAGE_ROWS)
    v = pool.view(5, PAGE_ROWS, 64)
    assert torch.equal(buf.view(torch.uint8),
                       torch.cat([v[4], v[0], v[2]]).view(torch.uint8))
    dpool = torch.zeros(6 * PAGE_ROWS, 64).to(dtype)
    out = tmig.scatter_pages(dpool, buf, [1, 5, 3], PAGE_ROWS)
    o = out.view(6, PAGE_ROWS, 64)
    for i, p in enumerate((1, 5, 3)):
        assert torch.equal(o[p].view(torch.uint8),
                           buf.view(3, PAGE_ROWS, 64)[i].view(torch.uint8))
    assert not out.view(torch.uint8)[PAGE_ROWS * 0:PAGE_ROWS].any()
    assert not dpool.view(torch.uint8).any()


@pytest.mark.parametrize("which", ["pack_range", "pack_negative",
                                   "scatter_range", "scatter_duplicate"])
def test_pack_scatter_refuse_bad_ids(which):
    """The public wrappers check the host id list themselves, before any
    kernel: on the card an id out of range would leave rows unwritten
    and a repeated destination would race."""
    pool = torch.randn(5 * PAGE_ROWS, 64)
    buf = torch.randn(2 * PAGE_ROWS, 64)
    with pytest.raises(ValueError, match="outside the pool|duplicate"):
        if which == "pack_range":
            tmig.pack_pages(pool, [0, 5], PAGE_ROWS)
        elif which == "pack_negative":
            tmig.pack_pages(pool, [-1, 2], PAGE_ROWS)
        elif which == "scatter_range":
            tmig.scatter_pages(pool, buf, [4, 7], PAGE_ROWS)
        else:
            tmig.scatter_pages(pool, buf, [3, 3], PAGE_ROWS)
    assert torch.equal(tmig.pack_pages(pool, [1, 1], PAGE_ROWS),
                       tmig.pack_plain(pool, [1, 1], PAGE_ROWS))


# ---------------------------------------------------------------------------
# MigrationStream (the host transport), as tests/test_disagg.py:236-290.
# ---------------------------------------------------------------------------

def _kv_blocks(n, val=1.0):
    return [(torch.full((2, 1, 4, 1, 8), val * (i + 1)),
             torch.full((2, 1, 4, 1, 8), -val * (i + 1))) for i in range(n)]


def test_migration_stream_double_buffer_and_accounting():
    landed = []
    stream = tmig.MigrationStream("r", _kv_blocks(3), [[7], [2], [5]],
                                  put=lambda kv: kv, verify=True)
    for want, done_want in (([], False), ([(0, [7])], False),
                            ([(0, [7]), (1, [2])], False)):
        done = stream.advance(lambda i, kv, pages: landed.append((i, pages)))
        assert done is done_want and landed == want
    assert stream.advance(lambda i, kv, pages: landed.append((i, pages)))
    assert landed[-1] == (2, [5])
    assert stream.pages_moved == 3
    assert stream.bytes_moved == 3 * 2 * (2 * 1 * 4 * 1 * 8) * 4


def test_migration_stream_drop_and_corrupt_named():
    def run(hook):
        stream = tmig.MigrationStream("r", _kv_blocks(2), [[0], [1]],
                                      put=lambda kv: kv, verify=True,
                                      chaos_hook=hook)
        for _ in range(4):
            if stream.advance(lambda i, kv, pages: None):
                break

    with pytest.raises(tmig.MigrationError, match="block 0 lost in transit"):
        run(lambda i, kv: None if i == 0 else kv)
    with pytest.raises(tmig.MigrationIntegrityError,
                       match="checksum mismatch"):
        run(lambda i, kv: (kv[0] + 1.0, kv[1]) if i == 1 else kv)


def test_migration_stream_deadline_named(monkeypatch):
    t = [0.0]
    stream = tmig.MigrationStream("r", _kv_blocks(2), [[0], [1]],
                                  put=lambda kv: kv, verify=False,
                                  timeout_s=10.0, clock=lambda: t[0])
    stream.advance(lambda i, kv, pages: None)
    t[0] = 11.0
    with pytest.raises(tmig.MigrationTimeoutError,
                       match="exceeded its deadline"):
        stream.advance(lambda i, kv, pages: None)
    for exc in (tmig.MigrationTimeoutError, tmig.MigrationIntegrityError,
                tmig.MigrationError):
        assert exc("x").transient is True
    # The knobs, as the reference's.
    monkeypatch.setenv("TDTPU_MIGRATE_TIMEOUT_MS", "2500")
    assert tmig.migrate_timeout_s() == jmig.migrate_timeout_s() == 2.5
    monkeypatch.setenv("TDTPU_MIGRATE_VERIFY", "0")
    assert tmig.migrate_verify() is jmig.migrate_verify() is False
    assert tmig._blocks(5, 2) == jmig._blocks(5, 2) == [(0, 2), (2, 2),
                                                        (4, 1)]


def test_stream_metrics_refused_and_exports():
    stream = tmig.MigrationStream("r", _kv_blocks(1), [[0]],
                                  put=lambda kv: kv)
    with pytest.raises(NotImplementedError, match="obs/metrics"):
        stream.finish_metrics()
    assert set(tdisagg.__all__) == {
        "MigrationError", "MigrationIntegrityError", "MigrationStream",
        "MigrationTimeoutError", "kv_migrate_local", "migrate_timeout_s"}
    assert not hasattr(tdisagg, "DisaggServingEngine")
