"""Boundaries of the PyTorch/CUDA port: it imports neither JAX nor the JAX
package (and ``triton`` only inside functions), its entry points refuse to
drop to the CPU on their own, and JAX bf16 weights cross bit-exactly."""

import ast
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from triton_distributed_tpu_torch.models.config import tiny_config
from triton_distributed_tpu_torch.models.convert import (
    array_to_tensor, params_from_numpy,
)
from triton_distributed_tpu_torch.models.dense import init_dense_llm
from triton_distributed_tpu_torch.models.engine import Engine
from triton_distributed_tpu_torch.runtime import build

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "triton_distributed_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"] + sorted((ROOT / "scripts").glob("*port*.py"))


def _violations(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    module_level = {id(n) for n in tree.body}
    for node in tree.body:          # imports under module-level if/try too
        if isinstance(node, (ast.If, ast.Try)):
            module_level |= {id(n) for n in ast.walk(node)}
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots = [node.module.split(".")[0]]
        else:
            continue
        for root in roots:
            if root in ("jax", "jaxlib", "triton_distributed_tpu"):
                bad.append(f"{path.name}:{node.lineno} imports {root}")
            if root == "triton" and id(node) in module_level:
                bad.append(f"{path.name}:{node.lineno} imports triton at "
                           "module level")
    return bad


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_no_jax(path):
    assert path.exists(), path
    assert _violations(path) == []


def test_scan_covers_every_subpackage():
    """The no-JAX scan reaches every subpackage of the port, the host
    tools (``obs``, ``analysis``) included, and ``chip_smoke.py``."""
    pkg = ROOT / "triton_distributed_tpu_torch"
    subs = {p.parent.name for p in PORT_FILES if p.parent != pkg}
    assert {"obs", "analysis", "megakernel", "runtime", "serving", "ops",
            "models", "layers"} <= subs
    for mod in ("obs/kernel_profile.py", "analysis/mklint.py",
                "analysis/checker.py"):
        assert pkg / mod in PORT_FILES
    assert ROOT / "chip_smoke.py" in PORT_FILES
    assert ROOT / "scripts" / "check_port_tp.py" in PORT_FILES


def test_import_guard_catches_a_violation(tmp_path):
    f = tmp_path / "bad.py"
    f.write_text("import jax.numpy as jnp\nimport triton\n"
                 "from triton_distributed_tpu.models import config\n"
                 "def k():\n    import triton\n")
    assert len(_violations(f)) == 3


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_config(num_layers=1)
    params = init_dense_llm(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    with pytest.raises(RuntimeError, match="is_available"):
        Engine(cfg, params, device=None, max_seq=16, page_size=4)
    with pytest.raises(RuntimeError, match="is_available"):
        init_dense_llm(cfg, generator=torch.Generator(), device=None)
    with pytest.raises(RuntimeError, match="is_available"):
        params_from_numpy({"w": np.zeros(2, np.float32)}, cfg)


def test_tp_megakernel_decoder_defaults_to_cuda(monkeypatch):
    """``MegakernelDecoder`` resolves ``device=None`` to the card at one
    rank, and at n > 1 takes its ranks' devices from a rank group only:
    without ``ctx`` it raises instead of running CPU ranks, and a group of
    cards (``initialize_distributed(2)``) raises without them. The CPU
    ranks are asked for explicitly."""
    from triton_distributed_tpu_torch.megakernel.serving import (
        MegakernelDecoder,
    )
    from triton_distributed_tpu_torch.models.config import ModelConfig
    from triton_distributed_tpu_torch.runtime import context

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig(hidden_size=128, intermediate_size=256, num_layers=1,
                      num_heads=2, num_kv_heads=2, head_dim=128,
                      vocab_size=64, dtype="float32")
    params = init_dense_llm(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    with pytest.raises(RuntimeError, match="is_available"):
        MegakernelDecoder(cfg, params, max_seq=128)
    with pytest.raises(ValueError, match="requires ctx"):
        MegakernelDecoder(cfg, params, max_seq=128, num_ranks=2)
    with pytest.raises(RuntimeError, match="asks for 2 cards"):
        MegakernelDecoder(cfg, params, max_seq=128, num_ranks=2,
                          ctx=context.initialize_distributed(2))
    ctx = context.DistContext([torch.device("cpu")] * 2)
    dec = MegakernelDecoder(cfg, params, max_seq=128, num_ranks=2, ctx=ctx)
    assert [d.type for d in dec.devices] == ["cpu", "cpu"]
    ctx.close()


def test_moe_and_layer_initialisers_default_to_cuda(monkeypatch):
    """The MoE slice's entry points (``init_dense_llm`` and ``Engine`` on a
    MoE config, ``init_ep_moe``) and the layer initialisers under them
    resolve ``device=None`` to the card and raise without CUDA. The layer
    initialisers (``init_tp_attn``, ``init_tp_mlp``) used to hand None to
    ``torch.randn``, i.e. allocate on the CPU."""
    from triton_distributed_tpu_torch.layers.ep_moe import init_ep_moe
    from triton_distributed_tpu_torch.layers.tp_attn import init_tp_attn
    from triton_distributed_tpu_torch.layers.tp_mlp import init_tp_mlp

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_config(num_layers=1, num_experts=4, num_experts_per_tok=2,
                      moe_intermediate_size=32)
    gen = torch.Generator()
    params = init_dense_llm(cfg, generator=gen, device="cpu")
    assert params["layers"][0]["moe"]["w_gate"].device.type == "cpu"
    for make in (
            lambda: init_dense_llm(cfg, generator=gen, device=None),
            lambda: Engine(cfg, params, device=None, max_seq=16,
                           page_size=4),
            lambda: init_ep_moe(128, 32, 4, torch.float32, generator=gen),
            lambda: init_tp_attn(cfg, torch.float32, generator=gen),
            lambda: init_tp_mlp(128, 256, torch.float32, generator=gen)):
        with pytest.raises(RuntimeError, match="is_available"):
            make()


def test_gemm_fp8_and_default_engine_default_to_cuda(monkeypatch):
    """The GEMM slice's entry points: the default ``Engine(cfg, params)``
    (linear cache) resolves ``device=None`` to the card and raises without
    CUDA; ``pallas_matmul`` and ``fp8_dot`` run where their tensors live —
    the plain version only on the CPU, another device raises by name, and
    B3's build raises without the toolkit; the tuner is off without a
    card."""
    from triton_distributed_tpu_torch.models.fp8 import fp8_dot
    from triton_distributed_tpu_torch.ops import gemm
    from triton_distributed_tpu_torch.runtime import autotuner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_config(num_layers=1)
    params = init_dense_llm(cfg, generator=torch.Generator(), device="cpu")
    with pytest.raises(RuntimeError, match="is_available"):
        Engine(cfg, params)
    assert Engine(cfg, params, device="cpu").page_size is None
    a, b = torch.ones(4, 8), torch.ones(8, 16)
    for fn in (gemm.pallas_matmul, fp8_dot):
        with pytest.raises(ValueError, match="no kernel for device meta"):
            fn(a.to("meta"), b.to("meta"))
    monkeypatch.setattr(build, "_nvcc", lambda: (_ for _ in ()).throw(
        build.KernelBuildError("nvcc not found")))
    monkeypatch.setattr(gemm.GEMM_KERNEL, "_fn", None)
    with pytest.raises(build.KernelBuildError):
        gemm.GEMM_KERNEL._load()
    assert not autotuner.autotune_enabled()
    assert autotuner.tuned_matmul_tiles(4, 8, 16, torch.float32) is None


def test_cache_and_workspace_constructors_default_to_cuda(monkeypatch):
    """The caches' and the megakernel workspaces' constructors allocate on
    the card unless given a device: with ``device=None`` they used to
    allocate on the CPU, where ``paged_decode_attention`` then ran the
    plain version without a word. Without CUDA they now raise."""
    from triton_distributed_tpu_torch.megakernel.models import (
        build_decode_step,
    )
    from triton_distributed_tpu_torch.models.kv_cache import (
        identity_page_table, init_kv_cache, init_paged_model_cache,
    )
    from triton_distributed_tpu_torch.ops.paged_attention import (
        init_paged_kv_cache,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_config(num_layers=1)
    comp = build_decode_step(hidden=128, hq_local=1, hkv_local=1,
                             ffn_local=128, num_layers=1, max_seq=128,
                             pos=127, kv_pool_pages=2, table_pages=1,
                             batch=128, kv_fp8=True, inkernel_append=True,
                             mat_prefetch=True).mb.compile()
    for make in (
            lambda: init_paged_kv_cache(1, num_pages=2, page_size=4,
                                        num_kv_heads=1, head_dim=16,
                                        max_pages=2),
            lambda: init_kv_cache(cfg, 1, 8),
            lambda: init_paged_model_cache(cfg, 1, page_size=4,
                                           max_pages=2),
            lambda: identity_page_table(1, 2, 2),
            lambda: comp.make_workspace({}),
            lambda: comp.make_workspace_mat({}),
            lambda: comp.make_workspace_kv8()):
        with pytest.raises(RuntimeError, match="is_available"):
            make()
    assert init_kv_cache(cfg, 1, 8, device="cpu").k.device.type == "cpu"


def test_params_from_numpy_bf16_bit_exact():
    rng = np.random.default_rng(0)
    a = (rng.standard_normal((33, 7)) * 100).astype(ml_dtypes.bfloat16)
    a[0, :4] = [np.inf, -np.inf, 0.0, -0.0]
    t = array_to_tensor(a)
    assert t.dtype == torch.bfloat16 and t.shape == a.shape
    np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16),
                                  a.view(np.uint16))
    tree = {"layers": [{"w": a}], "n": np.ones(3, np.float32)}
    out = params_from_numpy(tree, tiny_config(dtype="bfloat16"),
                            device="cpu")
    assert torch.equal(out["layers"][0]["w"], t)
    assert out["n"].dtype == torch.bfloat16


def test_kernel_build_is_lazy_and_keyed_by_source():
    """Importing the ops builds nothing; the library name hashes the
    source, so each kernel gets its own file in the git-ignored build
    directory."""
    srcs = build.sources()
    assert [s.name for s in srcs] == ["all_to_all.cu", "collectives.cu",
                                      "flash_attention.cu", "gemm.cu",
                                      "gemm_comm.cu", "megakernel.cu",
                                      "migrate.cu", "multi_axis.cu",
                                      "p2p.cu", "paged_attention.cu"]
    paths = {build.library_path(s) for s in srcs}
    assert len(paths) == 10
    assert all(p.parent == build.BUILD_DIR for p in paths)
    gitignore = (ROOT / ".gitignore").read_text().split()
    assert "triton_distributed_tpu_torch/_build/" in gitignore


def test_initialize_distributed_means_cards(monkeypatch):
    """``devices=None`` means n cards and raises without them; CPU rank
    threads and virtual ranks are asked for explicitly; nothing drops to
    fewer ranks on its own."""
    from triton_distributed_tpu_torch.runtime import context

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="asks for 4 cards, 0 visible"):
        context.initialize_distributed(4)
    with pytest.raises(RuntimeError, match="is_available"):
        context.initialize_distributed(devices=["cuda:0"] * 4)
    with pytest.raises(ValueError, match="argument n"):
        context.initialize_distributed(2, devices=["cpu"] * 4)
    ctx = context.initialize_distributed(devices=["cpu"] * 2)
    assert ctx.num_ranks == 2 and not ctx.is_cuda and not ctx.virtual
    assert context.get_context() is ctx
    assert ctx.run(lambda r: r * 10) == [0, 10]
    ctx.close()


def test_kernel_counts_and_first_build_thread_safe(monkeypatch):
    """Four rank threads launching one kernel at once lose no count, and
    its first-use build and load run once."""
    import threading

    builds = []

    def fake_build(srcs):
        builds.append(srcs)
        threading.Event().wait(0.05)        # the race window of a real nvcc
        return {s.name: s for s in srcs}

    class FakeLib:
        def __init__(self, path):
            self.sym = lambda *a: 0
            self.tdt_error_string = lambda e: b""

    monkeypatch.setattr(build, "build", fake_build)
    monkeypatch.setattr(build.ctypes, "CDLL", FakeLib)
    k = build.CudaKernel("fake.cu", "sym", [])
    start = threading.Barrier(4)

    def worker():
        start.wait()
        for _ in range(5000):
            k.launch(variants=("lane",))
            k.count_plain()

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(builds) == 1
    assert k.launches == 20000 and k.plain_calls == 20000
    assert k.variant_launches == {"lane": 20000}


def test_topology_ring_is_rank_order():
    """On the CPU (and on an all-to-all NVLink host) the ring is the rank
    order; a pair of cards without peer access has no ring."""
    from triton_distributed_tpu_torch.runtime import topology

    topo = topology.detect_topology(["cpu"] * 4)
    assert topo.platform == "cpu" and topo.all_to_all and not topo.virtual
    assert topology.ring_order(topo) == [0, 1, 2, 3]
    cut = topology.Topology(2, "cuda", ("a", "b"),
                            ((True, False), (True, True)), virtual=False)
    with pytest.raises(RuntimeError, match="peer access"):
        topology.ring_order(cut)


def test_sp_pp_state_defaults_to_cuda(monkeypatch):
    """The SP/PP slice's state — the decode layers' parity workspaces, the
    bucketed AllGather's buffers, B7's receive buffers — lives on a rank
    group's devices. Without a group none is made (nothing drops to the
    CPU on its own), the default group is cards and raises without CUDA,
    and CPU ranks are asked for explicitly."""
    from triton_distributed_tpu_torch.layers.decode_layers import (
        GemmARLayer, SpFlashDecodeAttention,
    )
    from triton_distributed_tpu_torch.ops.low_latency_allgather import (
        AllGatherLayer,
    )
    from triton_distributed_tpu_torch.ops.p2p import p2p_shift
    from triton_distributed_tpu_torch.runtime import context

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(context, "_GLOBAL_CONTEXT", None)
    x = torch.ones((4, 128))
    for make in (
            lambda: SpFlashDecodeAttention(num_ranks=2).init_state(1, 2, 64),
            lambda: GemmARLayer(num_ranks=2).init_state(4, 128),
            lambda: AllGatherLayer(),
            lambda: p2p_shift(x)):
        with pytest.raises(RuntimeError, match="No distributed context"):
            make()
    with pytest.raises(RuntimeError, match="asks for 2 cards"):
        context.initialize_distributed(2, tp_axis="sp")
    ctx = context.DistContext([torch.device("cpu")] * 2, tp_axis="sp")
    ws, idx = SpFlashDecodeAttention(axis="sp", num_ranks=2).init_state(
        1, 2, 64, ctx=ctx)
    assert idx == 0 and [t.device.type for t in ws.tensors] == ["cpu"] * 2
    assert ws.tensors[0].shape == (2, 2 * 2, 66)
    ctx.close()


def test_package_exports_keep_submodules():
    """The ops and layers packages export the SP and PP entry points, but
    a function named as its module (``flash_decode``, ``ring_attention``,
    ``sp_ag_attention``) is left out: ``from ...ops import <module>`` must
    keep giving the module (the scripts and tests import them so)."""
    import pkgutil
    import types

    import triton_distributed_tpu_torch.layers as layers
    import triton_distributed_tpu_torch.ops as ops

    for pkg in (ops, layers):
        for m in pkgutil.iter_modules(pkg.__path__):
            got = getattr(pkg, m.name, None)
            assert got is None or isinstance(got, types.ModuleType), m.name
    for name in ("all_gather_stream", "ag_stream_workspace", "p2p_shift",
                 "p2p_permute_local", "flash_decode_local",
                 "ulysses_attention", "AllGatherLayer", "combine_partials"):
        assert callable(getattr(ops, name))
    for name in ("SpFlashDecodeAttention", "GemmARLayer", "CommOp",
                 "PPStream", "pp_pipeline_forward",
                 "pp_pipeline_interleaved"):
        assert callable(getattr(layers, name))
