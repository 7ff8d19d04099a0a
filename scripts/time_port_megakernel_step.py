#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's megakernel lanes for the tree in the
current directory, on one CUDA card, and fingerprint their outputs.

Each case builds its program from ``chip_smoke.py``'s helpers at Qwen3-8B
(or Qwen3-30B-A3B) widths cut to 2 layers, bf16, seeded inputs, then
launches the kernel: the paged step (4 slots at kv_lens [0, 1, 127, 1999])
over bf16 and e4m3 pools, the 4-row speculative window step, the linear
batch-1 step at position 1999 in the matrix and the e4m3-tile layouts, and
the MoE step at batch 1 and 4. Per case it prints the kernel's time (L2
flushed before every launch; three rounds) and the SHA-256 of the
workspaces one launch leaves from the staged inputs, so two trees can be
compared bit for bit as well as in time. One JSON line, with the card's
name and power limit and ptxas's register and spill report for
``megakernel.cu``.

To compare two commits, unpack the other one (``git archive <commit>
chip_smoke.py triton_distributed_tpu_torch | tar -x -C <dir>``) into a
git-ignored directory and run this script from each root inside ONE
process sequence on the same card — parent, change, change, parent —
since a card's speed differs from one run to the next:

    cd <root of a tree> && python3 <path to>/time_port_megakernel_step.py [label]

It uses only helpers that older trees of the port (with the MoE program) have too.
"""
import dataclasses
import hashlib
import importlib
import json
import sys

sys.path.insert(0, ".")

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from triton_distributed_tpu_torch.models.config import (  # noqa: E402
    QWEN3_8B, QWEN3_30B_A3B,
)
from triton_distributed_tpu_torch.runtime import build  # noqa: E402


def _sha(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        if t is not None:
            h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def paged(mk, mkserv, cfg, *, seed, kv_dtype=None, window=1):
    lens = cs.MK_WIN_LENS if window > 1 else cs.MK_LENS
    dec, ws0, queue, _ = cs.mk_state(torch, mkserv, cfg, torch.bfloat16, seed,
                                     lens=lens, kv_dtype=kv_dtype,
                                     window=window)
    comp = dec.comp
    kw = dict(num_exec=comp.num_exec, mat_specs=comp.mat_specs,
              head_dim=comp.head_dim, sync_before=comp.sync_before,
              live_rows=dec.spec_w)

    def launcher(ws):
        main, pool = dec._split(ws)
        return mk.cuda_launcher(queue, main, dec._wsm,
                                wkv8=pool if dec.kv_fp8 else None, **kw)

    return ws0, lambda ws: (ws if dec.kv_fp8 else (ws,)), launcher, \
        (lambda ws: (ws[0].clone(), ws[1].clone()) if dec.kv_fp8
         else ws.clone())


def linear(mk, mkserv, cfg, *, seed, fp8_weights=False):
    from triton_distributed_tpu_torch.models.dense import init_dense_llm
    from triton_distributed_tpu_torch.models.kv_cache import KVCache

    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    params = init_dense_llm(
        cfg, generator=torch.Generator(device="cuda").manual_seed(seed))
    dec = mkserv.MegakernelDecoder(cfg, params, max_seq=cs.LIN_MAX_SEQ,
                                   dtype=torch.bfloat16,
                                   fp8_weights=fp8_weights)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    shape = (cfg.num_layers, 1, cs.LIN_MAX_SEQ, cfg.num_kv_heads,
             cfg.head_dim)
    cache = KVCache(
        k=torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16),
        v=torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16),
        offset=0)
    ws0 = dec.start(cache)
    queue = dec.queue_at(1999)
    dec.put_inputs(ws0, [17], 1999)
    comp = dec.comp
    wsm, ws8 = dec.weights()

    def launcher(ws):
        return mk.cuda_launcher(queue, ws, wsm, ws8=ws8,
                                live_rows=1, sync_before=comp.sync_before,
                                num_exec=comp.num_exec,
                                mat_specs=comp.mat_specs,
                                head_dim=comp.head_dim)

    return ws0, lambda ws: (ws,), launcher, lambda ws: ws.clone()


def moe(mk, mkmodels, mkserv, cfg, *, seed, batch):
    from triton_distributed_tpu_torch.models.dense import init_dense_llm

    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    params = init_dense_llm(
        cfg, generator=torch.Generator(device="cuda").manual_seed(seed))
    prog, comp = cs.moe_build(torch, mkmodels, cfg, batch=batch,
                              dtype=torch.bfloat16)
    main, _, wm = comp.split_feeds(mkserv.weight_feeds(prog, cfg, params))
    ws0, wsm = comp.make_workspace(main), comp.make_workspace_mat(wm)
    caches = torch.tensor(cs.moe_cache_tiles(prog), device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    ws0[caches] = torch.randn((len(caches), 128, 128), generator=g,
                              device="cuda").to(torch.bfloat16)
    toks = torch.randint(0, cfg.vocab_size, (batch,), generator=g,
                         device="cuda")
    queue = cs.moe_stage(torch, mkmodels, prog, comp, ws0, cfg,
                         params["embed"][toks], 1999)

    def launcher(ws):
        return mk.cuda_launcher(queue, ws, wsm, live_rows=batch,
                                sync_before=comp.sync_before,
                                num_exec=comp.num_exec,
                                mat_specs=comp.mat_specs,
                                head_dim=comp.head_dim)

    return ws0, lambda ws: (ws,), launcher, lambda ws: ws.clone()


def main() -> int:
    if not torch.cuda.is_available():
        print("time_port_megakernel_step: needs a CUDA card", file=sys.stderr)
        return 1
    mk = importlib.import_module(
        "triton_distributed_tpu_torch.megakernel.kernel")
    mkserv = importlib.import_module(
        "triton_distributed_tpu_torch.megakernel.serving")
    mkmodels = importlib.import_module(
        "triton_distributed_tpu_torch.megakernel.models")
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
    mcfg = dataclasses.replace(QWEN3_30B_A3B, num_layers=2)
    cases = {
        "step_2l_bf16": lambda: paged(mk, mkserv, cfg, seed=20),
        "step_2l_bf16_e4m3": lambda: paged(mk, mkserv, cfg, seed=23,
                                           kv_dtype=torch.float8_e4m3fn),
        "window4_2l_bf16": lambda: paged(mk, mkserv, cfg, seed=25,
                                         window=cs.MK_WINDOW),
        "linear_2l_bf16": lambda: linear(mk, mkserv, cfg, seed=30),
        "linear_w8_2l_bf16": lambda: linear(mk, mkserv, cfg, seed=35,
                                            fp8_weights=True),
        "moe_2l_bf16_b1": lambda: moe(mk, mkmodels, mkserv, mcfg, seed=40,
                                      batch=1),
        "moe_2l_bf16_b4": lambda: moe(mk, mkmodels, mkserv, mcfg, seed=41,
                                      batch=4),
    }
    out = {"tree": sys.argv[1] if len(sys.argv) > 1 else "."}
    for name, make in cases.items():
        ws0, parts, launcher, clone = make()
        ws = clone(ws0)
        launcher(ws)()
        torch.cuda.synchronize()
        sha = _sha(*parts(ws))
        launch = launcher(clone(ws0))
        out[name] = {"ms": [timer.ms(launch) for _ in range(3)],
                     "sha256": sha}
        del ws0, ws, launch
        torch.cuda.empty_cache()
    out["nvidia_smi"] = cs.nvidia_smi()
    out["ptxas"] = ptxas
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
