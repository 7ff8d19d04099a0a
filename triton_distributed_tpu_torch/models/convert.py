"""Parameter conversion from the JAX package's pytree.

:func:`params_from_numpy` turns the JAX package's parameter tree (dicts
and lists whose leaves are numpy arrays — or anything ``np.asarray``
accepts, such as JAX arrays) into the port's parameter dict. Weights keep
the JAX ``(in, out)`` layout, so ``x @ w`` computes the same product on
both sides and nothing is transposed.

bf16 leaves arrive as ``ml_dtypes.bfloat16`` arrays, which
``torch.from_numpy`` rejects; they cross bit-exactly through a ``uint16``
view reinterpreted as ``torch.bfloat16``.

:func:`shard_params` carries a parameter dict onto a TP group's ranks per
``models/dense.dense_llm_specs``: column-parallel q/k/v/gate/up split on
the output dimension, row-parallel o/down on the input dimension,
``lm_head`` by vocabulary, the embedding and norms replicated, a MoE
layer's expert stacks on their ffn dim.
"""

from __future__ import annotations

import numpy as np
import torch

from triton_distributed_tpu_torch.models.config import ModelConfig
from triton_distributed_tpu_torch.runtime.context import DistContext, P
from triton_distributed_tpu_torch.runtime.device import (
    resolve_device, torch_dtype,
)


def array_to_tensor(a) -> torch.Tensor:
    """One numpy leaf → a CPU tensor with the same bits."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_numpy(tree, cfg: ModelConfig, *, device=None, dtype=None):
    """Convert a JAX parameter tree into the port's parameters on
    ``device`` (``None`` = the card). ``dtype`` casts floating leaves
    (default: the config's dtype)."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype or cfg.dtype)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        t = array_to_tensor(node)
        if t.is_floating_point():
            t = t.to(dt)
        return t.to(dev)

    return conv(tree)


def shard_tree(tree, specs, ctx: DistContext, *, consume: bool = False
               ) -> list:
    """Split ``tree`` (dicts / lists of tensors or numpy leaves) per the
    matching tree of :class:`~runtime.context.P` specs into one tree per
    rank, rank r's leaves on ``ctx.devices[r]``. A sharded dim is cut
    into n equal contiguous pieces (it must divide); a replicated leaf is
    moved as it is — ranks that share a device (virtual ranks on one
    card) share one copy, which nothing writes. The tree is walked leaf
    by leaf; ``consume=True`` drops each leaf from ``tree`` once its
    shards exist, so a tree as large as the card (Qwen3-30B-A3B's 61 GB
    on one H100) is never held twice: ``tree`` ends empty."""
    n = ctx.num_ranks

    def leaf(t, spec, r):
        if not isinstance(t, torch.Tensor):
            t = array_to_tensor(t)
        dims = [d for d, ax in enumerate(spec) if ax is not None]
        if not dims:
            return t.to(ctx.devices[r])
        if len(dims) > 1:
            raise ValueError(f"spec {spec!r}: the port shards one dim")
        d = dims[0]
        # The dim's axis: one of the group's, or a tuple of them (a
        # two-tier group's joint (inter, tp) sharding); the ranks that
        # differ only off it hold the same piece.
        ax = spec[d]
        k = ctx.axis_size(ax)
        if t.shape[d] % k:
            raise ValueError(f"dim {d} of {tuple(t.shape)} not divisible "
                             f"by TP degree {k}")
        step = t.shape[d] // k
        i = ctx.axis_index(r, ax)
        # A copy, never a view: the shard must not keep the whole
        # parameter alive.
        return t.narrow(d, i * step, step).to(ctx.devices[r], copy=True,
                                              memory_format=torch.contiguous_format)

    def walk(node, spec) -> list:
        if isinstance(spec, P):
            return [leaf(node, spec, r) for r in range(n)]
        if isinstance(node, dict):
            if set(node) != set(spec):
                raise ValueError(f"parameter keys {sorted(node)} do not "
                                 f"match the specs' {sorted(spec)}")
            out = [{} for _ in range(n)]
            for k in list(node):
                for r, part in enumerate(walk(node[k], spec[k])):
                    out[r][k] = part
                if consume:
                    del node[k]
            return out
        if isinstance(node, (list, tuple)):
            if len(node) != len(spec):
                raise ValueError(f"{len(node)} entries, specs have "
                                 f"{len(spec)}")
            out = [[] for _ in range(n)]
            for i, sub in enumerate(spec):
                for r, part in enumerate(walk(node[i], sub)):
                    out[r].append(part)
                if consume and isinstance(node, list):
                    node[i] = None
            if consume and isinstance(node, list):
                node.clear()
            return out
        raise TypeError(f"unexpected parameter node {type(node)}")

    return walk(tree, specs)


def shard_params(params, ctx: DistContext, cfg: ModelConfig, *,
                 axis: str = "tp", consume: bool = False) -> list:
    """One parameter dict per rank of ``ctx`` per ``dense_llm_specs(cfg,
    axis)``: a MoE layer's experts sharded on their ffn dim, its router
    replicated; ``axis`` a name, or a tuple — the joint (inter, tp)
    sharding of a two-tier group. ``params``: the port's dict (from ``init_dense_llm`` or
    :func:`params_from_numpy`) or the JAX package's numpy tree;
    ``consume``: empty it leaf by leaf as the shards are made
    (:func:`shard_tree`)."""
    from triton_distributed_tpu_torch.models.dense import dense_llm_specs

    if cfg.num_kv_heads % ctx.axis_size(axis):
        raise ValueError(f"num_kv_heads {cfg.num_kv_heads} not divisible by "
                         f"TP degree {ctx.axis_size(axis)}")
    return shard_tree(params, dense_llm_specs(cfg, axis), ctx,
                      consume=consume)
