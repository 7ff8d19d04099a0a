"""Decode comm layers — stateful wrappers for the per-step collectives;
counterpart of the JAX package's ``layers/decode_layers.py``.

The reference's staged symmetric buffers are the persistent parity
workspaces of the ``*_stream`` collectives (``ops/allgather.py``,
``ops/allreduce.py``): a layer makes its (workspace, call_index) state
once and threads it across steps, so steady-state decode meets no
barrier. Each call returns the layer's next state. Call them inside
``DistContext.run``, one state a rank.
"""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.ops.allgather import ag_stream_workspace
from triton_distributed_tpu_torch.ops.allreduce import (
    AllReduceMethod, all_reduce_local, all_reduce_stream,
    ar_stream_workspace,
)
from triton_distributed_tpu_torch.ops.flash_decode import flash_decode_local
from triton_distributed_tpu_torch.runtime.context import DistContext


class SpFlashDecodeAttention:
    """SP/CP decode attention over a sequence-sharded KV cache (reference
    ``SpGQAFlashDecodeAttention``): each rank attends its KV shard (K2's
    split-KV partials), the (acc, m, l) partials ride the barrier-free
    parity AllGather, and the combine is the inter-rank LSE merge."""

    def __init__(self, *, axis: str = "tp", num_ranks: int):
        self.axis = axis
        self.n = num_ranks

    def init_state(self, batch: int, hq: int, d: int, *,
                   ctx: DistContext | None = None,
                   tag: str = "sp_flash_decode"):
        """The persistent parity-AG workspace for the (B·hq, d + 2)
        partials — always fp32, whatever the model's type — and its next
        call index. Give each stream of calls its own ``tag``."""
        return ag_stream_workspace(self.n, batch * hq, d + 2, torch.float32,
                                   ctx=ctx, tag=tag)

    def __call__(self, q: torch.Tensor, k_shard: torch.Tensor,
                 v_shard: torch.Tensor, kv_len, state):
        """q: (B, hq, d); k/v_shard: (B, S/n, hkv, d); kv_len: valid rows
        in this shard. Returns (out (B, hq, d), state')."""
        return flash_decode_local(q, k_shard, v_shard, kv_len,
                                  axis=self.axis, num_ranks=self.n,
                                  ag_state=state)


class GemmARLayer:
    """Row-parallel projection + AllReduce for decode steps (reference
    ``GemmARLayer``): y = x @ W (``torch.matmul``, as the reference's
    ``jnp.dot``), then with a state (from :meth:`init_state`) the
    barrier-free parity stream, without one ``all_reduce_local``."""

    def __init__(self, *, axis: str = "tp", num_ranks: int,
                 method: AllReduceMethod | str = AllReduceMethod.AUTO):
        self.axis = axis
        self.n = num_ranks
        self.method = method

    def init_state(self, m: int, cols: int, dtype=torch.float32, *,
                   ctx: DistContext | None = None, tag: str = "gemm_ar"):
        return ar_stream_workspace(self.n, m, cols, dtype, ctx=ctx,
                                   tag=tag)

    def __call__(self, x: torch.Tensor, w: torch.Tensor, state=None):
        """x: (m, k_local); w: (k_local, cols). Returns the reduced
        (m, cols) — and (out, state') when a stream state is given."""
        partial = torch.matmul(x, w)
        if self.n == 1:
            return (partial, state) if state is not None else partial
        if state is not None:
            ws, idx = state
            out, ws, idx = all_reduce_stream(partial, ws, idx, axis=self.axis,
                                             num_ranks=self.n)
            return out, (ws, idx)
        return all_reduce_local(partial, axis=self.axis, num_ranks=self.n,
                                method=self.method)
