"""ops of the PyTorch/CUDA port (see the package docstring).

Exports the sequence- and pipeline-parallel entry points and the two-tier
collectives (``two_level``, ``hierarchical``, ``multi_axis``) by name, as
the reference does. ``flash_decode``, ``ring_attention`` and
``sp_ag_attention`` are functions named as their modules: import them
from those modules, so that ``ops.<name>`` stays the module."""

from triton_distributed_tpu_torch.ops.allgather import (  # noqa: F401
    ag_stream_workspace,
    all_gather_stream,
)
from triton_distributed_tpu_torch.ops.p2p import (  # noqa: F401
    p2p_permute,
    p2p_permute_local,
    p2p_shift,
    p2p_shift_local,
)
from triton_distributed_tpu_torch.ops.ring_attention import (  # noqa: F401
    ring_attention_local,
)
from triton_distributed_tpu_torch.ops.sp_ag_attention import (  # noqa: F401
    sp_ag_attention_local,
)
from triton_distributed_tpu_torch.ops.ulysses import (  # noqa: F401
    ulysses_attention,
    ulysses_attention_local,
)
from triton_distributed_tpu_torch.ops.flash_decode import (  # noqa: F401
    combine_partials,
    flash_decode_local,
)
from triton_distributed_tpu_torch.ops.low_latency_allgather import (  # noqa
    AllGatherLayer,
    fast_allgather,
    fast_allgather_local,
)
from triton_distributed_tpu_torch.ops.two_level import (  # noqa: F401
    all_gather_2d,
    all_reduce_2d,
    reduce_scatter_2d,
)
from triton_distributed_tpu_torch.ops.hierarchical import (  # noqa: F401
    ag_gemm_2d,
    ag_gemm_2d_local,
    gemm_rs_2d,
    gemm_rs_2d_local,
    sp_ag_attention_2d,
    sp_ag_attention_2d_local,
)
from triton_distributed_tpu_torch.ops.multi_axis import (  # noqa: F401
    all_gather_torus,
    all_gather_torus_local,
    all_reduce_torus,
    all_reduce_torus_local,
    reduce_scatter_torus,
    reduce_scatter_torus_local,
)
