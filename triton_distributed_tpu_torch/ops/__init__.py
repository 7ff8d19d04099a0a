"""ops of the PyTorch/CUDA port (see the package docstring).

Exports the sequence- and pipeline-parallel entry points by name, as the
reference does. ``flash_decode``, ``ring_attention`` and
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
