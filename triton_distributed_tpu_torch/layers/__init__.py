"""layers of the PyTorch/CUDA port (see the package docstring).

Exports the sequence- and pipeline-parallel layers by name, as the
reference does."""

from triton_distributed_tpu_torch.layers.decode_layers import (  # noqa: F401
    GemmARLayer,
    SpFlashDecodeAttention,
)
from triton_distributed_tpu_torch.layers.pp import (  # noqa: F401
    CommOp,
    PPStream,
    pp_pipeline_forward,
    pp_pipeline_interleaved,
)
