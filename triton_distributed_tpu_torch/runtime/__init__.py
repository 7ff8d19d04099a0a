"""Device resolution and the CUDA kernel build for the port."""

from triton_distributed_tpu_torch.runtime.device import (  # noqa: F401
    resolve_device, torch_dtype,
)
