"""Continuous-batching serving tier of the port (synchronous loop)."""

from triton_distributed_tpu_torch.serving.loop import (  # noqa: F401
    ServingConfigError, ServingEngine,
)
from triton_distributed_tpu_torch.serving.request import (  # noqa: F401
    Request, RequestState,
)
from triton_distributed_tpu_torch.serving.scheduler import (  # noqa: F401
    AdmitResult, RequestTooLargeError, Scheduler,
)
from triton_distributed_tpu_torch.serving.spec import (  # noqa: F401
    NGramProposer, SpecConfigError,
)
