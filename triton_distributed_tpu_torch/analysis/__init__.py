"""Static analysis of the port's megakernel task queues.

:mod:`~triton_distributed_tpu_torch.analysis.mklint` verifies a compiled
queue against the builder's hazard metadata and a host-rewritten paged
step against the slot state it encodes (CLI: ``python -m
triton_distributed_tpu_torch.analysis.mklint --all``). Its reports use the
:class:`~triton_distributed_tpu_torch.analysis.checker.Violation` shape
of the JAX package's comm-lint. Import mklint from its own module, so
``python -m`` does not import it twice.
"""

from triton_distributed_tpu_torch.analysis.checker import (  # noqa: F401
    Report, Violation,
)
