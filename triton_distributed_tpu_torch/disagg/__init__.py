"""Disaggregated serving's KV migration — counterpart of the JAX
package's ``disagg/``, as far as it is ported:
:mod:`~triton_distributed_tpu_torch.disagg.migrate` (the transport:
:class:`MigrationStream` and :func:`kv_migrate_local` over kernel B13).
The role-split serving tier (``disagg/engine.py``: ``DisaggServingEngine``,
``split_roles``, ``role_contexts``) is not ported yet.
"""

from triton_distributed_tpu_torch.disagg.migrate import (  # noqa: F401
    MigrationError, MigrationIntegrityError, MigrationStream,
    MigrationTimeoutError, kv_migrate_local, migrate_timeout_s,
)

__all__ = [
    "MigrationError", "MigrationIntegrityError", "MigrationStream",
    "MigrationTimeoutError", "kv_migrate_local", "migrate_timeout_s",
]
