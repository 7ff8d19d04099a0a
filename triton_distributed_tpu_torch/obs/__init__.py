"""Observability of the port.

So far one tier of the JAX package's ``obs``:
:mod:`~triton_distributed_tpu_torch.obs.kernel_profile`, the per-task
megakernel timeline decoded from ``CompiledMegaKernel.step(profile=True)``
dumps. The span tracer, the metrics registry and the run directory that
turn profiling on automatically come with the serving loop's
observability.
"""
