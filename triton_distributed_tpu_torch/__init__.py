"""PyTorch/CUDA port of ``triton_distributed_tpu`` for one NVIDIA H100.

The JAX package beside this one is the reference: every module here has a
counterpart of the same name there (``models/``, ``layers/``, ``ops/``,
``serving/``, ``runtime/``), and the tests hold the two against each other.
This package imports torch and numpy only — never jax, and nothing of the
JAX package.

Entry points (:class:`~.models.engine.Engine`,
:class:`~.serving.loop.ServingEngine`, :func:`~.models.dense.init_dense_llm`,
the caches', the megakernel decoders' and their workspaces' constructors)
run on the card
by default (``device=None`` means ``"cuda"``) and raise when CUDA is
absent; the CPU runs only when the caller passes ``device="cpu"``. The
kernels (``csrc/*.cu``: flash prefill, paged decode, the megakernel) are
built with ``nvcc`` at first use (``runtime/build.py``); on CPU tensors
their wrappers take the plain PyTorch version of the same function.
"""

__version__ = "0.1.0"
