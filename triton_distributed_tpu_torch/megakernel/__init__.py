"""The persistent megakernel: a whole decode step as one task queue,
interpreted by one CUDA launch (``csrc/megakernel.cu``) — the port of the
JAX package's ``megakernel/`` for its paged serving lane and its linear
(sequential, batch-1) decoder, on one rank."""
