"""PyTorch/CUDA port of the MetaFed reproduction.

The JAX package ``repro`` is the reference; this package re-implements its
synchronous federated round in PyTorch, with the Pallas aggregation kernels
rewritten by hand in CUDA C++ for Hopper (``repro_torch.kernels``).  It
imports neither ``jax`` nor anything of ``repro``.
"""
