"""PyTorch/CUDA port of the MetaFed reproduction.

The JAX package ``repro`` is the reference; this package re-implements its
synchronous federated round, its gossip strategy and the serving path of
its LLM zoo (dense, vlm and audio families) in PyTorch, with the Pallas
kernels rewritten by hand in CUDA C++ for Hopper (``repro_torch.kernels``).
It imports neither ``jax`` nor anything of ``repro``.
"""
