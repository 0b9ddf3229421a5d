"""Hand-written Hopper kernels (``csrc/``), their plain versions (``ref``)
and the wrappers that route between them (``ops``)."""
