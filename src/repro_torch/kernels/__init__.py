"""Hand-written Hopper kernels (``csrc/``), their wrappers with plain
PyTorch versions, the model-layout entry points (``ops``) and the
oracles (``ref``)."""
