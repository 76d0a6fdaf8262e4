"""Hand-written CUDA kernels for Hopper (``csrc/``), their wrappers and
plain PyTorch versions, and the dispatch the model calls (``ops``)."""
