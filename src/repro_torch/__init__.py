"""PyTorch/CUDA port of the ``repro`` package for NVIDIA Hopper.

Modules mirror ``repro``'s paths (``repro/serve/engine.py`` ->
``repro_torch/serve/engine.py``).  The package imports torch and numpy
only; it never imports jax or anything of ``repro``.
"""
