"""Kernels of the port: hand-written CUDA sources in ``csrc/``, built by
``ops.build`` and wrapped beside their plain PyTorch versions."""
