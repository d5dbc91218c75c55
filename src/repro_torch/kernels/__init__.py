"""Kernels of the port: the CUDA megakernels (``csrc/``), their ctypes
bindings, the plain PyTorch version of each, and the ``ops`` dispatch."""
