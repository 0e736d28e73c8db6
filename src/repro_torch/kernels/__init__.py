"""CUDA kernels, their plain PyTorch versions, and the ``ops`` dispatch."""
