"""Hand-written CUDA kernels of the port (sources in ``csrc/``), their
plain PyTorch versions, and the build that compiles them at first use."""
