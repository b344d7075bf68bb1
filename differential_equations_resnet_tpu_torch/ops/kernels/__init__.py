"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.  Sources live in ``csrc/`` and are built at first use (`_build`)."""
