"""Hand-written CUDA kernels (sources in ``csrc/``), each beside its plain
PyTorch twin, and the build that compiles them at first use."""
