"""Benchmark of the PyTorch and CUDA port on NVIDIA GPUs; see run.py."""
