"""Numerics of the port: windows, framing, band power, and the hand-written
GPU kernels under :mod:`meteor_scatter_tpu_torch.ops.kernels`."""
