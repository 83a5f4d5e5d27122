"""Host-side utilities of the port."""

from meteor_scatter_tpu_torch.utils.timing import PhaseTimer, Throughput  # noqa: F401
