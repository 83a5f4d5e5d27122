"""meteor_scatter_tpu_torch — the PyTorch/CUDA port of meteor_scatter_tpu.

The JAX package beside it is the reference; this package keeps its public
names, argument orders and array layouts so that one input can be fed to
both and the results compared.  It imports ``torch`` and never ``jax``.

Slice ported so far: the batch analyzer
(:mod:`meteor_scatter_tpu_torch.apps.analyze`) — WAV → 0.2 s blocks →
band power (a plain ``torch.matmul``) → adaptive freeze-threshold detector
(the hand-written CUDA kernel ``csrc/adaptive_solver.cu`` on a GPU, its
plain PyTorch twin on the CPU) → fixed-capacity events → event CSV and
Audacity labels.

Every function takes its tensors on an explicit device; nothing here keeps
a global default device.  Importing the package sets the float32 matmul
policy once (:mod:`meteor_scatter_tpu_torch.device`).
"""

__version__ = "0.1.0"

from meteor_scatter_tpu_torch.device import resolve_device  # noqa: F401
