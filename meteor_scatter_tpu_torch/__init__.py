"""meteor_scatter_tpu_torch — the PyTorch/CUDA port of meteor_scatter_tpu.

The JAX package beside it is the reference; this package keeps its public
names, argument orders and array layouts so that one input can be fed to
both and the results compared.  It imports ``torch`` and never ``jax``.

Ported so far:

* the batch analyzer (:mod:`meteor_scatter_tpu_torch.apps.analyze`) — WAV →
  0.2 s blocks → band power (a plain ``torch.matmul``) → adaptive
  freeze-threshold detector (the CUDA kernel ``csrc/adaptive_solver.cu`` on
  a GPU, its plain PyTorch twin on the CPU) → fixed-capacity events →
  event CSV and Audacity labels;
* the streaming live detector (:mod:`meteor_scatter_tpu_torch.apps.live`)
  and its multi-station batch (:mod:`meteor_scatter_tpu_torch.models.streaming`)
  — Welch or bins-only band levels → the 3-state machine (the CUDA kernel
  ``csrc/stream_machine.cu`` on a GPU, its twin on the CPU) → events;
* the fused band power (``ops/kernels/bandpower_kernel.py``, the CUDA
  kernel ``csrc/bandpower.cu``).

Every function takes its tensors on an explicit device; nothing here keeps
a global default device.  Importing the package sets the float32 matmul
policy once (:mod:`meteor_scatter_tpu_torch.device`).
"""

__version__ = "0.1.0"

from meteor_scatter_tpu_torch.device import resolve_device  # noqa: F401
