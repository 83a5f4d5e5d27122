"""Device resolution and the float32 precision policy.

The reference runs its matrix products at ``Precision.HIGHEST``
(`meteor_scatter_tpu/ops/bandpower.py:92`), i.e. in full float32.  PyTorch
on an NVIDIA GPU may instead route float32 products through TF32 (about
three decimal digits), so both switches are turned off here, once, when
the package is imported.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from meteor_scatter_tpu_torch.utils.timing import wait

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike) -> torch.device:
    """The ``torch.device`` for an explicit device argument.

    A CUDA device is required when one is asked for: there is no silent
    fallback to the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() is False"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r} (expected 'cpu' or 'cuda')")
    return dev


def constant_on(a: np.ndarray, device: DeviceLike) -> torch.Tensor:
    """The host constant ``a`` as a tensor on ``device``.  To a GPU it is a
    pageable copy, which waits for the device's queue: the profiler sees it
    as the wait span ``constant_upload``."""
    t = torch.from_numpy(a)
    with wait("constant_upload"):
        return t.to(device)
