"""Detector model families, as in the reference's ``models`` package:

* :mod:`fixed`      — global mean+σ threshold
* :mod:`adaptive`   — rolling window + freeze
* :mod:`streaming`  — 3-state machine
* :mod:`image`      — spectrogram cluster path

and the fixed-capacity event buffers they fill (:mod:`events`).
"""

from meteor_scatter_tpu_torch.models.events import (  # noqa: F401
    Events,
    events_from_mask,
    events_from_run_sums,
    merge_adjacent,
)
from meteor_scatter_tpu_torch.models.fixed import detect_fixed  # noqa: F401
from meteor_scatter_tpu_torch.models.adaptive import adaptive_thresholds, detect_adaptive  # noqa: F401
from meteor_scatter_tpu_torch.models.image import (  # noqa: F401
    cluster_bursts,
    corner_keypoints,
    detect_and_cluster_bursts,
    spectrogram_image,
)
from meteor_scatter_tpu_torch.models.streaming import (  # noqa: F401
    StreamConfig,
    StreamState,
    stream_init,
    stream_process,
)
