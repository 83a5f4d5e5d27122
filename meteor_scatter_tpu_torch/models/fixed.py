"""Fixed global-threshold detector.

Counterpart of `meteor_scatter_tpu/models/fixed.py` (reference:
`dsp/src/main.py:396-448`): threshold = mean(delta) + k·std(delta) over the
whole series (population std), runs of above-threshold blocks become
detections.

Reference edge-case semantics preserved exactly:

* a run that reaches the end of the series gets stop index ``n-1``
  (`main.py:414-415` appends ``len(delta)-1``, not ``len(delta)``), so its
  final block is excluded from the dB mean and the duration;
* otherwise stop is the first below-threshold index after the run
  (exclusive), and the dB mean runs over ``delta[start:stop]``;
* under overflow the end-touching run was dropped, so the patch is skipped.
"""

from __future__ import annotations

from typing import Tuple

import torch

from meteor_scatter_tpu_torch.models.events import Events, events_from_mask, set_at


def detect_fixed(
    delta: torch.Tensor,
    threshold_std_factor: float,
    cap: int = 4096,
) -> Tuple[Events, torch.Tensor]:
    """Returns (events, threshold).  Event indices are block indices; convert
    to seconds by multiplying with block_duration_sec (`main.py:425-426`)."""
    dt = delta.dtype
    threshold = delta.mean() + threshold_std_factor * delta.std(correction=0)
    above = delta > threshold

    ev = events_from_mask(above, delta, cap)

    # Reference end-of-series semantics: if the last block is above
    # threshold, its run is reported with stop = n-1 (exclusive) and the
    # dB mean recomputed over [start, n-1).
    n = delta.shape[0]
    last = torch.clamp(ev.count - 1, min=0).long()
    # under overflow the end-touching run (the highest run id) was dropped
    # by events_from_mask, so slot count-1 holds an unrelated earlier event
    # — patching it would corrupt its stop/mean
    ends_open = (ev.count > 0) & above[-1] & ~ev.overflow
    open_stop = torch.tensor(n - 1, dtype=torch.int32, device=delta.device)
    length = torch.clamp(open_stop - ev.start[last], min=0)
    # re-mean over the truncated range: remove the final block's value
    full_len = ev.stop[last] - ev.start[last]
    sum_trunc = ev.db_mean[last] * full_len.to(dt) - delta[-1]
    mean_trunc = torch.where(length > 0, sum_trunc / length.clamp(min=1).to(dt), torch.nan)

    new_stop = torch.where(ends_open, set_at(ev.stop, last, open_stop), ev.stop)
    new_mean = torch.where(ends_open, set_at(ev.db_mean, last, mean_trunc), ev.db_mean)

    return Events(ev.start, new_stop, new_mean, ev.count, ev.overflow), threshold
