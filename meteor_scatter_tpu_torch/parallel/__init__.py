"""Multi-device execution: device meshes, halo exchange, sharded pipelines.

Counterpart of `meteor_scatter_tpu/parallel/`.  The reference is one
sequential CPU process; the scaling model follows BASELINE configs 3-5:

* ``station`` mesh axis: beacon channels / stations, embarrassingly data
  parallel;
* ``time`` mesh axis: one long stream split into contiguous sample
  ranges; STFT overlap and FIR warm-up tails cross shard seams and are
  exchanged as halos (:mod:`~meteor_scatter_tpu_torch.parallel.halo`);
* detections are reduced per shard and merged at seams, so the sharded
  event list equals the unsharded one.

One process drives a grid of devices (:mod:`~meteor_scatter_tpu_torch.parallel.mesh`),
which may repeat a device: a virtual mesh on one card or on the CPU.
Under a process group the grid spans processes, each holding its own
positions; :mod:`~meteor_scatter_tpu_torch.parallel.distributed` holds the
multi-process runtime on ``torch.distributed`` and the transport between
processes (NCCL, gloo, or gloo staged through the host).
"""

from meteor_scatter_tpu_torch.parallel.distributed import (  # noqa: F401
    init_multihost,
    process_count,
    process_device,
    process_index,
    row_group,
    transport_for,
)
from meteor_scatter_tpu_torch.parallel.mesh import make_mesh, station_time_specs  # noqa: F401
from meteor_scatter_tpu_torch.parallel.halo import (  # noqa: F401
    halo_exchange,
    time_all_gather,
    time_psum,
)
from meteor_scatter_tpu_torch.parallel.sharded import (  # noqa: F401
    sharded_channelize_iq,
    sharded_channelize_iq_frames,
    sharded_delta_power,
    sharded_detect_adaptive,
    sharded_detect_adaptive_exact,
    sharded_detect_fixed,
    sharded_fir_filter,
    sharded_spectrogram_psd,
    sharded_stream_process,
    sharded_welch_blocks,
)
