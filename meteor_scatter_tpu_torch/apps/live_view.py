"""Live visualization for the streaming detector — the port's counterpart of
`meteor_scatter_tpu/apps/live_view.py`.

Re-creates the reference's 3×2 interactive dashboard
(`processor.py:86-141`): live PSD with band markers, two waterfall views
(full band + zoomed around the signal), absolute band-level strip
(MS/noise1/noise2), and the over-noise strip with rolling mean/std and the
effective threshold, plus detection start/stop markers and realtime-factor
pacing (`processor.py:512-534`).  Requires matplotlib with an interactive
backend; the pipeline itself never depends on it.  Each feed's
diagnostics arrive as tensors on the detector's device; :meth:`LiveView.update`
copies the six per-block series it draws to the host once a feed (hop's
scalar ``thr_degraded`` is not one of them).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from meteor_scatter_tpu_torch.config import DetectionConfig, VisualizationConfig

# the per-block series of a feed's diagnostics that the view draws
SERIES = ("over_noise", "threshold", "ms_db", "noise1_db", "noise2_db", "psd_db")


class LiveView:
    def __init__(self, cfg: DetectionConfig, vis: VisualizationConfig, fs: float, freqs):
        import matplotlib.pyplot as plt

        self.plt = plt
        self.cfg = cfg
        self.vis = vis
        self.fs = fs
        self.freqs = np.asarray(freqs)
        self.block_sec = cfg.proc_block_sec
        self.max_blocks = int(vis.max_range_sec / cfg.proc_block_sec)

        self.t: List[float] = []
        self.ms_db: List[float] = []
        self.n1_db: List[float] = []
        self.n2_db: List[float] = []
        self.over: List[float] = []
        self.thr: List[float] = []
        self.wf: List[np.ndarray] = []
        self.wf_t: List[float] = []
        self.det_marks: List[tuple] = []
        self._db_mark_artists: List = []
        self.psd_mean_from_init: Optional[float] = None

        plt.ion()
        self.fig, axes = plt.subplots(3, 2, figsize=(20, 9))
        ((self.ax_psd, self.ax_wf), (self.ax_db, self.ax_wf2), (self.ax_db2, ax_unused)) = axes
        ax_unused.axis("off")
        self.fig.suptitle("Meteor Detection Live")

        (self.line_psd,) = self.ax_psd.plot(self.freqs, np.zeros_like(self.freqs))
        self.ax_psd.set_xlabel("Frequency [Hz]")
        self.ax_psd.set_ylabel("PSD [dB]")
        self.ax_psd.set_title("Live PSD")
        for lo, hi, color in [
            (*cfg.signal_band, "r"),
            (*cfg.noise_band_1, "grey"),
            (*cfg.noise_band_2, "brown"),
        ]:
            self.ax_psd.axvline(lo, color=color, linestyle="--")
            self.ax_psd.axvline(hi, color=color, linestyle="--")

        (self.l_ms,) = self.ax_db.plot([], [], label="MS (dB)", color="r")
        (self.l_n1,) = self.ax_db.plot([], [], label="Noise 1 (dB)", color="grey")
        (self.l_n2,) = self.ax_db.plot([], [], label="Noise 2 (dB)", color="brown")
        self.ax_db.set_title(f"Band levels, last {vis.max_range_sec}s")
        self.ax_db.legend()

        (self.l_over,) = self.ax_db2.plot([], [], label="over-noise (dB)", color="b")
        (self.l_thr,) = self.ax_db2.plot([], [], label="threshold (dB)", color="r")
        self.ax_db2.set_title("Over-noise level + threshold")
        self.ax_db2.legend()
        plt.tight_layout()
        plt.show(block=False)

    def update(self, diags: dict, block_offset: int, events: List[dict]) -> None:
        """Feed one processed chunk's diagnostics (stream_process output)."""
        host = {k: diags[k].cpu().numpy() for k in SERIES}
        n = len(host["over_noise"])
        ts = [(block_offset + i + 1) * self.block_sec for i in range(n)]
        self.t += ts
        self.ms_db += list(host["ms_db"])
        self.n1_db += list(host["noise1_db"])
        self.n2_db += list(host["noise2_db"])
        self.over += list(host["over_noise"])
        self.thr += list(host["threshold"])
        psd_db = host["psd_db"]
        for i in range(n):
            self.wf.append(psd_db[i])
            self.wf_t.append(ts[i])
        for ev in events:
            self.det_marks.append((ev["time_start"], ev["time_stop"]))

        # bound memory to the display window
        keep = self.max_blocks
        for name in ("t", "ms_db", "n1_db", "n2_db", "over", "thr", "wf", "wf_t"):
            setattr(self, name, getattr(self, name)[-keep:])
        # detection marks left of the window can never be drawn again —
        # trim like every other series, or a long run grows without bound
        win0 = self.t[0]
        self.det_marks = [(a, b) for a, b in self.det_marks if b >= win0]

        self.line_psd.set_ydata(psd_db[-1])
        self.ax_psd.relim()
        self.ax_psd.autoscale_view()

        vmin = vmax = None
        if self.psd_mean_from_init is not None:
            vmin = self.psd_mean_from_init - self.vis.wf_offset_vmin
            vmax = self.psd_mean_from_init + self.vis.wf_offset_vmax

        for ax, ylim in (
            (self.ax_wf, (self.freqs[0], self.freqs[-1])),
            (
                self.ax_wf2,
                (
                    self.cfg.signal_freq - self.vis.limit_freq_offset_wf2_and_export,
                    self.cfg.signal_freq + self.vis.limit_freq_offset_wf2_and_export,
                ),
            ),
        ):
            ax.clear()
            ax.imshow(
                np.asarray(self.wf).T,
                aspect="auto",
                cmap="viridis",
                origin="lower",
                extent=[self.wf_t[0], self.wf_t[-1], self.freqs[0], self.freqs[-1]],
                vmin=vmin,
                vmax=vmax,
            )
            ax.set_ylim(*ylim)
            ax.set_xlabel("Time [s]")
            ax.set_ylabel("Frequency [Hz]")
            for t0, t1 in self.det_marks:
                if self.wf_t[0] <= t0 <= self.wf_t[-1]:
                    ax.axvline(t0, color="r", linestyle="--")
                if self.wf_t[0] <= t1 <= self.wf_t[-1]:
                    ax.axvline(t1, color="g", linestyle="--")

        self.l_ms.set_data(self.t, self.ms_db)
        self.l_n1.set_data(self.t, self.n1_db)
        self.l_n2.set_data(self.t, self.n2_db)
        self.ax_db.relim()
        self.ax_db.autoscale_view()
        self.l_over.set_data(self.t, self.over)
        self.l_thr.set_data(self.t, self.thr)
        self.ax_db2.relim()
        self.ax_db2.autoscale_view()
        # ax_db is never cleared (its series lines update in place), so the
        # previous update's mark artists must be removed before re-adding —
        # appending every update leaks ~2·marks Line2Ds per frame
        for art in self._db_mark_artists:
            art.remove()
        self._db_mark_artists = []
        for t0, t1 in self.det_marks:
            self._db_mark_artists.append(
                self.ax_db.axvline(t0, color="r", linestyle="--")
            )
            self._db_mark_artists.append(
                self.ax_db.axvline(t1, color="g", linestyle="--")
            )

        self.fig.suptitle(f"Meteor Detection Live {self.t[-1]:.1f}s")
        if self.vis.flag_realtime_animation:
            self.plt.pause(
                max(len(ts) * self.block_sec / self.vis.realtime_factor, 1e-3)
            )
        else:
            self.plt.pause(1e-3)

    def finish(self) -> None:
        self.plt.ioff()
        self.plt.show()
