"""Chart renderers, all returning base64 PNG.

Same four charts as the reference `plot.py` with the same visual
conventions: half-circle gauge of yesterday's hourly average with a
yellow→black colormap needle dial (`plot.py:97-192`), hourly dual-axis
bars for the last full day (`plot.py:198-288`, Anzahl blue / Kritisch
#C72426 on twin axes with a shared 1.05× max), 7-day and 30-day daily
sums (`plot.py:294-553`), the month chart with yellow meteor-shower
axvspans + rotated labels (`plot.py:459-510`).

matplotlib is optional: without it the renderers return a small
placeholder PNG with the computed headline value so the dashboard stays
functional.

The port's copy of `meteor_scatter_tpu/dashboard/charts.py` (the port
imports nothing of the JAX package); it touches no device.
"""

from __future__ import annotations

import base64
import datetime
import io
import threading
from typing import Callable, Dict, Optional

import numpy as np
import pandas as pd

from meteor_scatter_tpu_torch.dashboard.showers import showers_in_range
from meteor_scatter_tpu_torch.dashboard.store import LedgerStore

try:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.colors import LinearSegmentedColormap

    HAVE_MPL = True
except ImportError:  # pragma: no cover - environment without matplotlib
    HAVE_MPL = False

_render_lock = threading.Lock()  # single-flight like plot.py:31,80

KRITISCH_COLOR = "#C72426"
DPI = 300


def setup_font(font_size: int = 16) -> None:
    if HAVE_MPL:
        plt.rcParams.update({"font.size": max(12, min(64, font_size))})


def _fig_to_base64(fig) -> str:
    buf = io.BytesIO()
    fig.savefig(buf, dpi=DPI, format="png")
    plt.close(fig)
    return base64.b64encode(buf.getvalue()).decode("utf-8")


def _placeholder_png(text: str) -> str:
    """No-matplotlib fallback: a dark card with the computed headline value
    rendered via the built-in bitmap font."""
    from meteor_scatter_tpu_torch.io.png import colorize, stamp_text, upscale_to, write_png
    import tempfile, os

    img = upscale_to(colorize(np.zeros((10, 20)), cmap="gray"), 640, 320)
    stamp_text(img, text, x=24, y=img.shape[0] // 2 - 14, scale=4)
    fd, path = tempfile.mkstemp(suffix=".png")
    os.close(fd)
    write_png(path, img)
    data = open(path, "rb").read()
    os.unlink(path)
    return base64.b64encode(data).decode("utf-8")


def _load_df(storage_path: str) -> Optional[pd.DataFrame]:
    try:
        df = pd.read_csv(storage_path, sep=";")
    except Exception as e:  # noqa: BLE001
        print(f"Could not load {storage_path}: {e}")
        return None
    df["Timestamp"] = pd.to_datetime(df["Timestamp"], errors="coerce")
    return df.dropna(subset=["Timestamp"])


def _daily_summary(df: pd.DataFrame, days: int) -> pd.DataFrame:
    """Last N full days summed per day (plot.py:309-324,412-427)."""
    max_date = df["Timestamp"].dt.floor("D").max()
    start = max_date - pd.Timedelta(days=days - 1)
    sel = df[(df["Timestamp"].dt.floor("D") >= start) & (df["Timestamp"].dt.floor("D") <= max_date)].copy()
    sel["Date"] = sel["Timestamp"].dt.floor("D")
    return sel.groupby("Date").agg({"Anzahl": "sum", "Kritisch": "sum"}).reset_index()


def _dual_axis_bars(x_labels, anzahl, kritisch, xlabel, title, tick_every=1, shower_spans=None):
    fig, ax1 = plt.subplots(figsize=(10, 6))
    fig.patch.set_facecolor("lightgrey")
    fig.patch.set_alpha(0.5)
    ax1.set_facecolor("lightgrey")
    ax1.patch.set_alpha(0.5)

    max_y = max(max(anzahl), max(kritisch)) * 1.05 if len(anzahl) else 1.0
    spacing = 1.8 if shower_spans is not None else 1.0
    width = 1.2 if shower_spans is not None else 0.8
    xs = [i * spacing for i in range(len(x_labels))]

    if shower_spans:
        day_labels: Dict[object, Dict] = {}
        for span in shower_spans:
            pos = span["positions"]
            if not pos:
                continue
            x_start = xs[pos[0]] - width / 2
            x_end = xs[pos[-1]] + width / 2
            ax1.axvspan(x_start, x_end, alpha=0.3, color="yellow")
            x_center = sum(xs[i] for i in pos) / len(pos)
            key = pos[0]
            day_labels.setdefault(key, {"x": x_center, "labels": []})
            day_labels[key]["labels"].append(span["label"])
        for entry in day_labels.values():
            ax1.text(
                entry["x"],
                max_y * 0.98,
                ", ".join(entry["labels"]),
                ha="center",
                va="top",
                rotation=90,
                fontsize=10,
                color="black",
            )

    plt.xticks(xs[::tick_every], list(x_labels)[::tick_every], rotation=45)
    ax1.bar(xs, anzahl, width=width, color="blue", alpha=1, label="Anzahl")
    ax1.set_xlabel(xlabel)
    ax1.set_ylabel("Anzahl", color="blue")
    ax1.tick_params(axis="y", labelcolor="blue")
    ax1.set_ylim(0, max_y)

    ax2 = ax1.twinx()
    ax2.bar(xs, kritisch, width=width, color=KRITISCH_COLOR, alpha=1, label="Kritisch")
    ax2.set_ylabel("davon überkritisch", color=KRITISCH_COLOR)
    ax2.tick_params(axis="y", labelcolor=KRITISCH_COLOR)
    ax2.set_ylim(0, max_y)

    plt.title(title, pad=20)
    plt.tight_layout()
    return fig


def create_zeiger_chart(storage_path: str, gauge_upper: int = 100, gauge_lower: int = 0) -> str:
    """Half-dial gauge of yesterday's hourly average.

    Visual contract shared with the reference (plot.py:97-192): a 0-100
    half dial with a yellow→black severity gradient, a black needle, and
    yesterday's date in the title.  The construction is this repo's own:
    a polar axes clipped to the upper half-plane, the dial face drawn as
    one pcolormesh ring sampled from the severity colormap, value labels
    as ordinary polar x-ticks, and the needle as a single polar line.
    """
    store = LedgerStore("", storage_path)
    value = store.average_last_24h()
    if not HAVE_MPL:
        return _placeholder_png(f"avg {value}")

    lo, hi = float(gauge_lower), float(gauge_upper)
    span = max(hi - lo, 1.0)
    frac = min(max((float(value) - lo) / span, 0.0), 1.0)

    cmap = LinearSegmentedColormap.from_list(
        "severity", ["yellow", "orange", "red", "darkred", "black"]
    )

    fig = plt.figure(figsize=(10, 6))
    fig.patch.set_facecolor("lightgrey")
    fig.patch.set_alpha(0.5)
    ax = fig.add_subplot(projection="polar")
    ax.set_facecolor("none")
    ax.set_thetamin(0)  # lower bound on the left, like an analog meter
    ax.set_thetamax(180)
    ax.set_ylim(0.0, 1.0)

    # Dial face: a single mesh ring, one quad per sampled angle.
    theta_edges = np.linspace(np.pi, 0.0, 257)
    radius_edges = np.array([0.72, 1.0])
    tt, rr = np.meshgrid(theta_edges, radius_edges)
    theta_mid = 0.5 * (theta_edges[:-1] + theta_edges[1:])
    severity = ((np.pi - theta_mid) / np.pi)[None, :]
    ax.pcolormesh(tt, rr, severity, cmap=cmap, vmin=0.0, vmax=1.0, shading="flat")

    # Value labels ride the polar tick machinery.
    tick_fracs = np.linspace(0.0, 1.0, 5)
    ax.set_xticks(np.pi * (1.0 - tick_fracs))
    ax.set_xticklabels([f"{lo + f * span:.0f}" for f in tick_fracs], fontsize=14)
    ax.set_yticks([])
    ax.grid(False)
    ax.spines["polar"].set_visible(False)

    # Needle and hub.
    theta_v = np.pi * (1.0 - frac)
    ax.plot([theta_v, theta_v], [0.0, 0.62], color="black", linewidth=3,
            solid_capstyle="round", zorder=5)
    ax.scatter([0.0], [0.0], s=160, color="black", zorder=6, clip_on=False)

    datum = (datetime.datetime.now() - datetime.timedelta(days=1)).strftime("%Y-%m-%d")
    fig.subplots_adjust(top=0.72, bottom=0.08)
    ax.set_title(f"Durchschnitt pro Stunde\nvom {datum}", fontsize=16, pad=18)
    ax.text(0.5, 0.02, f"Wert: {value}", fontsize=14, ha="center",
            transform=ax.transAxes)
    return _fig_to_base64(fig)


def create_tagesverlauf_chart(storage_path: str) -> str:
    """Hourly bars for the last full day (plot.py:198-288)."""
    df = _load_df(storage_path)
    if df is None or df.empty:
        return _placeholder_png("no data") if not HAVE_MPL else "0"
    max_date = df["Timestamp"].dt.floor("D").max()
    day = df[df["Timestamp"].dt.floor("D") == max_date]
    if day.empty:
        return "0"
    if not HAVE_MPL:
        return _placeholder_png("day")
    labels = day["Timestamp"].dt.strftime("%H").tolist()
    anzeigen_datum = day["Timestamp"].dt.date.iloc[0]
    fig = _dual_axis_bars(
        labels,
        day["Anzahl"].tolist(),
        day["Kritisch"].tolist(),
        "Stunde",
        f"Stündliche Auswertung vom: {anzeigen_datum}",
        tick_every=2,
    )
    return _fig_to_base64(fig)


def create_week_chart(storage_path: str) -> str:
    """Daily sums of the last 7 days (plot.py:294-391)."""
    df = _load_df(storage_path)
    if df is None or df.empty:
        return "0"
    daily = _daily_summary(df, 7)
    if daily.empty:
        return "0"
    if not HAVE_MPL:
        return _placeholder_png("week")
    fig = _dual_axis_bars(
        daily["Date"].dt.strftime("%d").tolist(),
        daily["Anzahl"].tolist(),
        daily["Kritisch"].tolist(),
        "Tag",
        f"7 - Tage - Übersicht vom {daily['Date'].min():%Y-%m-%d} "
        f"bis {daily['Date'].max():%Y-%m-%d}",
    )
    return _fig_to_base64(fig)


def create_month_chart(storage_path: str) -> str:
    """Daily sums of the last 30 days with shower-calendar overlays
    (plot.py:397-553)."""
    df = _load_df(storage_path)
    if df is None or df.empty:
        return "0"
    daily = _daily_summary(df, 30)
    if daily.empty:
        return "0"
    if not HAVE_MPL:
        return _placeholder_png("month")

    dates = daily["Date"].dt.date.tolist()
    spans = []
    for w in showers_in_range(min(dates), max(dates)):
        positions = [i for i, d in enumerate(dates) if w.start <= d <= w.end]
        if positions:
            spans.append({"positions": positions, "label": w.label})

    fig = _dual_axis_bars(
        daily["Date"].dt.strftime("%d").tolist(),
        daily["Anzahl"].tolist(),
        daily["Kritisch"].tolist(),
        "Tag",
        f"30 - Tage - Übersicht vom {daily['Date'].min():%Y-%m-%d} "
        f"bis {daily['Date'].max():%Y-%m-%d}",
        tick_every=2,
        shower_spans=spans,
    )
    return _fig_to_base64(fig)


CHART_FUNCTIONS: Dict[str, Callable[[str], str]] = {
    "zeiger": create_zeiger_chart,
    "tagesverlauf": create_tagesverlauf_chart,
    "week": create_week_chart,
    "month": create_month_chart,
}


def generate_chart(chart_func: Callable[[str], str], storage_path: str) -> Optional[str]:
    """Single-flight wrapper (plot.py:69-90)."""
    with _render_lock:
        try:
            img = chart_func(storage_path)
            if not img or img == "0":
                return None
            return img
        except Exception as e:  # noqa: BLE001
            print(f"Error in generate_chart: {e}")
            return None
