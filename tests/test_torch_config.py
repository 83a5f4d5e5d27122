"""The port's configuration tree against the JAX package's, on the CPU.

Both ``config.py`` files are pure stdlib; the port keeps its own copy.  The
INI text of ``to_ini`` must be equal for the defaults and for seeded values
of every field, and ``from_ini`` of either package's text must give the
same tree in both (``dataclasses.asdict``, exact).  No tolerance: the
values round-trip through ``str`` / ``float`` exactly.
"""

import dataclasses
import os

import numpy as np
import pytest

import meteor_scatter_tpu as jpkg
import meteor_scatter_tpu_torch as tpkg
from meteor_scatter_tpu import config as jcfg
from meteor_scatter_tpu_torch import config as tcfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SECTIONS = list(jcfg._SECTIONS)


def seeded_value(cur, rng):
    """A value of ``cur``'s type that differs from it."""
    if isinstance(cur, bool):
        return not cur
    if isinstance(cur, int):
        return int(rng.integers(1, 100_000)) + cur
    if isinstance(cur, float):
        return float(rng.standard_normal() * 1e3)
    if isinstance(cur, tuple):
        return tuple(float(v) for v in np.round(rng.uniform(0.0, 3000.0, len(cur)), 3))
    return f"{cur}_{int(rng.integers(0, 1000))}"


def seeded_pair(section, seed):
    """The same seeded change to every field of one section, as each
    package's ``FrameworkConfig`` (a ``[bandpower]`` section is also
    ``analyze.band``, as ``from_ini`` reads it)."""
    rng = np.random.default_rng(seed)
    defaults = getattr(jcfg.FrameworkConfig(), section)
    values = {f.name: seeded_value(getattr(defaults, f.name), rng)
              for f in dataclasses.fields(defaults)
              if not dataclasses.is_dataclass(getattr(defaults, f.name))}
    pair = []
    for mod in (jcfg, tcfg):
        sub = mod._SECTIONS[section](**values)
        extra = {"analyze": mod.AnalyzeConfig(band=sub)} if section == "bandpower" else {}
        pair.append(mod.FrameworkConfig(**{section: sub}, **extra))
    return pair


def test_same_tree_and_exports():
    assert list(tcfg._SECTIONS) == SECTIONS
    for section, cls in jcfg._SECTIONS.items():
        tcls = tcfg._SECTIONS[section]
        assert tcls.__name__ == cls.__name__
        assert [(f.name, f.type) for f in dataclasses.fields(tcls)] == [
            (f.name, f.type) for f in dataclasses.fields(cls)]
        assert dataclasses.asdict(tcls()) == dataclasses.asdict(cls())
    names = ("AnalyzeConfig", "BandPowerConfig", "DetectionConfig", "ShardingConfig",
             "SpecExportConfig", "VisualizationConfig")
    for name in names:
        assert getattr(tpkg, name) is getattr(tcfg, name)
        assert getattr(jpkg, name).__name__ == name
    assert tcfg.BandPowerConfig().block_size == jcfg.BandPowerConfig().block_size == 1200
    d_t, d_j = tcfg.DetectionConfig(), jcfg.DetectionConfig()
    for band in ("signal_band", "noise_band_1", "noise_band_2"):
        assert getattr(d_t, band) == getattr(d_j, band)


def test_defaults_ini_equal():
    text = tcfg.to_ini(tcfg.FrameworkConfig())
    assert text == jcfg.to_ini(jcfg.FrameworkConfig())
    assert dataclasses.asdict(tcfg.from_ini(text)) == dataclasses.asdict(tcfg.FrameworkConfig())


@pytest.mark.parametrize("section", SECTIONS)
def test_seeded_fields_round_trip(section):
    j, t = seeded_pair(section, seed=SECTIONS.index(section))
    text = tcfg.to_ini(t)
    assert text == jcfg.to_ini(j)
    assert text != tcfg.to_ini(tcfg.FrameworkConfig())
    want = dataclasses.asdict(j)
    for mod in (tcfg, jcfg):
        assert dataclasses.asdict(mod.from_ini(text)) == want


def test_from_ini_partial_and_coerce():
    text = "[detection]\nn_fft = 2048.0\nsignal_freq = 1020\n[visualization]\nenable_ui_plots = yes\n"
    assert dataclasses.asdict(tcfg.from_ini(text)) == dataclasses.asdict(jcfg.from_ini(text))
    got = tcfg.from_ini(text)
    assert got.detection.n_fft == 2048 and got.detection.signal_freq == 1020.0
    assert got.visualization.enable_ui_plots is True
    for value, target in (("(1, 2.5)", (0.0, 0.0)), ("off", True), ("7.9", 0), ("x", "")):
        assert tcfg._coerce(value, target) == jcfg._coerce(value, target)


def test_example_ini_and_save_load(tmp_path):
    path = os.path.join(ROOT, "config.example.ini")
    got = dataclasses.asdict(tcfg.load_config(path))
    assert got == dataclasses.asdict(jcfg.load_config(path))
    _, t = seeded_pair("monitor", seed=99)
    tcfg.save_config(t, str(tmp_path / "t.ini"))
    assert dataclasses.asdict(jcfg.load_config(str(tmp_path / "t.ini"))) == dataclasses.asdict(t)
