"""Logging setup, the port's copy of `meteor_scatter_tpu/utils/logging.py`
— equivalent of the reference's global config (`config.py:66-78`): file +
console handlers, overwrite mode."""

from __future__ import annotations

import logging
import sys


def setup_logging(
    log_file: str = "app.log",
    level: int = logging.INFO,
    mode: str = "w",
    console: bool = True,
) -> logging.Logger:
    root = logging.getLogger()
    root.setLevel(level)
    for h in list(root.handlers):
        root.removeHandler(h)
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
    fh = logging.FileHandler(log_file, mode=mode)
    fh.setFormatter(fmt)
    root.addHandler(fh)
    if console:
        ch = logging.StreamHandler(sys.stdout)
        ch.setFormatter(fmt)
        root.addHandler(ch)
    return root
