"""The port's monitor supervisor, ``meteor_scatter_tpu_torch/apps/watchdog.sh``,
with a stand-in ``python`` on ``PATH`` that prints its arguments and exits
at once: the watchdog logs each launch and exit, restarts after 3 s, and
passes its arguments on to the port's monitor."""

import datetime
import os
import re
import signal
import subprocess
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WATCHDOG = os.path.join(REPO, "meteor_scatter_tpu_torch", "apps", "watchdog.sh")
STAMP = r"(\d{4}-\d\d-\d\dT\d\d:\d\d:\d\d[+-]\d\d:\d\d)"


@pytest.fixture
def fake_python(tmp_path):
    shim = tmp_path / "bin"
    shim.mkdir()
    exe = shim / "python"
    exe.write_text('#!/bin/sh\necho "monitor args: $*"\nexit 3\n')
    exe.chmod(0o755)
    return shim


def test_watchdog_restarts_the_port_monitor(tmp_path, fake_python):
    env = {**os.environ, "PATH": f"{fake_python}{os.pathsep}{os.environ['PATH']}"}
    log = tmp_path / "log.txt"
    proc = subprocess.Popen(["bash", WATCHDOG, "--wav", "day.wav", "--device", "cuda"],
                            cwd=tmp_path, env=env, stdout=subprocess.PIPE, text=True,
                            start_new_session=True)
    deadline = time.monotonic() + 30
    try:
        while time.monotonic() < deadline and (
                not log.exists() or log.read_text().count("launching monitor") < 2):
            time.sleep(0.1)
    finally:
        os.killpg(proc.pid, signal.SIGTERM)
        out, _ = proc.communicate(timeout=10)
    assert out.splitlines()[0] == "[watchdog] starting monitor supervision, log: log.txt"
    lines = log.read_text().splitlines()
    launch = re.compile(rf"^\[watchdog\] {STAMP} launching monitor$")
    first, second = launch.match(lines[0]), launch.match(lines[3])
    assert first and second, lines
    assert lines[1] == "monitor args: -m meteor_scatter_tpu_torch.apps.monitor --wav day.wav --device cuda"
    exited = re.match(rf"^\[watchdog\] {STAMP} monitor exited with code 3; restarting in 3 s$",
                      lines[2])
    assert exited, lines
    gap = (datetime.datetime.fromisoformat(second.group(1))
           - datetime.datetime.fromisoformat(exited.group(1))).total_seconds()
    assert 2 <= gap <= 5  # the 3 s backoff, at the stamps' one-second resolution
