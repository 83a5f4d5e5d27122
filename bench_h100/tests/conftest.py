import tempfile

import pytest


@pytest.fixture(autouse=True)
def _tmpdir(tmp_path, monkeypatch):
    """Runs write their inputs under the temporary directory."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
