"""The port's package surface against the JAX package's: every name a JAX
package ``__init__`` exports imports from the port's counterpart and is the
port's own object; every ``ms-torch-*`` console script in ``pyproject.toml``
resolves to a callable ``main`` of the port; the port's containers name
files and modules that exist.  The JAX side is read from its source (``ast``),
so these tests import nothing of it.
"""

import ast
import importlib
import os
import re
import tomllib

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ["", ".models", ".ops", ".io", ".parallel", ".utils"]
TORCH_SCRIPTS = ["analyze", "live", "monitor", "merge", "frontend", "dashboard"]


def exported_names(package: str) -> list:
    """The names ``meteor_scatter_tpu<package>/__init__.py`` binds: its
    ``from ... import`` names and its top-level assignments."""
    path = os.path.join(REPO, "meteor_scatter_tpu", *package.split(".")[1:], "__init__.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    names = []
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names += [a.asname or a.name for a in node.names]
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
    return names


@pytest.mark.parametrize("package", PACKAGES, ids=lambda p: p or "top")
def test_every_reference_export_is_the_ports(package):
    names = exported_names(package)
    assert names, package
    port = importlib.import_module("meteor_scatter_tpu_torch" + package)
    for name in names:
        assert hasattr(port, name), f"meteor_scatter_tpu_torch{package} lacks {name}"
        obj = getattr(port, name)
        home = getattr(obj, "__module__", None)
        assert home is None or home.startswith("meteor_scatter_tpu_torch"), (name, home)


def pyproject() -> dict:
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        return tomllib.load(f)


@pytest.mark.parametrize("app", TORCH_SCRIPTS)
def test_console_script_resolves_to_the_ports_main(app):
    scripts = pyproject()["project"]["scripts"]
    target = scripts[f"ms-torch-{app}"]
    module, func = target.split(":")
    sub = "dashboard.app" if app == "dashboard" else f"apps.{app}"
    assert module == f"meteor_scatter_tpu_torch.{sub}" and func == "main"
    assert callable(getattr(importlib.import_module(module), func))
    # the JAX package's script of the same app stays beside it
    assert scripts[f"ms-{app}"].startswith("meteor_scatter_tpu.")


def test_torch_extra_and_jax_dependency():
    project = pyproject()["project"]
    assert project["optional-dependencies"]["torch"] == ["torch"]
    assert "jax" in project["dependencies"]


@pytest.mark.parametrize("image", ["Detection", "Webserver"])
def test_port_container_names_port_files(image):
    """The port's Dockerfiles copy and run only the port, install with
    ``--no-deps``, and name their base image; their run scripts build them."""
    with open(os.path.join(REPO, "docker", f"Dockerfile-{image}-torch")) as f:
        text = f.read()
    assert re.search(r"^# Base image: \S+", text, re.M)
    assert "pip install --no-cache-dir --no-deps ." in text
    assert "COPY meteor_scatter_tpu_torch ./meteor_scatter_tpu_torch" in text
    assert "COPY meteor_scatter_tpu " not in text and "meteor_scatter_tpu." not in text
    cmd = ast.literal_eval(re.search(r"^CMD (\[.*?\])$", text, re.M | re.S).group(1).replace("\\\n", ""))
    if image == "Detection":
        assert cmd[:2] == ["bash", "meteor_scatter_tpu_torch/apps/watchdog.sh"]
        assert os.path.exists(os.path.join(REPO, cmd[1]))
        assert "g++" in text
    else:
        assert cmd[:3] == ["python", "-m", "meteor_scatter_tpu_torch.dashboard.app"]
        importlib.import_module(cmd[2])
    with open(os.path.join(REPO, "docker", f"build-run-{image.lower()}-torch.sh")) as f:
        assert f"-f docker/Dockerfile-{image}-torch" in f.read()
