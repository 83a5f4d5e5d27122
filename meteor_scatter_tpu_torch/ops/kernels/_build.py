"""Build the port's native sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` (a hand-written CUDA kernel) has a plain C
interface (no PyTorch headers), so ``nvcc`` compiles it in seconds;
``csrc/<name>.cc`` (host C++: the streaming-ingest runtime behind
``io/native.py``) is compiled by ``g++`` with the flags of
``native/Makefile``.  Both land in ``build/torch_kernels/`` at the root of
the checkout (listed in ``.gitignore``).  The library's file name carries a
hash of the sources and flags: an edited source builds anew, an unchanged
one is loaded from the earlier build.

Nothing is compiled at import time — the CPU tests import every module of
the package on machines without ``nvcc`` or a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills into the build log
)
GXX_FLAGS = ("-O3", "-Wall", "-Wextra", "-fPIC", "-std=c++17", "-pthread", "-shared")
GXX_LIBS = ("-lpthread",)

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin/ on PATH or set CUDA_HOME")


def _gxx() -> str:
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError("g++ not found: put a C++ compiler on PATH")


def _source(name: str) -> Path:
    """``csrc/<name>.cu`` where it exists, else the host ``csrc/<name>.cc``."""
    cu = CSRC / f"{name}.cu"
    return cu if cu.exists() else CSRC / f"{name}.cc"


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` (or ``.cc``) builds to, keyed by the sources
    and flags."""
    src = _source(name)
    if src.suffix == ".cu":
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        deps = [src, *sorted(CSRC.glob("*.cuh"))]
    else:
        h = hashlib.sha256(" ".join(GXX_FLAGS + GXX_LIBS).encode())
        deps = [src]
    for dep in deps:
        h.update(dep.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _command(name: str, out: Path) -> list:
    src = _source(name)
    if src.suffix == ".cu":
        return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)]
    return [_gxx(), *GXX_FLAGS, "-o", str(out), str(src), *GXX_LIBS]


def build(name: str) -> Path:
    """Build ``csrc/<name>.cu`` (or ``.cc``) unless a build of the same
    sources and flags is there; returns the library's path.

    A failed build raises with the compiler's output.  The build log (for a
    kernel, ptxas' register and spill report) is kept beside the library as
    ``.log``.
    """
    out = library_path(name)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = _command(name, tmp)
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{os.path.basename(cmd[0])} failed building {name} (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (or ``.cc``), built first if
    needed (:func:`build`, which raises on a failed build)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    lib = ctypes.CDLL(str(build(name)))
    _libs[name] = lib
    return lib


def build_log(name: str) -> str:
    """The compiler's output from building ``csrc/<name>`` (empty if not built
    here)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
