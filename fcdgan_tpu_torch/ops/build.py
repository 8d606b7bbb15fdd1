"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
alone (no PyTorch headers, so a build takes seconds) into
``fcdgan_tpu_torch/_build/<name>-<source hash>.so``, then loaded with
``ctypes``. The hash key means an edited source rebuilds and an unchanged
one is built once per checkout. Builds happen at first use, never at import.
A failed build raises with the compiler's output.

``host_library`` builds a host C++ source the same way with ``g++`` (the
native tile I/O library, ``native/tileio.cpp``). Every build writes a
temporary file and moves it into place with ``os.replace``, so processes
that build at once each load a whole library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    pass


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> str:
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"{name}-{digest}.so")


def _start(name: str):
    """Start nvcc for ``csrc/<name>.cu`` unless its library exists; returns
    (final path, temp path, process or None)."""
    out = library_path(name)
    if os.path.exists(out):
        return out, None, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return out, tmp, proc


def build(names: Iterable[str]) -> Dict[str, str]:
    """Build the named sources, one nvcc each, all started together.
    Returns each name's nvcc output (registers, spills; '' when cached)."""
    jobs = [(n, *_start(n)) for n in names]
    logs = {}
    errors = []
    for name, out, tmp, proc in jobs:
        logs[name] = ""
        if proc is None:
            continue
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed for csrc/{name}.cu "
                          f"(exit {proc.returncode}):\n{logs[name]}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if errors:
        raise KernelBuildError("\n".join(errors))
    return logs


GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]


def host_library(src: str, libs=("-lz", "-pthread"), build_dir: str = BUILD_DIR) -> str:
    """Build the host C++ source ``src`` with g++ into
    ``<build_dir>/lib<stem>-<hash of source and flags>.so`` unless it is
    there; returns its path. A failed build raises with g++'s output."""
    cmd_flags = [*GXX_FLAGS, *libs]
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(cmd_flags).encode()).hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(src))[0]
    out = os.path.join(build_dir, f"lib{stem}-{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(build_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    cmd = [os.environ.get("CXX", "g++"), *GXX_FLAGS, src, "-o", tmp, *libs]
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
    except OSError as e:
        os.unlink(tmp)
        raise KernelBuildError(f"cannot run {cmd[0]} for {src}: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise KernelBuildError(f"{cmd[0]} failed for {src} (exit {proc.returncode}):\n"
                               f"{proc.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = _LIBS[name] = ctypes.CDLL(library_path(name))
    return lib
