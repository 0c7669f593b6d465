"""Build the package's CUDA sources with ``nvcc`` at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled into a shared
library with ``nvcc -shared -Xcompiler -fPIC`` for ``sm_90a`` (Hopper), then
loaded through ``ctypes``. Nothing includes PyTorch's headers, so a build
takes seconds, not minutes. The library lands in ``kernels/_build/`` (listed
in ``.gitignore``) under a name keyed by a hash of the flags, the source and
every header it includes from ``csrc/`` (``#include "..."``, followed
recursively): a checkout never loads a binary built from other sources.
``build_all`` starts one ``nvcc`` per source at once and waits for all.

A failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

__all__ = ["load_library", "build_all", "nvcc_path", "NVCC_FLAGS", "build_seconds"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_BUILD = os.path.join(_HERE, "_build")

NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict = {}
build_seconds: dict = {}  # name -> seconds the build took in this process (0.0 when cached)


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    if shutil.which("nvcc"):
        candidates.append(shutil.which("nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def _sources(name: str) -> list:
    """``csrc/<name>.cu`` and the local headers it includes, recursively."""
    todo, seen = [f"{name}.cu"], []
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.append(f)
        with open(os.path.join(_CSRC, f), "rb") as fh:
            todo.extend(m.decode() for m in _INCLUDE.findall(fh.read()))
    return seen


def _library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(_sources(name)):
        with open(os.path.join(_CSRC, f), "rb") as fh:
            h.update(f.encode() + b"\0" + fh.read())
    return os.path.join(_BUILD, f"lib{name}_{h.hexdigest()[:12]}.so")


def _start(name: str):
    """(library path, None) when built, else (path, (process, tmp, cmd, t0))."""
    so = _library_path(name)
    if os.path.exists(so):
        return so, None
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return so, (proc, tmp, cmd, time.perf_counter())


def _finish(name: str, so: str, job) -> str:
    if job is None:
        build_seconds[name] = 0.0
        return so
    proc, tmp, cmd, t0 = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed building {name}.cu (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{out}")
    os.replace(tmp, so)  # atomic: a concurrent loader sees a whole file or none
    build_seconds[name] = time.perf_counter() - t0
    return so


def build_all(names) -> None:
    """Build and load every ``csrc/<name>.cu`` not loaded yet, one ``nvcc``
    per source, all started together. Raises on the first failed build
    after every compiler has exited."""
    with _lock:
        todo = [n for n in names if n not in _libs]
        jobs = [(n, *_start(n)) for n in todo]
        errors = []
        for n, so, job in jobs:
            try:
                _libs[n] = ctypes.CDLL(_finish(n, so, job))
            except RuntimeError as e:
                errors.append(e)
        if errors:
            raise errors[0]


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    build_all([name])
    return _libs[name]
