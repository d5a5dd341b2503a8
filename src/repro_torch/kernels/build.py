"""Build and load the port's CUDA kernels.

Each kernel source under ``repro_torch/csrc/`` is compiled with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface
and loaded with `ctypes`.  The build happens at first use, from the
sources in the package only, into ``repro_torch/csrc/_build/`` (listed
in ``.gitignore``); the library's file name carries a hash of its source
and flags, so an edited source is rebuilt and a stale library is never
loaded.  Nothing here runs at import time: the module imports on a
machine without CUDA, and only `load` needs ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# name -> (library, seconds spent building (0.0 when reused), nvcc log)
_LOADED: Dict[str, Tuple[ctypes.CDLL, float, str]] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME or
    /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:12]}.so"


def build(name: str) -> Tuple[Path, float, str]:
    """Compile ``csrc/<name>.cu`` unless its library exists.  Returns
    (library path, build seconds, nvcc's output).  The library is
    written under a temporary name and renamed into place, so processes
    building at once never load a half-written file."""
    out = library_path(name)
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd: List[str] = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                      str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out, time.perf_counter() - t0, proc.stdout + proc.stderr


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    if name not in _LOADED:
        path, seconds, log = build(name)
        _LOADED[name] = (ctypes.CDLL(str(path)), seconds, log)
    return _LOADED[name][0]


def build_info(name: str) -> Tuple[float, str]:
    """(build seconds, nvcc log) of a library `load` has loaded."""
    _, seconds, log = _LOADED[name]
    return seconds, log
