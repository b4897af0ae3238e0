"""Build and load the hand-written Hopper kernels of ``ops/csrc``.

Each ``.cu`` source compiles with ``nvcc`` into its own shared library with a
plain C interface, loaded with :mod:`ctypes`. No source includes PyTorch's
headers, so a build takes seconds instead of minutes. All sources compile in
parallel (one ``nvcc`` process each, started together) at first use, into
``build/torch_kernels/`` at the repository root, a directory that
``.gitignore`` lists. A library's file name carries a hash of its source and
the flags, so an edited source rebuilds and an unchanged one loads as it is.

Nothing here runs at import time: the CPU tests import every module of the
package on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Callable, Dict

__all__ = ["build_all", "load_library", "bind", "KERNEL_SOURCES", "BUILD_DIR"]

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "torch_kernels")
KERNEL_SOURCES = ("frame_attention.cu", "groupnorm.cu", "flash_attention.cu",
                  "flash_attention_bwd.cu")
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the "
            "CUDA kernels of videop2p_tpu_torch build only where the CUDA "
            "toolkit is installed")
    return found


def _lib_path(source: str) -> str:
    with open(os.path.join(CSRC, source), "rb") as fh:
        digest = hashlib.sha1(fh.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:12]}.so")


def build_all() -> Dict[str, str]:
    """Compile every missing library in parallel; returns source → path.
    Raises with the compiler's output when a build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    paths = {}
    for src in KERNEL_SOURCES:
        path = _lib_path(src)
        paths[src] = path
        if os.path.exists(path):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, path)
    errors = []
    for src, (proc, tmp, path) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src} (rc={proc.returncode}):\n{out}")
            continue
        os.replace(tmp, path)
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load_library(source: str) -> ctypes.CDLL:
    """The loaded library of one source, building all sources on first use."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            paths = build_all()
            lib = _libs[source] = ctypes.CDLL(paths[source])
        return lib


def bind(source: str, name: str, argtypes) -> Callable[..., None]:
    """The C launcher ``name`` of ``source`` as a Python callable that raises
    when the launch returns a CUDA error (a refused launch never runs, and a
    later synchronise would not report it). Each launcher returns its
    ``cudaError_t``; each library exports ``<stem>_error_string``."""
    lib = load_library(source)
    fn = getattr(lib, name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    err = getattr(lib, os.path.splitext(source)[0] + "_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p

    def call(*args) -> None:
        code = fn(*args)
        if code != 0:
            raise RuntimeError(
                f"{name} launch failed: {err(code).decode()} (cudaError {code})")

    return call
