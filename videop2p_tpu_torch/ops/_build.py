"""Build and load the hand-written Hopper kernels of ``ops/csrc``.

Each ``.cu`` source compiles with ``nvcc`` into its own shared library with a
plain C interface, loaded with :mod:`ctypes`. No source includes PyTorch's
headers, so a build takes seconds instead of minutes. All sources compile in
parallel (one ``nvcc`` process each, started together) at first use, into
``build/torch_kernels/`` at the repository root, a directory that
``.gitignore`` lists. A library's file name carries a hash of its source,
of every header in ``csrc/`` (``*.cuh``, which the sources include) and of
the flags, so an edited source or header rebuilds and an unchanged one loads
as it is. ``nvcc -Xptxas -v`` reports each kernel's registers, shared memory
and spills; the report is kept beside the library (``<library>.ptxas.txt``)
and :func:`ptxas_report` reads it.

Nothing here runs at import time: the CPU tests import every module of the
package on a machine without ``nvcc``.
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
from typing import Callable, Dict, List

__all__ = ["build_all", "load_library", "bind", "ptxas_report", "KERNEL_SOURCES",
           "BUILD_DIR", "BUILD_LISTENERS"]

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "torch_kernels")
KERNEL_SOURCES = ("frame_attention.cu", "groupnorm.cu", "flash_attention.cu",
                  "flash_attention_bwd.cu")
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# called with (source, seconds) after each successful nvcc build (the run
# ledger records them as ``compile`` events)
BUILD_LISTENERS: List[Callable[[str, float], None]] = []


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


def source_digest(source: str, csrc: str = CSRC) -> str:
    """Hash of ``source``, of every ``*.cuh`` header in ``csrc`` (by name and
    content) and of the flags: the part of a library's name that changes
    whenever anything it is built from changes."""
    digest = hashlib.sha1()
    for name in [source] + sorted(f for f in os.listdir(csrc) if f.endswith(".cuh")):
        with open(os.path.join(csrc, name), "rb") as fh:
            digest.update(name.encode() + b"\0" + fh.read() + b"\0")
    digest.update(" ".join(NVCC_FLAGS).encode())
    return digest.hexdigest()[:12]


def _lib_path(source: str) -> str:
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"{stem}-{source_digest(source)}.so")


def build_all() -> Dict[str, str]:
    """Compile every missing library in parallel; returns source → path.
    Raises with the compiler's output when a build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
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
        with open(path + ".ptxas.txt", "w") as fh:
            fh.write(out)
        os.replace(tmp, path)
        for listener in list(BUILD_LISTENERS):
            listener(src, time.perf_counter() - t0)
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_SPILLS = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                     r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")


def parse_ptxas(text: str) -> List[dict]:
    """Per kernel of an ``nvcc -Xptxas -v`` log: its (mangled) name,
    registers, static shared memory in bytes (dynamic shared memory is set
    at launch) and spill stores and loads in bytes."""
    kernels: List[dict] = []
    for line in text.splitlines():
        entry = _ENTRY.search(line)
        if entry:
            kernels.append({"kernel": entry.group(1), "registers": None, "smem_bytes": 0,
                            "spill_stores": 0, "spill_loads": 0, "stack_bytes": 0})
            continue
        if not kernels:
            continue
        rec = kernels[-1]
        spills = _SPILLS.search(line)
        if spills:
            rec["stack_bytes"], rec["spill_stores"], rec["spill_loads"] = map(
                int, spills.groups())
        used = _USED.search(line)
        if used:
            rec["registers"] = int(used.group(1))
            smem = _SMEM.search(line)
            rec["smem_bytes"] = int(smem.group(1)) if smem else 0
    return kernels


def ptxas_report(source: str) -> List[dict]:
    """The ptxas resource report of the built library of ``source``, the
    kernel names demangled by the toolkit's ``cu++filt``."""
    with open(_lib_path(source) + ".ptxas.txt") as fh:
        kernels = parse_ptxas(fh.read())
    if kernels:
        filt = os.path.join(os.path.dirname(_nvcc()), "cu++filt")
        out = subprocess.run([filt, *(k["kernel"] for k in kernels)],
                             capture_output=True, text=True, check=True, timeout=60)
        for rec, name in zip(kernels, out.stdout.splitlines()):
            rec["kernel"] = name
    return kernels


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
