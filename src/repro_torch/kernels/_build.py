"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into a shared library, at first use, under
``build/repro_torch/`` of the checkout (listed in ``.gitignore``).  The file
name carries a hash of the source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited source or header builds anew and an unchanged one
is reused.  The library is loaded with
``ctypes``; callers declare ``argtypes`` with ``c_void_p`` for every
pointer and the stream.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The CUDA compiler: on ``PATH``, else under ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin; "
                       "the CUDA kernels cannot be built")


def _output(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names) -> Dict[str, Path]:
    """Compile every ``csrc/<name>.cu`` that has no build of its source
    yet, one ``nvcc`` each, all started together; wait for all of them.

    The compiler's output (ptxas register and shared-memory report) is
    kept beside each library as ``<library>.log``.
    """
    jobs = {}
    for name in names:
        out = _output(name)
        if out.exists() or name in jobs:
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs[name] = (proc, tmp, out)
    failed = []
    for name, (proc, tmp, out) in jobs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed to build {CSRC / name}.cu:\n"
                          f"{stderr}")
            continue
        out.with_name(out.name + ".log").write_text(stdout + stderr)
        os.replace(tmp, out)      # atomic: a concurrent build never half-loads
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: _output(name) for name in names}


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a build of this source exists."""
    return build_all([name])[name]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(str(build(name)))
    return lib
