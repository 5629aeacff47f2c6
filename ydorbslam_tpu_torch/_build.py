"""Build the port's CUDA kernels with nvcc and load them with ctypes.

The sources in ``csrc/`` are compiled for Hopper (``sm_90a``) into one
shared library with a plain C interface, at first use and never at
import:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/kernels/<hash>/libydorb_kernels.so csrc/*.cu

The library goes under ``build/kernels/`` at the repository root (listed
in ``.gitignore``), in a directory named by a hash of the sources and
flags, so an edited source builds anew and an unchanged one is reused.
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "kernels"
LIB_NAME = "libydorb_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> dict:
    """Compile the library if it is not built yet.  Returns the path,
    the seconds spent and nvcc's output (ptxas register and shared
    memory report)."""
    path = library_path()
    if path.exists():
        return dict(path=str(path), seconds=0.0, log="(cached)")
    path.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, path)
    return dict(
        path=str(path), seconds=time.perf_counter() - t0,
        log=proc.stdout + proc.stderr,
    )


def load() -> ctypes.CDLL:
    """Build if needed, then load the library and declare its entry
    points.  Every entry point returns ``cudaGetLastError()``."""
    lib = ctypes.CDLL(build()["path"])
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ydorb_fast_score_nms.argtypes = [p, p, i, i, i, p]
    lib.ydorb_fast_score_nms.restype = i
    lib.ydorb_proj_best2.argtypes = [p, p, p, p, i, i, i, p, p]
    lib.ydorb_proj_best2.restype = i
    return lib
