"""Build the port's CUDA kernels with nvcc and load them with ctypes.

The sources in ``csrc/`` are compiled for Hopper (``sm_90a``) into one
shared library with a plain C interface, at first use and never at
import.  Each source is compiled by its own nvcc process, all started
together, and the objects are then linked:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c
         -Xcompiler -fPIC -o build/kernels/<hash>/<source>.o csrc/<source>.cu
    nvcc -shared -o build/kernels/<hash>/libydorb_kernels.so build/kernels/<hash>/*.o

The library goes under ``build/kernels/`` at the repository root (listed
in ``.gitignore``), in a directory named by a hash of the sources, the
shared headers (``csrc/*.cuh``) and the flags, so an edited source or
header builds anew and an unchanged tree is reused.
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Per-source flags.  K4 is built without multiply-add contraction, so
# each of its operations rounds once as in the plain PyTorch version and
# the two agree to the order of the per-point sums (csrc/lm_obs.cu).
SOURCE_FLAGS = {"lm_obs.cu": ("-fmad=false",)}


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _headers():
    return sorted(CSRC.glob("*.cuh"))


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
        h.update(" ".join(SOURCE_FLAGS.get(src.name, ())).encode())
        h.update(src.read_bytes())
    for hdr in _headers():
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
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
    nvcc = _nvcc()
    work = Path(tempfile.mkdtemp(dir=path.parent))
    try:
        jobs = []
        for src in _sources():
            obj = work / (src.stem + ".o")
            cmd = [
                nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(src.name, ()),
                "-c", "-o", str(obj), str(src),
            ]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            jobs.append((cmd, obj, proc))
        log, failed = [], []
        for cmd, _, proc in jobs:
            out, _ = proc.communicate()
            log.append(out)
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = work / LIB_NAME
        cmd = [nvcc, "-shared", "-o", str(tmp), *(str(obj) for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return dict(
        path=str(path), seconds=time.perf_counter() - t0, log="".join(log),
    )


def load() -> ctypes.CDLL:
    """Build if needed, then load the library and declare its entry
    points.  Every entry point returns ``cudaGetLastError()``."""
    lib = ctypes.CDLL(build()["path"])
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ydorb_fast_score_nms.argtypes = [ctypes.POINTER(ctypes.c_longlong), i, i, i, p]
    lib.ydorb_fast_score_nms.restype = i
    lib.ydorb_proj_best2.argtypes = [p, p, p, p, i, i, i, p, i, p]
    lib.ydorb_proj_best2.restype = i
    lib.ydorb_pair_best2.argtypes = [p, p, p, p, i, i, i, i, p, i, p]
    lib.ydorb_pair_best2.restype = i
    lib.ydorb_lm_obs.argtypes = [p, i, i, p, p, i, p]
    lib.ydorb_lm_obs.restype = i
    lib.ydorb_pose_lm.argtypes = [p] * 14 + [i] * 4 + [p]
    lib.ydorb_pose_lm.restype = i
    return lib
