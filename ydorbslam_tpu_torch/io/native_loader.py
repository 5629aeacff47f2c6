"""ctypes binding for the native C++ TUM loader (native/tum_loader.cpp).

A copy of ``ydorbslam_tpu/io/native_loader.py`` (numpy and ctypes
only).  It uses the repository's ``native/`` directory, the shared
library and its Makefile, found from this file's own path.

The native loader decodes PNGs and converts gray/depth on background
threads so the host is free to dispatch device work — the data-loader
role of the framework runtime.  Where the shared library has not been
built (``make -C native``), use the PIL-based ``TumRgbdDataset``.
"""
from __future__ import annotations

import ctypes
import os
from typing import Iterator, Optional, Tuple

import numpy as np

_LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
    "libtumloader.so",
)


def _load_lib() -> Optional[ctypes.CDLL]:
    if not os.path.exists(_LIB_PATH):
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.tum_loader_open.restype = ctypes.c_void_p
    lib.tum_loader_open.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_float, ctypes.c_int,
    ]
    lib.tum_loader_size.restype = ctypes.c_int
    lib.tum_loader_size.argtypes = [ctypes.c_void_p]
    lib.tum_loader_next.restype = ctypes.c_int
    lib.tum_loader_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint16),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.tum_loader_close.argtypes = [ctypes.c_void_p]
    return lib


_lib = None


def native_available() -> bool:
    global _lib
    if _lib is None:
        _lib = _load_lib()
    return _lib is not None


def build_native(quiet: bool = True) -> bool:
    """Compile the shared library in-tree (best effort)."""
    import subprocess

    try:
        subprocess.run(
            ["make", "-C", os.path.dirname(_LIB_PATH)],
            check=True,
            capture_output=quiet,
        )
    except Exception:
        return False
    global _lib
    _lib = None
    return native_available()


class NativeTumLoader:
    """Streaming (timestamp, gray, depth) frames with C++ prefetch.

    Same sensor-native contract as ``TumRgbdDataset``: uint8 grayscale
    and RAW uint16 depth (the device applies 1/DepthMapFactor)."""

    def __init__(
        self,
        sequence_dir: str,
        assoc_path: str,
        depth_map_factor: float,
        width: int = 640,
        height: int = 480,
        lookahead: int = 4,
    ):
        if not native_available():
            raise RuntimeError(
                "libtumloader.so not built — run `make -C native` or use "
                "ydorbslam_tpu_torch.io.tum.TumRgbdDataset"
            )
        self._h = _lib.tum_loader_open(
            sequence_dir.encode(), assoc_path.encode(),
            ctypes.c_float(depth_map_factor), lookahead,
        )
        if not self._h:
            raise FileNotFoundError(assoc_path)
        self.width, self.height = width, height
        self._n = _lib.tum_loader_size(self._h)

    def __len__(self) -> int:
        return self._n

    def __iter__(self) -> Iterator[Tuple[float, np.ndarray, np.ndarray]]:
        while True:
            f = self.next()
            if f is None:
                return
            yield f

    def next(self) -> Optional[Tuple[float, np.ndarray, np.ndarray]]:
        gray = np.empty((self.height, self.width), np.uint8)
        depth = np.empty((self.height, self.width), np.uint16)
        ts = ctypes.c_double()
        w = ctypes.c_int()
        h = ctypes.c_int()
        ok = _lib.tum_loader_next(
            self._h, ctypes.byref(ts),
            gray.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            depth.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            ctypes.byref(w), ctypes.byref(h),
        )
        if not ok:
            return None
        assert (h.value, w.value) == (self.height, self.width), (
            f"frame size {(h.value, w.value)} != configured "
            f"{(self.height, self.width)}"
        )
        return float(ts.value), gray, depth

    def close(self):
        if self._h:
            _lib.tum_loader_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
