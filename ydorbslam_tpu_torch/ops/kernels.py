"""Wrappers of the hand-written CUDA kernels (K1, K2) with launch counts.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the current stream of the
tensor's device and raises if ``cudaGetLastError()`` is not 0.  The
kernels are built and loaded at the first launch (``_build.py``), never
at import.

``launch_counts()`` reports how many times each kernel was launched
since ``reset_launch_counts()``; a wrapper adds one exactly where it
launches.  The plain versions (``ops.fast``, ``ops.hamming``) never
touch the counts.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from .. import _build

_LAUNCHES: Dict[str, int] = {"fast_score_nms": 0, "proj_best2": 0}


def launch_counts() -> Dict[str, int]:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def _lib():
    return _build.load()


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: Tuple) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if len(t.shape) != len(shape) or any(
        s is not None and d != s for d, s in zip(t.shape, shape)
    ):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError {err}")


def fast_score_nms_cuda(image: torch.Tensor, border: int) -> torch.Tensor:
    """K1 on the card: (H, W) float32 -> (H, W) float32 suppressed FAST
    scores, bit-identical to ``nms_and_border(fast_score_map(image))``."""
    _check(image, "fast_score_nms", torch.float32, (None, None))
    H, W = image.shape
    if H * W >= 2**31 or border < 0:
        raise ValueError(f"fast_score_nms: unsupported shape {H}x{W} / border {border}")
    out = torch.empty_like(image)
    if H * W == 0:
        return out
    lib = _lib()
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream(image.device).cuda_stream
        err = lib.ydorb_fast_score_nms(
            image.data_ptr(), out.data_ptr(), H, W, int(border), stream
        )
        _LAUNCHES["fast_score_nms"] += 1
    _raise_on(err, "fast_score_nms")
    return out


def proj_best2_cuda(
    desc_a: torch.Tensor, attr_a: torch.Tensor,
    desc_b: torch.Tensor, attr_b: torch.Tensor,
    check_ur: bool = False,
):
    """K2 on the card; same contract and results as
    ``ops.hamming.proj_best2_plain``."""
    M, N = desc_a.shape[0], desc_b.shape[0]
    _check(desc_a, "proj_best2 desc_a", torch.int32, (M, 8))
    _check(attr_a, "proj_best2 attr_a", torch.float32, (M, 8))
    _check(desc_b, "proj_best2 desc_b", torch.int32, (N, 8))
    _check(attr_b, "proj_best2 attr_b", torch.float32, (N, 8))
    dev = desc_a.device
    if any(t.device != dev for t in (attr_a, desc_b, attr_b)):
        raise ValueError("proj_best2: inputs on different devices")
    if M >= 2**28 or N >= 2**28:
        raise ValueError(f"proj_best2: unsupported shape M={M}, N={N}")
    out = torch.empty((6, M), dtype=torch.int32, device=dev)
    if M == 0:
        return (out[0], out[1], out[2]), (out[3], out[4], out[5])
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ydorb_proj_best2(
            desc_a.data_ptr(), attr_a.data_ptr(), desc_b.data_ptr(),
            attr_b.data_ptr(), M, N, int(bool(check_ur)), out.data_ptr(), stream,
        )
        _LAUNCHES["proj_best2"] += 1
    _raise_on(err, "proj_best2")
    return (out[0], out[1], out[2]), (out[3], out[4], out[5])
