# Frozen copy of ydorbslam_tpu_torch/ops/pyramid.py, taken when the benchmark was
# written, for the benchmark's plain reference; imports nothing of the port.
"""Image pyramid (bilinear, chained level to level) on torch tensors.

Port of ``ydorbslam_tpu/ops/pyramid.py``.  Level geometry matches the
reference: level l has size ``round(dim * scale_factor^-l)`` computed
from the ORIGINAL size, resampled from level l-1 with OpenCV's
INTER_LINEAR coordinate convention.

The JAX package applies each axis' resampling as a dense (dst, src)
matmul (an MXU-shaped form, in bf16 on the TPU).  Here each axis is a
gather of the two source rows (or columns) and a lerp in float32:
``out = x[i0] * w0 + x[i1] * w1``, with the weights of the same
``_resize_matrix``.  Each step is one elementwise float32 operation
(no sum whose order a backend may choose), so the result is the same
on the CPU and on the card.  Against XLA's CPU matmul the
interpolated levels differ in the last bits (level 0 is the input,
exact); ``tests/test_torch_ops.py`` states the bound.

``gaussian_blur`` is the JAX package's separable 7x7 blur with
reflect-101 edges (OpenCV's BORDER_REFLECT_101), written as two 1-D
convolutions over a reflect-padded image, where the JAX package
multiplies by dense (n, n) band matrices.
"""
from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _resize_matrix(dst: int, src: int) -> np.ndarray:
    """Dense (dst, src) bilinear resampling matrix, OpenCV INTER_LINEAR
    coordinate convention: src_x = (dst_x + 0.5) * src/dst - 0.5."""
    M = np.zeros((dst, src), dtype=np.float32)
    scale = src / dst
    for d in range(dst):
        x = (d + 0.5) * scale - 0.5
        x0 = int(np.floor(x))
        w1 = x - x0
        x0c = min(max(x0, 0), src - 1)
        x1c = min(max(x0 + 1, 0), src - 1)
        M[d, x0c] += 1.0 - w1
        M[d, x1c] += w1
    return M


@functools.lru_cache()
def _lerp_taps(dst: int, src: int, device: torch.device) -> Tuple[torch.Tensor, ...]:
    """(i0, i1, w0, w1) per output index on ``device``: the (at most
    two) nonzeros of each row of ``_resize_matrix``.  Where a row has
    one nonzero (the clamped edge) i1 = i0 and w1 = 0."""
    M = _resize_matrix(dst, src)
    nz = M != 0
    rows = np.arange(dst)
    i0 = np.argmax(nz, axis=1)
    i1 = src - 1 - np.argmax(nz[:, ::-1], axis=1)
    w0 = M[rows, i0]
    w1 = np.where(i1 != i0, M[rows, i1], 0.0).astype(np.float32)
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a)).to(device)
        for a in (i0.astype(np.int64), i1.astype(np.int64), w0, w1)
    )


def _resize_axis(x: torch.Tensor, dst: int, axis: int) -> torch.Tensor:
    i0, i1, w0, w1 = _lerp_taps(dst, x.shape[axis], x.device)
    if axis == 0:
        return x[i0] * w0[:, None] + x[i1] * w1[:, None]
    return x[:, i0] * w0[None, :] + x[:, i1] * w1[None, :]


def pyramid_shapes(
    height: int, width: int, n_levels: int, scale_factor: float
) -> List[Tuple[int, int]]:
    """(H_l, W_l) per level, reference rounding (orbExtractor.cpp:608)."""
    out = []
    for level in range(n_levels):
        inv = scale_factor ** (-level)
        out.append((int(round(height * inv)), int(round(width * inv))))
    return out


def build_pyramid(
    image: torch.Tensor, n_levels: int = 8, scale_factor: float = 1.2
) -> Tuple[torch.Tensor, ...]:
    """float32 (H, W) image -> tuple of per-level float32 images."""
    h, w = image.shape
    shapes = pyramid_shapes(h, w, n_levels, scale_factor)
    levels = [image]
    for level in range(1, n_levels):
        nh, nw = shapes[level]
        rows = _resize_axis(levels[-1], nh, 0)
        levels.append(_resize_axis(rows, nw, 1))
    return tuple(levels)


def _gaussian_kernel_1d(ksize: int = 7, sigma: float = 2.0) -> np.ndarray:
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    g = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (g / g.sum()).astype(np.float32)


def gaussian_blur(image: torch.Tensor, ksize: int = 7, sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian blur of a float32 (H, W) image with reflect-101
    edges; H and W must exceed ``ksize // 2``.  ``torch.backends.cudnn``
    keeps TF32 off (the package's ``__init__``), so the card convolves
    in float32."""
    r = ksize // 2
    g = torch.from_numpy(_gaussian_kernel_1d(ksize, sigma)).to(image.device)
    x = F.pad(image[None, None], (0, 0, r, r), mode="reflect")
    x = F.conv2d(x, g.reshape(1, 1, ksize, 1))
    x = F.pad(x, (r, r, 0, 0), mode="reflect")
    return F.conv2d(x, g.reshape(1, 1, 1, ksize))[0, 0]


def scale_factors(n_levels: int, scale_factor: float) -> np.ndarray:
    """Per-level scale (level coords * scale = level-0 coords)."""
    return (scale_factor ** np.arange(n_levels)).astype(np.float32)


@functools.lru_cache()
def scale_table(n_levels: int, scale_factor: float, device: torch.device) -> torch.Tensor:
    """``scale_factors`` on ``device``, copied there once and from pinned
    memory: an upload from pageable memory stalls the host, and the
    searches and the stereo match run per frame and per loop
    verification."""
    t = torch.from_numpy(scale_factors(n_levels, scale_factor))
    return t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t.to(device)


def level_sigma2(n_levels: int, scale_factor: float) -> np.ndarray:
    """Per-level variance used as information weights in optimization."""
    return (scale_factor ** (2.0 * np.arange(n_levels))).astype(np.float32)
