# Frozen copy of ydorbslam_tpu_torch/ops/descriptors.py, taken when the benchmark was
# written, for the benchmark's plain reference; imports nothing of the port.
"""Orientation + rotation-steered binary descriptors (rBRIEF), torch.

Port of ``ydorbslam_tpu/ops/descriptors.py``.  Keypoint neighbourhoods
are gathered once into (K, 45, 45) uint8 patches; orientation (the
intensity centroid over the radius-15 disc), the 7x7 sigma-2 descriptor
blur and the 256 BRIEF tests all work on those patches.  Steering is
quantized to 32 angle bins; the test pattern is the same Gaussian
pattern from the same seed, so the bits are identical for identical
blurred patches.

The JAX package evaluates BRIEF as an int8 one-hot einsum over all 32
bins (an MXU form, 32x redundant).  Here it is a gather: a (32, 256, 2)
table holds, per bin and test, the flat patch offsets of the two
rotated and rounded sample points, and each keypoint reads the two
samples of its own bin and compares them.

Descriptors are (K, 8) int32 tensors that hold the uint32 words bit for
bit (PyTorch's uint32 lacks shifts and comparisons); bit i of word w is
test 32*w + i.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .pyramid import _gaussian_kernel_1d

HALF_PATCH = 15  # orientation patch radius (reference patchSize 31)
BRIEF_HALF = 19  # descriptor patch half-size: |pattern| <= 13, rotated <= 19
BRIEF_P = 2 * BRIEF_HALF + 1  # 39
BLUR_K = 7  # descriptor blur kernel (reference 7x7 sigma 2)
RAW_HALF = BRIEF_HALF + BLUR_K // 2  # 22: raw patch half-size pre-blur
RAW_P = 2 * RAW_HALF + 1  # 45
N_BITS = 256
N_ANGLE_BINS = 32


@functools.lru_cache()
def brief_pattern() -> np.ndarray:
    """(256, 2, 2) int32 test-point pairs, Gaussian, deterministic.

    Points ~ N(0, (31/5)^2), clipped to [-13, 13], from the same seed
    as the JAX package."""
    rs = np.random.RandomState(0x0B1EF)
    pts = rs.normal(0.0, 31.0 / 5.0, size=(N_BITS, 2, 2))
    return np.clip(np.round(pts), -13, 13).astype(np.int32)


@functools.lru_cache()
def brief_offsets() -> np.ndarray:
    """(32, 256, 2) int64 flat offsets into a 39x39 blurred patch: test
    points A and B of each pair, rotated by the bin angle and rounded —
    the same points as the JAX package's ``_binned_diff_tensor``."""
    pat = brief_pattern().astype(np.float64)
    out = np.zeros((N_ANGLE_BINS, N_BITS, 2), np.int64)
    for b in range(N_ANGLE_BINS):
        th = 2.0 * np.pi * b / N_ANGLE_BINS
        c, s = np.cos(th), np.sin(th)
        px, py = pat[..., 0], pat[..., 1]  # (256,2)
        rx = np.round(px * c - py * s).astype(np.int64)
        ry = np.round(px * s + py * c).astype(np.int64)
        out[b] = (ry + BRIEF_HALF) * BRIEF_P + (rx + BRIEF_HALF)
    return out


@functools.lru_cache()
def _device_consts(device: torch.device):
    """Per-device constants: orientation weights, blur taps, BRIEF table."""
    dy, dx = np.mgrid[-HALF_PATCH : HALF_PATCH + 1, -HALF_PATCH : HALF_PATCH + 1]
    mask = (dx * dx + dy * dy <= HALF_PATCH * HALF_PATCH).astype(np.float32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return dict(
        wx=t((dx * mask).astype(np.float32)),
        wy=t((dy * mask).astype(np.float32)),
        blur=t(_blur_matrix()),
        offsets=t(brief_offsets()),
        shifts=t(np.arange(32, dtype=np.int64)),
        # A tensor divisor: CUDA turns division by a Python scalar into a
        # multiplication by its reciprocal, which can move a bin edge.
        bin_width=t(np.float32(2.0 * np.pi / N_ANGLE_BINS)),
    )


def _blur_matrix() -> np.ndarray:
    """(45, 39) valid-region 1D Gaussian blur operator (7 taps, sigma 2)."""
    g = _gaussian_kernel_1d(BLUR_K, 2.0)
    m = np.zeros((RAW_P, BRIEF_P), np.float32)
    for i in range(BRIEF_P):
        m[i : i + BLUR_K, i] = g
    return m


def extract_patches(image: torch.Tensor, uv: torch.Tensor, half: int) -> torch.Tensor:
    """Gather (K, 2*half+1, 2*half+1) patches centred at integer uv.

    ``image`` is pre-padded by the caller with at least ``half`` pixels
    and ``uv`` includes the pad offset.  Rows are clamped per index and
    the column window's start is clamped into the image, as the JAX
    package's row gather + ``dynamic_slice`` do."""
    p = 2 * half + 1
    h, w = image.shape
    ui = torch.round(uv[:, 0]).to(torch.int64)
    vi = torch.round(uv[:, 1]).to(torch.int64)
    d = torch.arange(-half, half + 1, device=image.device)
    rows = torch.clamp(vi[:, None] + d[None, :], 0, h - 1)  # (K, p)
    c0 = torch.clamp(ui - half, 0, w - p)
    cols = c0[:, None] + torch.arange(p, device=image.device)[None, :]  # (K, p)
    return image[rows[:, :, None], cols[:, None, :]]


def orientation_from_patches(patches: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle per patch: (K, 31, 31) -> (K,) radians.

    The moments are sums of integer products below 2^24, so they are
    exact in float32 whatever the summation order."""
    c = _device_consts(patches.device)
    patches = patches.to(torch.float32)
    m10 = torch.sum(patches * c["wx"], dim=(1, 2))
    m01 = torch.sum(patches * c["wy"], dim=(1, 2))
    return torch.atan2(m01, m10)


def blur_patches(patches: torch.Tensor) -> torch.Tensor:
    """Separable 7x7 sigma-2 Gaussian blur inside the patch:
    (K, 45, 45) -> (K, 39, 39) valid region, as two constant matmuls."""
    B = _device_consts(patches.device)["blur"]
    patches = patches.to(torch.float32)
    return torch.einsum("kab,ac,bd->kcd", patches, B, B)


def brief_from_patches(patches: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Steered BRIEF: (K, 39, 39) blurred patches + (K,) angles ->
    (K, 8) int32 descriptor words.

    The blurred patch is rounded to uint8 intensities first (the
    reference blurs a CV_8U image); bit s is I(A_s) < I(B_s) with the
    pair rotated by the keypoint's angle bin."""
    c = _device_consts(patches.device)
    K = patches.shape[0]
    flat = torch.clamp(torch.round(patches.reshape(K, BRIEF_P * BRIEF_P)), 0, 255)
    bins = torch.round(angles / c["bin_width"]).to(torch.int64)
    bins = torch.remainder(bins, N_ANGLE_BINS)
    off = c["offsets"][bins]  # (K, 256, 2)
    a = torch.gather(flat, 1, off[..., 0])
    b = torch.gather(flat, 1, off[..., 1])
    bits = (a < b).to(torch.int64).reshape(K, 8, 32)
    words = torch.sum(bits << c["shifts"], dim=-1)  # [0, 2^32)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
