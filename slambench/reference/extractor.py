# Frozen copy of ydorbslam_tpu_torch/ops/extractor.py, taken when the benchmark was
# written, for the benchmark's plain reference; imports nothing of the port.
"""The ORB extraction pipeline on torch tensors.

Port of ``ydorbslam_tpu/ops/extractor.py``: pyramid, per-level FAST
score + NMS (K1), the two-threshold cell fallback, 8x8-cell top-k
selection, sub-pixel refinement, orientation, blur and steered BRIEF,
then undistortion.  The output is a fixed-capacity ``FrameFeatures``
with a validity mask, exactly as in the JAX package, so every stage
downstream sees static shapes.

K1 runs on whatever device the image is on: a CUDA image launches the
CUDA kernel once for all levels, a CPU image takes the plain version
level by level (``ops.fast.fast_score_nms_levels``).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .camera import CameraIntrinsics, undistort_points
from .descriptors import (
    HALF_PATCH,
    RAW_HALF,
    blur_patches,
    brief_from_patches,
    extract_patches,
    orientation_from_patches,
)
from .fast import fast_score_nms_levels, fast_subpixel_offsets, two_threshold_mask
from .pyramid import build_pyramid, scale_factors
from .select import level_budgets, select_topk_cells

DETECT_BORDER = 16  # reference maxPadSize-3 (src/orbExtractor.cpp:550-553)


class FrameFeatures(NamedTuple):
    """Fixed-capacity per-frame feature set.

    All tensors have leading dim N (capacity); ``valid`` masks real
    rows.  ``uv`` is undistorted level-0 pixel coords, ``uv_raw`` the
    detector coords (for depth lookup).  ``right_u`` is the virtual
    right-image x and ``depth`` the metric depth, -1 when unavailable.
    ``desc`` holds the 8 uint32 words of each descriptor as int32.
    """

    uv: torch.Tensor  # (N,2) f32
    uv_raw: torch.Tensor  # (N,2) f32
    response: torch.Tensor  # (N,) f32
    octave: torch.Tensor  # (N,) i32
    angle: torch.Tensor  # (N,) f32 radians
    desc: torch.Tensor  # (N,8) i32 (uint32 bits)
    right_u: torch.Tensor  # (N,) f32
    depth: torch.Tensor  # (N,) f32
    valid: torch.Tensor  # (N,) bool


def empty_features(n: int, device="cuda") -> FrameFeatures:
    """``n`` rows of no feature: zeros, ``right_u`` and ``depth`` -1,
    ``valid`` False, on ``device`` (the card unless the caller asks for
    another; without a card a CUDA request raises)."""
    f32 = torch.float32

    def full(shape, v, dtype):
        return torch.full(shape, v, dtype=dtype, device=device)

    return FrameFeatures(
        uv=full((n, 2), 0.0, f32),
        uv_raw=full((n, 2), 0.0, f32),
        response=full((n,), 0.0, f32),
        octave=full((n,), 0, torch.int32),
        angle=full((n,), 0.0, f32),
        desc=full((n, 8), 0, torch.int32),
        right_u=full((n,), -1.0, f32),
        depth=full((n,), -1.0, f32),
        valid=full((n,), False, torch.bool),
    )


def extract_orb(
    image: torch.Tensor,
    cam: CameraIntrinsics,
    n_features: int = 1000,
    capacity: int = 1024,
    n_levels: int = 8,
    scale_factor: float = 1.2,
    th_high: int = 20,
    th_low: int = 7,
    has_distortion: bool = True,
    subpixel: bool = True,
) -> FrameFeatures:
    """(H, W) image (uint8 or float32) on the working device ->
    FrameFeatures with ``capacity`` rows on the same device."""
    return _extract_orb_pyramid(
        image, cam, n_features, capacity, n_levels, scale_factor, th_high, th_low,
        has_distortion, subpixel,
    )[0]


def _extract_orb_pyramid(
    image: torch.Tensor,
    cam: CameraIntrinsics,
    n_features: int,
    capacity: int,
    n_levels: int,
    scale_factor: float,
    th_high: int,
    th_low: int,
    has_distortion: bool,
    subpixel: bool,
) -> Tuple[FrameFeatures, Tuple[torch.Tensor, ...]]:
    """``extract_orb`` that also returns the float32 pyramid it builds,
    which the stereo match reads (the JAX package builds it twice)."""
    dev = image.device
    image = image.to(torch.float32)
    pyr = build_pyramid(image, n_levels, scale_factor)
    budgets = level_budgets(n_features, n_levels, scale_factor)
    scales = scale_factors(n_levels, scale_factor)

    live = [level for level in range(n_levels) if budgets[level] > 0]
    scores = fast_score_nms_levels([pyr[level] for level in live], DETECT_BORDER)

    uvs, patches_l = [], []
    resps, octs, valids = [], [], []
    for level, score in zip(live, scores):
        lvl = pyr[level]
        k = budgets[level]
        score = two_threshold_mask(score, 32, float(th_high), float(th_low))
        uv_l, resp, valid = select_topk_cells(score, k)

        # One raw uint8 patch per keypoint feeds orientation, the
        # descriptor blur and the BRIEF tests; the level is edge-padded
        # so patches near the border read replicated pixels.
        lvl_q = torch.clamp(torch.round(lvl), 0.0, 255.0)
        pad = F.pad(lvl_q[None, None], (RAW_HALF,) * 4, mode="replicate")[0, 0]
        patch = extract_patches(pad.to(torch.uint8), uv_l + RAW_HALF, RAW_HALF)
        patches_l.append(patch)

        if subpixel:
            uv_l = uv_l + fast_subpixel_offsets(patch)

        uvs.append(uv_l * float(scales[level]))
        resps.append(resp)
        octs.append(torch.full((k,), level, dtype=torch.int32, device=dev))
        valids.append(valid)

    uv_raw = torch.cat(uvs, dim=0)
    response = torch.cat(resps, dim=0)
    octave = torch.cat(octs, dim=0)
    valid = torch.cat(valids, dim=0)

    patches = torch.cat(patches_l, dim=0).to(torch.float32)
    c0 = RAW_HALF - HALF_PATCH
    ctr = patches[:, c0 : c0 + 2 * HALF_PATCH + 1, c0 : c0 + 2 * HALF_PATCH + 1]
    angle = orientation_from_patches(ctr)
    desc = brief_from_patches(blur_patches(patches), angle)

    pad = capacity - uv_raw.shape[0]
    if pad < 0:
        raise ValueError(f"capacity {capacity} < total budget {uv_raw.shape[0]}")
    if pad:
        uv_raw, response, octave, angle, desc, valid = (
            torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
            for x in (uv_raw, response, octave, angle, desc, valid)
        )

    uv = undistort_points(cam, uv_raw) if has_distortion else uv_raw
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    minus_one = torch.full((capacity,), -1.0, dtype=torch.float32, device=dev)
    feats = FrameFeatures(
        uv=torch.where(valid[:, None], uv, zero),
        uv_raw=torch.where(valid[:, None], uv_raw, zero),
        response=response,
        octave=octave,
        angle=angle,
        desc=desc,
        right_u=minus_one,
        depth=minus_one.clone(),
        valid=valid,
    )
    return feats, pyr
