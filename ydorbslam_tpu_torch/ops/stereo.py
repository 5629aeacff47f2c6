"""RGB-D depth association for a frame.

Port of ``ydorbslam_tpu/ops/stereo.py::fill_depth_from_rgbd`` (the
reference's ``Frame::computeStereoFromRGBD``).  The lookup is a plain
gather ``depth[vi, ui]``; the TPU's one-hot row matmul is not carried
over.  Stereo matching (``stereo_match``) belongs to the stereo slice.
"""
from __future__ import annotations

import torch

from ..geometry.camera import CameraIntrinsics
from .extractor import FrameFeatures


def fill_depth_from_rgbd(
    feats: FrameFeatures, depth_image: torch.Tensor, cam: CameraIntrinsics
) -> FrameFeatures:
    """Fill (depth, right_u) from a registered float32 depth map (metres).

    Depth is read at the RAW keypoint coords and the virtual right-image
    x is derived from the UNDISTORTED x, the reference's convention."""
    h, w = depth_image.shape
    ui = torch.clamp(torch.round(feats.uv_raw[:, 0]).to(torch.int64), 0, w - 1)
    vi = torch.clamp(torch.round(feats.uv_raw[:, 1]).to(torch.int64), 0, h - 1)
    d = depth_image[vi, ui]
    ok = feats.valid & (d > 0.0)
    minus_one = torch.full_like(d, -1.0)
    right_u = torch.where(ok, feats.uv[:, 0] - cam.bf / torch.clamp(d, min=1e-6), minus_one)
    depth = torch.where(ok, d, minus_one)
    return feats._replace(depth=depth, right_u=right_u)
