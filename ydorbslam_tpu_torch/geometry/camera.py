"""Pinhole camera model with radial-tangential distortion (torch).

Port of ``ydorbslam_tpu/geometry/camera.py``: the intrinsics shared by
all frames, ``undistort_points`` (fixed-point iteration, the
``cv::undistortPoints`` replacement), the pinhole ``project`` and
``project_stereo``, ``backproject`` and the ``in_image`` bounds mask.
Batched over points: (N,2)/(N,3) tensors in, (N,...) tensors out.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class CameraIntrinsics(NamedTuple):
    """Pinhole + distortion parameters as 0-dim float32 tensors on one
    device (so every product with them is a float32 product, as in the
    JAX package), plus the integer image size.

    ``bf`` is the stereo baseline times fx, used to convert depth to
    virtual right-image x: ``uR = uL - bf/z``.
    """

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    k1: torch.Tensor
    k2: torch.Tensor
    p1: torch.Tensor
    p2: torch.Tensor
    k3: torch.Tensor
    bf: torch.Tensor
    width: int
    height: int

    @staticmethod
    def create(fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0, bf=0.0,
               width=640, height=480, *, device) -> "CameraIntrinsics":
        def f(v):
            return torch.as_tensor(v, dtype=torch.float32, device=device)

        return CameraIntrinsics(
            f(fx), f(fy), f(cx), f(cy), f(k1), f(k2), f(p1), f(p2), f(k3), f(bf),
            int(width), int(height),
        )

    @property
    def baseline(self) -> torch.Tensor:
        return self.bf / self.fx


def distort_normalized(cam: CameraIntrinsics, xn: torch.Tensor) -> torch.Tensor:
    """Apply radtan distortion to normalized coords (...,2) -> (...,2)."""
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
    xy2 = 2.0 * x * y
    xd = x * radial + cam.p1 * xy2 + cam.p2 * (r2 + 2.0 * x * x)
    yd = y * radial + cam.p2 * xy2 + cam.p1 * (r2 + 2.0 * y * y)
    return torch.stack([xd, yd], dim=-1)


def undistort_points(
    cam: CameraIntrinsics, uv: torch.Tensor, iters: int = 8
) -> torch.Tensor:
    """Undistort pixel coords by fixed-point iteration (8 iterations, as
    the JAX package).  Returns pixel coords in the undistorted K frame."""
    xn = torch.stack(
        [(uv[..., 0] - cam.cx) / cam.fx, (uv[..., 1] - cam.cy) / cam.fy], dim=-1
    )
    x = xn
    for _ in range(iters):
        x = xn - (distort_normalized(cam, x) - x)
    return torch.stack(
        [x[..., 0] * cam.fx + cam.cx, x[..., 1] * cam.fy + cam.cy], dim=-1
    )


def project(cam: CameraIntrinsics, pts_cam: torch.Tensor) -> torch.Tensor:
    """Camera-frame 3D points (...,3) -> undistorted pixels (...,2), pure
    pinhole, depth clamped at 1e-6."""
    z = torch.clamp(pts_cam[..., 2], min=1e-6)
    return torch.stack(
        [cam.fx * pts_cam[..., 0] / z + cam.cx, cam.fy * pts_cam[..., 1] / z + cam.cy], dim=-1
    )


def project_stereo(cam: CameraIntrinsics, pts_cam: torch.Tensor) -> torch.Tensor:
    """Project to the stereo triple (uL, vL, uR) with uR = uL - bf/z."""
    uv = project(cam, pts_cam)
    z = torch.clamp(pts_cam[..., 2], min=1e-6)
    ur = uv[..., 0] - cam.bf / z
    return torch.cat([uv, ur[..., None]], dim=-1)


def backproject(
    cam: CameraIntrinsics, uv: torch.Tensor, depth: torch.Tensor
) -> torch.Tensor:
    """Pixels (...,2) + depth (...) -> camera-frame 3D (...,3)."""
    x = (uv[..., 0] - cam.cx) / cam.fx * depth
    y = (uv[..., 1] - cam.cy) / cam.fy * depth
    return torch.stack([x, y, depth], dim=-1)


def in_image(cam: CameraIntrinsics, uv: torch.Tensor, border: float = 0.0) -> torch.Tensor:
    """Bounds mask for pixel coords (...,2) -> (...,) bool, half-open:
    border <= u < width - border, likewise v."""
    u, v = uv[..., 0], uv[..., 1]
    return (
        (u >= border) & (u < cam.width - border)
        & (v >= border) & (v < cam.height - border)
    )
