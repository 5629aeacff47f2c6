"""Synthetic sensor streams of the benchmark, made from a seed.

A vectorised, frozen copy of the dot-world generators the port's tests
and tools use: ``tests/synthetic.py`` (``make_landmarks``,
``_landmark_patch``, ``render_dots``, ``oscillating_trajectory``,
``SyntheticRgbdSequence.frame``), ``bench.make_frames`` (the RGB-D
encoding) and ``ydorbslam_tpu_torch.testing.make_stereo_frames`` (the
rectified pair).  The loops over landmarks of the originals are replaced
by one nearest-wins reduction per image, which gives the same pixels:
the originals paint far landmarks first, so the nearest landmark that
covers a pixel sets it.

The "xyz" oscillation repeats exactly every ``PERIOD`` frames (its terms
have periods of 40, 400/7, 80 and 400/9 frames), so one period is made
once and replayed: frame ``k`` of a stream shows period frame
``k % PERIOD`` with the timestamp ``k / fps``, and the camera simply
continues its motion for a window of any length.

The seed draws the landmarks' textures.  The landmark field and the
motion are the configuration's own, so every seed brings the same
geometry, the same frame sizes and the same arrivals, and other
descriptors: the work of a run depends on the seed as little as it can
while its inputs still do.
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
from scipy.spatial.transform import Rotation

PERIOD = 400
DEPTH_BORDER = 10  # px: depth is written only this far inside the image


class Stream(NamedTuple):
    """One period of a sensor stream: ``images[i]`` is (gray, depth) for
    RGB-D or (left, right) for stereo, ``poses[i]`` the ground-truth T_cw
    of period frame i (the left camera's for stereo)."""

    sensor: str
    fps: float
    images: List[tuple]
    poses: np.ndarray  # (PERIOD, 4, 4) float64

    def frame(self, k: int):
        """Frame ``k`` of the stream: (timestamp, image, image)."""
        a, b = self.images[k % PERIOD]
        return k / self.fps, a, b

    def pose(self, k: int) -> np.ndarray:
        return self.poses[k % PERIOD]


def make_landmarks(rng, n, x=6.0, y=4.0, z=(2.0, 8.0)) -> np.ndarray:
    """``tests/synthetic.make_landmarks``: uniform in a box ahead of the origin."""
    return np.stack([rng.uniform(-x, x, n), rng.uniform(-y, y, n),
                     rng.uniform(z[0], z[1], n)], axis=-1).astype(np.float64)


def landmark_patches(n: int, dot: int, seed=None) -> np.ndarray:
    """(n, dot, dot) float32: ``tests/synthetic._landmark_patch`` of every
    landmark, a texture of its own with a peaked centre, drawn from
    ``seed`` (None: the original's seed of each landmark, 1000 + i)."""
    out = np.empty((n, dot, dot), np.float32)
    c = dot // 2
    for i in range(n):
        r = np.random.default_rng(1000 + i if seed is None else [seed % 2**63, i])
        patch = r.uniform(30.0, 130.0, (dot, dot)).astype(np.float32)
        if dot >= 5:
            patch[c - 1:c + 2, c - 1:c + 2] = r.uniform(150.0, 250.0, (3, 3))
        patch[c, c] = 255.0
        out[i] = patch
    return out


def oscillating_poses(n_frames: int, amp=(0.25, 0.18, 0.12), period=40.0,
                      yaw_amp=0.02) -> np.ndarray:
    """(n, 4, 4) world-to-camera poses of ``tests/synthetic.oscillating_trajectory``."""
    ph = 2 * np.pi * np.arange(n_frames) / period
    c_w = np.stack([amp[0] * np.sin(ph), amp[1] * np.sin(0.7 * ph + 1.0),
                    amp[2] * np.sin(0.5 * ph + 2.0)], -1)
    R_wc = Rotation.from_euler("y", (yaw_amp * np.sin(0.9 * ph))[:, None]).as_matrix()
    T = np.tile(np.eye(4), (n_frames, 1, 1))
    T[:, :3, :3] = np.transpose(R_wc, (0, 2, 1))
    T[:, :3, 3] = -np.einsum("nji,nj->ni", R_wc, c_w)
    return T


def project(K, T_cw, pts):
    """``tests/synthetic.project_np``: (uv (N, 2), z (N,))."""
    pc = pts @ T_cw[:3, :3].T + T_cw[:3, 3]
    z = pc[:, 2]
    uv = np.stack([K[0, 0] * pc[:, 0] / z + K[0, 2], K[1, 1] * pc[:, 1] / z + K[1, 2]], -1)
    return uv, z


def _nearest_wins(u, v, z, W, H, offsets):
    """For landmarks at integer centres (u, v) with depths z, and the
    pixel offsets (dy, dx) each one covers: the flat pixel index of every
    (landmark, offset) pair, and the depth image of the nearest cover
    (inf where none)."""
    dy, dx = offsets
    pix = ((v[:, None] + dy[None, :]) * W + (u[:, None] + dx[None, :])).ravel()
    zrep = np.repeat(z, dy.size)
    zimg = np.full(H * W, np.inf)
    np.minimum.at(zimg, pix, zrep)
    return pix, zrep, zimg


def render_dots(uv, z, W, H, dot, patches, background=20.0) -> np.ndarray:
    """``tests/synthetic.render_dots``: float32 (H, W), each landmark's
    patch centred on its rounded projection, nearer landmarks on top."""
    r = dot // 2
    u, v = np.rint(uv[:, 0]), np.rint(uv[:, 1])
    keep = ((z > 0.1) & (r + 8 <= u) & (u < W - r - 8) & (r + 8 <= v) & (v < H - r - 8))
    idx = np.nonzero(keep)[0]
    u, v = u[idx].astype(np.int64), v[idx].astype(np.int64)
    dy, dx = np.meshgrid(np.arange(-r, r + 1), np.arange(-r, r + 1), indexing="ij")
    pix, zrep, zimg = _nearest_wins(u, v, z[idx], W, H, (dy.ravel(), dx.ravel()))
    win = zrep == zimg[pix]
    img = np.full(H * W, background, np.float32)
    img[pix[win]] = patches[idx].reshape(idx.size, -1).ravel()[win]
    return img.reshape(H, W)


def render_depth(uv, z, W, H) -> np.ndarray:
    """The z-buffer of ``SyntheticRgbdSequence.frame``: float32 (H, W)
    metres, a 4x4 block per landmark (rows and columns -1..+2 of its
    rounded projection), the nearest on top, 0 where none."""
    u, v = np.rint(uv[:, 0]), np.rint(uv[:, 1])
    b = DEPTH_BORDER
    keep = (b <= u) & (u < W - b) & (b <= v) & (v < H - b) & (z > 0.1)
    idx = np.nonzero(keep)[0]
    dy, dx = np.meshgrid(np.arange(-1, 3), np.arange(-1, 3), indexing="ij")
    _, _, zimg = _nearest_wins(u[idx].astype(np.int64), v[idx].astype(np.int64), z[idx],
                               W, H, (dy.ravel(), dx.ravel()))
    return np.where(np.isfinite(zimg), zimg, 0.0).astype(np.float32).reshape(H, W)


def make_stream(cfg: dict, seed) -> Stream:
    """One period of the stream of configuration ``cfg`` (its ``camera``
    and ``scene``: the landmark field of ``scene.landmark_seed``), the
    landmarks' textures drawn from ``seed`` (None: the originals')."""
    cam, sc = cfg["camera"], cfg["scene"]
    W, H = cam["width"], cam["height"]
    K = np.array([[cam["fx"], 0, cam["cx"]], [0, cam["fy"], cam["cy"]], [0, 0, 1.0]])
    pts = make_landmarks(np.random.default_rng(sc["landmark_seed"]), sc["landmarks"])
    patches = landmark_patches(sc["landmarks"], sc["dot"], seed)
    poses = oscillating_poses(PERIOD)
    images = []
    if sc["sensor"] == "rgbd":
        factor = cfg["depth"]["depth_map_factor"]
        for T in poses:
            uv, z = project(K, T, pts)
            gray = render_dots(uv, z, W, H, sc["dot"], patches).astype(np.uint8)
            depth = (render_depth(uv, z, W, H) * factor).astype(np.uint16)
            images.append((gray, depth))
    elif sc["sensor"] == "stereo":
        baseline = cam["bf"] / cam["fx"]
        for T in poses:
            T_r = T.copy()
            T_r[0, 3] -= baseline  # the right camera, b along the left camera's x
            images.append(tuple(
                render_dots(*project(K, pose, pts), W, H, sc["dot"], patches).astype(np.uint8)
                for pose in (T, T_r)))
    else:
        raise ValueError(f"unknown sensor {sc['sensor']!r}")
    return Stream(sc["sensor"], float(cam["fps"]), images, poses)
