"""KITTI odometry (stereo) dataset loading.

Copy of ``ydorbslam_tpu/io/kitti.py`` (numpy and PIL only).

The reference ships only a TUM RGB-D driver (test/src/test.cpp), but its
System supports stereo via ``trackStereo`` (src/system.hpp:45); KITTI is
the standard stereo benchmark (BASELINE.md config 4).  Sequence layout:
``sequences/NN/image_0`` (left gray), ``image_1`` (right gray),
``times.txt``; calibration from ``calib.txt`` row ``P0``/``P1``.
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from .tum import load_image_gray


def load_kitti_calib(calib_path: str):
    """Parse calib.txt -> dict of 3x4 projection matrices."""
    out = {}
    with open(calib_path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, vals = line.split(":", 1)
            arr = np.fromstring(vals, sep=" ", dtype=np.float64)
            if arr.size == 12:
                out[key.strip()] = arr.reshape(3, 4)
    return out


def kitti_intrinsics(calib_path: str):
    """Return (fx, fy, cx, cy, bf) from P0/P1 of a KITTI calib file.

    bf = -P1[0,3] (P1's fourth column is -fx * baseline).
    """
    P = load_kitti_calib(calib_path)
    P0, P1 = P["P0"], P["P1"]
    fx, fy, cx, cy = P0[0, 0], P0[1, 1], P0[0, 2], P0[1, 2]
    bf = -P1[0, 3]
    return float(fx), float(fy), float(cx), float(cy), float(bf)


class KittiStereoDataset:
    """Iterable (timestamp, left_gray, right_gray) frames."""

    def __init__(self, sequence_dir: str):
        self.dir = sequence_dir
        with open(os.path.join(sequence_dir, "times.txt")) as f:
            self.times = [float(x) for x in f.read().split()]
        self.left_dir = os.path.join(sequence_dir, "image_0")
        self.right_dir = os.path.join(sequence_dir, "image_1")

    def __len__(self):
        return len(self.times)

    def __getitem__(self, i: int) -> Tuple[float, np.ndarray, np.ndarray]:
        name = f"{i:06d}.png"
        return (
            self.times[i],
            load_image_gray(os.path.join(self.left_dir, name)),
            load_image_gray(os.path.join(self.right_dir, name)),
        )
