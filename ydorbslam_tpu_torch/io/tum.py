"""TUM RGB-D dataset loading.

Copy of ``ydorbslam_tpu/io/tum.py`` (numpy and PIL only), so the port
imports nothing of the JAX package.  Replaces the reference's
driver-side dataset handling: the association file parser
(test/src/test.cpp:115-140: lines of ``t_rgb rgb_path t_depth
depth_path``) and the per-frame ``cv::imread`` + grayscale conversion +
``DepthMapFactor`` rescale (src/tracking.cpp:96-118).  Decoding happens
on the host; the device only ever sees the decoded arrays.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np


@dataclass
class TumAssociation:
    timestamps: List[float]
    rgb_paths: List[str]
    depth_paths: List[str]

    def __len__(self):
        return len(self.timestamps)


def parse_association(assoc_path: str) -> TumAssociation:
    """Parse a TUM association file (``t_rgb rgb t_depth depth`` lines).

    Same contract as test/src/test.cpp:115-140: the RGB timestamp is the
    frame timestamp.
    """
    ts, rgbs, depths = [], [], []
    with open(assoc_path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) < 4:
                continue
            ts.append(float(parts[0]))
            rgbs.append(parts[1])
            depths.append(parts[3])
    return TumAssociation(ts, rgbs, depths)


def load_image_gray(path: str, is_rgb_order: bool = True) -> np.ndarray:
    """Load an image as SENSOR-NATIVE uint8 grayscale, shape (H, W).

    Uses the Rec.601 luma weights of ``cv::cvtColor``
    (src/tracking.cpp:99-106); PIL's 'L' mode uses the same weights.
    uint8 ships 4x less host->device data than a float32 conversion;
    the device converts (ops/extractor.extract_orb).

    ``is_rgb_order``: the Camera.RGB flag (tracking.cpp:73).  True =
    the decoded channels are labeled correctly (the PNG spec case);
    False = the file carries BGR-swapped channels (cameras that write
    OpenCV buffers verbatim), so the R/B luma weights swap.
    """
    from PIL import Image

    img = Image.open(path)
    if img.mode in ("I;16", "I"):
        # Scale 16-bit gray to 8-bit (keep high byte) — clipping would
        # saturate genuine 16-bit input to near-white.
        a = np.asarray(img)
        return (np.clip(a, 0, 65535).astype(np.uint16) >> 8).astype(np.uint8)
    if img.mode == "L":
        return np.asarray(img, dtype=np.uint8)
    if not is_rgb_order:
        a = np.asarray(img.convert("RGB"), dtype=np.float32)[..., ::-1]
        gray = a[..., 0] * 0.299 + a[..., 1] * 0.587 + a[..., 2] * 0.114
        return np.clip(np.round(gray), 0, 255).astype(np.uint8)
    return np.asarray(img.convert("L"), dtype=np.uint8)


def load_depth(path: str, depth_map_factor: float) -> np.ndarray:
    """Load a TUM 16-bit depth PNG -> float32 meters (0 = invalid).

    Equivalent to the reference's ``convertTo(CV_32F, 1/DepthMapFactor)``
    (src/tracking.cpp:108-114).
    """
    from PIL import Image

    img = Image.open(path)
    arr = np.asarray(img, dtype=np.float32)
    if arr.ndim == 3:
        arr = arr[..., 0]
    return arr / float(depth_map_factor)


def load_depth_raw(path: str) -> np.ndarray:
    """Load a TUM 16-bit depth PNG as RAW uint16 (sensor-native; the
    device applies 1/DepthMapFactor — slam/tracking.Tracker.track_rgbd)."""
    from PIL import Image

    img = Image.open(path)
    arr = np.asarray(img)
    if arr.ndim == 3:
        arr = arr[..., 0]
    return arr.astype(np.uint16)


class TumRgbdDataset:
    """Iterable (timestamp, gray, depth) frames for a TUM sequence.

    ``is_rgb``: the Camera.RGB channel-order flag from the settings YAML
    (config.CameraConfig.is_rgb; tracking.cpp:73)."""

    def __init__(self, sequence_dir: str, assoc_path: str,
                 depth_map_factor: float, is_rgb: bool = True):
        self.dir = sequence_dir
        self.assoc = parse_association(assoc_path)
        self.depth_map_factor = depth_map_factor
        self.is_rgb = is_rgb

    def __len__(self):
        return len(self.assoc)

    def __getitem__(self, i: int) -> Tuple[float, np.ndarray, np.ndarray]:
        rgb = os.path.join(self.dir, self.assoc.rgb_paths[i])
        dep = os.path.join(self.dir, self.assoc.depth_paths[i])
        return (
            self.assoc.timestamps[i],
            load_image_gray(rgb, is_rgb_order=self.is_rgb),
            load_depth_raw(dep),
        )
