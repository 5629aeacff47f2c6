"""Carry the JAX package's state over to the port.

SLAM has no learned weights: the state that has to carry across is the
configuration, the camera, a frame's features and the tracker's state.
Every function here takes plain numpy arrays (call ``np.asarray`` on
the JAX side), so this module imports neither JAX nor the JAX package.
With these a test can load a JAX tracker in the middle of a sequence
into the port and compare one step.
"""
from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch

from .config import (
    CameraConfig, CapacityConfig, DepthConfig, LoopConfig, MappingConfig,
    MatcherConfig, OptimConfig, OrbConfig, SlamConfig, TrackingConfig,
)
from .geometry.camera import CameraIntrinsics
from .ops.extractor import FrameFeatures
from .slam.tracking import Tracker, TrackingState

_SECTIONS = dict(
    camera=CameraConfig, orb=OrbConfig, depth=DepthConfig, matcher=MatcherConfig,
    tracking=TrackingConfig, mapping=MappingConfig, loop=LoopConfig,
    optim=OptimConfig, capacity=CapacityConfig,
)


def config_from_dict(d: Mapping[str, Mapping[str, Any]]) -> SlamConfig:
    """``SlamConfig`` from ``dataclasses.asdict`` of a JAX ``SlamConfig``
    (the two dataclasses have the same fields)."""
    return SlamConfig(**{k: cls(**d[k]) for k, cls in _SECTIONS.items()})


def camera_from_numpy(cam: Sequence, device="cpu") -> CameraIntrinsics:
    """``CameraIntrinsics`` from the fields of a JAX ``CameraIntrinsics``
    in order (fx, fy, cx, cy, k1, k2, p1, p2, k3, bf, width, height)."""
    *params, width, height = cam
    return CameraIntrinsics.create(
        *(np.float32(np.asarray(p)) for p in params), int(width), int(height),
        device=device,
    )


def _t(x, device, dtype=None):
    return torch.from_numpy(np.array(x)).to(device=device, dtype=dtype)


def features_from_numpy(feats: Mapping[str, np.ndarray], device="cpu") -> FrameFeatures:
    """``FrameFeatures`` from a mapping of field name -> numpy array (for
    example ``{k: np.asarray(v) for k, v in jax_feats._asdict().items()}``).
    The uint32 descriptor words keep their bits, viewed as int32."""
    desc = np.asarray(feats["desc"])
    if desc.dtype != np.uint32:
        raise ValueError(f"descriptors must be uint32, got {desc.dtype}")
    return FrameFeatures(
        uv=_t(feats["uv"], device, torch.float32),
        uv_raw=_t(feats["uv_raw"], device, torch.float32),
        response=_t(feats["response"], device, torch.float32),
        octave=_t(feats["octave"], device, torch.int32),
        angle=_t(feats["angle"], device, torch.float32),
        desc=_t(desc.view(np.int32), device),
        right_u=_t(feats["right_u"], device, torch.float32),
        depth=_t(feats["depth"], device, torch.float32),
        valid=_t(feats["valid"], device, torch.bool),
    )


def tracker_state_from_numpy(
    tracker: Tracker,
    *,
    T_cw: np.ndarray,
    velocity: np.ndarray,
    last_feats: Mapping[str, np.ndarray],
    last_lms: np.ndarray,
    last_lms_valid: np.ndarray,
    state: int,
) -> Tracker:
    """Load a JAX tracker's state (pose, velocity, last frame, its
    landmarks and the state enum's value) into a port ``Tracker``."""
    dev = tracker.device
    tracker.T_cw = _t(T_cw, dev, torch.float32)
    tracker.velocity = _t(velocity, dev, torch.float32)
    tracker.last_feats = features_from_numpy(last_feats, dev)
    tracker.last_lms = _t(last_lms, dev, torch.float32)
    tracker.last_lms_valid = _t(last_lms_valid, dev, torch.bool)
    tracker.state = TrackingState(int(state))
    return tracker
