"""Carry the JAX package's state over to the port.

SLAM has no learned weights: the state that has to carry across is the
configuration, the camera, a frame's features, the tracker's state, the
pipelined path's device state and tracking set, the map, the
place-recognition index and a bundle-adjustment problem.  Every function here takes plain
numpy arrays (call ``np.asarray`` on the JAX side), so this module
imports neither JAX nor the JAX package.  With these a test can load a
JAX tracker or map in the middle of a sequence into the port and step
both.  Descriptors keep their uint32 bits: they travel as int32 views
into the port and back.
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
from .optim.schur import BAProblem
from .slam.map_state import MapState
from .slam.pipeline import TrackSet, TrackState
from .slam.retrieval import RetrievalIndex
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


def _desc_in(desc, device) -> torch.Tensor:
    desc = np.asarray(desc)
    if desc.dtype != np.uint32:
        raise ValueError(f"descriptors must be uint32, got {desc.dtype}")
    return _t(desc.view(np.int32), device)


# MapState fields that hold descriptors, and the dtype of every other field.
_MAP_DESC = ("kf_desc", "mp_desc")
_MAP_DTYPES = dict(
    kf_valid=torch.bool, kf_frame_id=torch.int32, kf_octave=torch.int32,
    kf_kp_valid=torch.bool, kf_mp=torch.int32, mp_valid=torch.bool,
    mp_ref_kf=torch.int32, mp_first_kf=torch.int32, mp_found=torch.int32,
    mp_visible=torch.int32, mp_obs_kf=torch.int32, mp_obs_kp=torch.int32,
    mp_obs_oct=torch.int32, mp_obs_stereo=torch.bool, covis=torch.int32,
    parent=torch.int32, loop_edge=torch.int32,
)


def map_state_from_numpy(fields: Mapping[str, np.ndarray], device="cpu") -> MapState:
    """``MapState`` from a mapping of field name -> numpy array (for
    example ``{k: np.asarray(v) for k, v in jax_map._asdict().items()}``).
    Descriptor words keep their uint32 bits, viewed as int32."""
    out = {}
    for name in MapState._fields:
        if name in _MAP_DESC:
            out[name] = _desc_in(fields[name], device)
        else:
            out[name] = _t(fields[name], device, _MAP_DTYPES.get(name, torch.float32))
    return MapState(**out)


def map_state_to_numpy(m: MapState) -> dict:
    """The inverse of ``map_state_from_numpy``: field name -> numpy array,
    descriptors as uint32."""
    out = {}
    for name, v in m._asdict().items():
        a = v.cpu().numpy()
        out[name] = a.view(np.uint32) if name in _MAP_DESC else a
    return out


def retrieval_index_from_numpy(fields: Mapping[str, np.ndarray], device="cpu") -> RetrievalIndex:
    """``RetrievalIndex`` from a mapping of field name -> numpy array of a
    JAX ``RetrievalIndex`` (hist, presence, valid)."""
    return RetrievalIndex(
        hist=_t(fields["hist"], device, torch.float32),
        presence=_t(fields["presence"], device, torch.float32),
        valid=_t(fields["valid"], device, torch.bool),
    )


def retrieval_index_to_numpy(idx: RetrievalIndex) -> dict:
    """The inverse of ``retrieval_index_from_numpy``."""
    return {name: v.cpu().numpy() for name, v in idx._asdict().items()}


def ba_problem_from_numpy(fields: Mapping[str, np.ndarray], device="cpu") -> BAProblem:
    """``BAProblem`` from a mapping of field name -> numpy array of a JAX
    ``BAProblem``."""
    dtypes = dict(
        cam_fixed=torch.bool, cam_valid=torch.bool, pt_valid=torch.bool,
        obs_cam=torch.int32, obs_stereo=torch.bool, obs_valid=torch.bool,
    )
    return BAProblem(**{
        name: _t(fields[name], device, dtypes.get(name, torch.float32))
        for name in BAProblem._fields
    })


def features_from_numpy(feats: Mapping[str, np.ndarray], device="cpu") -> FrameFeatures:
    """``FrameFeatures`` from a mapping of field name -> numpy array (for
    example ``{k: np.asarray(v) for k, v in jax_feats._asdict().items()}``).
    The uint32 descriptor words keep their bits, viewed as int32."""
    return FrameFeatures(
        uv=_t(feats["uv"], device, torch.float32),
        uv_raw=_t(feats["uv_raw"], device, torch.float32),
        response=_t(feats["response"], device, torch.float32),
        octave=_t(feats["octave"], device, torch.int32),
        angle=_t(feats["angle"], device, torch.float32),
        desc=_desc_in(feats["desc"], device),
        right_u=_t(feats["right_u"], device, torch.float32),
        depth=_t(feats["depth"], device, torch.float32),
        valid=_t(feats["valid"], device, torch.bool),
    )


def features_to_numpy(f: FrameFeatures) -> dict:
    """The inverse of ``features_from_numpy``: field name -> numpy array,
    descriptors as uint32."""
    out = {name: v.cpu().numpy() for name, v in f._asdict().items()}
    out["desc"] = out["desc"].view(np.uint32)
    return out


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


# TrackState fields besides the two feature sets, by dtype.
_STATE_DTYPES = dict(
    mode=torch.int32, last_lms_valid=torch.bool, ring_mpid=torch.int32,
    frame_idx=torch.int32, since_reloc=torch.int32, vis_acc=torch.int32,
    found_acc=torch.int32,
)


def track_state_from_numpy(fields: Mapping[str, Any], device="cpu") -> TrackState:
    """``TrackState`` of the pipelined path from a mapping of field name ->
    numpy array, where ``last`` and ``ring_feats`` are themselves mappings
    of feature field -> array (``features_from_numpy``'s input; the ring's
    arrays carry the leading ``RING`` axis)."""
    out = {}
    for name in TrackState._fields:
        if name in ("last", "ring_feats"):
            out[name] = features_from_numpy(fields[name], device)
        else:
            out[name] = _t(fields[name], device, _STATE_DTYPES.get(name, torch.float32))
    return TrackState(**out)


def track_state_to_numpy(state: TrackState) -> dict:
    """The inverse of ``track_state_from_numpy``."""
    return {
        name: features_to_numpy(v) if name in ("last", "ring_feats") else v.cpu().numpy()
        for name, v in state._asdict().items()
    }


def track_set_from_numpy(fields: Mapping[str, np.ndarray], device="cpu") -> TrackSet:
    """``TrackSet`` from a mapping of field name -> numpy array (point ids
    as int64, the port's own type; descriptors uint32, viewed as int32)."""
    dtypes = dict(pts=torch.int64, valid=torch.bool)
    return TrackSet(**{
        name: _desc_in(fields[name], device) if name == "desc"
        else _t(fields[name], device, dtypes.get(name, torch.float32))
        for name in TrackSet._fields
    })
