"""Map and system checkpoints.

Port of ``ydorbslam_tpu/slam/serialize.py``, in the same file format, so
that a checkpoint written by either package loads into the other: one
compressed npz of numpy arrays and a JSON ``__meta__``.  Descriptors are
stored as uint32 (``convert`` views the port's int32 words as uint32 and
back), record reference keyframes as int64, lost flags as bool.

  * ``save_map``/``load_map``: the ``MapState`` arrays alone (version 1,
    unprefixed keys, as the JAX package's ``save_map`` writes them;
    ``load_map`` also reads version 2's ``map.`` keys);
  * ``save_system``/``load_system``: the map, the retrieval index, the
    tracker's pose, velocity and last frame, the system's counters and
    its frame records (version 2).  Saving reads the device once per
    tensor; loading uploads to the requested device.

What the JAX package drops, the port drops too: the loop closer starts
fresh (no pending verification, no consistency groups), the run
counters start fresh, and ``frames_since_reloc`` and the frame's
map-point ids are not saved.  The host's copies of the keyframe slot
mask and frame ids are rebuilt from the loaded map; the reference
keyframe's pose is read from it when first needed.  A loaded system
tracks synchronously until ``enable_pipelined`` is called again, which
starts the device state over, as in the JAX package.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from ..convert import (
    features_from_numpy, features_to_numpy, map_state_from_numpy, map_state_to_numpy,
    retrieval_index_from_numpy, retrieval_index_to_numpy,
)
from ..ops.extractor import FrameFeatures
from .map_state import MapState

_FORMAT_VERSION = 2


def _meta(m: MapState, version: int, **extra) -> np.ndarray:
    meta = dict(version=version, K=int(m.K), N=int(m.N), M=int(m.M), O=int(m.O), **extra)
    return np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)


def _read_meta(data) -> dict:
    return json.loads(bytes(data["__meta__"]).decode())


def save_map(m: MapState, path: str) -> None:
    """Write the map state (and its capacities) to a compressed npz."""
    arrays = map_state_to_numpy(m)
    arrays["__meta__"] = _meta(m, 1)
    np.savez_compressed(path, **arrays)


def load_map(path: str, device="cuda") -> MapState:
    """Read a map written by either package's ``save_map`` (version 1) or
    ``save_system`` (version 2) onto ``device``."""
    data = np.load(path)
    meta = _read_meta(data)
    if meta["version"] not in (1, 2):
        raise ValueError(f"unsupported map format version {meta['version']}")
    prefix = "map." if meta["version"] >= 2 else ""
    return map_state_from_numpy({f: data[prefix + f] for f in MapState._fields}, device)


def save_system(system, path: str) -> None:
    """Full checkpoint of a ``slam.system.SlamSystem``: map, retrieval
    index, tracker and frame records."""
    m = system.map
    arrays = {f"map.{k}": v for k, v in map_state_to_numpy(m).items()}
    arrays.update({f"retr.{k}": v for k, v in retrieval_index_to_numpy(system.retrieval).items()})
    tr = system.tracker
    arrays["trk.T_cw"] = tr.T_cw.cpu().numpy()
    arrays["trk.velocity"] = tr.velocity.cpu().numpy()
    # The last frame and its landmarks: the motion model's matching
    # source, so that the first resumed frame tracks straight through.
    if tr.last_feats is not None:
        arrays.update({f"trk.last.{k}": v for k, v in features_to_numpy(tr.last_feats).items()})
        arrays["trk.last_lms"] = tr.last_lms.cpu().numpy()
        arrays["trk.last_lms_valid"] = tr.last_lms_valid.cpu().numpy()
    recs = system.records
    arrays["rec.timestamp"] = np.asarray([r.timestamp for r in recs])
    arrays["rec.ref_kf"] = np.asarray([r.ref_kf for r in recs], np.int64)
    arrays["rec.T_c_ref"] = (
        np.stack([np.asarray(r.T_c_ref) for r in recs]) if recs else np.zeros((0, 4, 4))
    )
    arrays["rec.lost"] = np.asarray([r.lost for r in recs], bool)
    arrays["__meta__"] = _meta(
        m, _FORMAT_VERSION,
        ref_kf=int(system.ref_kf), n_keyframes=int(system.n_keyframes),
        frame_id=int(system.frame_id), frames_since_kf=int(system.frames_since_kf),
        tracker_state=tr.state.name, localization_only=bool(system.localization_only),
    )
    np.savez_compressed(path, **arrays)


def load_system(path: str, cfg, sensor=None, device="cuda", **system_kwargs):
    """Rebuild a ``SlamSystem`` on ``device`` from a checkpoint of either
    package.  ``cfg`` must have the capacities the checkpoint was saved
    with (``ValueError`` otherwise).  Tracking continues from the saved
    pose; ``activate_localization_mode()`` on the result relocalizes and
    tracks against the frozen map instead."""
    from .system import Sensor, SlamSystem, SystemRecord
    from .tracking import TrackingState

    data = np.load(path)
    meta = _read_meta(data)
    if meta["version"] != _FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint version {meta['version']}")
    system = SlamSystem(cfg, Sensor.RGBD if sensor is None else sensor, device=device,
                        **system_kwargs)
    m = system.map
    saved = tuple(meta[k] for k in "KNMO")
    if (m.K, m.N, m.M, m.O) != saved:
        raise ValueError(f"checkpoint capacities (K, N, M, O) = {saved} do not match the "
                         f"config's {(m.K, m.N, m.M, m.O)}")
    dev = system.device
    system.map = map_state_from_numpy({f: data["map." + f] for f in MapState._fields}, dev)
    system.retrieval = retrieval_index_from_numpy(
        {f: data["retr." + f] for f in ("hist", "presence", "valid")}, dev)
    tr = system.tracker
    tr.T_cw = torch.from_numpy(np.array(data["trk.T_cw"], np.float32)).to(dev)
    tr.new_T = tr.T_cw
    tr.velocity = torch.from_numpy(np.array(data["trk.velocity"], np.float32)).to(dev)
    if "trk.last_lms" in data:
        tr.last_feats = features_from_numpy(
            {f: data["trk.last." + f] for f in FrameFeatures._fields}, dev)
        tr.last_lms = torch.from_numpy(np.array(data["trk.last_lms"], np.float32)).to(dev)
        tr.last_lms_valid = torch.from_numpy(np.array(data["trk.last_lms_valid"], bool)).to(dev)
    tr.state = TrackingState[meta["tracker_state"]]
    system.ref_kf = meta["ref_kf"]
    system.n_keyframes = meta["n_keyframes"]
    system.frame_id = meta["frame_id"]
    system.frames_since_kf = meta["frames_since_kf"]
    system.localization_only = meta["localization_only"]
    ts, ref, T_c_ref, lost = (data["rec." + k] for k in ("timestamp", "ref_kf", "T_c_ref", "lost"))
    system.records = [
        SystemRecord(timestamp=float(ts[i]), ref_kf=int(ref[i]), T_c_ref=T_c_ref[i],
                     lost=bool(lost[i]))
        for i in range(len(ts))
    ]
    # The host's copies of the slot mask and frame ids, which keyframe
    # allocation and the loop closer's staleness guard read; the reference
    # keyframe's pose (the pipelined records' base) is read from the loaded
    # map when first needed, and no deferred snapshot is pending (the JAX
    # package's cleared ``_snap`` and ``_pending_snap``).
    system._host_kf_valid = system.map.kf_valid.cpu().numpy().copy()
    system._host_kf_frame_id = system.map.kf_frame_id.cpu().numpy().astype(np.int64)
    system._host_ref_pose = None
    system._pending_snap = None
    return system
