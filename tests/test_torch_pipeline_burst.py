"""The pipelined path's first keyframe burst at bench.py's configuration:
the port against the JAX package on JAX's own state, on the CPU.

bench.py's pipelined run (``enable_pipelined(lag=16)`` at
``bench.make_system``'s configuration: 1000 features, 160 keyframe and
16,384 map-point slots) drains after frame 38 a burst: the keyframes of
frames 26-38, two frames apart, each through ``mapping_prep`` (K3), then
one deferred local BA (``mapping_finish``, K4) on the newest.  The module
fixture runs the JAX package's pipelined path in ``bench.run``'s call
sequence over frames 0-39 of ``bench.make_frames()`` and captures the
inputs and outputs of that drain's calls and of frame 39's step, the first
on the burst's map; each goes through the port's counterpart on JAX's
inputs.

Tolerances:

* each ``mapping_prep``: the keyframe graph and the point counters exact;
  the bindings (``kf_mp``, ``mp_obs_kf``, ``mp_valid``) at
  ``test_torch_mapping_system``'s 99.5 %; the map points' median
  difference within 1e-3 m, its bound for BA-moved floats, and every point
  within ``chip_smoke.PIPE_PREP_MAX_M`` (0.05 m): the last two keyframes'
  triangulations, at two frames of baseline and 4-8 m of depth, are
  ill-conditioned (the reference's parallax test is off) and differ by up
  to 2 cm; the median does not move.  The comparisons are
  ``chip_smoke._map_diff``'s, which phase 17 applies to the card.
* ``mapping_finish``: the keyframe graph exact, bindings at 99.5 %, the
  snapshot's keyframe rows exact.  Its floats are held to the reference's
  own spread, because this BA is chaotic in the JAX package itself: JAX's
  BA on the same input with one coordinate of one map point one ulp
  larger (six such inputs, seeds 0-5) moves keyframe pose entries by up
  to ~0.045 and the map points by a median of up to ~0.33 m.  The port's
  answer lies within 1.5x of the widest of those (the ratio that
  ``chip_smoke.py`` allows against JAX's figures): pose entries, points'
  median and 90th percentile.
* frame 39's step on the burst's map: mode, ok and need_kf exact, inliers
  within 2 (T10), the pose within 1e-4 m and 1e-4 rad.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bench  # noqa: E402
from chip_smoke import PIPE_PREP_MAX_M, _map_diff, _nudged  # noqa: E402
from test_torch_mapstate import map_np
from test_torch_pipeline import _np, _port_step, _rot_err

from ydorbslam_tpu.config import (
    CameraConfig, CapacityConfig, DepthConfig, OrbConfig, SlamConfig, TrackingConfig,
)
from ydorbslam_tpu.slam import mapping as jmapping
from ydorbslam_tpu.slam import pipeline as jpipeline
from ydorbslam_tpu.slam.map_state import MapState as JaxMap
from ydorbslam_tpu.slam.system import Sensor as JaxSensor
from ydorbslam_tpu.slam.system import SlamSystem as JaxSystem

from ydorbslam_tpu_torch.convert import (
    config_from_dict, map_state_from_numpy, map_state_to_numpy,
)
from ydorbslam_tpu_torch.slam import mapping as pmapping
from ydorbslam_tpu_torch.slam import pipeline as ppipeline
from ydorbslam_tpu_torch.slam.system import Sensor, SlamSystem

torch.set_num_threads(2)

N_FRAMES = 40  # frames 0-39: the burst drains in frame 38's call, 39 steps on its map
BURST_FRAME_ID = 39  # the system's frame counter during that drain
BURST_KFS = 7
N_ULP = 6  # one-ulp nudges of JAX's BA input


def bench_cfg():
    """``bench.make_system``'s configuration (``chip_smoke._config()``)."""
    return SlamConfig(
        tracking=TrackingConfig(min_init_depth_points=100),
        camera=CameraConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=50.0, width=640,
                            height=480),
        orb=OrbConfig(n_features=1000), depth=DepthConfig(depth_map_factor=5000.0),
        capacity=CapacityConfig(max_keyframes=160, max_map_points=16384),
    )


@pytest.fixture(scope="module")
def burst():
    frames = bench.make_frames()[:N_FRAMES]
    orig = dict(step=jpipeline.rgbd_frame_step, prep=jmapping.mapping_prep,
                finish=jmapping.mapping_finish)
    cap = dict(calls=[], steps=0)
    jax_sys = JaxSystem(bench_cfg(), JaxSensor.RGBD, enable_loop_closing=False)

    def step(state, gray, depth, trkset, cam, inv_sigma2_tab, depth_threshold, **kw):
        i = cap["steps"]
        cap["steps"] += 1
        if i != N_FRAMES - 1:
            return orig["step"](state, gray, depth, trkset, cam, inv_sigma2_tab,
                                depth_threshold, **kw)
        rec = dict(state=_np(state), gray=np.array(gray), depth=np.array(depth),
                   trkset=_np(trkset), depth_threshold=float(depth_threshold),
                   kw={k: float(v) if k == "depth_scale" else v for k, v in kw.items()})
        out = orig["step"](state, gray, depth, trkset, cam, inv_sigma2_tab, depth_threshold,
                           **kw)
        cap["step"] = dict(rec, out=_np(out))
        return out

    def prep(m, kf_id, kf_count, cam, **kw):
        rec = dict(kind="prep", frame_id=jax_sys.frame_id, map=map_np(m), kf_id=int(kf_id),
                   kf_count=int(kf_count), kw=kw)
        out = orig["prep"](m, kf_id, kf_count, cam, **kw)
        cap["calls"].append(dict(rec, out=map_np(out)))
        return out

    def finish(m, kf_id, cam, inv_sigma2_tab, depth_threshold, **kw):
        rec = dict(kind="finish", frame_id=jax_sys.frame_id, map=map_np(m), kf_id=int(kf_id),
                   depth_threshold=float(depth_threshold), kw=kw)
        out = orig["finish"](m, kf_id, cam, inv_sigma2_tab, depth_threshold, **kw)
        cap["calls"].append(dict(rec, out=map_np(out[0]), snap=np.array(out[1])))
        return out

    jpipeline.rgbd_frame_step, jmapping.mapping_prep, jmapping.mapping_finish = (
        step, prep, finish)
    try:
        jax_sys.enable_pipelined(lag=16)
        for f in frames[:20]:  # bench.run: the warm-up, a flush, the rest
            jax_sys.track_rgbd_pipelined(*f)
        jax_sys.flush_pipeline()
        for f in frames[20:]:
            jax_sys.track_rgbd_pipelined(*f)
    finally:
        jpipeline.rgbd_frame_step, jmapping.mapping_prep, jmapping.mapping_finish = (
            orig["step"], orig["prep"], orig["finish"])
    calls = [c for c in cap["calls"] if c["frame_id"] == BURST_FRAME_ID]
    port = SlamSystem(config_from_dict(dataclasses.asdict(bench_cfg())), Sensor.RGBD,
                      enable_mapping=True, enable_loop_closing=False, device="cpu")
    return dict(calls=calls, step=cap["step"], jax=jax_sys, port=port)


def test_the_drain_after_frame_38_is_a_burst(burst):
    """The scenario the other tests rely on: seven ``mapping_prep`` calls
    on keyframes 2-8 in one drain, then one deferred BA on the newest."""
    kinds = [(c["kind"], c["kf_id"]) for c in burst["calls"]]
    assert kinds == [("prep", k) for k in range(2, 2 + BURST_KFS)] + [("finish", BURST_KFS + 1)]


@pytest.mark.parametrize("i", range(BURST_KFS))
def test_burst_mapping_prep_matches_jax(burst, i):
    c = burst["calls"][i]
    system = burst["port"]
    m = pmapping.mapping_prep(map_state_from_numpy(c["map"]), c["kf_id"], c["kf_count"],
                              system.cam, **c["kw"])
    p, ref = map_state_to_numpy(m), c["out"]
    graph, bind, d = _map_diff(p, ref)
    assert not graph and bind > 0.995, (graph, bind)
    np.testing.assert_array_equal(p["kf_pose"], ref["kf_pose"])
    assert d[1] < 1e-3 and d[3] < PIPE_PREP_MAX_M, d


def test_burst_deferred_ba_within_the_references_spread(burst):
    c = burst["calls"][-1]
    assert c["kind"] == "finish"
    system, jax_sys = burst["port"], burst["jax"]
    m, snap = pmapping.mapping_finish(map_state_from_numpy(c["map"]), c["kf_id"], system.cam,
                                      system.inv_sigma2_tab,
                                      torch.tensor(np.float32(c["depth_threshold"])), **c["kw"])
    p, ref = map_state_to_numpy(m), c["out"]
    graph, bind, diff = _map_diff(p, ref)
    assert not graph and bind > 0.995, (graph, bind)
    K = ref["kf_valid"].shape[0]
    np.testing.assert_array_equal(snap[:4 * K].numpy(), c["snap"][:4 * K])
    spread = np.zeros(4)
    for seed in range(N_ULP):
        jm = JaxMap(**_nudged(c["map"], seed))
        out, _ = jmapping.mapping_finish(jm, c["kf_id"], jax_sys.cam, jax_sys.inv_sigma2_tab,
                                         np.float32(c["depth_threshold"]), **c["kw"])
        spread = np.maximum(spread, _map_diff(map_np(out), ref)[2])
    # The reference itself is chaotic here: a one-ulp nudge moves its answer by
    # centimetres in the poses and decimetres in the points.
    assert spread[0] > 1e-3 and spread[1] > 1e-2, spread
    assert (diff[:3] <= 1.5 * spread[:3]).all(), (diff, spread)


def test_step_on_the_burst_map_matches_jax(burst):
    rec = burst["step"]
    assert int(rec["state"]["mode"]) == ppipeline.MODE_OK
    out, slot = _port_step(rec, burst["port"])
    a = ppipeline.FrameInfo.unpack(out["ring_info"][slot])
    b = jpipeline.FrameInfo.unpack(rec["out"]["ring_info"][slot])
    assert (a.mode, a.ok, a.need_kf) == (b.mode, b.ok, b.need_kf), (a, b)
    assert abs(a.n_inliers - b.n_inliers) <= 2, (a.n_inliers, b.n_inliers)
    cp, cj = -a.T_cw[:3, :3].T @ a.T_cw[:3, 3], -b.T_cw[:3, :3].T @ b.T_cw[:3, 3]
    assert np.abs(cp - cj).max() < 1e-4
    assert _rot_err(a.T_cw[:3, :3], b.T_cw[:3, :3]) < 1e-4
