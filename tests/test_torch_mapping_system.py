"""The port's mapping-on slice end to end against the JAX package on the CPU.

``SlamSystem(cfg, Sensor.RGBD, enable_mapping=True,
enable_loop_closing=False)`` of both packages tracks the same frames of a
``SyntheticRgbdSequence`` under ``test_slam_system.small_cfg``'s
capacities: every frame inserts a keyframe, and from the third one on
the whole local-mapping pipeline runs (cull, triangulation and fusion
through K3, local BA through K4, keyframe cull).  The JAX run is shared
by the module; its last ``mapping_step`` input is captured so the port's
``mapping_step`` can be held against it on the same map.

Tolerances: the lost pattern, the keyframe insertions and the run
counters are exact; TUM camera centres agree within 1e-3 m (measured
1.2e-4 m over 8 frames: the local BA sums float32 normal equations in
another order).  A CPU run launches no CUDA kernel.
"""
import dataclasses

import numpy as np
import pytest
import torch

from synthetic import SyntheticRgbdSequence
from test_slam_system import small_cfg
from test_torch_mapstate import assert_maps_match, map_np

from ydorbslam_tpu.slam import mapping as jmapping
from ydorbslam_tpu.slam.system import Sensor as JaxSensor
from ydorbslam_tpu.slam.system import SlamSystem as JaxSystem

from ydorbslam_tpu_torch.convert import config_from_dict, map_state_from_numpy
from ydorbslam_tpu_torch.io import read_tum_trajectory
from ydorbslam_tpu_torch.ops import launch_counts, reset_launch_counts
from ydorbslam_tpu_torch.slam import mapping as pmapping
from ydorbslam_tpu_torch.slam.system import Sensor, SlamSystem

torch.set_num_threads(2)

# Six frames keep every local BA in the small capacity bucket, so the JAX
# package compiles its mapping program once.
N_FRAMES = 6


def port_cfg():
    return config_from_dict(dataclasses.asdict(small_cfg()))


@pytest.fixture(scope="module")
def frames():
    seq = SyntheticRgbdSequence(np.random.default_rng(42), n_frames=N_FRAMES, n_landmarks=500)
    return seq, [seq.frame(i) for i in range(N_FRAMES)]


@pytest.fixture(scope="module")
def runs(frames):
    _, fr = frames
    captured = {}
    original = jmapping.mapping_step

    def capture(m, kf_id, kf_count, cam, inv_sigma2_tab, depth_threshold, **kw):
        captured.update(map=map_np(m), kf_id=int(kf_id), kf_count=int(kf_count),
                        depth_threshold=float(depth_threshold), kw=kw)
        out = original(m, kf_id, kf_count, cam, inv_sigma2_tab, depth_threshold, **kw)
        captured.update(out_map=map_np(out[0]), snap=np.array(out[1]))
        return out

    jmapping.mapping_step = capture
    try:
        jax_sys = JaxSystem(small_cfg(), JaxSensor.RGBD, enable_loop_closing=False)
        jax_kf = []
        for f in fr:
            jax_sys.track_rgbd(*f)
            jax_kf.append(jax_sys.n_keyframes)
    finally:
        jmapping.mapping_step = original
    port = SlamSystem(port_cfg(), Sensor.RGBD, enable_mapping=True, enable_loop_closing=False,
                      device="cpu")
    reset_launch_counts()
    port_kf = []
    for f in fr:
        port.track_rgbd(*f)
        port_kf.append(port.n_keyframes)
    return dict(jax=jax_sys, port=port, jax_kf=jax_kf, port_kf=port_kf,
                launches=launch_counts(), captured=captured)


def _centres(path):
    t, P = read_tum_trajectory(path)[:2]
    return np.asarray(t), np.asarray(P)[:, :3]


def test_mapping_slice_matches_jax(frames, runs, tmp_path):
    jax_sys, port = runs["jax"], runs["port"]
    assert [r.lost for r in port.records] == [r.lost for r in jax_sys.records]
    assert not any(r.lost for r in port.records)
    assert runs["port_kf"] == runs["jax_kf"]
    assert runs["port_kf"][-1] == N_FRAMES
    js, ps = jax_sys.run_stats(), port.run_stats()
    for k in ("frames_total", "keyframes_inserted", "keyframes_culled", "local_ba_runs",
              "inlier_frames", "keyframes_live"):
        assert ps[k] == js[k], k
    assert ps["local_ba_runs"] == N_FRAMES - 2
    # Matches and map points: the same within a few, since the BA's
    # float32 sums move points by ~1e-4 m and a gate can flip.
    assert abs(ps["inlier_sum"] - js["inlier_sum"]) <= 0.01 * js["inlier_sum"]
    assert abs(ps["map_points_live"] - js["map_points_live"]) <= 0.01 * js["map_points_live"]
    jax_sys.save_trajectory_tum(str(tmp_path / "jax.txt"))
    port.save_trajectory_tum(str(tmp_path / "port.txt"))
    tj, cj = _centres(tmp_path / "jax.txt")
    tp, cp = _centres(tmp_path / "port.txt")
    np.testing.assert_array_equal(tp, tj)
    assert np.abs(cp - cj).max() < 1e-3
    jax_sys.save_keyframe_trajectory_tum(str(tmp_path / "jax_kf.txt"))
    port.save_keyframe_trajectory_tum(str(tmp_path / "port_kf.txt"))
    tkj, ckj = _centres(tmp_path / "jax_kf.txt")
    tkp, ckp = _centres(tmp_path / "port_kf.txt")
    np.testing.assert_allclose(tkp, tkj)
    assert np.abs(ckp - ckj).max() < 1e-3


def test_mapping_step_matches_jax(runs):
    """The JAX run's last mapping_step input carried into the port: the
    same keyframe graph and bookkeeping, the same culls and snapshot
    layout; BA-optimised floats within 1e-3 (the LM's float32 sums)."""
    cap = runs["captured"]
    cam = runs["port"].cam
    tab = runs["port"].inv_sigma2_tab
    m, snap = pmapping.mapping_step(
        map_state_from_numpy(cap["map"]), cap["kf_id"], cap["kf_count"], cam, tab,
        torch.tensor(cap["depth_threshold"]), **cap["kw"],
    )
    ref = cap["out_map"]
    exact = ["kf_valid", "kf_frame_id", "parent", "covis", "kf_T_c2p", "kf_desc",
             "kf_octave", "kf_kp_valid", "mp_first_kf", "mp_found", "mp_visible"]
    assert_maps_match(ref, m, fields=exact)
    # Bindings and observation lists: a triangulation or fusion gate on a
    # float boundary may flip for a handful of keypoints.
    for name in ("kf_mp", "mp_obs_kf", "mp_valid"):
        same = (getattr(m, name).numpy() == ref[name]).mean()
        assert same > 0.995, (name, same)
    np.testing.assert_allclose(m.kf_pose.numpy(), ref["kf_pose"], atol=1e-3)
    both = ref["mp_valid"] & m.mp_valid.numpy()
    np.testing.assert_allclose(np.median(np.abs(m.mp_pos.numpy() - ref["mp_pos"])[both]), 0,
                               atol=1e-4)
    assert snap.shape == cap["snap"].shape
    K = ref["kf_valid"].shape[0]
    np.testing.assert_array_equal(snap[:4 * K].numpy(), cap["snap"][:4 * K])


def test_cpu_mapping_run_launches_no_kernel(runs):
    assert runs["launches"] == {"fast_score_nms": 0, "proj_best2": 0, "pair_best2": 0,
                                "lm_obs": 0}


def test_unported_paths_raise(frames, runs):
    """Stereo tracking is refused loudly, naming its ROADMAP slice.  Loop
    closing with mapping builds a ``LoopCloser`` (tests/test_torch_loop_*.py
    hold it against JAX); with mapping off loop closing has nothing to run
    on and none is built.  (Reaching LOST relocalizes:
    tests/test_torch_reloc_system.py.)"""
    from ydorbslam_tpu_torch.slam.loop import LoopCloser

    s = SlamSystem(port_cfg(), Sensor.RGBD, enable_mapping=True, enable_loop_closing=True,
                   device="cpu")
    assert isinstance(s.loop_closer, LoopCloser) and s.loop_closer.n_loops_closed == 0
    s.reset()
    assert isinstance(s.loop_closer, LoopCloser)
    off = SlamSystem(port_cfg(), Sensor.RGBD, enable_mapping=False, enable_loop_closing=True,
                     device="cpu")
    assert off.loop_closer is None
    off.shutdown()  # nothing to flush
    _, fr = frames
    with pytest.raises(NotImplementedError, match="slice 12"):
        runs["port"].track_stereo(fr[-1][0] + 1.0, fr[-1][1], fr[-1][1])


def test_reset_clears_the_map(frames):
    _, fr = frames
    s = SlamSystem(port_cfg(), Sensor.RGBD, enable_mapping=True, enable_loop_closing=False,
                   device="cpu")
    assert s.track_rgbd(*fr[0])
    assert s.n_keyframes == 1 and int(s.map.mp_valid.sum()) > 100
    s.reset()
    assert s.n_keyframes == 0 and not bool(s.map.mp_valid.any())
    assert s.records == [] and s.stats.resets == 1
    assert s.tracker.local_map_hook is not None
