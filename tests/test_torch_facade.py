"""The rest of the port's facade against the JAX package on the CPU:
``update_calibration``, the frame accessors, the headless renders, the
periodic viewer, and the KITTI runner's viewer.

Both packages run ``SlamSystem(small_cfg(), Sensor.RGBD,
enable_loop_closing=False)`` with ``attach_viewer(every=3)`` over the 8
frames of ``tests/test_serialize_viz.py``'s viewer test (a
``SyntheticRgbdSequence``, rng 42, 400 landmarks; every frame makes a
keyframe).  The runs are shared by the module.

Tolerances: configurations, camera values, file names and rendered
pixels are exact.  ``tracked_keypoints`` is held as
``tests/test_torch_ops.py`` holds the extraction: the validity mask
exact, and the coordinates of at most 2 % of the valid keypoints
different (pyramid levels 1-7 differ by ulps from XLA's).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch
from PIL import Image

from synthetic import SyntheticRgbdSequence
from test_slam_system import small_cfg
from test_torch_stereo_system import _write_kitti_sequence

from ydorbslam_tpu.slam.system import Sensor as JaxSensor
from ydorbslam_tpu.slam.system import SlamSystem as JaxSystem
from ydorbslam_tpu.viz import headless as jviz

from ydorbslam_tpu_torch.apps import run_kitti_stereo
from ydorbslam_tpu_torch.convert import config_from_dict, map_state_from_numpy
from ydorbslam_tpu_torch.slam.system import Sensor, SlamSystem
from ydorbslam_tpu_torch.testing import TUM_RGBD_SETTINGS, write_settings
from ydorbslam_tpu_torch.viz import headless as pviz

torch.set_num_threads(2)

N_FRAMES = 8
EVERY = 3
CAM_FIELDS = ("fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2", "k3", "bf", "width", "height")


def port_cfg():
    return config_from_dict(dataclasses.asdict(small_cfg()))


def pixels(path):
    return np.asarray(Image.open(path))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    seq = SyntheticRgbdSequence(np.random.default_rng(42), n_frames=N_FRAMES, n_landmarks=400)
    frames = [seq.frame(i) for i in range(N_FRAMES)]
    out = {}
    for name, system in (
        ("jax", JaxSystem(small_cfg(), JaxSensor.RGBD, enable_loop_closing=False)),
        ("port", SlamSystem(port_cfg(), Sensor.RGBD, enable_loop_closing=False, device="cpu")),
    ):
        d = tmp_path_factory.mktemp(f"viz_{name}")
        viewer = system.attach_viewer(str(d), every=EVERY)
        changed = []
        for i, f in enumerate(frames):
            system.track_rgbd(*f)
            changed.append((system.map_changed_index(), system.n_keyframes))
            if i == 2:
                out[f"{name}_kps"] = system.tracked_keypoints()
        out[name] = dict(system=system, viewer=viewer, dir=d, changed=changed,
                         files=sorted(os.listdir(d)))
    out["frames"] = frames
    return out


def test_tracked_keypoints_match_jax_after_three_frames(runs):
    (juv, jvalid), (puv, pvalid) = runs["jax_kps"], runs["port_kps"]
    assert puv.dtype == juv.dtype == np.float32 and pvalid.dtype == jvalid.dtype == bool
    assert puv.shape == juv.shape
    np.testing.assert_array_equal(pvalid, jvalid)
    differs = (puv != juv).any(1)[jvalid]
    assert jvalid.sum() > 100 and differs.sum() <= 0.02 * jvalid.sum()


def test_tracked_keypoints_before_any_frame_is_none():
    assert SlamSystem(port_cfg(), Sensor.RGBD, device="cpu").tracked_keypoints() is None


def test_map_changed_index_counts_keyframes(runs):
    for name in ("jax", "port"):
        assert all(a == b for a, b in runs[name]["changed"]), name
    assert runs["port"]["changed"] == runs["jax"]["changed"]
    assert runs["port"]["changed"][-1][0] == N_FRAMES


def test_viewer_writes_jax_files(runs):
    files = runs["port"]["files"]
    assert files == runs["jax"]["files"]
    assert files == [f"{kind}_{i:06d}.png" for kind in ("frame", "map")
                     for i in range(0, N_FRAMES, EVERY)]
    assert runs["port"]["viewer"].n_rendered == runs["jax"]["viewer"].n_rendered == 3
    for f in files:
        img = Image.open(runs["port"]["dir"] / f)
        assert img.size == ((640, 480) if f.startswith("frame") else (1024, 1024))


def test_viewer_touches_nothing_on_a_frame_it_does_not_draw(tmp_path):
    """The cadence test comes first: on a frame it does not draw,
    ``maybe_draw`` reads nothing of the system (on the card, no wait)."""
    viewer = pviz.PeriodicViewer(str(tmp_path), every=EVERY)
    assert viewer.maybe_draw(object(), 1, gray=None) is False
    assert viewer.n_rendered == 0 and os.listdir(tmp_path) == []


def test_render_map_topdown_is_pixel_equal_to_jax(runs, tmp_path):
    jmap = runs["jax"]["system"].map
    pmap = map_state_from_numpy({k: np.asarray(v) for k, v in jmap._asdict().items()})
    jviz.render_map_topdown(jmap, str(tmp_path / "jax.png"))
    pviz.render_map_topdown(pmap, str(tmp_path / "port.png"))
    a, b = pixels(tmp_path / "jax.png"), pixels(tmp_path / "port.png")
    assert a.shape == (1024, 1024, 3) and (a != 250).any()
    np.testing.assert_array_equal(b, a)


def test_render_tracked_frame_is_pixel_equal_to_jax(runs, tmp_path):
    uv, valid = runs["jax_kps"]
    gray = runs["frames"][2][1]
    matched = np.arange(len(uv))[valid] % 2 == 0
    args = (uv[valid], matched)
    jviz.render_tracked_frame(gray, *args, str(tmp_path / "jax.png"), "f2 OK KF 3 inliers 123")
    pviz.render_tracked_frame(gray, *args, str(tmp_path / "port.png"), "f2 OK KF 3 inliers 123")
    np.testing.assert_array_equal(pixels(tmp_path / "port.png"), pixels(tmp_path / "jax.png"))


@pytest.fixture(scope="module")
def calibrated(tmp_path_factory):
    """Both packages' systems after ``update_calibration`` with a settings
    file whose camera, depth and ORB settings all differ from small_cfg's."""
    settings = dict(TUM_RGBD_SETTINGS, **{
        "Camera.fx": 505.0, "Camera.fy": 498.0, "Camera.cx": 322.5, "Camera.k1": 0.01,
        "Camera.bf": 40.0, "ThDepth": 35.0, "DepthMapFactor": 1000.0,
        "ORBextractor.nFeatures": 800})
    path = str(tmp_path_factory.mktemp("calib") / "calib.yaml")
    write_settings(path, settings)
    jax = JaxSystem(small_cfg(), JaxSensor.RGBD, enable_mapping=False, enable_loop_closing=False)
    port = SlamSystem(port_cfg(), Sensor.RGBD, enable_mapping=False, enable_loop_closing=False,
                      device="cpu")
    before = dict(port_tracker_cfg=port.tracker.cfg, jax_tracker_cfg=jax.tracker.cfg,
                  depth_factor=port.tracker.depth_factor, inv_sigma2=port.tracker.inv_sigma2_tab,
                  has_distortion=port.tracker._extract_kw()["has_distortion"])
    jax.update_calibration(path)
    port.update_calibration(path)
    return dict(jax=jax, port=port, before=before, path=path)


def test_update_calibration_matches_jax(calibrated):
    jax, port = calibrated["jax"], calibrated["port"]
    assert dataclasses.asdict(port.cfg) == dataclasses.asdict(jax.cfg)
    assert port.cfg.camera.fx == 505.0 and port.cfg.orb.n_features == 800
    for name in CAM_FIELDS:
        p, j = getattr(port.cam, name), getattr(jax.cam, name)
        assert float(p) == float(np.asarray(j)), name
    assert port.tracker.cam is port.cam and port.cam.fx.device == port.device
    assert port.depth_threshold == jax.depth_threshold == 35.0 * 40.0 / 505.0
    assert float(port._depth_thr_dev) == float(np.asarray(jax._depth_thr_dev))


def test_update_calibration_leaves_the_tracker_settings(calibrated):
    """As in the JAX package (and Tracking::changeIntParMat), the tracker
    keeps its own cfg: its distortion gate, ORB settings, depth divisor
    and octave tables stay as they were."""
    jax, port, before = calibrated["jax"], calibrated["port"], calibrated["before"]
    assert port.tracker.cfg is before["port_tracker_cfg"]
    assert jax.tracker.cfg is before["jax_tracker_cfg"]
    assert dataclasses.asdict(port.tracker.cfg) == dataclasses.asdict(jax.tracker.cfg)
    assert port.tracker.depth_factor is before["depth_factor"]
    assert float(port.tracker.depth_factor) == small_cfg().depth.depth_map_factor
    assert port.tracker.inv_sigma2_tab is before["inv_sigma2"]
    assert port.tracker._extract_kw()["has_distortion"] is before["has_distortion"] is False


def test_frame_after_update_calibration_tracks(calibrated):
    seq = SyntheticRgbdSequence(np.random.default_rng(42), n_frames=3, n_landmarks=400)
    system = SlamSystem(port_cfg(), Sensor.RGBD, enable_mapping=False, enable_loop_closing=False,
                        device="cpu")
    assert system.track_rgbd(*seq.frame(0))
    system.update_calibration(calibrated["path"])
    assert system.track_rgbd(*seq.frame(1))


def test_kitti_runner_viewer_writes_pngs_on_the_cpu(tmp_path, capsys):
    seq_dir = str(tmp_path / "seq00")
    _write_kitti_sequence(seq_dir, np.random.default_rng(42), 3)
    viz = tmp_path / "viz"
    run_kitti_stereo.main([seq_dir, "--no-loop", "--device", "cpu", "--max-frames", "3",
                           "--out-trajectory", str(tmp_path / "traj.txt"),
                           "--viewer-dir", str(viz), "--viewer-every", "2"])
    assert "median tracking time:" in capsys.readouterr().out
    files = sorted(os.listdir(viz))
    assert files == ["frame_000000.png", "frame_000002.png", "map_000000.png", "map_000002.png"]
    for f in files:
        Image.open(viz / f).verify()
