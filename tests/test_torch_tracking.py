"""The port's tracking slice end to end against the JAX package on the CPU.

``SlamSystem(cfg, Sensor.RGBD, enable_mapping=False,
enable_loop_closing=False)`` of both packages tracks the same 20 frames
of the test_tracking_vo.py scenario (640x480, 600 features); the port
must keep the same lost/ok pattern and the same trajectory.  Also: the
port imports with JAX blocked, a CPU run launches no CUDA kernel, and a
JAX tracker's state loaded mid-sequence steps the same in the port.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from synthetic import SyntheticRgbdSequence

from ydorbslam_tpu.config import CameraConfig, OrbConfig, SlamConfig, TrackingConfig
from ydorbslam_tpu.slam.system import Sensor as JaxSensor
from ydorbslam_tpu.slam.system import SlamSystem as JaxSystem

from ydorbslam_tpu_torch.convert import (
    camera_from_numpy, config_from_dict, features_from_numpy, tracker_state_from_numpy,
)
from ydorbslam_tpu_torch.io import ate_rmse
from ydorbslam_tpu_torch.ops import fast_score_nms, launch_counts, proj_best2, reset_launch_counts
from ydorbslam_tpu_torch.slam.system import Sensor, SlamSystem
from ydorbslam_tpu_torch.slam.tracking import Tracker

torch.set_num_threads(2)

N_FRAMES = 20
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_cfg():
    return SlamConfig(
        tracking=TrackingConfig(min_init_depth_points=100),
        camera=CameraConfig(
            fx=500.0, fy=500.0, cx=320.0, cy=240.0,
            k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0,
            bf=50.0, width=640, height=480,
        ),
        orb=OrbConfig(n_features=600),
    )


def port_system(cfg=None):
    cfg = config_from_dict(dataclasses.asdict(cfg or make_cfg()))
    return SlamSystem(cfg, Sensor.RGBD, enable_mapping=False,
                      enable_loop_closing=False, device="cpu")


def centres(poses):
    return np.stack([-p[:3, :3].T @ p[:3, 3] for p in poses])


@pytest.fixture(scope="module")
def seq():
    s = SyntheticRgbdSequence(np.random.default_rng(42), n_frames=N_FRAMES, n_landmarks=600)
    return s, [s.frame(i) for i in range(N_FRAMES)]


@pytest.fixture(scope="module")
def runs(seq):
    _, frames = seq
    jax_sys = JaxSystem(make_cfg(), JaxSensor.RGBD, enable_mapping=False,
                        enable_loop_closing=False)
    port = port_system()
    reset_launch_counts()
    for t, gray, depth in frames:
        jax_sys.track_rgbd(t, gray, depth)
        port.track_rgbd(t, gray, depth)
    return jax_sys, port, launch_counts()


def test_vo_slice_matches_jax(seq, runs):
    s, _ = seq
    jax_sys, port, _ = runs
    _, jp, jl = jax_sys.tracker.trajectory()
    _, tp, tl = port.tracker.trajectory()
    assert tl == jl
    assert not any(tl)
    assert port.tracking_state().name == jax_sys.tracking_state().name == "OK"
    jp, tp = np.stack(jp), np.stack(tp)
    # Camera centres: the same matches, float32 LM sums in another order
    # (measured max 2e-5 m); bound 1e-3 m per frame.
    assert np.abs(centres(tp) - centres(jp)).max() < 1e-3
    # Rotations: ||R_port - R_jax||_max bounds the angle to first order.
    assert np.abs(tp[:, :3, :3] - jp[:, :3, :3]).max() < 1e-3
    assert ate_rmse(centres(tp), centres(s.poses)) < 0.05
    assert abs(port.tracked_map_points() - jax_sys.tracked_map_points()) <= 2


def test_cpu_run_launches_no_kernel(runs):
    # The whole 20-frame CPU run went through the plain versions.
    assert runs[2] == {"fast_score_nms": 0, "proj_best2": 0, "pair_best2": 0, "lm_obs": 0}


def test_step_from_jax_state(seq, runs):
    """Load a JAX tracker's state after frame 9 into a fresh port tracker
    and compare frame 10's pose."""
    _, frames = seq
    from ydorbslam_tpu.slam.tracking import Tracker as JaxTracker

    jt = JaxTracker(make_cfg())
    for t, gray, depth in frames[:10]:
        jt.track_rgbd(t, gray, depth)
    cfg = config_from_dict(dataclasses.asdict(make_cfg()))
    pt = tracker_state_from_numpy(
        Tracker(cfg, device="cpu"),
        T_cw=np.asarray(jt.T_cw), velocity=np.asarray(jt.velocity),
        last_feats={k: np.asarray(v) for k, v in jt.last_feats._asdict().items()},
        last_lms=np.asarray(jt.last_lms), last_lms_valid=np.asarray(jt.last_lms_valid),
        state=jt.state.value,
    )
    cam = camera_from_numpy([np.asarray(x) for x in jt.cam])
    for a, b in zip(cam, pt.cam):
        assert float(a) == float(b)
    assert jt.track_rgbd(*frames[10]) and pt.track_rgbd(*frames[10])
    # One pose solve from identical state: float32 sums in another
    # order, 1e-4.
    np.testing.assert_allclose(pt.trajectory()[1][-1], jt.trajectory()[1][-1],
                               rtol=0, atol=1e-4)
    assert abs(pt.n_inliers - jt.n_inliers) <= 2


def test_features_convert_keeps_descriptor_bits():
    desc = np.array([[0, 1, 0x80000000, 0xFFFFFFFF, 7, 8, 9, 10]], np.uint32)
    f = {k: np.zeros((1, 2), np.float32) for k in ("uv", "uv_raw")}
    f.update(response=np.zeros(1, np.float32), octave=np.zeros(1, np.int32),
             angle=np.zeros(1, np.float32), desc=desc, right_u=-np.ones(1, np.float32),
             depth=-np.ones(1, np.float32), valid=np.ones(1, bool))
    out = features_from_numpy(f)
    assert out.desc.dtype == torch.int32
    np.testing.assert_array_equal(out.desc.numpy().view(np.uint32), desc)
    with pytest.raises(ValueError):
        features_from_numpy({**f, "desc": desc.astype(np.int64)})


def test_unported_paths_raise_and_dispatch_refuses_other_devices():
    cfg = config_from_dict(dataclasses.asdict(make_cfg()))
    # Loop closing is ported: with mapping it builds the closer.
    s = SlamSystem(cfg, Sensor.RGBD, enable_mapping=True, enable_loop_closing=True,
                   device="cpu")
    assert s.loop_closer is not None
    with pytest.raises(NotImplementedError, match="slice 12"):
        port_system().track_stereo(0.0, None, None)
    meta = torch.zeros((64, 64), device="meta")
    with pytest.raises(ValueError):
        fast_score_nms(meta, 16)
    d = torch.zeros((4, 8), dtype=torch.int32, device="meta")
    a = torch.zeros((4, 8), device="meta")
    with pytest.raises(ValueError):
        proj_best2(d, a, d, a)


def test_default_device_is_the_card():
    """SlamSystem and Tracker put their state on the card unless asked
    otherwise; without one, the CUDA request raises instead of falling
    back to the CPU."""
    cfg = config_from_dict(dataclasses.asdict(make_cfg()))

    def build():
        return (Tracker(cfg),
                SlamSystem(cfg, Sensor.RGBD, enable_mapping=True, enable_loop_closing=False))

    if torch.cuda.is_available():
        tracker, system = build()
        assert tracker.T_cw.is_cuda and system.map.mp_valid.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            build()


def test_port_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ydorbslam_tpu'] = None\n"
        "import ydorbslam_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'ydorbslam_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k in sys.modules"
        " if sys.modules[k] is not None)\n"
    )
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    pkg = os.path.join(REPO, "ydorbslam_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(dirpath, name)) as f:
                    src = f.read()
                assert "import jax" not in src and "from jax" not in src, name
                assert "ydorbslam_tpu." not in src.replace("ydorbslam_tpu_torch", ""), name


def test_depth_divisor_is_made_once(seq, monkeypatch):
    """The uint16 depth divisor is a tensor made when the tracker is built
    (ROADMAP Queue 3, F3): a frame makes no tensor from the factor, and
    the depth is still the float32 quotient of the raw value by it."""
    from ydorbslam_tpu_torch.slam import tracking

    _, frames = seq
    t, gray, depth = frames[0]
    raw = (np.asarray(depth) * 5000.0).astype(np.uint16)
    cfg = config_from_dict(dataclasses.asdict(make_cfg()))
    tr = Tracker(cfg, device="cpu")
    assert tr.depth_factor.dim() == 0 and tr.depth_factor.dtype == torch.float32
    assert float(tr.depth_factor) == cfg.depth.depth_map_factor
    made, seen = [], {}
    real_tensor, real_fill = torch.tensor, tracking.fill_depth_from_rgbd

    def counting_tensor(data, *a, **k):
        made.append(data)
        return real_tensor(data, *a, **k)

    def keep_depth(feats, d, cam):
        seen["d"] = d
        return real_fill(feats, d, cam)

    monkeypatch.setattr(torch, "tensor", counting_tensor)
    monkeypatch.setattr(tracking, "fill_depth_from_rgbd", keep_depth)
    tr.track_rgbd(t, gray, raw)
    assert not any(isinstance(x, float) and x == cfg.depth.depth_map_factor for x in made)
    expect = raw.astype(np.float32) / np.float32(cfg.depth.depth_map_factor)
    np.testing.assert_array_equal(seen["d"].numpy(), expect)
