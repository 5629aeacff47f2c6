"""The port's stereo slice end to end against the JAX package on the CPU,
and the port's KITTI runner.

``SlamSystem(cfg, Sensor.STEREO, enable_mapping=True,
enable_loop_closing=False)`` of both packages tracks the same rectified
pairs (the first 5 of ``test_stereo_system.SyntheticStereoSequence``'s 12:
640x480, 500 dots, a 0.1 m baseline) under ``test_slam_system.small_cfg``:
every frame makes a keyframe, and from the third one on local BA runs.

Tolerances: the lost pattern and the keyframes after each frame are
exact; camera centres at track time agree within 1e-3 m (measured: under
1e-6 m before the first local BA, 4.6e-5 m after the third).  The local
BA sums float32 normal equations in another order, and on this map of
3x3 dots, many of whose stereo depths are outliers, the difference
grows fast: 2.3e-3 m one frame later.  K1's dispatcher runs twice per
frame (left and right), and a CPU run launches no CUDA kernel.

The runner test writes a KITTI sequence directory (as
``test_kitti_app.py`` does) and runs
``python -m ydorbslam_tpu_torch.apps.run_kitti_stereo`` on it on the CPU.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from synthetic import circular_trajectory, make_landmarks, project_np, render_dots
from test_slam_system import small_cfg
from test_stereo_system import SyntheticStereoSequence

from ydorbslam_tpu.io import kitti as jkitti
from ydorbslam_tpu.slam.system import Sensor as JaxSensor
from ydorbslam_tpu.slam.system import SlamSystem as JaxSystem

from ydorbslam_tpu_torch.apps import run_kitti_stereo
from ydorbslam_tpu_torch.convert import config_from_dict
from ydorbslam_tpu_torch.io import KittiStereoDataset, kitti_intrinsics
from ydorbslam_tpu_torch.ops import extractor, launch_counts, reset_launch_counts
from ydorbslam_tpu_torch.slam.system import Sensor, SlamSystem

torch.set_num_threads(2)

N_FRAMES = 5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def centres(poses):
    return np.stack([-p[:3, :3].T @ p[:3, 3] for p in poses])


@pytest.fixture(scope="module")
def runs():
    # The first frames of test_stereo_system's 12-frame sequence.
    seq = SyntheticStereoSequence(np.random.default_rng(42), n_frames=12, n_landmarks=500)
    frames = [seq.frame(i) for i in range(N_FRAMES)]
    jax_sys = JaxSystem(small_cfg(), JaxSensor.STEREO, enable_loop_closing=False)
    jax_kf = []
    for f in frames:
        jax_sys.track_stereo(*f)
        jax_kf.append(jax_sys.n_keyframes)
    port = SlamSystem(config_from_dict(dataclasses.asdict(small_cfg())), Sensor.STEREO,
                      enable_mapping=True, enable_loop_closing=False, device="cpu")
    k1_calls, port_kf = [], []
    original = extractor.fast_score_nms_levels

    def spy(levels, border):
        k1_calls.append(len(port_kf))
        return original(levels, border)

    extractor.fast_score_nms_levels = spy
    reset_launch_counts()
    try:
        for f in frames:
            port.track_stereo(*f)
            port_kf.append(port.n_keyframes)
    finally:
        extractor.fast_score_nms_levels = original
    return dict(jax=jax_sys, port=port, jax_kf=jax_kf, port_kf=port_kf, k1_calls=k1_calls,
                launches=launch_counts())


def test_stereo_slice_matches_jax(runs):
    j, p = runs["jax"], runs["port"]
    _, jposes, jlost = j.tracker.trajectory()
    _, pposes, plost = p.tracker.trajectory()
    assert plost == jlost and sum(plost) == 0
    assert runs["port_kf"] == runs["jax_kf"] and runs["port_kf"][-1] >= 3
    assert p.stats.local_ba_runs == j.stats.local_ba_runs >= 1
    diff = np.abs(centres(pposes) - centres([np.asarray(T) for T in jposes])).max()
    assert diff < 1e-3, diff
    assert [r.lost for r in p.records] == [r.lost for r in j.records]
    assert p.frame_id == j.frame_id == N_FRAMES


def test_stereo_runs_k1_twice_per_frame(runs):
    assert runs["k1_calls"] == [i for i in range(N_FRAMES) for _ in range(2)]
    assert all(v == 0 for v in runs["launches"].values())


def _write_kitti_sequence(root, rng, n_frames):
    """A KITTI odometry directory (image_0/image_1 PNGs, calib.txt,
    times.txt, poses.txt) of the synthetic dot world with a 0.1 m
    baseline at fx = 500, as tests/test_kitti_app.py writes one."""
    from PIL import Image

    fx, fy, cx, cy, bf = 500.0, 500.0, 320.0, 240.0, 50.0
    os.makedirs(os.path.join(root, "image_0"))
    os.makedirs(os.path.join(root, "image_1"))
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    lms = make_landmarks(rng, 500)
    T_r = np.eye(4)
    T_r[0, 3] = -bf / fx
    rows = []
    for i, T_cw in enumerate(circular_trajectory(10)[:n_frames]):
        for sub, T in (("image_0", T_cw), ("image_1", T_r @ T_cw)):
            uv, z = project_np(K, T, lms)
            Image.fromarray(render_dots(uv, z, 640, 480).astype(np.uint8), "L").save(
                os.path.join(root, sub, f"{i:06d}.png"))
        rows.append(np.linalg.inv(T_cw)[:3, :].reshape(-1))
    with open(os.path.join(root, "times.txt"), "w") as f:
        f.write("\n".join(f"{i / 10.0:.6f}" for i in range(n_frames)))
    P0 = np.array([[fx, 0, cx, 0], [0, fy, cy, 0], [0, 0, 1, 0]])
    P1 = P0.copy()
    P1[0, 3] = -bf
    with open(os.path.join(root, "calib.txt"), "w") as f:
        for name, P in (("P0", P0), ("P1", P1)):
            f.write(name + ": " + " ".join(f"{x:.6e}" for x in P.reshape(-1)) + "\n")
    np.savetxt(os.path.join(root, "poses.txt"), np.stack(rows))


@pytest.fixture(scope="module")
def kitti_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti") / "seq00")
    _write_kitti_sequence(root, np.random.default_rng(42), 4)
    return root


def test_kitti_readers_match_jax(kitti_dir):
    calib = os.path.join(kitti_dir, "calib.txt")
    assert kitti_intrinsics(calib) == jkitti.kitti_intrinsics(calib)
    ds, jds = KittiStereoDataset(kitti_dir), jkitti.KittiStereoDataset(kitti_dir)
    assert len(ds) == len(jds) == 4
    for i in (0, 3):
        for a, b in zip(ds[i], jds[i]):
            np.testing.assert_array_equal(a, b)


def test_kitti_runner_on_the_cpu(kitti_dir, tmp_path, capsys):
    out_traj = str(tmp_path / "traj.txt")
    # Three frames: the third keyframe, and with it local BA, comes later
    # (a local BA at the default capacities takes ~16 s on a CPU).
    run_kitti_stereo.main([kitti_dir, "--poses", os.path.join(kitti_dir, "poses.txt"),
                           "--no-loop", "--device", "cpu", "--max-frames", "3",
                           "--out-trajectory", out_traj])
    out = capsys.readouterr().out
    for line in ("median tracking time:", "mean tracking time:", "--- run stats ---",
                 "frames        3  (lost 0", "ATE RMSE:"):
        assert line in out, out
    ate = float(out.split("ATE RMSE:")[1].split("m")[0])
    assert ate < 0.10, out
    with open(out_traj) as f:
        assert len(f.read().splitlines()) == 3


@pytest.mark.parametrize("extra", [["--pipelined"], ["--lag", "4"], ["--viewer-dir", "v"],
                                   ["--viewer-every", "3"]])
def test_kitti_runner_refuses_what_is_not_ported(kitti_dir, extra, capsys):
    with pytest.raises(SystemExit):
        run_kitti_stereo.main([kitti_dir, "--device", "cpu", *extra])
    assert "not ported" in capsys.readouterr().err


def test_kitti_runner_refuses_the_multi_host_join(kitti_dir, monkeypatch, capsys):
    monkeypatch.setenv("YDORBSLAM_COORDINATOR", "localhost:1234")
    with pytest.raises(SystemExit):
        run_kitti_stereo.main([kitti_dir, "--device", "cpu"])
    assert "not ported" in capsys.readouterr().err


def test_kitti_runner_needs_a_card_by_default(kitti_dir):
    """``python -m ...run_kitti_stereo`` defaults to the card and fails
    without one; it does not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, "-m", "ydorbslam_tpu_torch.apps.run_kitti_stereo",
                          kitti_dir], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and "no CUDA device" in res.stderr
    assert "median tracking time" not in res.stdout
