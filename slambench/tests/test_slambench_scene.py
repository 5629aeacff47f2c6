"""The vectorised generators against the loops they were copied from."""
import sys

import numpy as np
import pytest

from slambench import harness, scene

sys.path.insert(0, str(harness.ROOT / "tests"))
from synthetic import SyntheticRgbdSequence  # noqa: E402

BENCH_CFG = {"camera": dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480,
                            fps=30.0, bf=50.0),
             "depth": {"depth_map_factor": 5000.0},
             "scene": dict(sensor="rgbd", landmarks=1500, dot=3, landmark_seed=0)}


@pytest.fixture(scope="module")
def rgbd():
    return scene.make_stream(BENCH_CFG, None)


@pytest.mark.parametrize("i", [0, 7, 123, 399])
def test_rgbd_frames_equal_bench_make_frames(rgbd, i):
    seq = SyntheticRgbdSequence(np.random.default_rng(0), n_frames=400, n_landmarks=1500,
                                trajectory="xyz")
    _, gray, depth = seq.frame(i)
    assert np.array_equal(rgbd.images[i][0], gray.astype(np.uint8))
    assert np.array_equal(rgbd.images[i][1], (depth * 5000.0).astype(np.uint16))
    np.testing.assert_allclose(rgbd.poses[i], seq.poses[i], atol=1e-12)


def test_stereo_frames_equal_make_stereo_frames():
    from ydorbslam_tpu_torch import testing

    c = testing.KITTI00
    cfg = {"camera": {k: c[k] for k in ("fx", "fy", "cx", "cy", "width", "height", "fps", "bf")},
           "scene": dict(sensor="stereo", landmarks=testing.STEREO_LANDMARKS,
                         dot=testing.STEREO_DOT, landmark_seed=0)}
    st = scene.make_stream(cfg, None)
    frames, poses = testing.make_stereo_frames(6, seed=0)
    for i in (0, 5):
        assert np.array_equal(frames[i][1], st.images[i][0])
        assert np.array_equal(frames[i][2], st.images[i][1])
        np.testing.assert_allclose(st.poses[i], poses[i], atol=1e-12)


def test_period_holds_and_replays(rgbd):
    P = scene.oscillating_poses(2 * scene.PERIOD + 1)
    np.testing.assert_allclose(P[:scene.PERIOD + 1], P[scene.PERIOD:], atol=1e-12)
    t, a, _ = rgbd.frame(scene.PERIOD + 3)
    assert t == pytest.approx((scene.PERIOD + 3) / 30.0) and a is rgbd.images[3][0]
    assert np.array_equal(rgbd.pose(scene.PERIOD + 3), rgbd.poses[3])


def test_seed_draws_the_textures_alone():
    a = scene.landmark_patches(5, 3, 2**31 + 5)
    assert np.array_equal(a, scene.landmark_patches(5, 3, 2**31 + 5))
    assert not np.array_equal(a, scene.landmark_patches(5, 3, 7))
    assert not np.array_equal(a, scene.landmark_patches(5, 3, None))
    cfg = dict(BENCH_CFG, scene=dict(BENCH_CFG["scene"], landmarks=50))
    s1, s2 = scene.make_stream(cfg, 1), scene.make_stream(cfg, 2)
    assert np.array_equal(s1.poses, s2.poses)
    assert np.array_equal(s1.images[0][1], s2.images[0][1])  # same geometry, same depth
    assert not np.array_equal(s1.images[0][0], s2.images[0][0])
