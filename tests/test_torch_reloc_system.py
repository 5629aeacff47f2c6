"""Relocalization and localization-only mode end to end, against the JAX
package on the CPU.

Both packages' ``SlamSystem(small_cfg(), Sensor.RGBD,
enable_loop_closing=False)`` run one scenario on a 10-frame
``SyntheticRgbdSequence`` (rng 42, 500 landmarks):

1. frames 0-5 build the map (a keyframe each, so the map has 6 and the
   auto-reset for maps of <= 5 keyframes does not fire);
2. kidnap: a blank frame (uint8 gray and uint16 depth of zeros) is lost,
   then frame 2 again relocalizes through retrieval, K2's plain version,
   RANSAC and the pose LM;
3. ``activate_localization_mode()`` and frames 3-5, going on from frame 2
   without a jump: no keyframe or map point is added;
4. frames 6-7 with the same seeded 3 % of ``mp_valid`` kept in both: the
   map leaves the view and tracking goes on by visual odometry;
5. frames 8-9 with the map restored: map tracking resumes.

The JAX run is shared by the module.  Tolerances: the lost pattern, the
accepted candidate keyframe, the keyframe and map-point counts, the
visual-odometry flag and the index's ``valid`` are exact; the index's
histograms within 1e-7 (measured 0: the keyframes' descriptors are the
same bits); camera centres within 1e-3 m of each other (measured
5.1e-5 m right after relocalization and 1.7e-4 m at most, on a
visual-odometry frame) and within 0.05 m of ground truth after
relocalization (measured 5.3e-3 m), as in tests/test_relocalization.py.
The RANSAC draws differ between the packages (``jax.random`` against a
torch generator), so the outcomes are compared, not the hypotheses.
"""
import dataclasses

import numpy as np
import pytest
import torch

from synthetic import SyntheticRgbdSequence
from test_slam_system import small_cfg

from ydorbslam_tpu.slam.system import Sensor as JaxSensor
from ydorbslam_tpu.slam.system import SlamSystem as JaxSystem

from ydorbslam_tpu_torch.convert import config_from_dict
from ydorbslam_tpu_torch.ops import launch_counts, reset_launch_counts
from ydorbslam_tpu_torch.slam.system import Sensor, SlamSystem
from ydorbslam_tpu_torch.slam.tracking import TrackingState

torch.set_num_threads(2)

N_FRAMES = 10
N_BUILD = 6
H, W = 480, 640


def port_cfg():
    return config_from_dict(dataclasses.asdict(small_cfg()))


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _centre(T):
    T = _np(T)
    return -T[:3, :3].T @ T[:3, 3]


def run_scenario(system, seq, set_mp_valid):
    """Drive one system through the scenario; returns what each step
    left behind.  ``set_mp_valid(system, mask)`` sets the map's
    ``mp_valid`` from a numpy mask."""
    out = {"ok": [], "centre": [], "vo": [], "kf": [], "mp": []}
    accepted = []
    reloc = system.tracker.reloc_hook

    def hook(tracker, timestamp, feats):
        ok = reloc(tracker, timestamp, feats)
        accepted.append(system.ref_kf if ok else -1)
        return ok

    system.tracker.reloc_hook = hook

    def step(t, gray, depth):
        out["ok"].append(bool(system.track_rgbd(t, gray, depth)))
        out["centre"].append(_centre(system.tracker.T_cw))
        out["vo"].append(bool(system.visual_odometry))
        out["kf"].append(system.n_keyframes)
        out["mp"].append(int(_np(system.map.mp_valid).sum()))

    for i in range(N_BUILD):
        step(*seq.frame(i))
    step(N_BUILD / 30.0, np.zeros((H, W), np.uint8), np.zeros((H, W), np.uint16))
    out["state_after_blank"] = system.tracking_state()
    _, g, d = seq.frame(2)
    step((N_BUILD + 1) / 30.0, g, d)
    out["accepted"] = list(accepted)
    out["reloc"] = (system.stats.reloc_attempts, system.stats.reloc_successes)
    system.activate_localization_mode()
    for i in range(3, N_FRAMES):
        _, g, d = seq.frame(i)
        if i == 6:
            keep = np.random.default_rng(7).random(system.map.M) < 0.03
            out["mp_valid"] = _np(system.map.mp_valid).copy()
            set_mp_valid(system, out["mp_valid"] & keep)
        if i == 8:
            set_mp_valid(system, out["mp_valid"])
        step((i + 5) / 30.0, g, d)
    out["retrieval"] = {k: _np(v).copy() for k, v in system.retrieval._asdict().items()}
    return out


@pytest.fixture(scope="module")
def seq():
    return SyntheticRgbdSequence(np.random.default_rng(42), n_frames=N_FRAMES, n_landmarks=500)


@pytest.fixture(scope="module")
def jax_run(seq):
    import jax.numpy as jnp

    def set_valid(s, mask):
        s.map = s.map._replace(mp_valid=jnp.asarray(mask))

    return run_scenario(JaxSystem(small_cfg(), JaxSensor.RGBD, enable_loop_closing=False),
                        seq, set_valid)


@pytest.fixture(scope="module")
def port_run(seq):
    def set_valid(s, mask):
        s.map = s.map._replace(mp_valid=torch.from_numpy(mask))

    system = SlamSystem(port_cfg(), Sensor.RGBD, enable_mapping=True,
                        enable_loop_closing=False, device="cpu")
    reset_launch_counts()
    out = run_scenario(system, seq, set_valid)
    out["launches"] = launch_counts()
    out["system"] = system
    return out


def test_kidnap_relocalizes_like_jax(seq, jax_run, port_run):
    """The blank frame is lost in both (LOST, not reset: 6 keyframes), and
    frame 2 relocalizes on the same candidate keyframe, near the JAX pose
    and the ground truth."""
    j, p = jax_run, port_run
    assert p["ok"][:N_BUILD + 2] == j["ok"][:N_BUILD + 2] == [True] * N_BUILD + [False, True]
    assert p["state_after_blank"] == TrackingState.LOST
    assert p["kf"][N_BUILD] == j["kf"][N_BUILD] == N_BUILD
    assert p["reloc"] == j["reloc"] == (1, 1)
    assert p["accepted"] == j["accepted"] and p["accepted"][0] >= 0
    c_p, c_j = p["centre"][N_BUILD + 1], j["centre"][N_BUILD + 1]
    assert np.linalg.norm(c_p - c_j) < 1e-3
    assert np.linalg.norm(c_p - _centre(seq.poses[2])) < 0.05


def test_retrieval_index_matches_jax(jax_run, port_run):
    rj, rp = jax_run["retrieval"], port_run["retrieval"]
    np.testing.assert_array_equal(rp["valid"], rj["valid"])
    assert rp["valid"].sum() == port_run["kf"][-1]
    np.testing.assert_allclose(rp["hist"], rj["hist"], rtol=0, atol=1e-7)
    np.testing.assert_array_equal(rp["presence"], rj["presence"])


def test_localization_mode_freezes_the_map_like_jax(jax_run, port_run):
    """Frames 3-5 in localization mode: tracked as in JAX, no keyframe or
    map point added, centres within 1e-3 m of JAX's."""
    j, p = jax_run, port_run
    loc = slice(N_BUILD + 2, N_BUILD + 5)
    assert p["ok"][loc] == j["ok"][loc] == [True] * 3
    for r in (j, p):
        assert r["kf"][loc] == [r["kf"][N_BUILD + 1]] * 3
        assert r["mp"][loc] == [r["mp"][N_BUILD + 1]] * 3
        assert r["vo"][loc] == [False] * 3
    assert p["kf"] == j["kf"]
    assert np.abs(np.stack(p["centre"][loc]) - np.stack(j["centre"][loc])).max() < 1e-3


def test_visual_odometry_fallback_like_jax(seq, jax_run, port_run):
    """Frames 6-7 with 3 % of the map points: tracked by visual odometry
    in both; frames 8-9 with the map back: the flag falls in both."""
    j, p = jax_run, port_run
    vo, back = slice(N_BUILD + 5, N_BUILD + 7), slice(N_BUILD + 7, N_BUILD + 9)
    assert p["ok"][vo] == j["ok"][vo] == [True, True]
    assert p["vo"][vo] == j["vo"][vo] == [True, True]
    assert p["ok"][back] == j["ok"][back] == [True, True]
    assert p["vo"][back] == j["vo"][back] == [False, False]
    assert p["kf"][-1] == p["kf"][N_BUILD + 1] and j["kf"][-1] == j["kf"][N_BUILD + 1]
    assert np.abs(np.stack(p["centre"]) - np.stack(j["centre"])).max() < 1e-3
    assert np.linalg.norm(p["centre"][-1] - _centre(seq.poses[N_FRAMES - 1])) < 0.05


def test_cpu_run_launches_no_kernel(port_run):
    assert port_run["launches"] == {"fast_score_nms": 0, "proj_best2": 0, "pair_best2": 0,
                                    "lm_obs": 0}


def test_reset_clears_the_index_and_keeps_the_mode(port_run):
    """A reset empties the retrieval index and re-seeds the RANSAC draws;
    localization mode stays on, as in the JAX package."""
    s = port_run["system"]
    drawn = torch.rand(4, generator=s._reloc_gen)
    s.reset()
    assert not bool(s.retrieval.valid.any()) and not bool(s.retrieval.hist.any())
    assert s.localization_only
    assert torch.equal(torch.rand(4, generator=s._reloc_gen),
                       torch.rand(4, generator=torch.Generator().manual_seed(7)))
    assert not torch.equal(drawn, torch.rand(4, generator=torch.Generator().manual_seed(7)))
    s.deactivate_localization_mode()
    assert not s.localization_only and not s.visual_odometry
