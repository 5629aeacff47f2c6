"""The port's pipelined stereo path against the JAX package on the CPU.

Both packages run ``SlamSystem(small_cfg(), Sensor.STEREO,
enable_loop_closing=False)`` with ``enable_pipelined(lag=3)`` over the
first ``N_FRAMES`` pairs of ``test_stereo_system.SyntheticStereoSequence``
(640x480, 500 dots, a 0.1 m baseline), fed two ways: as rendered
(float32) and cast to uint8.  The JAX package's pipelined step builds its
stereo pyramids from the frames as they come, so on the uint8 feed its
level 0 is uint8 and the SAD differences of octave-0 keypoints wrap
modulo 256 (``ops/stereo.py:78-90``); the port's step reproduces that
with ``stereo_match(..., wrap_level0=True)`` on the float32 pyramids its
extraction built.  The JAX runs share one process and so their compiled
programs (the step compiles once per feed); the first INIT step and the
first OK step with a populated tracking set of each run are captured by
wrapping the module function, and each goes through the port's
``stereo_frame_step`` on JAX's inputs.

Tolerances:

* ``sad_costs`` against JAX's ``_sad_costs_at_level``: exact, wrapped on
  a uint8 level 0 and plain on a float32 one of the same whole numbers
  (and levels 1-7 of whole numbers, so that every sum is exact in any
  order).
* ``stereo_match`` on the step's own pyramids against JAX's on
  ``build_pyramid`` of the frame as it comes: the same ok mask; right_u
  within 1e-4 px (levels 1-7 differ from XLA's by <= 5e-5, ROADMAP T4).
* ``stereo_frame_step``: the INIT step's info row exact; the OK step's
  mode, ok, need_kf and slot exact, inliers within 2 (T10), the pose
  entries within ``POSE_TOL``; the ring features of both steps within
  1e-5, relative or absolute (descriptors, octaves, masks and map-point
  ids exact).
* The run: the lost frames, keyframe insertions and the trace's mode /
  ok / need_kf / inserted exact, inliers within 2; TUM camera centres
  within 1e-3 m (the local BA sums float32 in another order).
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_slam_system import small_cfg
from test_stereo_system import SyntheticStereoSequence

from ydorbslam_tpu.io import kitti as jkitti
from ydorbslam_tpu.ops import extractor as jextractor
from ydorbslam_tpu.ops import stereo as jstereo
from ydorbslam_tpu.ops.pyramid import build_pyramid as jax_pyramid
from ydorbslam_tpu.slam import pipeline as jpipeline
from ydorbslam_tpu.slam.system import Sensor as JaxSensor
from ydorbslam_tpu.slam.system import SlamSystem as JaxSystem

from ydorbslam_tpu_torch.apps import run_kitti_stereo
from ydorbslam_tpu_torch.convert import (
    config_from_dict, features_from_numpy, track_set_from_numpy, track_state_from_numpy,
    track_state_to_numpy,
)
from ydorbslam_tpu_torch.io import KittiStereoDataset, kitti_intrinsics, read_tum_trajectory
from ydorbslam_tpu_torch.ops import launch_counts, reset_launch_counts
from ydorbslam_tpu_torch.ops import stereo
from ydorbslam_tpu_torch.ops.extractor import _extract_orb_pyramid
from ydorbslam_tpu_torch.slam import pipeline as ppipeline
from ydorbslam_tpu_torch.slam import system as psystem
from ydorbslam_tpu_torch.slam.system import Sensor, SlamSystem
from ydorbslam_tpu_torch.testing import KITTI00, make_stereo_frames, write_kitti_sequence

torch.set_num_threads(2)

LAG = 3
N_FRAMES = 8
# The OK step's pose entries: after two pose LMs that sum float32 in
# another order, measured 1.01e-5 apart at most (a translation entry, the
# float32 feed) and 0 on the rotation's diagonal.
POSE_TOL = 2e-5
FEEDS = ("float32", "uint8")


def port_cfg():
    return config_from_dict(dataclasses.asdict(small_cfg()))


def _np(x):
    """A numpy copy of a (nested) NamedTuple of JAX arrays, taken before
    the call that donates them."""
    if hasattr(x, "_asdict"):
        return {k: _np(v) for k, v in x._asdict().items()}
    return np.array(x)


def _frames(feed):
    seq = SyntheticStereoSequence(np.random.default_rng(42), n_frames=12, n_landmarks=500)
    out = []
    for i in range(N_FRAMES):
        t, left, right = seq.frame(i)
        if feed == "uint8":
            left, right = left.astype(np.uint8), right.astype(np.uint8)
        out.append((t, left, right))
    return out


def _run_port(frames):
    s = SlamSystem(port_cfg(), Sensor.STEREO, enable_mapping=True, enable_loop_closing=False,
                   device="cpu")
    s.enable_pipelined(lag=LAG)
    for f in frames:
        s.track_stereo_pipelined(*f)
    s.shutdown()
    return s


@pytest.fixture(scope="module")
def runs():
    """Both feeds through both packages, with the JAX package's INIT and
    first populated OK step of each captured."""
    orig = jpipeline.stereo_frame_step
    min_local = small_cfg().tracking.min_matches_local_map
    cap = {}

    def step(state, gray_l, gray_r, trkset, cam, inv_sigma2_tab, depth_threshold, **kw):
        c = cap[cap["feed"]]
        want = None
        if "init" not in c:
            want = "init"
        elif ("ok" not in c and int(state.mode) == jpipeline.MODE_OK
              and int(np.sum(np.asarray(trkset.valid))) >= min_local):
            want = "ok"
        if want:
            rec = dict(state=_np(state), gray_l=np.array(gray_l), gray_r=np.array(gray_r),
                       trkset=_np(trkset), depth_threshold=float(depth_threshold), kw=kw)
        out = orig(state, gray_l, gray_r, trkset, cam, inv_sigma2_tab, depth_threshold, **kw)
        if want:
            rec["out"] = _np(out)
            c[want] = rec
        return out

    old_env = os.environ.get("YDORBSLAM_TRACE_FRAMES")
    os.environ["YDORBSLAM_TRACE_FRAMES"] = "1"
    jpipeline.stereo_frame_step = step
    out = {}
    try:
        for feed in FEEDS:
            frames = _frames(feed)
            cap["feed"] = feed
            cap[feed] = {}
            j = JaxSystem(small_cfg(), JaxSensor.STEREO, enable_loop_closing=False)
            j.enable_pipelined(lag=LAG)
            for f in frames:
                j.track_stereo_pipelined(*f)
            j.shutdown()
            reset_launch_counts()
            p = _run_port(frames)
            out[feed] = dict(jax=j, port=p, cap=cap[feed], launches=launch_counts())
    finally:
        jpipeline.stereo_frame_step = orig
        if old_env is None:
            os.environ.pop("YDORBSLAM_TRACE_FRAMES", None)
        else:
            os.environ["YDORBSLAM_TRACE_FRAMES"] = old_env
    return out


# ----------------------------------------------------------------------
# The level-0 wrap of the SAD costs, exact
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def frame0():
    """Frame 0 of the sequence in both feeds, with the JAX package's
    features of each image and its pyramids of the frame as it comes."""
    out = {}
    cam = JaxSystem(small_cfg(), JaxSensor.STEREO, enable_loop_closing=False).cam
    o = small_cfg().orb
    for feed in FEEDS:
        _, left, right = _frames(feed)[0]
        feats = [jextractor.extract_orb(jnp.asarray(im), cam, n_features=o.n_features,
                                        capacity=small_cfg().n_keypoints, has_distortion=False)
                 for im in (left, right)]
        pyrs = [jax_pyramid(jnp.asarray(im)) for im in (left, right)]
        out[feed] = dict(left=left, right=right, jcam=cam, fl=feats[0], fr=feats[1],
                         pl=pyrs[0], pr=pyrs[1])
    return out


@pytest.mark.parametrize("feed", FEEDS)
def test_sad_costs_equal_jax_at_level_zero_and_above(frame0, feed):
    """Every valid keypoint of the uint8 frame 0 at its own octave, slid
    around a right x up to 40 level px left of it (at least 0: the right
    keypoints lie inside the image): the port's costs, with
    ``wrap_level0`` for a uint8 level 0, equal ``_sad_costs_at_level`` on
    the same whole numbers as uint8 (``feed`` "uint8") or float32
    ("float32") at level 0 and rounded float32 levels 1-7, at every row.
    (A right x below -2 level px would part the two: the JAX package's
    ``extract_patches`` wraps a negative column start Python-style, the
    port clamps it to 0; ``stereo_match`` never asks for one.)"""
    d = frame0["uint8"]
    fl = _np(d["fl"])
    valid = fl["valid"]
    octave = fl["octave"][valid]
    sigma = (1.2 ** octave).astype(np.float32)
    uv = (fl["uv_raw"][valid] / sigma[:, None]).astype(np.float32)
    rng = np.random.default_rng(3)
    ur = np.maximum(uv[:, 0] - rng.uniform(0.0, 40.0, len(uv)), 0.0).astype(np.float32)
    jl, jr = ([np.asarray(x[0]).astype(feed)] + [np.round(np.asarray(y)) for y in x[1:]]
              for x in (d["pl"], d["pr"]))
    ref = np.zeros((len(uv), 2 * stereo.SAD_L + 1), np.float32)
    for level in range(len(jl)):
        c = np.asarray(jstereo._sad_costs_at_level(jnp.asarray(jl[level]), jnp.asarray(jr[level]),
                                                   jnp.asarray(uv), jnp.asarray(ur)))
        ref = np.where((octave == level)[:, None], c, ref)
    pl, pr = ([torch.from_numpy(y.astype(np.float32)) for y in x] for x in (jl, jr))
    args = (pl, pr, torch.from_numpy(octave), torch.from_numpy(uv), torch.from_numpy(ur))
    got = stereo.sad_costs(*args, wrap_level0=feed == "uint8").numpy()
    assert (octave == 0).sum() > 50 and (octave > 0).sum() > 50
    np.testing.assert_array_equal(got, ref)
    # The wrap is what makes the uint8 costs JAX's: the other form differs
    # on octave-0 rows only.
    other = stereo.sad_costs(*args, wrap_level0=feed != "uint8").numpy()
    differs = (other != ref).any(axis=1)
    assert differs[octave == 0].mean() > 0.5 and not differs[octave > 0].any()


@pytest.mark.parametrize("feed", FEEDS)
def test_stereo_match_on_the_step_pyramids_matches_jax(frame0, feed):
    """``stereo_match`` on the float32 pyramids the port's extraction builds
    (the step's), with the wrap on the uint8 feed, against JAX's on
    ``build_pyramid`` of the frame as it comes, from the same features."""
    d = frame0[feed]
    jout = _np(jstereo.stereo_match(d["fl"], d["fr"], d["pl"], d["pr"], d["jcam"]))
    cam = SlamSystem(port_cfg(), Sensor.STEREO, enable_loop_closing=False, device="cpu").cam
    o = small_cfg().orb
    kw = dict(n_features=o.n_features, capacity=small_cfg().n_keypoints, n_levels=o.n_levels,
              scale_factor=o.scale_factor, th_high=o.ini_th_fast, th_low=o.min_th_fast,
              has_distortion=False, subpixel=o.subpixel)
    _, pl = _extract_orb_pyramid(torch.from_numpy(d["left"]), cam, **kw)
    _, pr = _extract_orb_pyramid(torch.from_numpy(d["right"]), cam, **kw)
    assert all(x.dtype == torch.float32 for x in (*pl, *pr))
    out = stereo.stereo_match(features_from_numpy(_np(d["fl"])), features_from_numpy(_np(d["fr"])),
                              pl, pr, cam, wrap_level0=feed == "uint8")
    ok, jok = out.depth.numpy() > 0, jout["depth"] > 0
    np.testing.assert_array_equal(ok, jok)
    assert jok.sum() > 100
    np.testing.assert_allclose(out.right_u.numpy()[ok], jout["right_u"][ok], rtol=0, atol=1e-4)


# ----------------------------------------------------------------------
# The frame step on JAX's captured inputs
# ----------------------------------------------------------------------

def _port_step(rec, system):
    state = track_state_from_numpy(rec["state"])
    slot = int(rec["state"]["frame_idx"]) % ppipeline.RING
    out = ppipeline.stereo_frame_step(
        state, torch.from_numpy(rec["gray_l"]), torch.from_numpy(rec["gray_r"]),
        track_set_from_numpy(rec["trkset"]), system.cam, system.inv_sigma2_tab,
        torch.tensor(np.float32(rec["depth_threshold"])), slot, **rec["kw"],
    )
    return track_state_to_numpy(out), slot


def _same_ring_features(out, ref, slot):
    a, b = out["ring_feats"], ref["ring_feats"]
    for name in ("valid", "octave", "desc"):
        np.testing.assert_array_equal(a[name][slot].view(b[name].dtype), b[name][slot], name)
    for name in ("uv", "uv_raw", "angle", "response", "right_u", "depth"):
        np.testing.assert_allclose(a[name][slot], b[name][slot], rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    np.testing.assert_array_equal(out["ring_mpid"][slot], ref["ring_mpid"][slot])


@pytest.mark.parametrize("feed", FEEDS)
def test_init_step_matches_jax(runs, feed):
    rec = runs[feed]["cap"]["init"]
    assert int(rec["state"]["mode"]) == ppipeline.MODE_INIT
    assert rec["gray_l"].dtype == np.dtype(feed)
    out, slot = _port_step(rec, runs[feed]["port"])
    ref = rec["out"]
    np.testing.assert_array_equal(out["ring_info"][slot], ref["ring_info"][slot])
    assert int(out["mode"]) == int(ref["mode"]) == ppipeline.MODE_OK
    _same_ring_features(out, ref, slot)
    np.testing.assert_array_equal(out["T_cw"], ref["T_cw"])


@pytest.mark.parametrize("feed", FEEDS)
def test_ok_step_matches_jax(runs, feed):
    rec = runs[feed]["cap"]["ok"]
    assert int(rec["state"]["mode"]) == ppipeline.MODE_OK
    assert rec["trkset"]["valid"].sum() >= small_cfg().tracking.min_matches_local_map
    out, slot = _port_step(rec, runs[feed]["port"])
    ref = rec["out"]
    a = ppipeline.FrameInfo.unpack(out["ring_info"][slot])
    b = ppipeline.FrameInfo.unpack(ref["ring_info"][slot])
    assert (a.mode, a.ok, a.need_kf, a.ring_slot) == (b.mode, b.ok, b.need_kf, b.ring_slot)
    assert a.ok and a.ring_slot == slot
    assert abs(a.n_inliers - b.n_inliers) <= 2, (a.n_inliers, b.n_inliers)
    np.testing.assert_allclose(a.T_cw, b.T_cw, rtol=0, atol=POSE_TOL)
    np.testing.assert_allclose(out["T_cw"], ref["T_cw"], rtol=0, atol=POSE_TOL)
    _same_ring_features(out, ref, slot)
    assert int(out["frame_idx"]) == int(ref["frame_idx"])


# ----------------------------------------------------------------------
# The slice as a whole
# ----------------------------------------------------------------------

def _centres(path):
    t, P = read_tum_trajectory(path)[:2]
    return np.asarray(t), np.asarray(P)[:, :3]


@pytest.mark.parametrize("feed", FEEDS)
def test_pipelined_stereo_run_matches_jax(runs, feed, tmp_path):
    j, p = runs[feed]["jax"], runs[feed]["port"]
    lost = [r.lost for r in p.records]
    assert lost == [r.lost for r in j.records] and len(lost) == N_FRAMES
    assert len(p.frame_trace) == len(j.frame_trace) == N_FRAMES
    for i, (a, b) in enumerate(zip(p.frame_trace, j.frame_trace)):
        assert (a[0], a[1], a[2], a[4], a[5]) == (b[0], b[1], b[2], b[4], b[5]), (i, a, b)
        assert abs(a[3] - b[3]) <= 2, (i, a, b)
    assert p.n_keyframes == j.n_keyframes >= 3
    js, ps = j.run_stats(), p.run_stats()
    for k in ("frames_lost", "keyframes_inserted", "keyframes_culled", "local_ba_runs"):
        assert ps[k] == js[k], k
    assert ps["local_ba_runs"] >= 1
    j.save_trajectory_tum(str(tmp_path / "jax.txt"))
    p.save_trajectory_tum(str(tmp_path / "port.txt"))
    tj, cj = _centres(tmp_path / "jax.txt")
    tp, cp = _centres(tmp_path / "port.txt")
    np.testing.assert_array_equal(tp, tj)
    assert np.abs(cp - cj).max() < 1e-3
    assert p._pending == [] and all(v == 0 for v in runs[feed]["launches"].values())


# ----------------------------------------------------------------------
# The facade
# ----------------------------------------------------------------------

def test_precompile_warms_the_stereo_step_and_leaves_the_live_state(runs):
    s = SlamSystem(port_cfg(), Sensor.STEREO, enable_mapping=True, enable_loop_closing=True,
                   device="cpu")
    s.enable_pipelined(lag=LAG)
    for f in _frames("uint8")[:4]:
        s.track_stereo_pipelined(*f)
    before = dict(map={k: v.clone() for k, v in s.map._asdict().items()},
                  index={k: v.clone() for k, v in s.retrieval._asdict().items()},
                  state=track_state_to_numpy(s._dstate),
                  trkset={k: v.clone() for k, v in s._trkset._asdict().items()},
                  gen=s.loop_closer._impl.generator.get_state(),
                  reloc=s._reloc_gen.get_state(), n_keyframes=s.n_keyframes,
                  records=len(s.records), pending=list(s._pending))
    calls = []
    orig = dict(stereo=psystem.stereo_frame_step, rgbd=psystem.rgbd_frame_step)

    def spy(kind):
        def call(state, a, b, *args, **kw):
            calls.append((kind, a.dtype, b.dtype, tuple(a.shape)))
            return orig[kind](state, a, b, *args, **kw)
        return call

    psystem.stereo_frame_step, psystem.rgbd_frame_step = spy("stereo"), spy("rgbd")
    try:
        s.precompile()
    finally:
        psystem.stereo_frame_step, psystem.rgbd_frame_step = orig["stereo"], orig["rgbd"]
    c = small_cfg().camera
    assert calls == [("stereo", torch.uint8, torch.uint8, (c.height, c.width))]
    for k, v in s.map._asdict().items():
        assert torch.equal(v, before["map"][k]), k
    for k, v in s.retrieval._asdict().items():
        assert torch.equal(v, before["index"][k]), k
    after = track_state_to_numpy(s._dstate)
    for k, v in before["state"].items():
        for a, b in ((after[k], v),) if not isinstance(v, dict) else (
                (after[k][n], v[n]) for n in v):
            np.testing.assert_array_equal(a, b, err_msg=k)
    for k, v in s._trkset._asdict().items():
        assert torch.equal(v, before["trkset"][k]), k
    assert torch.equal(s.loop_closer._impl.generator.get_state(), before["gen"])
    assert torch.equal(s._reloc_gen.get_state(), before["reloc"])
    assert (s.n_keyframes, len(s.records), s._pending) == (
        before["n_keyframes"], before["records"], before["pending"])


def test_stereo_step_refuses_a_pair_of_two_dtypes():
    s = SlamSystem(port_cfg(), Sensor.STEREO, enable_loop_closing=False, device="cpu")
    s.enable_pipelined(lag=LAG)
    _, left, right = _frames("float32")[0]
    with pytest.raises(ValueError, match="two dtypes"):
        s.track_stereo_pipelined(0.0, left.astype(np.uint8), right)


# ----------------------------------------------------------------------
# The KITTI sequence writer and the runner
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def kitti_seq(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti") / "seq")
    frames, poses = make_stereo_frames(3)
    write_kitti_sequence(root, frames, poses)
    return root, frames, poses


def test_write_kitti_sequence_reads_back_in_both_packages(kitti_seq):
    root, frames, poses = kitti_seq
    calib = os.path.join(root, "calib.txt")
    c = KITTI00
    assert kitti_intrinsics(calib) == jkitti.kitti_intrinsics(calib) == (
        c["fx"], c["fy"], c["cx"], c["cy"], c["bf"])
    ds, jds = KittiStereoDataset(root), jkitti.KittiStereoDataset(root)
    assert len(ds) == len(jds) == len(frames)
    for i, (t, left, right) in enumerate(frames):
        for got in (ds[i], jds[i]):
            assert got[0] == t
            np.testing.assert_array_equal(got[1], left)
            np.testing.assert_array_equal(got[2], right)
            assert got[1].dtype == np.uint8
    P = np.loadtxt(os.path.join(root, "poses.txt")).reshape(-1, 3, 4)
    for row, T in zip(P, poses):
        np.testing.assert_allclose(row, np.linalg.inv(T)[:3], atol=1e-11)


def test_kitti_runner_pipelined_on_the_cpu(kitti_seq, tmp_path, capsys):
    """``run_kitti_stereo --pipelined --lag 3 --device cpu`` on a 3-frame
    KITTI-00 directory prints the runner's lines and drains every frame."""
    root, _, _ = kitti_seq
    out_traj = str(tmp_path / "traj.txt")
    system = run_kitti_stereo.main([root, "--pipelined", "--lag", "3", "--device", "cpu",
                                    "--no-loop", "--poses", os.path.join(root, "poses.txt"),
                                    "--out-trajectory", out_traj])
    text = capsys.readouterr().out
    for line in ("frame 0/3 state=", "median tracking time:", "mean tracking time:",
                 "--- run stats ---", "frames        3  (lost 0", "ATE RMSE:"):
        assert line in text, text
    assert system._pipe_lag == 3 and system._pending == [] and system.sensor == Sensor.STEREO
    with open(out_traj) as f:
        assert len(f.read().splitlines()) == 3
