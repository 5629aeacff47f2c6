"""The port's pipelined RGB-D path against the JAX package on the CPU.

Both packages run ``enable_pipelined(lag=3)`` under
``test_slam_system.small_cfg`` with mapping on and loop closing off, on
``SyntheticRgbdSequence(default_rng(42), 20 frames, 500 landmarks)`` (the
workload of ``tests/test_pipeline.run_pipelined``) and on
``default_rng(0)`` with 8 frames, where the reference loses frames 1-3
while the map bootstraps (and 6-7 after it).  The JAX runs share one
process, so they share their compiled programs; the 20-frame run's first
INIT step, one OK step with a populated tracking set, and its last
``mapping_prep`` and ``mapping_finish`` inputs are captured by wrapping
the module functions, and each goes through the port's counterpart.

Tolerances: the lost pattern, keyframe insertions, the frame trace's
mode / ok / need_kf / inserted, the run counters and the INIT step's info
row are exact; inliers within 2 (T10: a gate on a float boundary may
flip); the OK step's pose within 1e-4 m and 1e-4 rad, its mode, ok,
need_kf, slot and ring map-point ids exact, its found/visible
accumulators apart in at most 2 rows; ``mapping_prep``/``mapping_finish``
at ``test_torch_mapping_system``'s tolerances (the BA-moved floats within
1e-3); TUM camera centres within 1e-3 m (the local BA sums float32 in
another order).
The small helpers (``empty_track_state``, the counter fold and clear,
``read_ring``, ``FrameInfo``) are exact.  A CPU run launches no CUDA kernel.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from synthetic import SyntheticRgbdSequence
from test_slam_system import small_cfg
from test_torch_mapstate import assert_maps_match, map_np

from ydorbslam_tpu.slam import mapping as jmapping
from ydorbslam_tpu.slam import pipeline as jpipeline
from ydorbslam_tpu.slam.map_state import empty_map as jax_empty_map
from ydorbslam_tpu.slam.system import Sensor as JaxSensor
from ydorbslam_tpu.slam.system import SlamSystem as JaxSystem

from ydorbslam_tpu_torch.convert import (
    config_from_dict, map_state_from_numpy, map_state_to_numpy, track_set_from_numpy,
    track_state_from_numpy, track_state_to_numpy,
)
from ydorbslam_tpu_torch.geometry.se3 import so3_log
from ydorbslam_tpu_torch.io import read_tum_trajectory
from ydorbslam_tpu_torch.ops import launch_counts, reset_launch_counts
from ydorbslam_tpu_torch.slam import mapping as pmapping
from ydorbslam_tpu_torch.slam import pipeline as ppipeline
from ydorbslam_tpu_torch.slam import serialize
from ydorbslam_tpu_torch.slam.system import Sensor, SlamSystem

torch.set_num_threads(2)

LAG = 3
N_MAIN, N_BOOT = 20, 8
OK_FRAME = 8  # the OK step captured: the first from this frame on with a populated set


def port_cfg():
    return config_from_dict(dataclasses.asdict(small_cfg()))


def _np(x):
    """A numpy copy of a (nested) NamedTuple of JAX arrays, taken before
    the call that donates them."""
    if hasattr(x, "_asdict"):
        return {k: _np(v) for k, v in x._asdict().items()}
    return np.array(x)


def _frames(seed, n):
    seq = SyntheticRgbdSequence(np.random.default_rng(seed), n_frames=n, n_landmarks=500)
    return [seq.frame(i) for i in range(n)]


def _run_port(frames):
    s = SlamSystem(port_cfg(), Sensor.RGBD, enable_mapping=True, enable_loop_closing=False,
                   device="cpu")
    s.enable_pipelined(lag=LAG)
    for f in frames:
        s.track_rgbd_pipelined(*f)
    pending = len(s._pending)
    s.shutdown()
    return s, pending


@pytest.fixture(scope="module")
def runs():
    main, boot = _frames(42, N_MAIN), _frames(0, N_BOOT)
    cap = {}
    orig = dict(step=jpipeline.rgbd_frame_step, prep=jmapping.mapping_prep,
                finish=jmapping.mapping_finish)
    min_local = small_cfg().tracking.min_matches_local_map

    def step(state, gray, depth, trkset, cam, inv_sigma2_tab, depth_threshold, **kw):
        want = None
        if cap.get("capture"):
            i = cap["calls"] = cap.get("calls", -1) + 1
            if "init" not in cap:
                want = "init"
            elif ("ok" not in cap and i >= OK_FRAME and int(state.mode) == jpipeline.MODE_OK
                  and int(np.sum(np.asarray(trkset.valid))) >= min_local):
                want = "ok"
        if want:
            rec = dict(state=_np(state), gray=np.array(gray), depth=np.array(depth),
                       trkset=_np(trkset), depth_threshold=float(depth_threshold),
                       kw={k: float(v) if k == "depth_scale" else v for k, v in kw.items()})
        out = orig["step"](state, gray, depth, trkset, cam, inv_sigma2_tab, depth_threshold, **kw)
        if want:
            rec["out"] = _np(out)
            cap[want] = rec
        return out

    def prep(m, kf_id, kf_count, cam, **kw):
        rec = dict(map=map_np(m), kf_id=int(kf_id), kf_count=int(kf_count), kw=kw)
        out = orig["prep"](m, kf_id, kf_count, cam, **kw)
        cap["prep"] = dict(rec, out=map_np(out))
        return out

    def finish(m, kf_id, cam, inv_sigma2_tab, depth_threshold, **kw):
        rec = dict(map=map_np(m), kf_id=int(kf_id), depth_threshold=float(depth_threshold),
                   kw=kw)
        out = orig["finish"](m, kf_id, cam, inv_sigma2_tab, depth_threshold, **kw)
        cap["finish"] = dict(rec, out=map_np(out[0]), snap=np.array(out[1]))
        return out

    old_env = os.environ.get("YDORBSLAM_TRACE_FRAMES")
    os.environ["YDORBSLAM_TRACE_FRAMES"] = "1"
    jpipeline.rgbd_frame_step, jmapping.mapping_prep, jmapping.mapping_finish = (
        step, prep, finish)
    try:
        jax_boot = JaxSystem(small_cfg(), JaxSensor.RGBD, enable_loop_closing=False)
        jax_boot.enable_pipelined(lag=LAG)
        for f in boot:
            jax_boot.track_rgbd_pipelined(*f)
        jax_boot.shutdown()
        cap["capture"] = True
        jax_main = JaxSystem(small_cfg(), JaxSensor.RGBD, enable_loop_closing=False)
        jax_main.enable_pipelined(lag=LAG)
        for f in main:
            jax_main.track_rgbd_pipelined(*f)
        jax_main.shutdown()
        reset_launch_counts()
        port_main, pending = _run_port(main)
        port_boot, _ = _run_port(boot)
        launches = launch_counts()
    finally:
        jpipeline.rgbd_frame_step, jmapping.mapping_prep, jmapping.mapping_finish = (
            orig["step"], orig["prep"], orig["finish"])
        if old_env is None:
            os.environ.pop("YDORBSLAM_TRACE_FRAMES", None)
        else:
            os.environ["YDORBSLAM_TRACE_FRAMES"] = old_env
    return dict(jax_main=jax_main, jax_boot=jax_boot, port_main=port_main,
                port_boot=port_boot, pending=pending, launches=launches, cap=cap,
                main=main)


# ----------------------------------------------------------------------
# The small helpers, exact
# ----------------------------------------------------------------------

def _assert_state_equal(port_np, jax_np):
    for name, a in jax_np.items():
        b = port_np[name]
        if isinstance(a, dict):
            _assert_state_equal(b, a)
        else:
            assert b.shape == a.shape, (name, b.shape, a.shape)
            np.testing.assert_array_equal(b, a, err_msg=name)


def test_empty_track_state_matches_jax():
    port = track_state_to_numpy(ppipeline.empty_track_state(64, 128, device="cpu"))
    ref = _np(jpipeline.empty_track_state(64, 128))
    _assert_state_equal(port, ref)
    assert port["ring_feats"]["desc"].shape == (ppipeline.RING, 64, 8)
    assert ppipeline.INFO_DIM == jpipeline.INFO_DIM and ppipeline.RING == jpipeline.RING
    assert (ppipeline.MODE_INIT, ppipeline.MODE_OK, ppipeline.MODE_LOST) == (
        jpipeline.MODE_INIT, jpipeline.MODE_OK, jpipeline.MODE_LOST)


def test_fold_and_clear_counters_match_jax():
    """Map-point ids with -1, ids past the map and invalid rows: those rows
    drop, the others add, the same as JAX's ``.at[].add(mode="drop")``."""
    rng = np.random.default_rng(5)
    K, N, M, O, P = 4, 8, 40, 4, 64
    jm = jax_empty_map(K, N, M, O)
    jm = jm._replace(mp_visible=rng.integers(0, 9, M).astype(np.int32),
                     mp_found=rng.integers(0, 5, M).astype(np.int32))
    pts = rng.integers(-1, M + 4, P).astype(np.int32)
    pts[:6] = [M, M + 3, -1, 0, 0, M - 1]  # out of range, empty, a repeated id, the last
    valid = rng.random(P) < 0.8
    vis = rng.integers(0, 7, P).astype(np.int32)
    found = rng.integers(0, 3, P).astype(np.int32)
    pm = map_state_from_numpy(map_np(jm))
    out = ppipeline.fold_track_counters(pm, torch.from_numpy(pts.astype(np.int64)),
                                        torch.from_numpy(valid), torch.from_numpy(vis),
                                        torch.from_numpy(found))
    ref = jpipeline.fold_track_counters(jm, pts, valid, vis, found)
    for name in ("mp_visible", "mp_found"):
        np.testing.assert_array_equal(getattr(out, name).numpy(), np.asarray(getattr(ref, name)))
    st = ppipeline.empty_track_state(8, P, device="cpu")._replace(
        vis_acc=torch.from_numpy(vis), found_acc=torch.from_numpy(found))
    cleared = ppipeline.clear_track_counters(st)
    jst = jpipeline.empty_track_state(8, P)._replace(vis_acc=vis, found_acc=found)
    jcleared = _np(jpipeline.clear_track_counters(jst))
    _assert_state_equal(track_state_to_numpy(cleared), jcleared)


def test_read_ring_matches_jax_and_returns_copies():
    rng = np.random.default_rng(6)
    n = 16
    ref = _np(jpipeline.empty_track_state(n, 32))
    R = ppipeline.RING
    ring = ref["ring_feats"]
    ring["uv"] = rng.random((R, n, 2)).astype(np.float32)
    ring["desc"] = rng.integers(0, 2**32, (R, n, 8), dtype=np.uint64).astype(np.uint32)
    ring["valid"] = rng.random((R, n)) < 0.5
    ring["depth"] = rng.random((R, n)).astype(np.float32)
    ref["ring_mpid"] = rng.integers(-1, 100, (R, n)).astype(np.int32)
    ref["ring_T"] = rng.random((R, 4, 4)).astype(np.float32)
    port = track_state_from_numpy(ref)
    jstate = jpipeline.TrackState(**{
        k: (jpipeline.FrameFeatures(**v) if isinstance(v, dict) else v) for k, v in ref.items()
    })
    for slot in (0, 5, R - 1):
        f, mpid, T = ppipeline.read_ring(port, slot)
        jf, jmpid, jT = jpipeline.read_ring(jstate, slot)
        for name, a in jf._asdict().items():
            b = getattr(f, name).numpy()
            np.testing.assert_array_equal(b.view(np.uint32) if name == "desc" else b,
                                          np.asarray(a), err_msg=name)
        np.testing.assert_array_equal(mpid.numpy(), np.asarray(jmpid))
        np.testing.assert_array_equal(T.numpy(), np.asarray(jT))
        before = (f.uv.clone(), mpid.clone(), T.clone())
        port.ring_feats.uv[slot] += 1.0
        port.ring_mpid[slot] += 1
        port.ring_T[slot] += 1.0
        assert torch.equal(f.uv, before[0]) and torch.equal(mpid, before[1])
        assert torch.equal(T, before[2])


def test_frame_info_unpacks_as_jax():
    row = np.arange(21, dtype=np.float32) * 0.5
    row[:5] = [2, 1, 37, 0, 11]
    a, b = ppipeline.FrameInfo.unpack(row), jpipeline.FrameInfo.unpack(row)
    assert a[:5] == b[:5] and a.T_cw.dtype == np.float64
    np.testing.assert_array_equal(a.T_cw, b.T_cw)


# ----------------------------------------------------------------------
# The frame step on JAX's captured inputs
# ----------------------------------------------------------------------

def _port_step(rec, system):
    state = track_state_from_numpy(rec["state"])
    slot = int(rec["state"]["frame_idx"]) % ppipeline.RING
    kw = dict(rec["kw"])
    depth_scale = torch.tensor(np.float32(kw.pop("depth_scale")))
    out = ppipeline.rgbd_frame_step(
        state, torch.from_numpy(rec["gray"]), torch.from_numpy(rec["depth"]),
        track_set_from_numpy(rec["trkset"]), system.cam, system.inv_sigma2_tab,
        torch.tensor(np.float32(rec["depth_threshold"])), slot, depth_scale=depth_scale, **kw,
    )
    return track_state_to_numpy(out), slot


def test_init_step_matches_jax(runs):
    rec = runs["cap"]["init"]
    assert int(rec["state"]["mode"]) == ppipeline.MODE_INIT
    out, slot = _port_step(rec, runs["port_main"])
    ref = rec["out"]
    np.testing.assert_array_equal(out["ring_info"][slot], ref["ring_info"][slot])
    assert int(out["mode"]) == int(ref["mode"]) == ppipeline.MODE_OK
    np.testing.assert_array_equal(out["ring_mpid"][slot], ref["ring_mpid"][slot])
    np.testing.assert_array_equal(out["T_cw"], ref["T_cw"])


def _rot_err(Ra, Rb):
    return float(torch.linalg.norm(so3_log(torch.from_numpy(Ra @ Rb.T).double())))


def test_ok_step_matches_jax(runs):
    rec = runs["cap"]["ok"]
    assert int(rec["state"]["mode"]) == ppipeline.MODE_OK
    assert rec["trkset"]["valid"].sum() >= small_cfg().tracking.min_matches_local_map
    out, slot = _port_step(rec, runs["port_main"])
    ref = rec["out"]
    a = ppipeline.FrameInfo.unpack(out["ring_info"][slot])
    b = jpipeline.FrameInfo.unpack(ref["ring_info"][slot])
    assert (a.mode, a.ok, a.need_kf, a.ring_slot) == (b.mode, b.ok, b.need_kf, b.ring_slot)
    assert a.ok and a.ring_slot == slot
    assert abs(a.n_inliers - b.n_inliers) <= 2, (a.n_inliers, b.n_inliers)
    for T in (a.T_cw, out["T_cw"].astype(np.float64)):
        cp, cj = -T[:3, :3].T @ T[:3, 3], -b.T_cw[:3, :3].T @ b.T_cw[:3, 3]
        assert np.abs(cp - cj).max() < 1e-4
        assert _rot_err(T[:3, :3], b.T_cw[:3, :3]) < 1e-4
    np.testing.assert_array_equal(out["ring_mpid"][slot], ref["ring_mpid"][slot])
    np.testing.assert_allclose(out["velocity"], ref["velocity"], atol=1e-4)
    for name in ("vis_acc", "found_acc"):
        assert (out[name] != ref[name]).sum() <= 2, name
    assert int(out["frame_idx"]) == int(ref["frame_idx"])
    assert int(out["since_reloc"]) == int(ref["since_reloc"])
    np.testing.assert_array_equal(out["last_lms_valid"], ref["last_lms_valid"])
    np.testing.assert_allclose(out["last_lms"], ref["last_lms"], atol=1e-3)


def test_mapping_prep_and_finish_match_jax(runs):
    """``mapping_prep`` on JAX's last input of the run, and
    ``mapping_finish`` on its: the keyframe graph exact, bindings at
    ``test_torch_mapping_system``'s 99.5 %, BA floats within 1e-3.  On
    the port's side the pair gives exactly what ``mapping_step`` gives."""
    system = runs["port_main"]
    cam, tab = system.cam, system.inv_sigma2_tab
    prep, fin = runs["cap"]["prep"], runs["cap"]["finish"]
    m = pmapping.mapping_prep(map_state_from_numpy(prep["map"]), prep["kf_id"],
                              prep["kf_count"], cam, **prep["kw"])
    ref = prep["out"]
    assert_maps_match(ref, m, fields=["kf_valid", "kf_frame_id", "parent", "covis", "kf_pose",
                                      "mp_first_kf", "mp_found", "mp_visible"])
    for name in ("kf_mp", "mp_obs_kf", "mp_valid"):
        assert (getattr(m, name).numpy() == ref[name]).mean() > 0.995, name
    thr = torch.tensor(np.float32(fin["depth_threshold"]))
    m2, snap = pmapping.mapping_finish(map_state_from_numpy(fin["map"]), fin["kf_id"], cam,
                                       tab, thr, **fin["kw"])
    ref2 = fin["out"]
    assert_maps_match(ref2, m2, fields=["kf_valid", "kf_frame_id", "parent", "covis"])
    # The culled keyframes' frozen transforms come from BA-moved poses.
    for name in ("kf_pose", "kf_T_c2p"):
        np.testing.assert_allclose(getattr(m2, name).numpy(), ref2[name], atol=1e-3)
    both = ref2["mp_valid"] & m2.mp_valid.numpy()
    assert np.median(np.abs(m2.mp_pos.numpy() - ref2["mp_pos"])[both]) < 1e-3
    K = ref2["kf_valid"].shape[0]
    np.testing.assert_array_equal(snap[:4 * K].numpy(), fin["snap"][:4 * K])
    # In the port the two halves are mapping_step.
    src = map_state_from_numpy(prep["map"])
    kw_fin = dict(fin["kw"])
    half = pmapping.mapping_finish(
        pmapping.mapping_prep(src, prep["kf_id"], prep["kf_count"], cam, **prep["kw"]),
        prep["kf_id"], cam, tab, thr, **kw_fin)
    whole = pmapping.mapping_step(map_state_from_numpy(prep["map"]), prep["kf_id"],
                                  prep["kf_count"], cam, tab, thr, **prep["kw"], **kw_fin)
    for name, a in map_state_to_numpy(half[0]).items():
        np.testing.assert_array_equal(a, map_state_to_numpy(whole[0])[name], err_msg=name)
    assert torch.equal(half[1], whole[1])


# ----------------------------------------------------------------------
# The slice as a whole
# ----------------------------------------------------------------------

def _centres(path):
    t, P = read_tum_trajectory(path)[:2]
    return np.asarray(t), np.asarray(P)[:, :3]


def _same_trace(port, ref):
    assert len(port.frame_trace) == len(ref.frame_trace)
    for i, (a, b) in enumerate(zip(port.frame_trace, ref.frame_trace)):
        assert (a[0], a[1], a[2], a[4], a[5]) == (b[0], b[1], b[2], b[4], b[5]), (i, a, b)
        assert abs(a[3] - b[3]) <= 2, (i, a, b)


def test_pipelined_slice_matches_jax(runs, tmp_path):
    jax_sys, port = runs["jax_main"], runs["port_main"]
    lost = [r.lost for r in port.records]
    assert lost == [r.lost for r in jax_sys.records] and len(lost) == N_MAIN
    assert not any(lost)
    _same_trace(port, jax_sys)
    assert port.n_keyframes == jax_sys.n_keyframes >= 5
    js, ps = jax_sys.run_stats(), port.run_stats()
    for k in ("frames_total", "frames_lost", "keyframes_inserted", "keyframes_culled",
              "local_ba_runs", "inlier_frames", "keyframes_live"):
        assert ps[k] == js[k], k
    # One deferred local BA per drain that inserted a keyframe from the
    # third keyframe on, not one per keyframe.
    assert 0 < ps["local_ba_runs"] < ps["keyframes_inserted"] - 2
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


def test_bootstrap_loss_matches_jax(runs):
    """Seed 0, 8 frames: both packages lose frames 1-3 while the map has
    one keyframe (no relocalization below two), track 4-5 and lose 6-7."""
    port, jax_sys = runs["port_boot"], runs["jax_boot"]
    lost = [i for i, r in enumerate(port.records) if r.lost]
    assert lost == [i for i, r in enumerate(jax_sys.records) if r.lost]
    assert lost[:3] == [1, 2, 3] and 4 not in lost
    _same_trace(port, jax_sys)
    assert port.n_keyframes == jax_sys.n_keyframes


def test_cpu_pipelined_run_launches_no_kernel(runs):
    assert runs["launches"] == {"fast_score_nms": 0, "proj_best2": 0, "pair_best2": 0,
                                "lm_obs": 0, "pose_lm": 0}


# ----------------------------------------------------------------------
# The facade
# ----------------------------------------------------------------------

def test_shutdown_drains_every_pending_frame(runs):
    port = runs["port_main"]
    assert runs["pending"] > 0
    assert port._pending == [] and len(port.records) == N_MAIN


def test_precompile_leaves_the_live_state_untouched(runs):
    s = SlamSystem(port_cfg(), Sensor.RGBD, enable_mapping=True, enable_loop_closing=True,
                   device="cpu")
    with pytest.raises(RuntimeError, match="enable_pipelined"):
        s.precompile()
    s.enable_pipelined(lag=LAG)
    for f in runs["main"][:4]:
        s.track_rgbd_pipelined(*f)
    before = dict(map=map_state_to_numpy(s.map),
                  index={k: v.clone() for k, v in s.retrieval._asdict().items()},
                  state=track_state_to_numpy(s._dstate),
                  trkset={k: v.clone() for k, v in s._trkset._asdict().items()},
                  gen=s.loop_closer._impl.generator.get_state(),
                  reloc=s._reloc_gen.get_state(), n_keyframes=s.n_keyframes,
                  records=len(s.records), pending=list(s._pending))
    s.precompile()
    for name, a in map_state_to_numpy(s.map).items():
        np.testing.assert_array_equal(a, before["map"][name], err_msg=name)
    for k, v in s.retrieval._asdict().items():
        assert torch.equal(v, before["index"][k]), k
    _assert_state_equal(track_state_to_numpy(s._dstate), before["state"])
    for k, v in s._trkset._asdict().items():
        assert torch.equal(v, before["trkset"][k]), k
    assert torch.equal(s.loop_closer._impl.generator.get_state(), before["gen"])
    assert torch.equal(s._reloc_gen.get_state(), before["reloc"])
    assert (s.n_keyframes, len(s.records), s._pending) == (
        before["n_keyframes"], before["records"], before["pending"])


@pytest.mark.parametrize("n_kf, frame_id, stress, lag", [
    (0, 0, 0, 16), (1, 5, 0, 16), (2, 23, 0, 16), (2, 24, 0, 16), (3, 10, 0, 16),
    (5, 90, 2, 16), (5, 90, 0, 2), (1, 5, 0, 2)])
def test_effective_lag_matches_jax(n_kf, frame_id, stress, lag):
    """Every frame drains until the map initializes, a short lag while the
    first keyframes are minted, a short lag under stress, else the lag."""
    s = SlamSystem(port_cfg(), Sensor.RGBD, enable_mapping=True, enable_loop_closing=False,
                   device="cpu")
    j = JaxSystem(small_cfg(), JaxSensor.RGBD, enable_loop_closing=False)
    for system in (s, j):
        system.n_keyframes, system.frame_id = n_kf, frame_id
        system._stress_drains, system._pipe_lag = stress, lag
    assert s._effective_lag == j._effective_lag


def test_reset_keeps_the_pipelined_state(runs):
    """``reset()`` clears the map and the records but, as the JAX package's
    does, leaves the device state, the pending frames and the tracking set
    (ROADMAP "Reference behaviours")."""
    s = SlamSystem(port_cfg(), Sensor.RGBD, enable_mapping=True, enable_loop_closing=False,
                   device="cpu")
    s.enable_pipelined(lag=LAG)
    for f in runs["main"][:2]:
        s.track_rgbd_pipelined(*f)
    kept = (s._dstate, s._pending, s._trkset)
    assert s.n_keyframes == 1 and kept[1]
    s.reset()
    assert all(a is b for a, b in zip((s._dstate, s._pending, s._trkset), kept))
    assert s.n_keyframes == 0 and s.records == [] and s.stats.resets == 1
    np.testing.assert_array_equal(s._host_ref_pose, np.eye(4))


@pytest.mark.parametrize("sensor, call", [(Sensor.STEREO, "track_rgbd_pipelined"),
                                          (Sensor.RGBD, "track_stereo_pipelined")])
def test_pipelined_call_of_the_other_sensor_raises(sensor, call):
    s = SlamSystem(port_cfg(), sensor, enable_mapping=True, enable_loop_closing=False,
                   device="cpu")
    with pytest.raises(ValueError, match="sensor mismatch"):
        getattr(s, call)(0.0, None, None)


def test_checkpoint_mid_run_resumes_pipelined(runs, tmp_path):
    """Frames 0-9 pipelined, flushed, saved; the checkpoint loads and runs
    frames 10-19 pipelined.  As in the JAX package, ``enable_pipelined``
    starts the device state over in MODE_INIT: the first frame after the
    load re-initializes at the identity (no keyframe: fewer than 2 frames
    since the last), the next are lost against the loaded map until a
    drain relocalizes its newest frame, and tracking goes on from there."""
    frames = runs["main"]
    s = SlamSystem(port_cfg(), Sensor.RGBD, enable_mapping=True, enable_loop_closing=False,
                   device="cpu")
    s.enable_pipelined(lag=LAG)
    for f in frames[:10]:
        s.track_rgbd_pipelined(*f)
    s.flush_pipeline()
    path = str(tmp_path / "ckpt.npz")
    serialize.save_system(s, path)
    r = serialize.load_system(path, port_cfg(), device="cpu", enable_loop_closing=False)
    assert (r.n_keyframes, len(r.records), r.frame_id) == (s.n_keyframes, 10, 10)
    assert r._host_ref_pose is None and r._pending_snap is None
    np.testing.assert_array_equal(r._host_kf_valid, s.map.kf_valid.numpy())
    r.enable_pipelined(lag=LAG)
    for f in frames[10:]:
        r.track_rgbd_pipelined(*f)
    r.shutdown()
    assert len(r.records) == N_MAIN and r._pending == []
    assert not r.records[10].lost
    assert r.stats.reloc_successes >= 1
    assert not r.records[-1].lost and r.tracking_state().name == "OK"
    assert r.n_keyframes >= s.n_keyframes


def test_runner_pipelined_on_the_cpu(tmp_path, capsys):
    """``run_tum_rgbd --pipelined --lag 3 --device cpu`` on a short written
    sequence writes both trajectories and prints the JAX runner's lines."""
    import sys

    from ydorbslam_tpu_torch.apps import run_tum_rgbd
    from ydorbslam_tpu_torch.testing import TUM_RGBD_SETTINGS, write_tum_sequence

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import bench
    from synthetic import oscillating_trajectory

    n = 5
    root = str(tmp_path / "seq")
    yaml, assoc, gt = write_tum_sequence(root, bench.make_frames(n), oscillating_trajectory(n),
                                         TUM_RGBD_SETTINGS)
    out = {k: str(tmp_path / f"{k}.txt") for k in ("traj", "kf")}
    system = run_tum_rgbd.main([
        yaml, root, assoc, "--groundtruth", gt, "--device", "cpu", "--pipelined", "--lag", "3",
        "--no-loop", "--out-trajectory", out["traj"], "--out-kf-trajectory", out["kf"]])
    text = capsys.readouterr().out
    for line in (f"sequence: {n} frames; starting SLAM", "median tracking time:",
                 f"trajectories saved: {out['traj']}, {out['kf']}", "--- run stats ---",
                 f"frames        {n}  (lost 0", "ATE RMSE:"):
        assert line in text, text
    assert system._pipe_lag == 3 and system._pending == []
    with open(out["traj"]) as f:
        assert len(f.read().splitlines()) == n
    t_kf, _, _ = read_tum_trajectory(out["kf"])
    assert len(t_kf) == system.run_stats()["keyframes_live"] >= 1
