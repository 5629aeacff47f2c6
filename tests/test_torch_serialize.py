"""The port's checkpoints (``slam/serialize.py``) against the JAX package's,
on the CPU.

Both packages run ``SlamSystem(small_cfg(), Sensor.RGBD,
enable_loop_closing=False)`` over a 15-frame ``SyntheticRgbdSequence``
(rng 42, 500 landmarks), the sequence of ``tests/test_serialize_viz.py``'s
resume test, and checkpoint after frame 7 (8 frames tracked).  The runs
are shared by the module:

* the port tracks all 15 frames, saving ``save_system`` and ``save_map``
  after frame 7 (saving reads the system and changes nothing);
* JAX tracks frames 0-7 and saves both files;
* each package resumes from the other's checkpoint and from its own, and
  tracks frames 8-14.

Tolerances: every map, retrieval and tracker array that crosses between
the packages is bit-exact (descriptors are uint32 in both files, and the
files hold the same keys, dtypes and shapes); the port's resume from the
JAX checkpoint and JAX's own resume agree in their TUM camera centres
within 1e-3 m, the tolerance of ``tests/test_torch_mapping_system.py``
(local BA sums float32 normal equations in another order); the port's
resume keeps JAX's bound against an uninterrupted run (ATE below
max(2x, 0.03 m)).
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from synthetic import SyntheticRgbdSequence
from test_slam_system import small_cfg

from ydorbslam_tpu.io import ate_rmse as jax_ate_rmse
from ydorbslam_tpu.slam import serialize as jser
from ydorbslam_tpu.slam.system import Sensor as JaxSensor
from ydorbslam_tpu.slam.system import SlamSystem as JaxSystem

from ydorbslam_tpu_torch.convert import (
    config_from_dict, features_from_numpy, features_to_numpy, map_state_from_numpy,
    map_state_to_numpy, retrieval_index_from_numpy, retrieval_index_to_numpy,
)
from ydorbslam_tpu_torch.io import read_tum_trajectory
from ydorbslam_tpu_torch.slam import serialize
from ydorbslam_tpu_torch.slam.system import Sensor, SlamSystem

torch.set_num_threads(2)

N_FRAMES = 15
N_SAVE = 8  # frames tracked before the checkpoint
TOL_M = 1e-3


def port_cfg():
    return config_from_dict(dataclasses.asdict(small_cfg()))


def centres(system, path):
    system.save_trajectory_tum(str(path))
    t, p, _ = read_tum_trajectory(str(path))
    return np.asarray(t), np.asarray(p)


def slot_of_frame(m, frame_id: int) -> list:
    """The live keyframe slots made at ``frame_id``."""
    return np.where(m.kf_valid.numpy() & (m.kf_frame_id.numpy() == frame_id))[0].tolist()


def jnp_dict(nt) -> dict:
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def assert_tensors_equal(port: dict, expect: dict):
    assert port.keys() == expect.keys()
    for k, v in expect.items():
        assert port[k].dtype == v.dtype and torch.equal(port[k], v), k


def assert_arrays_equal(got: dict, expect: dict):
    assert got.keys() == expect.keys()
    for k, v in expect.items():
        assert got[k].dtype == v.dtype, (k, got[k].dtype, v.dtype)
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.fixture(scope="module")
def seq():
    s = SyntheticRgbdSequence(np.random.default_rng(42), n_frames=N_FRAMES, n_landmarks=500)
    return s, [s.frame(i) for i in range(N_FRAMES)]


@pytest.fixture(scope="module")
def files(seq, tmp_path_factory):
    """Both packages' checkpoints after frame 7, and the port's whole run."""
    _, frames = seq
    d = tmp_path_factory.mktemp("ckpt")
    out = {k: str(d / f"{k}.npz") for k in ("port_sys", "port_map", "jax_sys", "jax_map")}
    port = SlamSystem(port_cfg(), Sensor.RGBD, enable_loop_closing=False, device="cpu")
    for i, f in enumerate(frames):
        if i == N_SAVE:
            serialize.save_system(port, out["port_sys"])
            serialize.save_map(port.map, out["port_map"])
            out["port_at_save"] = dict(map=map_state_to_numpy(port.map),
                                       n_keyframes=port.n_keyframes,
                                       retrieval=retrieval_index_to_numpy(port.retrieval))
        port.track_rgbd(*f)
        if i == N_SAVE:
            out["slot_of_frame_8"] = slot_of_frame(port.map, N_SAVE)
    out["port"] = port
    out["port_centres"] = centres(port, d / "port.txt")
    jax = JaxSystem(small_cfg(), JaxSensor.RGBD, enable_loop_closing=False)
    for f in frames[:N_SAVE]:
        jax.track_rgbd(*f)
    jser.save_system(jax, out["jax_sys"])
    jser.save_map(jax.map, out["jax_map"])
    out["jax_saved"] = jax
    return out


@pytest.fixture(scope="module")
def resumed(seq, files, tmp_path_factory):
    """Frames 8-14 resumed by each package from each checkpoint."""
    _, frames = seq
    d = tmp_path_factory.mktemp("resumed")
    runs = {}
    for name, load in (
        ("jax_from_jax", lambda: jser.load_system(files["jax_sys"], small_cfg(),
                                                  enable_loop_closing=False)),
        ("jax_from_port", lambda: jser.load_system(files["port_sys"], small_cfg(),
                                                   enable_loop_closing=False)),
        ("port_from_jax", lambda: serialize.load_system(files["jax_sys"], port_cfg(),
                                                        device="cpu", enable_loop_closing=False)),
        ("port_from_port", lambda: serialize.load_system(files["port_sys"], port_cfg(),
                                                         device="cpu", enable_loop_closing=False)),
    ):
        system = load()
        loaded = dict(n_keyframes=system.n_keyframes, records=len(system.records))
        if name.startswith("port"):
            loaded["host_kf_valid"] = system._host_kf_valid.copy()
            loaded["kf_valid"] = system.map.kf_valid.numpy().copy()
        oks = [bool(system.track_rgbd(*frames[N_SAVE]))]
        if name.startswith("port"):
            loaded["slot_of_frame_8"] = slot_of_frame(system.map, N_SAVE)
        oks += [bool(system.track_rgbd(*f)) for f in frames[N_SAVE + 1:]]
        runs[name] = dict(system=system, loaded=loaded, oks=oks,
                          centres=centres(system, d / f"{name}.txt"))
    return runs


def test_map_round_trip_is_bit_exact(files):
    m = serialize.load_map(files["port_map"], device="cpu")
    assert_arrays_equal(map_state_to_numpy(m), files["port_at_save"]["map"])
    # The map keys of a system checkpoint (version 2) load as well.
    assert_arrays_equal(map_state_to_numpy(serialize.load_map(files["port_sys"], device="cpu")),
                        files["port_at_save"]["map"])


def test_jax_files_load_into_the_port(files):
    jax = files["jax_saved"]
    expect_map = map_state_from_numpy(jnp_dict(jax.map))._asdict()
    # Version 1 (JAX's save_map: unprefixed keys).
    assert json.loads(bytes(np.load(files["jax_map"])["__meta__"]))["version"] == 1
    assert_tensors_equal(serialize.load_map(files["jax_map"], device="cpu")._asdict(), expect_map)
    # Version 2 (JAX's save_system).
    s = serialize.load_system(files["jax_sys"], port_cfg(), device="cpu",
                              enable_loop_closing=False)
    assert_tensors_equal(s.map._asdict(), expect_map)
    assert_tensors_equal(s.retrieval._asdict(),
                         retrieval_index_from_numpy(jnp_dict(jax.retrieval))._asdict())
    tr, jtr = s.tracker, jax.tracker
    assert_tensors_equal(tr.last_feats._asdict(),
                         features_from_numpy(jnp_dict(jtr.last_feats))._asdict())
    for name in ("T_cw", "velocity", "last_lms", "last_lms_valid"):
        expect = torch.from_numpy(np.array(getattr(jtr, name)))
        assert torch.equal(getattr(tr, name), expect), name
    assert tr.new_T is tr.T_cw
    assert tr.state.name == jtr.state.name
    for k in ("ref_kf", "n_keyframes", "frame_id", "frames_since_kf", "localization_only"):
        assert getattr(s, k) == getattr(jax, k), k
    assert [(r.timestamp, r.ref_kf, r.lost) for r in s.records] == \
        [(r.timestamp, r.ref_kf, r.lost) for r in jax.records]
    for a, b in zip(s.records, jax.records):
        np.testing.assert_array_equal(a.T_c_ref, np.asarray(b.T_c_ref))


def test_port_files_load_into_jax(files):
    saved = files["port_at_save"]
    assert_arrays_equal(jnp_dict(jser.load_map(files["port_map"])), saved["map"])
    j = jser.load_system(files["port_sys"], small_cfg(), enable_loop_closing=False)
    assert_arrays_equal(jnp_dict(j.map), saved["map"])
    assert_arrays_equal(jnp_dict(j.retrieval), saved["retrieval"])
    assert j.n_keyframes == saved["n_keyframes"]
    with np.load(files["port_sys"]) as data:
        last = {k[len("trk.last."):]: data[k] for k in data.files if k.startswith("trk.last.")}
        assert_arrays_equal(jnp_dict(j.tracker.last_feats), last)
        for name in ("T_cw", "velocity", "last_lms", "last_lms_valid"):
            np.testing.assert_array_equal(np.asarray(getattr(j.tracker, name)),
                                          data[f"trk.{name}"], err_msg=name)
    assert len(j.records) == N_SAVE


@pytest.mark.parametrize("kind", ["sys", "map"])
def test_files_hold_jax_keys_dtypes_and_uint32_descriptors(files, kind):
    with np.load(files[f"port_{kind}"]) as p, np.load(files[f"jax_{kind}"]) as j:
        assert sorted(p.files) == sorted(j.files)
        for k in j.files:
            if k != "__meta__":
                assert (p[k].dtype, p[k].shape) == (j[k].dtype, j[k].shape), k
        meta_p, meta_j = (json.loads(bytes(x["__meta__"])) for x in (p, j))
        assert meta_p.keys() == meta_j.keys() and meta_p["version"] == meta_j["version"]
        desc = [k for k in p.files if k.endswith("desc")]
        assert len(desc) == (3 if kind == "sys" else 2)
        assert all(p[k].dtype == np.uint32 for k in desc)
        if kind == "sys":
            assert (p["rec.ref_kf"].dtype, p["rec.lost"].dtype) == (np.int64, bool)
            assert p["rec.T_c_ref"].shape == (N_SAVE, 4, 4)


def test_port_resume_from_a_jax_checkpoint_matches_jax_resume(resumed):
    jj, pj = resumed["jax_from_jax"], resumed["port_from_jax"]
    assert all(jj["oks"]) and all(pj["oks"])
    for k in ("n_keyframes", "records"):
        assert pj["loaded"][k] == jj["loaded"][k], k
    (tj, cj), (tp, cp) = jj["centres"], pj["centres"]
    np.testing.assert_array_equal(tp, tj)
    assert np.abs(cp - cj).max() < TOL_M


def test_jax_resumes_a_port_checkpoint(resumed, files):
    jp = resumed["jax_from_port"]
    assert all(jp["oks"])
    assert jp["loaded"]["n_keyframes"] == files["port_at_save"]["n_keyframes"]
    assert len(jp["system"].records) == N_FRAMES


def test_port_resume_matches_the_uninterrupted_run(seq, files, resumed):
    s, _ = seq
    pp = resumed["port_from_port"]
    assert all(pp["oks"])
    assert pp["loaded"]["n_keyframes"] == files["port_at_save"]["n_keyframes"]
    assert pp["loaded"]["records"] == N_SAVE
    (t0, p0), (t1, p1) = files["port_centres"], pp["centres"]
    assert len(p1) == len(p0) == N_FRAMES
    gt = np.stack([-p[:3, :3].T @ p[:3, 3] for p in s.poses])
    e0, e1 = jax_ate_rmse(p0, gt), jax_ate_rmse(p1, gt)
    assert e1 < max(2.0 * e0, 0.03), (e0, e1)


def test_resume_rebuilds_the_slot_mask_and_reuses_the_same_slot(files, resumed):
    for name in ("port_from_port", "port_from_jax"):
        loaded = resumed[name]["loaded"]
        np.testing.assert_array_equal(loaded["host_kf_valid"], loaded["kf_valid"])
        assert loaded["kf_valid"].sum() > 0
    # The keyframe of frame 8 (every frame of small_cfg makes one) takes the
    # slot it took in the uninterrupted run, not slot 0 again.
    slot = files["slot_of_frame_8"]
    assert len(slot) == 1 and slot[0] != 0
    assert resumed["port_from_port"]["loaded"]["slot_of_frame_8"] == slot
    assert resumed["port_from_jax"]["loaded"]["slot_of_frame_8"] == slot


def test_loaded_checkpoint_serves_localization_mode(seq, files):
    _, frames = seq
    s = serialize.load_system(files["port_sys"], port_cfg(), device="cpu",
                              enable_loop_closing=False)
    s.activate_localization_mode()
    nkf, n_mp = s.n_keyframes, int(s.map.mp_valid.sum())
    ok = sum(bool(s.track_rgbd(t + 100.0, g, d)) for t, g, d in frames[:N_SAVE])
    assert ok >= 6
    assert s.n_keyframes == nkf and int(s.map.mp_valid.sum()) == n_mp


def _rewrite(src, dst, **meta_changes):
    with np.load(src) as data:
        arrays = {k: data[k] for k in data.files}
    meta = json.loads(bytes(arrays["__meta__"]))
    meta.update(meta_changes)
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(dst, **arrays)


def test_capacity_mismatch_raises(files):
    cfg = port_cfg()
    cfg = dataclasses.replace(cfg, capacity=dataclasses.replace(cfg.capacity, max_keyframes=32))
    with pytest.raises(ValueError, match="capacities"):
        serialize.load_system(files["port_sys"], cfg, device="cpu", enable_loop_closing=False)


@pytest.mark.parametrize("which", ["system", "map"])
def test_unknown_version_raises(files, tmp_path, which):
    path = str(tmp_path / "v9.npz")
    _rewrite(files["port_sys"], path, version=9)
    with pytest.raises(ValueError, match="version 9"):
        if which == "system":
            serialize.load_system(path, port_cfg(), device="cpu", enable_loop_closing=False)
        else:
            serialize.load_map(path, device="cpu")


def test_features_round_trip_keeps_descriptor_bits(files):
    feats = files["port"].tracker.last_feats
    back = features_from_numpy(features_to_numpy(feats))
    assert features_to_numpy(feats)["desc"].dtype == np.uint32
    assert_tensors_equal(back._asdict(), feats._asdict())


@pytest.mark.parametrize("which", ["system", "map"])
def test_loading_defaults_to_the_card(files, which):
    """``load_system`` and ``load_map`` upload to the card unless asked
    otherwise; without one, they raise instead of falling back to the CPU."""
    def load():
        if which == "system":
            return serialize.load_system(files["port_sys"], port_cfg(),
                                         enable_loop_closing=False).map
        return serialize.load_map(files["port_map"])

    if torch.cuda.is_available():
        assert load().mp_valid.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            load()
