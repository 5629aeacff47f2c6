"""The port's map state (``ydorbslam_tpu_torch/slam/map_state.py``) and its
scatter helper (``ops/scatter.py``) against the JAX package on the CPU.

Inputs are made from a numpy seed.  A small synthetic world (landmarks
with descriptors, keyframes on a known path) is inserted keyframe by
keyframe with JAX's ``insert_keyframe``; the JAX map is carried into the
port with ``map_state_from_numpy`` and each map-state function steps
both.  Tolerances: integer and boolean fields exact, float fields within
1e-5 (the same float32 formulas, summed in a different order).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ydorbslam_tpu.config import CameraConfig, SlamConfig
from ydorbslam_tpu.config import camera_intrinsics as jax_camera
from ydorbslam_tpu.ops.extractor import FrameFeatures as JaxFeatures
from ydorbslam_tpu.slam import map_state as jms

from ydorbslam_tpu_torch.convert import (
    camera_from_numpy, features_from_numpy, map_state_from_numpy, map_state_to_numpy,
)
from ydorbslam_tpu_torch.ops.scatter import (
    scatter_add, scatter_max, scatter_min, scatter_set,
)
from ydorbslam_tpu_torch.slam import map_state as pms

torch.set_num_threads(2)

K, N, M, O = 8, 256, 2048, 12
N_KF = 6
SF, NL = 1.2, 8
CFG = SlamConfig(camera=CameraConfig(
    fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=50.0, width=640, height=480,
))


# ----------------------------------------------------------------------
# A synthetic world inserted with the JAX package (shared with
# test_torch_mapping.py)
# ----------------------------------------------------------------------

def world_pose(i: int) -> np.ndarray:
    """T_cw of keyframe i: the camera slides along x and yaws slightly."""
    a = 0.02 * i
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    c = np.array([0.12 * i, 0.01 * i, 0.0])
    T = np.eye(4)
    T[:3, :3] = R.T
    T[:3, 3] = -R.T @ c
    return T.astype(np.float32)


def world_frame(rng, lm, lm_desc, lm_oct, lm_depth, T, depth_frac=0.9):
    """Features of the landmarks visible from T (at most N, by landmark
    id), with pixel noise, descriptor bit noise and partial depth (never
    for landmarks outside ``lm_depth``, which only triangulation maps).
    Returns (fields dict for FrameFeatures, landmark id per keypoint)."""
    pc = lm @ T[:3, :3].T + T[:3, 3]
    u = 500.0 * pc[:, 0] / pc[:, 2] + 320.0
    v = 500.0 * pc[:, 1] / pc[:, 2] + 240.0
    vis = np.where((pc[:, 2] > 0.5) & (u > 20) & (u < 620) & (v > 20) & (v < 460))[0][:N]
    n = len(vis)
    uv = np.zeros((N, 2), np.float32)
    uv[:n, 0] = u[vis] + rng.normal(0, 0.3, n)
    uv[:n, 1] = v[vis] + rng.normal(0, 0.3, n)
    depth = -np.ones(N, np.float32)
    has_d = lm_depth[vis] & (rng.random(n) < depth_frac)
    depth[:n] = np.where(has_d, pc[vis, 2], -1.0)
    right_u = np.where(depth > 0, uv[:, 0] - 50.0 / np.maximum(depth, 1e-3), -1.0)
    flip = (rng.random((n, 8, 32)) < 0.02) * (1 << np.arange(32, dtype=np.uint64))
    desc = np.zeros((N, 8), np.uint32)
    desc[:n] = lm_desc[vis] ^ flip.sum(-1).astype(np.uint32)
    octave = np.zeros(N, np.int32)
    octave[:n] = lm_oct[vis]
    valid = np.zeros(N, bool)
    valid[:n] = True
    ids = -np.ones(N, np.int64)
    ids[:n] = vis
    feats = dict(
        uv=uv, uv_raw=uv.copy(), response=np.ones(N, np.float32), octave=octave,
        angle=rng.uniform(0, 2 * np.pi, N).astype(np.float32), desc=desc,
        right_u=right_u.astype(np.float32), depth=depth, valid=valid,
    )
    return feats, ids


def jax_features(f):
    return JaxFeatures(**{k: jnp.asarray(v) for k, v in f.items()})


def map_np(m) -> dict:
    """A numpy copy of a JAX map (safe against later buffer donation)."""
    return {k: np.array(v) for k, v in m._asdict().items()}


def build_world(seed=0, n_kf=N_KF, dup_frac=0.1):
    """Insert ``n_kf`` keyframes with JAX's insert_keyframe.  Keypoints of
    landmarks that already have a point bind to it, except ``dup_frac``
    of them, which seed duplicate points for fusion to merge.  Returns
    (list of numpy maps before each insertion + the final one, inputs of
    each insertion)."""
    rng = np.random.default_rng(seed)
    L = 600
    lm = np.stack([rng.uniform(-2.5, 3.5, L), rng.uniform(-1.5, 1.5, L),
                   rng.uniform(3.0, 6.0, L)], -1).astype(np.float32)
    lm_desc = rng.integers(0, 2**32, (L, 8), dtype=np.uint64).astype(np.uint32)
    lm_oct = rng.integers(0, 4, L).astype(np.int32)
    lm_depth = rng.random(L) < 0.6
    cam = jax_camera(CFG)
    m = jms.empty_map(K, N, M, O)
    slot_of = {}
    maps, inputs = [], []
    for i in range(n_kf):
        T = world_pose(i)
        f, ids = world_frame(rng, lm, lm_desc, lm_oct, lm_depth, T)
        matched = np.array([slot_of.get(int(l), -1) if l >= 0 else -1 for l in ids], np.int32)
        matched[rng.random(N) < dup_frac] = -1
        inp = dict(kf_id=i, frame_id=3 * i, timestamp=0.1 * i, feats=f, T=T,
                   matched=matched, depth_thr=np.float32(1e9 if i == 0 else 4.0),
                   kf_count=i)
        maps.append(map_np(m))
        inputs.append(inp)
        m, _ = jms.insert_keyframe(
            m, i, 3 * i, 0.1 * i, jax_features(f), jnp.asarray(T), jnp.asarray(matched),
            cam, jnp.float32(inp["depth_thr"]), jnp.int32(i), scale_factor=SF, n_levels=NL,
        )
        row = np.asarray(m.kf_mp[i])
        for kp, l in enumerate(ids):
            if l >= 0 and row[kp] >= 0 and int(l) not in slot_of:
                slot_of[int(l)] = int(row[kp])
    maps.append(map_np(m))
    return maps, inputs


@pytest.fixture(scope="module")
def world():
    return build_world()


def to_jax(mnp: dict):
    return jms.MapState(**{k: jnp.asarray(v) for k, v in mnp.items()})


def to_port(mnp: dict):
    return map_state_from_numpy(mnp)


def assert_maps_match(jax_map, port_map, atol=1e-5, fields=None):
    jm = map_np(jax_map) if not isinstance(jax_map, dict) else jax_map
    pm = map_state_to_numpy(port_map)
    for name in fields or jm:
        a, b = jm[name], pm[name]
        assert a.shape == b.shape, (name, a.shape, b.shape)
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=atol, err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)


# ----------------------------------------------------------------------
# The scatter helper
# ----------------------------------------------------------------------

def _rand_case(seed, dims, n, lo=-3):
    rng = np.random.default_rng(seed)
    base = rng.integers(-50, 50, (9, 5)).astype(np.int32)
    idx = tuple(rng.integers(lo, base.shape[d] + 3, n) for d in range(dims))
    vals = rng.integers(-1000, 1000, (n,) + base.shape[dims:]).astype(np.int32)
    return base, idx, vals


@pytest.mark.parametrize("case", ["issue", "rows", "cells", "neg", "bool"])
def test_scatter_set_matches_jax(case):
    """Duplicates keep the last update, out-of-range indices drop,
    negative ones count from the end: exact against ``.at[].set``."""
    if case == "issue":
        base = np.full((8,), -1, np.int32)
        idx = (np.array([3, 0, 5, 0, 0, 2, 0, 0, 8, 11]),)
        vals = np.array([0, 1, 2, -1, -1, 5, -1, -1, 7, 9], np.int32)
    elif case == "bool":
        base = np.zeros((12,), bool)
        idx = (np.array([1, 1, 4, 12, 4, 0]),)
        vals = np.array([True, False, True, True, False, True])
    else:
        base, idx, vals = _rand_case(
            {"rows": 1, "cells": 2, "neg": 3}[case], 2 if case == "cells" else 1, 40,
            lo=-12 if case == "neg" else 0,
        )
    ref = np.asarray(jnp.asarray(base).at[tuple(jnp.asarray(i) for i in idx)].set(
        jnp.asarray(vals), mode="drop"))
    got = scatter_set(torch.from_numpy(base), tuple(torch.from_numpy(i) for i in idx),
                      torch.from_numpy(vals))
    np.testing.assert_array_equal(got.numpy(), ref)
    if case == "issue":
        assert ref[0] == -1  # the last of the duplicates won


@pytest.mark.parametrize("op", ["add", "min", "max"])
def test_scatter_reductions_match_jax(op):
    base, idx, vals = _rand_case(4, 1, 60, lo=0)
    jfn = getattr(jnp.asarray(base).at[jnp.asarray(idx[0])], op)
    ref = np.asarray(jfn(jnp.asarray(vals), mode="drop"))
    fn = {"add": scatter_add, "min": scatter_min, "max": scatter_max}[op]
    got = fn(torch.from_numpy(base), torch.from_numpy(idx[0]), torch.from_numpy(vals))
    np.testing.assert_array_equal(got.numpy(), ref)


# ----------------------------------------------------------------------
# Conversion
# ----------------------------------------------------------------------

def test_map_round_trip_keeps_bits(world):
    maps, _ = world
    m = maps[-1]
    assert (m["kf_desc"] > np.uint32(2**31)).any()  # high bits exercised
    back = map_state_to_numpy(map_state_from_numpy(m))
    for k, v in m.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)


# ----------------------------------------------------------------------
# Map-state functions on the carried-over JAX map
# ----------------------------------------------------------------------

@pytest.mark.parametrize("i", [0, 1, 3, 5])
def test_insert_keyframe_matches_jax(world, i):
    """Keyframe i inserted into the JAX map before it (i = 0: the empty
    map, all points seeded)."""
    maps, inputs = world
    inp = inputs[i]
    pm, n_new = pms.insert_keyframe(
        to_port(maps[i]), inp["kf_id"], inp["frame_id"], inp["timestamp"],
        features_from_numpy(inp["feats"]), torch.from_numpy(inp["T"]),
        torch.from_numpy(inp["matched"]), camera_from_numpy(_cam_fields()),
        torch.tensor(inp["depth_thr"]), inp["kf_count"], scale_factor=SF, n_levels=NL,
    )
    assert_maps_match(maps[i + 1], pm)
    assert int(n_new) > 0


def _cam_fields():
    c = CFG.camera
    return (c.fx, c.fy, c.cx, c.cy, c.k1, c.k2, c.p1, c.p2, c.k3, c.bf, c.width, c.height)


def test_add_observations_matches_jax(world):
    maps, _ = world
    rng = np.random.default_rng(5)
    live = np.where(maps[-1]["mp_valid"])[0]
    ids = rng.choice(live, 40, replace=False).astype(np.int32)
    ids[::7] = -1
    kp = rng.integers(0, N, 40).astype(np.int32)
    valid = rng.random(40) < 0.8
    ref = jms.add_observations(to_jax(maps[-1]), jnp.asarray(ids), 2, jnp.asarray(kp),
                               jnp.asarray(valid))
    got = pms.add_observations(to_port(maps[-1]), torch.from_numpy(ids), 2,
                               torch.from_numpy(kp), torch.from_numpy(valid))
    assert_maps_match(ref, got)


def test_add_observations_multi_matches_jax(world):
    """The same point several times in one batch: ranked into successive
    free slots; points at capacity drop the extra ones."""
    maps, _ = world
    rng = np.random.default_rng(6)
    live = np.where(maps[-1]["mp_valid"])[0]
    ids = rng.choice(live[:30], 120).astype(np.int32)
    ids[::9] = -1
    kfs = rng.integers(0, N_KF, 120).astype(np.int32)
    kp = rng.integers(0, N, 120).astype(np.int32)
    valid = rng.random(120) < 0.9
    ref_m, ref_ok = jms.add_observations_multi(
        to_jax(maps[-1]), jnp.asarray(ids), jnp.asarray(kfs), jnp.asarray(kp), jnp.asarray(valid))
    got_m, got_ok = pms.add_observations_multi(
        to_port(maps[-1]), torch.from_numpy(ids), torch.from_numpy(kfs),
        torch.from_numpy(kp), torch.from_numpy(valid))
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(ref_ok))
    assert_maps_match(ref_m, got_m)
    assert not np.asarray(ref_ok)[valid & (ids >= 0)].all()  # capacity was hit


def test_erase_and_recount_match_jax(world):
    maps, _ = world
    rng = np.random.default_rng(7)
    live = np.where(maps[-1]["mp_valid"])[0]
    ids = rng.choice(live, 50, replace=False).astype(np.int32)
    ids[::5] = -1
    kfs = rng.integers(0, N_KF, 50).astype(np.int32)
    ref = jms.erase_observations(to_jax(maps[-1]), jnp.asarray(ids), jnp.asarray(kfs))
    got = pms.erase_observations(to_port(maps[-1]), torch.from_numpy(ids), torch.from_numpy(kfs))
    assert_maps_match(ref, got)
    np.testing.assert_array_equal(pms.recount_obs(got).numpy(), np.asarray(jms.recount_obs(ref)))
    np.testing.assert_array_equal(
        pms.recount_obs_weighted(got).numpy(), np.asarray(jms.recount_obs_weighted(ref)))


def test_refresh_points_matches_jax(world):
    maps, _ = world
    rng = np.random.default_rng(8)
    ids = rng.choice(M, 300, replace=False).astype(np.int32)
    ids[::11] = -1
    ref = jms.refresh_points(to_jax(maps[-1]), jnp.asarray(ids), SF, NL)
    got = pms.refresh_points(to_port(maps[-1]), torch.from_numpy(ids), SF, NL)
    assert_maps_match(ref, got)


@pytest.mark.parametrize("kf", [0, 3, 5])
def test_update_covisibility_matches_jax(world, kf):
    maps, _ = world
    m = maps[-1]
    # Forget the spanning-tree parent so the parent choice runs too.
    m = dict(m, parent=np.where(np.arange(K) == kf, -1, m["parent"]).astype(np.int32))
    ref = jms.update_covisibility(to_jax(m), kf)
    got = pms.update_covisibility(to_port(m), kf)
    assert_maps_match(ref, got)
    assert np.asarray(ref.covis)[kf].sum() > 0


def test_alloc_slots_matches_jax():
    rng = np.random.default_rng(9)
    valid = rng.random(64) < 0.6
    want = rng.integers(-2, 40, 50)
    ref = jms.alloc_slots(jnp.asarray(valid), jnp.asarray(want))
    got = pms.alloc_slots(torch.from_numpy(valid), torch.from_numpy(want))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# The replace_points scenarios of tests/test_map_replace.py.
RK, RN, RM, RO = 8, 16, 32, 6


def _replace_map():
    m = {k: np.array(v) for k, v in jms.empty_map(RK, RN, RM, RO)._asdict().items()}
    for kf, kp, pt in [(0, 0, 0), (1, 1, 0), (2, 2, 1), (3, 3, 1), (1, 5, 2)]:
        free = int(np.argmax(m["mp_obs_kf"][pt] < 0))
        m["kf_valid"][kf] = True
        m["kf_kp_valid"][kf, kp] = True
        m["kf_mp"][kf, kp] = pt
        m["mp_valid"][pt] = True
        m["mp_obs_kf"][pt, free] = kf
        m["mp_obs_kp"][pt, free] = kp
    m["mp_pos"][:3] = [[0.0, 0.0, 2.0], [0.1, 0.0, 2.0], [0.0, 0.2, 2.0]]
    m["mp_found"][:2] = [5, 3]
    m["mp_visible"][:2] = [7, 4]
    m["kf_pose"][:4, :3, 3] = np.arange(4)[:, None] * np.array([0.1, 0.0, 0.0])
    return m


@pytest.mark.parametrize("old,new", [
    ([0], [1]),  # observation transfer and invalidation
    ([0], [2]),  # a conflicting observation is erased
    ([0, 0], [1, 2]),  # a duplicate old id: the first row wins
    ([0, 1], [1, 2]),  # a chain: both rows dropped
])
def test_replace_points_matches_jax(old, new):
    m = _replace_map()
    ok = np.ones(len(old), bool)
    ref = jms.replace_points(to_jax(m), jnp.asarray(old), jnp.asarray(new), jnp.asarray(ok), SF, NL)
    got = pms.replace_points(to_port(m), torch.tensor(old), torch.tensor(new),
                             torch.from_numpy(ok), SF, NL)
    assert_maps_match(ref, got)


def test_replace_points_on_world_matches_jax(world):
    """Merges of the world's duplicate points, with a full obs list in
    play, the batch rules on random rows, and -1 padding."""
    maps, _ = world
    rng = np.random.default_rng(10)
    live = np.where(maps[-1]["mp_valid"])[0]
    old = rng.choice(live, 64).astype(np.int32)
    new = rng.choice(live, 64).astype(np.int32)
    old[::13] = -1
    ok = rng.random(64) < 0.9
    ref = jms.replace_points(to_jax(maps[-1]), jnp.asarray(old), jnp.asarray(new),
                             jnp.asarray(ok), SF, NL)
    got = pms.replace_points(to_port(maps[-1]), torch.from_numpy(old), torch.from_numpy(new),
                             torch.from_numpy(ok), SF, NL)
    assert_maps_match(ref, got)
