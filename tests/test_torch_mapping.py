"""K3 and local mapping of the port against the JAX package on the CPU.

* ``ops.hamming.pair_best2_plain`` (K3's plain version) against
  ``pair_best2_pallas`` in interpret mode, as tests/test_pallas_pair.py
  runs it: exact.
* The port's triangulation and fusion searches (K3 + selection) against
  JAX's dense CPU fields (``_tri_candidate_fields``,
  ``_fuse_candidate_fields``) on the synthetic world of
  test_torch_mapstate.py: exact flags and indices, positions within
  5e-3 m (the low-parallax two-view normal equations are ill-conditioned:
  JAX's own jitted and eager runs of ``_tri_geom`` differ by 1.2e-3 m on
  a point of this world).
* ``triangulate_neighbors_batch``, ``fuse_neighbors_batch`` and the
  jitted mapping functions (point cull, local window, BA problem, BA
  write-back, keyframe cull) on the carried-over JAX map: integer and
  boolean fields exact, floats within 1e-5, new point positions as above.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_mapstate import (
    CFG, N, N_KF, NL, SF, _cam_fields, assert_maps_match, build_world, to_jax, to_port,
)

from ydorbslam_tpu.config import camera_intrinsics as jax_camera
from ydorbslam_tpu.ops.pallas_kernels import pair_best2_pallas
from ydorbslam_tpu.slam import mapping as jmap
from ydorbslam_tpu.slam import triangulate as jtri

from ydorbslam_tpu_torch.convert import camera_from_numpy
from ydorbslam_tpu_torch.ops import launch_counts
from ydorbslam_tpu_torch.ops.hamming import pair_best2, pair_best2_plain
from ydorbslam_tpu_torch.slam import mapping as pmap
from ydorbslam_tpu_torch.slam import triangulate as ptri

torch.set_num_threads(2)

KF1 = N_KF - 1  # the newest keyframe of the world
TRI_ATOL = 5e-3  # metres, triangulated positions (see the module docstring)


@pytest.fixture(scope="module")
def world():
    return build_world()


@pytest.fixture(scope="module")
def cams():
    return jax_camera(CFG), camera_from_numpy(_cam_fields())


def _neighbors(m, kf, n=4):
    w = m["covis"][kf] * m["kf_valid"].astype(np.int32)
    order = np.argsort(-w, kind="stable")[:n]
    return order.astype(np.int32), w[order] > 0


# ----------------------------------------------------------------------
# K3's plain version
# ----------------------------------------------------------------------

def _pair_problem(seed, mode, B=3, M=256, Nb=128):
    rng = np.random.default_rng(seed)
    da = rng.integers(0, 2**32, (B, M, 8), dtype=np.uint64).astype(np.uint32)
    noise = (rng.integers(0, 2**32, (B, Nb, 8), dtype=np.uint64).astype(np.uint32)
             & rng.integers(0, 2**32, (B, Nb, 8), dtype=np.uint64).astype(np.uint32)
             & rng.integers(0, 2**32, (B, Nb, 8), dtype=np.uint64).astype(np.uint32))
    db = np.take_along_axis(da, rng.integers(0, M, (B, Nb, 1)), 1) ^ noise
    z = np.zeros((B, M))
    zb = np.zeros((B, Nb))
    if mode == "proj":
        alo = rng.integers(-1, 3, (B, M))
        aa = np.stack([rng.uniform(0, 640, (B, M)), rng.uniform(0, 480, (B, M)),
                       rng.uniform(0, 640, (B, M)), rng.uniform(30, 300, (B, M)), z,
                       alo, alo + rng.integers(0, 3, (B, M)), rng.random((B, M)) > 0.2], -1)
        ab = np.stack([rng.uniform(0, 640, (B, Nb)), rng.uniform(0, 480, (B, Nb)),
                       np.where(rng.random((B, Nb)) < 0.5, rng.uniform(0, 640, (B, Nb)), -1),
                       rng.integers(0, 4, (B, Nb)), rng.random((B, Nb)) > 0.2,
                       1e-3 / 1.44 ** rng.integers(0, 4, (B, Nb)), zb, zb], -1)
    else:
        la, lb = rng.normal(0, 1, (B, M)), rng.normal(0, 1, (B, M))
        boct = rng.integers(0, 4, (B, Nb))
        aa = np.stack([la, lb, rng.normal(0, 100, (B, M)),
                       3.84 * np.maximum(la * la + lb * lb, 1e-18),
                       rng.integers(0, 4, (B, M)), rng.random((B, M)) > 0.2, z, z], -1)
        ab = np.stack([rng.uniform(0, 640, (B, Nb)), rng.uniform(0, 480, (B, Nb)),
                       1.44 ** boct * 1e4, boct, rng.random((B, Nb)) > 0.2, zb, zb, zb], -1)
    return da, aa.astype(np.float32), db, ab.astype(np.float32)


@pytest.mark.parametrize("mode", ["proj", "epi"])
def test_pair_best2_plain_matches_pallas(mode):
    """Identical idx, best and second, tie rule and sentinels included."""
    da, aa, db, ab = _pair_problem({"proj": 0, "epi": 1}[mode], mode)
    ref = pair_best2_pallas(jnp.asarray(da), jnp.asarray(aa), jnp.asarray(db),
                            jnp.asarray(ab), mode=mode)
    got = pair_best2_plain(torch.from_numpy(da.view(np.int32)), torch.from_numpy(aa),
                           torch.from_numpy(db.view(np.int32)), torch.from_numpy(ab), mode)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert (got[0] >= 0).sum() > 100 and (got[1] < 60).sum() > 0
    assert (got[0] < 0).any()  # rows with no candidate keep the sentinels


def test_pair_best2_ragged_and_dispatch():
    """Any M and N (no tile multiples); a CPU tensor takes the plain
    version and counts no launch; an unknown mode raises."""
    da, aa, db, ab = _pair_problem(2, "epi", B=2, M=100, Nb=77)
    args = (torch.from_numpy(da.view(np.int32)), torch.from_numpy(aa),
            torch.from_numpy(db.view(np.int32)), torch.from_numpy(ab))
    before = launch_counts()["pair_best2"]
    got = pair_best2(*args, mode="epi")
    assert launch_counts()["pair_best2"] == before
    # Dense reference in numpy: gate, distance, stable two smallest.
    pop = np.vectorize(lambda x: bin(int(x)).count("1"))
    for p in range(2):
        d = pop(da[p][:, None, :] ^ db[p][None, :, :]).sum(-1)
        a, b = aa[p], ab[p]
        num = a[:, None, 0] * b[None, :, 0] + a[:, None, 1] * b[None, :, 1] + a[:, None, 2]
        gate = ((a[:, None, 5] > 0.5) & (b[None, :, 4] > 0.5)
                & (np.abs(b[None, :, 3] - a[:, None, 4]) <= 1)
                & (num * num < a[:, None, 3] * b[None, :, 2]))
        dg = np.where(gate, d, 10000)
        order = np.argsort(dg, axis=1, kind="stable")
        best = np.take_along_axis(dg, order[:, :1], 1)[:, 0]
        np.testing.assert_array_equal(got[1][p].numpy(), best)
        np.testing.assert_array_equal(got[2][p].numpy(),
                                      np.take_along_axis(dg, order[:, 1:2], 1)[:, 0])
        np.testing.assert_array_equal(got[0][p].numpy(), np.where(best < 10000, order[:, 0], -1))
    with pytest.raises(ValueError):
        pair_best2(*args, mode="window")


# ----------------------------------------------------------------------
# Triangulation and fusion searches against JAX's dense CPU fields
# ----------------------------------------------------------------------

def test_triangulation_search_matches_dense(world, cams):
    maps, _ = world
    m = maps[-1]
    nids, nok = _neighbors(m, KF1)
    jcam, pcam = cams
    jm = to_jax(m)
    good, best2, X = jax.vmap(
        lambda k2, act: jtri._tri_candidate_fields(jm, KF1, k2, act, jcam, SF, NL)
    )(jnp.asarray(nids), jnp.asarray(nok))
    pm = to_port(m)
    kf2 = torch.from_numpy(nids).long()
    a_attr, b_attr = ptri._tri_attrs(pm, KF1, kf2, torch.from_numpy(nok), pcam, NL, SF)
    idx, b1, b2 = pair_best2(pm.kf_desc[KF1].expand(len(nids), N, 8).contiguous(), a_attr,
                             pm.kf_desc[kf2], b_attr, mode="epi")
    matched, pbest2 = ptri._tri_select(b1, b2, idx, 0.6, N)
    pgood, pbest2, pX = ptri._tri_geom(pm, KF1, kf2, torch.from_numpy(nok), matched,
                                       pbest2, pcam, SF, NL)
    np.testing.assert_array_equal(pgood.numpy(), np.asarray(good))
    g = np.asarray(good)
    assert g.sum() > 10
    np.testing.assert_array_equal(pbest2.numpy()[g], np.asarray(best2)[g])
    np.testing.assert_allclose(pX.numpy()[g], np.asarray(X)[g], atol=TRI_ATOL)


@pytest.mark.parametrize("direction", ["out", "in"])
def test_fuse_search_matches_dense(world, cams, direction):
    maps, _ = world
    m = maps[-1]
    nids, nok = _neighbors(m, KF1)
    jcam, pcam = cams
    jm = to_jax(m)
    kf1v = np.full_like(nids, KF1)
    src, dst = (kf1v, nids) if direction == "out" else (nids, kf1v)
    bound, cand, who_d = jax.vmap(
        lambda s, d, act: jtri._fuse_candidate_fields(jm, s, d, act, jcam, SF, NL)
    )(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(nok))
    pm = to_port(m)
    s_t, d_t = torch.from_numpy(src).long(), torch.from_numpy(dst).long()
    a_attr, b_attr, ids = ptri._fuse_attrs(pm, s_t, d_t, pcam, SF, NL)
    desc_a = pm.mp_desc[torch.clamp(ids.long(), 0, pm.M - 1)]
    idx, b1, _ = pair_best2(desc_a, a_attr, pm.kf_desc[d_t], b_attr, mode="proj")
    pbound, pcand, pwho = ptri._fuse_select(idx, b1, torch.from_numpy(nok), ids, N)
    np.testing.assert_array_equal(pbound.numpy(), np.asarray(bound))
    b = np.asarray(bound)
    assert b.sum() > 5, b.sum()
    np.testing.assert_array_equal(pcand.numpy()[b], np.asarray(cand)[b])
    np.testing.assert_array_equal(pwho.numpy(), np.asarray(who_d))


# ----------------------------------------------------------------------
# Whole mapping functions on the carried-over map
# ----------------------------------------------------------------------

def test_triangulate_neighbors_batch_matches_jax(world, cams):
    maps, _ = world
    m = maps[-1]
    nids, nok = _neighbors(m, KF1)
    jcam, pcam = cams
    ref = jtri.triangulate_neighbors_batch(
        to_jax(m), KF1, jnp.asarray(nids), jnp.asarray(nok), jnp.int32(N_KF), jcam, SF, NL)
    got = ptri.triangulate_neighbors_batch(
        to_port(m), KF1, torch.from_numpy(nids).long(), torch.from_numpy(nok), N_KF, pcam, SF, NL)
    new = np.asarray(ref.mp_valid) & ~m["mp_valid"]
    assert new.sum() > 10  # points were created
    np.testing.assert_allclose(got.mp_pos.numpy()[new], np.asarray(ref.mp_pos)[new],
                               atol=TRI_ATOL)
    assert_maps_match(ref, got, fields=[f for f in m if f != "mp_pos"])


def test_fuse_neighbors_batch_matches_jax(world, cams):
    maps, _ = world
    m = maps[-1]
    nids, nok = _neighbors(m, KF1, n=5)
    jcam, pcam = cams
    ref = jtri.fuse_neighbors_batch(
        to_jax(m), KF1, jnp.asarray(nids), jnp.asarray(nok), jcam, SF, NL)
    got = ptri.fuse_neighbors_batch(
        to_port(m), KF1, torch.from_numpy(nids).long(), torch.from_numpy(nok), pcam, SF, NL)
    assert_maps_match(ref, got)
    # Duplicates were merged: points died.
    assert np.asarray(ref.mp_valid).sum() < m["mp_valid"].sum()


def test_cull_map_points_matches_jax(world):
    maps, _ = world
    m = dict(maps[-1])
    rng = np.random.default_rng(11)
    m["mp_visible"] = (m["mp_visible"] + rng.integers(0, 8, m["mp_visible"].shape)).astype(np.int32)
    ref = jmap.cull_map_points(to_jax(m), jnp.int32(N_KF + 1))
    got = pmap.cull_map_points(to_port(m), N_KF + 1)
    assert_maps_match(ref, got)
    assert np.asarray(ref.mp_valid).sum() < m["mp_valid"].sum()


@pytest.mark.parametrize("caps", [(4, 2, 300), (8, 4, 2048)])
def test_local_ba_window_and_problem_match_jax(world, caps):
    """select_local_window, build_local_ba (obs_cap compaction) and the
    BA write-back with an outlier mask: the padded-slot writes to slot 0
    resolve as in JAX."""
    maps, _ = world
    m = maps[-1]
    win_cap, fix_cap, pts_cap = caps
    win, fixed, pts = jmap.select_local_window(to_jax(m), KF1, win_cap, fix_cap, pts_cap)
    pwin, pfixed, ppts = pmap.select_local_window(to_port(m), KF1, win_cap, fix_cap, pts_cap)
    for r, g in ((win, pwin), (fixed, pfixed), (pts, ppts)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    tab = (1.0 / 1.44 ** np.arange(NL)).astype(np.float32)
    prob, sel = jmap.build_local_ba(to_jax(m), win, fixed, pts, jnp.asarray(tab), obs_cap=8)
    pprob, psel = pmap.build_local_ba(to_port(m), pwin, pfixed, ppts, torch.from_numpy(tab),
                                      obs_cap=8)
    np.testing.assert_array_equal(psel.numpy(), np.asarray(sel))
    for name in prob._fields:
        np.testing.assert_array_equal(getattr(pprob, name).numpy(),
                                      np.asarray(getattr(prob, name)), err_msg=name)
    rng = np.random.default_rng(12)
    T_new = np.asarray(prob.T_cw).copy()
    T_new[:, :3, 3] += rng.normal(0, 0.01, (T_new.shape[0], 3))
    p_new = np.asarray(prob.p_w) + rng.normal(0, 0.01, np.asarray(prob.p_w).shape)
    outlier = rng.random(np.asarray(sel).shape) < 0.1
    ref = jmap.apply_local_ba(to_jax(m), win, pts, jnp.asarray(T_new[:win_cap]),
                              jnp.asarray(p_new, jnp.float32), jnp.asarray(outlier), sel)
    got = pmap.apply_local_ba(to_port(m), pwin, ppts, torch.from_numpy(T_new[:win_cap]),
                              torch.from_numpy(p_new.astype(np.float32)),
                              torch.from_numpy(outlier), psel)
    assert_maps_match(ref, got)


def test_cull_keyframes_matches_jax(world):
    """A world whose keyframe 1 is redundant: every one of its points is
    also seen by the others; culling re-parents its children."""
    maps, _ = world
    m = dict(maps[-1])
    # Make all observations share octave 0 so the redundancy test passes.
    m["mp_obs_oct"] = np.zeros_like(m["mp_obs_oct"])
    m["kf_octave"] = np.zeros_like(m["kf_octave"])
    ref = jmap.cull_keyframes(to_jax(m), KF1, jnp.float32(10.0), redundancy=0.5)
    got = pmap.cull_keyframes(to_port(m), KF1, torch.tensor(10.0), redundancy=0.5)
    assert_maps_match(ref, got)
    assert np.asarray(ref.kf_valid).sum() < m["kf_valid"].sum()
