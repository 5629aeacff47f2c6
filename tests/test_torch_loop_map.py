"""The map-side loop-closing pieces of the port against the JAX package.

Maps are built by the JAX package (test_torch_mapstate.build_world: six
keyframes through JAX's insert_keyframe) and carried across with
``convert.map_state_from_numpy``; the same inputs go through both
packages on the CPU.

* ``_detect`` / ``_detect_body`` on tests/test_loop_guard.py's three
  ``min_frame_gap`` scenarios and on the world map: identical ids,
  consistency flags, group masks and counts.
* ``_verify_pack`` with the RANSAC picks that JAX draws: identical gate
  counts and ``matched_mp``; the refined Sim3 within 1e-4.
* The fusion search (``match_fuse_points``, one K2 call) against JAX's
  dense ``search_by_projection`` through ``_fuse_match_into_kf``:
  identical assignments.
* ``_bind_points_into_kf``, and each step of ``_correct_on_device`` from
  the same map: integer fields identical, poses and points within 1e-5.
  The whole ``_correct_on_device``: the bundle's poses, group, tree and
  loop edges identical or within 1e-5, at most 2 % of the fusion's
  keypoint bindings apart (an octave gate on a float boundary, T10).
* ``_merge_gba`` on tests/test_gba_async.py's two scenarios, within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_gba_async as tga
import test_loop_guard as tlg
from test_torch_mapstate import CFG, NL, SF, assert_maps_match, build_world, map_np, to_jax, to_port

from ydorbslam_tpu_torch.convert import map_state_to_numpy

from ydorbslam_tpu.config import camera_intrinsics as jax_camera
from ydorbslam_tpu.slam import loop_impl as jli
from ydorbslam_tpu.slam import retrieval as jret

from ydorbslam_tpu_torch.convert import camera_from_numpy, retrieval_index_from_numpy
from ydorbslam_tpu_torch.ops import launch_counts
from ydorbslam_tpu_torch.slam import loop_impl as pli

torch.set_num_threads(2)

JCAM = jax_camera(CFG)
PCAM = camera_from_numpy(tuple(JCAM))


@pytest.fixture(scope="module")
def world():
    """Six keyframes in 16 slots: the JAX closer takes the top 10
    covisibles, so it needs K >= 10."""
    import test_torch_mapstate as tms

    k = tms.K
    tms.K = 16
    try:
        maps, _ = build_world(seed=1, n_kf=6)
    finally:
        tms.K = k
    return maps[-1]


def _world_index(mnp):
    idx = jret.empty_index(mnp["kf_valid"].shape[0])
    for k in np.where(mnp["kf_valid"])[0]:
        idx = jret.add_keyframe(idx, int(k), jnp.asarray(mnp["kf_desc"][k]),
                                jnp.asarray(mnp["kf_kp_valid"][k]))
    return idx


def _idx_np(idx):
    return {k: np.asarray(v) for k, v in idx._asdict().items()}


# ----------------------------------------------------------------------
# Detection
# ----------------------------------------------------------------------

def _port_detect(mnp, idx_np, kf, C, th, gap, prev=None):
    K = mnp["kf_valid"].shape[0]
    masks = torch.zeros((C, K), dtype=torch.bool) if prev is None else torch.from_numpy(prev[0])
    counts = torch.full((C,), -1, dtype=torch.int32) if prev is None else torch.from_numpy(prev[1])
    return pli._detect(to_port(mnp), retrieval_index_from_numpy(idx_np), kf, masks, counts, C, th,
                       min_frame_gap=gap)


@pytest.mark.parametrize("scenario", ["gate_off", "gate_rejects", "real_revisit"])
def test_detect_min_frame_gap_matches_jax(scenario):
    """tests/test_loop_guard.py's lost-stretch pair: surfaced without the
    guard, rejected at a gap of 30, kept for a 300-frame revisit."""
    m, idx = tlg._scenario(np.random.default_rng(42))
    gap = 0 if scenario == "gate_off" else 30
    if scenario == "real_revisit":
        m = m._replace(kf_frame_id=m.kf_frame_id.at[1].set(409))
    C = 4
    ref = jli._detect_on_device(m, idx, 1, jnp.zeros((C, tlg.K), bool), -jnp.ones((C,), jnp.int32),
                                C, 1, min_frame_gap=gap)
    got = _port_detect(map_np(m), _idx_np(idx), 1, C, 1, gap)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    ids = [int(i) for i in got[0] if i >= 0]
    assert (0 in ids) == (scenario != "gate_rejects")


def test_detect_consistency_chain_matches_jax(world):
    """Two consecutive detections on the world map, the second consuming
    the first's groups: identical outputs at each step."""
    mnp = world
    idx = _world_index(mnp)
    C, th = 4, 1
    K = mnp["kf_valid"].shape[0]
    jprev = (jnp.zeros((C, K), bool), -jnp.ones((C,), jnp.int32))
    pprev = None
    for kf in (4, 5):
        ref = jli._detect_on_device(to_jax(mnp), idx, kf, *jprev, C, th, min_frame_gap=0)
        got = _port_detect(mnp, _idx_np(idx), kf, C, th, 0, pprev)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        jprev = (ref[2], ref[3].astype(jnp.int32))
        pprev = (got[2].numpy(), got[3].to(torch.int32).numpy())


# ----------------------------------------------------------------------
# Verification
# ----------------------------------------------------------------------

def _jax_picks_ransac(key, B):
    """The port's ransac_sim3 with the picks JAX's draws inside its
    _verify_pack (jax.random.choice on the same eligibility mask)."""
    orig = pli.ransac_sim3

    def wrapped(cam, p1, p2, s1, s2, valid, **kw):
        probs = jnp.where(jnp.asarray(valid.numpy()), 1.0, 0.0)
        probs = probs / jnp.maximum(probs.sum(), 1e-6)
        picks = np.asarray(jax.random.choice(key, valid.shape[0], shape=(B, 3), replace=True,
                                             p=probs))
        kw.update(picks=torch.from_numpy(picks.astype(np.int64)), generator=None)
        return orig(cam, p1, p2, s1, s2, valid, **kw)

    return wrapped


VERIFY_KW = dict(th_low=50, ratio=0.75, n_hypotheses=256, min_inliers=20, sim3_iters=5,
                 scale_factor=SF, n_levels=NL, guided_cap=1024)


@pytest.mark.parametrize("kf1,kf2", [(5, 1), (4, 1)])
def test_verify_pack_matches_jax(world, monkeypatch, kf1, kf2):
    key = jax.random.PRNGKey(kf1)
    pack_j, mm_j = jli._verify_pack(to_jax(world), kf1, kf2, key, JCAM, **VERIFY_KW)
    monkeypatch.setattr(pli, "ransac_sim3", _jax_picks_ransac(key, VERIFY_KW["n_hypotheses"]))
    before = launch_counts()["proj_best2"]
    pack_p, mm_p = pli._verify_pack(to_port(world), kf1, kf2, PCAM, **VERIFY_KW)
    assert launch_counts()["proj_best2"] == before  # the CPU takes K2's plain version
    pack_j, pack_p = np.asarray(pack_j), pack_p.numpy()
    assert pack_p.shape == (pli.PACK,)
    np.testing.assert_array_equal(pack_p[:6], pack_j[:6])
    assert pack_j[0] >= 20 and pack_j[1] == 1.0 and pack_j[3] >= 40  # the loop gates pass
    np.testing.assert_allclose(pack_p[6:], pack_j[6:], atol=1e-4)
    np.testing.assert_array_equal(mm_p.numpy(), np.asarray(mm_j))


# ----------------------------------------------------------------------
# Fusion search, binding, correction
# ----------------------------------------------------------------------

def _offset(T, dx):
    T = np.array(T, np.float32)
    T[:3, 3] += np.asarray(dx, np.float32)
    return T


@pytest.mark.parametrize("g,dx", [(5, (0.0, 0.0, 0.0)), (3, (0.02, -0.01, 0.03)),
                                  (0, (0.0, 0.0, 0.0))])
def test_fusion_search_matches_jax_dense(world, g, dx):
    """JAX's ``_fuse_match_into_kf`` (the dense search_by_projection) and
    the port's one-K2 search give identical assignments."""
    mnp = {k: v.copy() for k, v in world.items()}
    mnp["kf_pose"][g] = _offset(mnp["kf_pose"][g], dx)
    pts = np.where(mnp["mp_valid"])[0][:1500].astype(np.int32)
    pts = np.pad(pts, (0, 2048 - len(pts)), constant_values=-1)
    pvalid = pts >= 0
    ref = np.asarray(jli._fuse_match_into_kf(to_jax(mnp), g, jnp.asarray(pts), jnp.asarray(pvalid),
                                             JCAM, SF, NL))
    got = pli._fuse_match_into_kf(to_port(mnp), torch.tensor([g]), torch.from_numpy(pts),
                                  torch.from_numpy(pvalid), PCAM, SF, NL).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (ref >= 0).sum() > 50


def test_bind_points_matches_jax(world):
    """Candidates into keyframe 5: some bind to empty slots, some replace
    the slot's point, some are already observed there."""
    mnp = world
    rng = np.random.default_rng(2)
    N = mnp["kf_mp"].shape[1]
    valid_pts = np.where(mnp["mp_valid"])[0]
    q = np.where(rng.random(N) < 0.5, rng.choice(valid_pts, N), -1).astype(np.int32)
    q[:20] = mnp["kf_mp"][5, :20]  # already bound here: a no-op
    ref = jli._bind_points_into_kf(to_jax(mnp), 5, jnp.asarray(q), SF, NL)
    got = pli._bind_points_into_kf(to_port(mnp), 5, torch.from_numpy(q), SF, NL)
    assert_maps_match(ref, got, atol=1e-5)


def _loop_inputs(mnp):
    """A loop between keyframes 5 and 1: JAX's verification of the pair,
    and its Sim3 moved 3.6 cm so that the correction moves the group."""
    pack, mm = jli._verify_pack(to_jax(mnp), 5, 1, jax.random.PRNGKey(5), JCAM, **VERIFY_KW)
    S_12 = np.asarray(pack)[6:].reshape(4, 4) @ _offset(np.eye(4), (0.03, 0.0, -0.02))
    return S_12.astype(np.float32), np.asarray(mm)


@pytest.mark.parametrize("fuse_group_cap", [16, 2])
def test_correct_on_device_matches_jax(world, fuse_group_cap):
    """The whole correction: the group, the corrected poses and points,
    the covisibility before, the tree and the loop edge identical or
    within 1e-5.  The fusion's bindings may differ on a few keypoints:
    the predicted octave of a point seen from its reference keyframe is
    ceil() of a ratio that is a power of the scale factor up to rounding,
    so the octave gate of such a point sits on a float boundary (ROADMAP
    T10); at most 2 % of the keypoint bindings may differ.  The step-wise
    test below holds each step exactly on the same inputs."""
    mnp = world
    S_12, mm = _loop_inputs(mnp)
    kw = dict(scale_factor=SF, n_levels=NL, fuse_pts_cap=1024, fuse_group_cap=fuse_group_cap)
    ref_m, ref_b = jli._correct_on_device(to_jax(mnp), 5, 1, jnp.asarray(S_12), jnp.asarray(mm),
                                          JCAM, **kw)
    got_m, got_b = pli._correct_on_device(to_port(mnp), 5, 1, torch.from_numpy(S_12),
                                          torch.from_numpy(mm), PCAM, **kw)
    for i in (0, 1, 2, 3, 5, 6, 7):  # poses, group, covis before, validity, tree, loop edges
        g, r = got_b[i].numpy(), np.asarray(ref_b[i])
        np.testing.assert_allclose(g, r, atol=1e-5, err_msg=f"bundle[{i}]")
    assert int(got_b[8]) == int(ref_b[8])
    jm, pm = map_np(ref_m), map_state_to_numpy(got_m)
    np.testing.assert_allclose(pm["kf_pose"], jm["kf_pose"], atol=1e-5)
    both = jm["mp_valid"] & pm["mp_valid"]
    np.testing.assert_allclose(pm["mp_pos"][both], jm["mp_pos"][both], atol=1e-5)
    bound = (jm["kf_mp"] >= 0) | (pm["kf_mp"] >= 0)
    assert (jm["kf_mp"] != pm["kf_mp"]).sum() <= 0.02 * bound.sum()
    assert abs(int(got_b[9]) - int(ref_b[9])) <= 0.02 * int(ref_b[9])
    # The packed bundle reads back as the bundle.
    back = pli._unpack_bundle(pli._fetch(pli._pack_bundle(got_b)), got_m.K)
    np.testing.assert_array_equal(back[4], got_b[4].numpy())
    np.testing.assert_array_equal(back[1], got_b[1].numpy())
    assert back[8] == int(got_b[8]) and back[9] == int(got_b[9])
    if fuse_group_cap == 2:
        assert back[8] > 0  # a fusion group larger than the cap


def test_correct_steps_match_jax_on_same_inputs(world):
    """Each step of the correction from the same map in both packages:
    the propagation and the binding at kf1, then per fusion target the
    search and the binding, the port fed JAX's map before every step and
    held to identical integers and floats within 1e-5 after it."""
    from ydorbslam_tpu.geometry.se3 import inv_T as jinv
    from ydorbslam_tpu.geometry.sim3 import sim3_to_se3 as js2s

    mnp = world
    S_12, mm = _loop_inputs(mnp)
    m = to_jax(mnp)
    K, kf1, kf2 = m.K, 5, 1
    group = ((m.covis[kf1] > 0) & m.kf_valid).at[kf1].set(True)
    corr = jnp.einsum("kij,jl->kil", m.kf_pose @ jinv(m.kf_pose[kf1]), S_12 @ m.kf_pose[kf2])
    # The port's propagation on the same map (the first half of its
    # _correct_on_device) against JAX's formulas.
    pm = to_port(mnp)
    pg = torch.from_numpy(np.asarray(group))
    pc = (pm.kf_pose @ pli.inv_T(pm.kf_pose[kf1])) @ (torch.from_numpy(S_12) @ pm.kf_pose[kf2])
    np.testing.assert_allclose(pc.numpy(), np.asarray(corr), atol=1e-5)
    np.testing.assert_array_equal(
        pli._member_points(pm, pg).numpy(),
        np.asarray(jnp.zeros((m.M,), bool).at[jnp.clip(m.kf_mp, 0, m.M - 1)].max(
            group[:, None] & (m.kf_mp >= 0), mode="drop") & m.mp_valid))
    m = m._replace(kf_pose=jnp.where(group[:, None, None], jax.vmap(js2s)(corr), m.kf_pose))
    steps = [(kf1, jnp.asarray(mm), None)]
    lsel = ((m.covis[kf2] > 0) & m.kf_valid).at[kf2].set(True)
    lm = jnp.zeros((m.M,), bool).at[jnp.clip(m.kf_mp, 0, m.M - 1)].max(
        lsel[:, None] & (m.kf_mp >= 0), mode="drop") & m.mp_valid
    pts = jnp.sort(jnp.where(lm, jnp.arange(m.M), m.M))[:1024].astype(jnp.int32)
    pv = pts < m.M
    pts = jnp.where(pv, pts, -1)
    gv, gi = jax.lax.top_k(jnp.where(group & (jnp.arange(K) != kf1), m.covis[kf1], -1), 5)
    steps += [(int(g), None, True) for g, v in zip(np.asarray(gi), np.asarray(gv)) if v > 0]
    n_fused = 0
    for g, q, _ in steps:
        pm = to_port(map_np(m))
        if q is None:
            a = jli._fuse_match_into_kf(m, g, pts, pv, JCAM, SF, NL)
            b = pli._fuse_match_into_kf(pm, torch.tensor([g]), torch.from_numpy(np.asarray(pts)),
                                        torch.from_numpy(np.asarray(pv)), PCAM, SF, NL)
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f"fusion into {g}")
            q = jnp.where(a >= 0, pts[jnp.clip(a, 0, pts.shape[0] - 1)], -1)
            n_fused += int((a >= 0).sum())
        m = jli._bind_points_into_kf(m, g, q, SF, NL)
        got = pli._bind_points_into_kf(pm, torch.tensor([g]), torch.from_numpy(np.asarray(q)), SF, NL)
        assert_maps_match(m, got, atol=1e-5)
    assert n_fused > 100


# ----------------------------------------------------------------------
# Global-BA merge
# ----------------------------------------------------------------------

@pytest.mark.parametrize("reused", [False, True])
def test_merge_gba_matches_jax(reused):
    """tests/test_gba_async.py's scenarios: keyframes present at the BA's
    start take its poses, one minted since chains off its parent, and a
    slot re-minted during the BA chains instead of taking the stale pose."""
    m = tga._base_map()
    fid0 = np.arange(m.K, dtype=np.int32)
    if reused:
        fid_now = np.asarray(m.kf_frame_id).copy()
        fid_now[1] = 42
        m = m._replace(kf_frame_id=jnp.asarray(fid_now))
    T_new, p_new, pts, valid0 = tga._gba_result(m, tga.se3(0.5, yaw=0.2))
    ref = jli._merge_gba(m, T_new, p_new, pts, valid0, jnp.asarray(fid0), jnp.int32(3))
    got = pli._merge_gba(to_port(map_np(m)), *(torch.from_numpy(np.array(x)) for x in
                                               (T_new, p_new, pts, valid0, fid0)), 3)
    assert_maps_match(ref, got, atol=1e-5)
