"""Loop closing: detection -> Sim3 verification -> correction -> global BA.

Port of ``ydorbslam_tpu/slam/loop_impl.py``, the algorithmic mirror of
src/loopClosing.cpp with the thread protocol removed:

  detect   retrieval candidates (``slam/retrieval.py``) + covisibility
           consistency across consecutive keyframes (loopClosing.cpp:
           34-114), ``_detect_body``;
  verify   appearance match (K2, ``match_dense``), Horn RANSAC, Sim3
           refinement and the guided search of the loop group's points
           (K2, ``match_local_points``) (loopClosing.cpp:115-228),
           ``_verify_pack``;
  correct  the corrected Sim3 propagated to the covisible group and its
           points, the guided matches bound at the query keyframe,
           fusion of the loop-side points into the group (K2 per
           target, ``match_fuse_points``), the covisibility rebuild
           (loopClosing.cpp:229-352), ``_correct_on_device``; then the
           essential graph (``optim/pose_graph.py``) and a global BA
           advanced one chunk (K4) per keyframe and merged into the live
           map (``_merge_gba``, loopClosing.cpp:377-445).

When the process is one of several ranks (``parallel.multihost``), the
detection's scoring shards the keyframe axis of the retrieval index and
the global BA's chunks shard its points over the ranks
(``parallel/retrieval_sharded.py``, ``parallel/ba_sharded.py``), as the
JAX package does on more than one device; every other step runs on every
rank alike, on the same replicated state.

The host reads the device at the JAX package's points only, each through
``_fetch``: one packed detection vector per dispatched keyframe, read one
keyframe late; one packed 22-float verification vector per candidate;
one packed correction bundle per accepted loop.  Between those reads the
host waits on the card only in a verification's RANSAC, where PyTorch
checks the error codes of its two batched ``eigh`` on the host
(``chip_smoke.py`` phase 13 counts every wait).  The RANSAC draws come from a
seeded CPU ``torch.Generator`` (the JAX package's ``PRNGKey(0)`` chain).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import trace
from ..geometry.se3 import inv_T
from ..geometry.sim3 import sim3_to_se3
from ..ops.extractor import FrameFeatures
from ..ops.pyramid import scale_table
from ..ops.scatter import scatter_max, scatter_set
from ..ops.select import stable_topk
from ..optim.horn import ransac_sim3
from ..optim.pose_graph import PoseGraphProblem, optimize_pose_graph
from ..optim.schur import _lm_chunk
from ..optim.sim3_opt import optimize_sim3
from ..parallel import multihost
from ..parallel.ba_sharded import _sharded_lm_chunk
from ..parallel.retrieval_sharded import score_all_sharded
from .map_state import MapState, add_observations_multi, recompute_covis_all, replace_points
from .mapping import build_local_ba
from .matchers import match_dense, match_fuse_points, match_local_points
from .retrieval import bow_histogram, detect_candidates, score_all

PACK = 22  # [n_matches, ransac_ok, n_sim3_inliers, n_guided_total, n_has1, n_has2, S_ref(16)]


def _fetch(x: torch.Tensor) -> np.ndarray:
    """The device->host read of loop closing: every host read of the
    detect/verify/correct path goes through here, one packed tensor at a
    time, so a test can count them."""
    with trace.wait("loop_fetch"):
        return x.cpu().numpy()


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on ``dev``.  To the card it goes from pinned memory,
    which does not stall the host as a copy from pageable memory does."""
    t = torch.from_numpy(a)
    return t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t.to(dev)


def _i64(x):
    return x.to(torch.int64)


def _member_points(m: MapState, kf_sel: torch.Tensor) -> torch.Tensor:
    """(M,) valid points bound to any keyframe of the mask ``kf_sel`` (K,)."""
    sel = kf_sel[:, None] & (m.kf_mp >= 0)
    member = scatter_max(
        torch.zeros((m.M,), dtype=torch.bool, device=m.device),
        torch.clamp(_i64(m.kf_mp), 0, m.M - 1), sel,
    )
    return member & m.mp_valid


def _lowest_ids(mask: torch.Tensor, cap: int) -> torch.Tensor:
    """The ``cap`` lowest indices where ``mask`` holds, ascending, padded
    with len(mask) (``jnp.sort(where(mask, arange, M))[:cap]``)."""
    n = mask.shape[0]
    order = torch.where(mask, torch.arange(n, device=mask.device), n)
    return torch.sort(order).values[:cap]


def _row(x: torch.Tensor, g) -> torch.Tensor:
    """x[g] for a keyframe id that is an int or a (1,) device tensor; the
    tensor is gathered, not read on the host (indexing with a 0-dim
    tensor reads its value)."""
    return x[g] if isinstance(g, int) else torch.index_select(x, 0, g)[0]


def _kf_features(m: MapState, g) -> FrameFeatures:
    """Keyframe ``g``'s keypoints as a frame's features."""
    angle = _row(m.kf_angle, g)
    return FrameFeatures(
        uv=_row(m.kf_uv, g), uv_raw=_row(m.kf_uv, g), response=torch.zeros_like(angle),
        octave=_row(m.kf_octave, g), angle=angle, desc=_row(m.kf_desc, g),
        right_u=_row(m.kf_right_u, g), depth=_row(m.kf_depth, g), valid=_row(m.kf_kp_valid, g),
    )


def _transform(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Per-row transform: (n,4,4) poses applied to (n,3) points."""
    return torch.einsum("nij,nj->ni", T[:, :3, :3], p) + T[:, :3, 3]


# ----------------------------------------------------------------------
# Verification
# ----------------------------------------------------------------------

def _verify_pack(
    m: MapState, kf1: int, kf2: int, cam, th_low: int, ratio: float, n_hypotheses: int,
    min_inliers: int, sim3_iters: int, scale_factor: float, n_levels: int, guided_cap: int,
    generator: Optional[torch.Generator] = None,
):
    """Geometric verification of candidate ``kf2`` for query ``kf1``
    (loopClosing.cpp:115-228): appearance match between the keypoints
    with map points (K2), Horn RANSAC with the scale fixed, Sim3
    refinement on its inliers, then the guided search of the loop group
    (kf2 and its 10 strongest covisibles, ``guided_cap`` lowest point
    ids) projected through the refined Sim3 (K2, th = 2).

    Returns (pack (22,) float32 [n_matches, ransac_ok, n_sim3_inliers,
    n_guided_total, n_has1, n_has2, S_ref(16)], matched_mp (N,) int32 the
    guided loop point per kf1 keypoint or -1), both on the device."""
    dev = m.device
    M, N, K = m.M, m.N, m.K
    has1 = m.kf_kp_valid[kf1] & (m.kf_mp[kf1] >= 0)
    has2 = m.kf_kp_valid[kf2] & (m.kf_mp[kf2] >= 0)
    assign, _ = match_dense(
        m.kf_desc[kf1], has1, m.kf_angle[kf1], m.kf_desc[kf2], has2, m.kf_angle[kf2],
        max_dist=th_low, ratio=ratio,
    )  # per kf2 keypoint -> kf1 keypoint
    n_matches = torch.sum(assign >= 0)
    kp1 = torch.clamp(_i64(assign), 0, N - 1)
    mp1 = m.kf_mp[kf1][kp1]
    mp2 = m.kf_mp[kf2]
    mp1c, mp2c = torch.clamp(_i64(mp1), 0, M - 1), torch.clamp(_i64(mp2), 0, M - 1)
    ok = (assign >= 0) & (mp1 >= 0) & (mp2 >= 0) & m.mp_valid[mp1c] & m.mp_valid[mp2c]
    T1, T2 = m.kf_pose[kf1], m.kf_pose[kf2]
    p1 = m.mp_pos[mp1c] @ T1[:3, :3].T + T1[:3, 3]
    p2 = m.mp_pos[mp2c] @ T2[:3, :3].T + T2[:3, 3]
    scales = scale_table(n_levels, scale_factor, dev)
    sf2 = scales * scales
    s2_1 = sf2[_i64(m.kf_octave[kf1][kp1])]
    s2_2 = sf2[_i64(m.kf_octave[kf2])]
    res = ransac_sim3(cam, p1, p2, s2_1, s2_2, ok, n_hypotheses=n_hypotheses,
                      min_inliers=min_inliers, generator=generator)
    S_ref, _, n_in = optimize_sim3(
        cam, res.S_12, p1, p2, m.kf_uv[kf1][kp1], m.kf_uv[kf2], 1.0 / s2_1, 1.0 / s2_2,
        res.inliers, iters1=sim3_iters, iters2=10,
    )
    # Guided search against the loop group's points
    # (searchByProjectionInSim, loopClosing.cpp:196-227).
    w = m.covis[kf2] * m.kf_valid.to(torch.int32)
    nvals, nids = stable_topk(w, min(10, K))
    gsel = scatter_set(torch.zeros((K,), dtype=torch.bool, device=dev),
                       torch.where(nvals > 0, nids, K), nvals > 0)
    gsel = scatter_set(gsel, kf2, True)
    pts = _lowest_ids(_member_points(m, gsel), guided_cap)
    pvalid = pts < M
    idc = torch.clamp(pts, 0, M - 1)
    T_cw = sim3_to_se3(S_ref @ T2)
    gassign, _ = match_local_points(
        cam, _kf_features(m, kf1), T_cw, m.mp_pos[idc], m.mp_desc[idc], m.mp_normal[idc],
        m.mp_max_dist[idc], m.mp_min_dist[idc], pvalid & m.mp_valid[idc],
        th=2.0, n_levels=n_levels, scale_factor=scale_factor,
    )
    total = torch.sum(gassign >= 0)
    matched_mp = torch.where(
        gassign >= 0, pts[torch.clamp(_i64(gassign), 0, pts.shape[0] - 1)], -1
    ).to(torch.int32)
    f = torch.float32
    pack = torch.cat([
        torch.stack([n_matches.to(f), res.ok.to(f), n_in.to(f), total.to(f),
                     torch.sum(has1).to(f), torch.sum(has2).to(f)]),
        S_ref.reshape(16),
    ])
    return pack, matched_mp


# ----------------------------------------------------------------------
# Detection
# ----------------------------------------------------------------------

def _detect_body(m: MapState, retrieval, kf_id: int, prev_masks, prev_counts, q, scores,
                 max_out: int, consistency_th: int, min_frame_gap: int = 0):
    """Loop candidates of keyframe ``kf_id`` (KeyFrameDatabase::
    detectLoopCandidates: candidates outside its covisible group scoring at
    least its weakest covisible neighbour), the temporal guard
    ``min_frame_gap`` (candidates minted within that many frames of the
    query are dropped), and the consistency update of loopClosing.cpp:
    73-113: each candidate's group (itself and its covisibles) against
    the previous keyframe's groups.  Returns (ids (C,) or -1,
    consistent (C,), masks (C, K), counts (C,))."""
    K = m.K
    dev = m.device
    connected = scatter_set(m.covis[kf_id] > 0, kf_id, True)
    neigh = connected & (torch.arange(K, device=dev) != kf_id) & retrieval.valid
    min_score = torch.amin(torch.where(neigh, scores, torch.inf))
    min_score = torch.where(torch.isfinite(min_score), min_score, 0.0)
    ids, _ = detect_candidates(retrieval, q, connected, m.covis, min_score, max_out=max_out)
    if min_frame_gap > 0:
        idg = torch.clamp(_i64(ids), 0, K - 1)
        gap_ok = torch.abs(m.kf_frame_id[idg] - m.kf_frame_id[kf_id]) >= min_frame_gap
        ids = torch.where(gap_ok, ids, -1)
    idc = torch.clamp(_i64(ids), 0, K - 1)
    masks = (m.covis[idc] > 0) | (idc[:, None] == torch.arange(K, device=dev)[None, :])
    masks = masks & (ids >= 0)[:, None]
    hit = torch.any(masks[:, None, :] & prev_masks[None, :, :], dim=-1)  # (C, C_prev)
    best_prev = torch.amax(torch.where(hit, prev_counts[None, :] + 1, 0), dim=-1)
    consistent = (ids >= 0) & (best_prev >= consistency_th)
    return ids, consistent, masks, best_prev


def _detect(m: MapState, retrieval, kf_id: int, prev_masks, prev_counts, max_out: int,
            consistency_th: int, n_banks: int = 4, bank_bits: int = 12, min_frame_gap: int = 0,
            group=None):
    """Query histogram and scores of keyframe ``kf_id``, then
    ``_detect_body``.  With ``group`` the scores come from the
    keyframe-sharded ``score_all_sharded`` (the JAX package's
    ``make_sharded_detect``), bit-equal to ``score_all``'s."""
    q = bow_histogram(m.kf_desc[kf_id], m.kf_kp_valid[kf_id], n_banks, bank_bits)
    if group is None:
        _, scores = score_all(retrieval, q)
    else:
        _, scores = score_all_sharded(group, retrieval, q)
    return _detect_body(m, retrieval, kf_id, prev_masks, prev_counts, q, scores,
                        max_out, consistency_th, min_frame_gap)


# ----------------------------------------------------------------------
# Global-BA merge
# ----------------------------------------------------------------------

def _merge_gba(m: MapState, T_new, p_new, pts, valid0, fid0, kf_count_start: int) -> MapState:
    """Merge a finished global BA into the live map (loopClosing.cpp:
    377-445): keyframes that existed when it started (same slot, same
    frame id, ``fid0``) take their optimised pose; keyframes minted
    since chain off their spanning-tree parent in 8 rounds
    (T_child = T_child<-parent_old @ T_parent_old^-1 @ T_parent_new); BA
    points write back unless their slot was reused since; every other
    point follows its reference keyframe's correction."""
    K, M = m.K, m.M
    T_now = m.kf_pose
    same = m.kf_valid & valid0 & (m.kf_frame_id == fid0)
    T_merged = torch.where(same[:, None, None], T_new[:K], T_now)
    parc = torch.clamp(_i64(m.parent), 0, K - 1)
    T_rel = T_now @ inv_T(T_now[parc])
    resolved = same
    for _ in range(8):
        can = m.kf_valid & ~resolved & (m.parent >= 0) & resolved[parc]
        T_merged = torch.where(can[:, None, None], T_rel @ T_merged[parc], T_merged)
        resolved = resolved | can
    kf_pose = torch.where((m.kf_valid & resolved)[:, None, None], T_merged, T_now)

    ptc = torch.clamp(_i64(pts), 0, M - 1)
    direct_ok = (pts >= 0) & m.mp_valid[ptc] & (m.mp_first_kf[ptc] < kf_count_start)
    row_w = torch.where(direct_ok, ptc, M)
    direct_mask = scatter_set(torch.zeros((M,), dtype=torch.bool, device=m.device), row_w, True)
    mp_pos = scatter_set(m.mp_pos, row_w, torch.where(direct_ok[:, None], p_new, m.mp_pos[ptc]))
    refc = torch.clamp(_i64(m.mp_ref_kf), 0, K - 1)
    p_ind = _transform(inv_T(kf_pose[refc]), _transform(T_now[refc], m.mp_pos))
    ind_ok = (m.mp_valid & ~direct_mask & (m.mp_ref_kf >= 0) & resolved[refc]
              & m.kf_valid[refc])
    mp_pos = torch.where(ind_ok[:, None], p_ind, mp_pos)
    return m._replace(kf_pose=kf_pose, mp_pos=mp_pos)


# ----------------------------------------------------------------------
# Correction
# ----------------------------------------------------------------------

def _fuse_match_into_kf(m: MapState, g, pts, pvalid, cam, scale_factor: float,
                        n_levels: int) -> torch.Tensor:
    """fuseBySim3's candidate search for target keyframe ``g`` (an int or
    a (1,) tensor; one K2 launch, ``matchers.match_fuse_points``).
    Returns the candidate index into ``pts`` per keypoint of ``g``, or -1."""
    idc = torch.clamp(_i64(pts), 0, m.M - 1)
    assign, _ = match_fuse_points(
        cam, _kf_features(m, g), _row(m.kf_pose, g), m.mp_pos[idc], m.mp_desc[idc],
        m.mp_normal[idc], m.mp_max_dist[idc], m.mp_min_dist[idc], pvalid & m.mp_valid[idc],
        n_levels=n_levels, scale_factor=scale_factor,
    )
    return assign


def _bind_points_into_kf(m: MapState, g, q: torch.Tensor, scale_factor: float,
                         n_levels: int) -> MapState:
    """Bind candidate points ``q`` (N,) into keyframe ``g`` (an int or a
    (1,) tensor): an empty keypoint slot binds (addObservation +
    addMapPoint, loopClosing.cpp:299-303); an occupied slot hands its
    point to the candidate (beReplacedBy, :297, 344-350: the loop-side
    point survives)."""
    N = m.N
    dev = m.device
    qc = torch.clamp(_i64(q), 0, m.M - 1)
    already = torch.any(m.mp_obs_kf[qc] == g, dim=-1)
    vq = (q >= 0) & m.mp_valid[qc] & ~already
    p_exist = _row(m.kf_mp, g)
    bind = vq & (p_exist < 0)
    repl = vq & (p_exist >= 0) & (p_exist != q)
    g_row = torch.zeros((N,), dtype=torch.int32, device=dev) + g
    m, okw = add_observations_multi(
        m, torch.where(bind, q, -1), g_row, torch.arange(N, dtype=torch.int32, device=dev), bind,
    )
    m = m._replace(kf_mp=scatter_set(m.kf_mp, g, torch.where(bind & okw, q, p_exist)))
    return replace_points(m, torch.where(repl, p_exist, -1), q, repl, scale_factor, n_levels)


def _correct_on_device(m: MapState, kf1: int, kf2: int, S_12, matched_mp, cam,
                       scale_factor: float, n_levels: int, fuse_pts_cap: int,
                       fuse_group_cap: int):
    """The loop correction (loopClosing.cpp:229-352): the corrected Sim3
    propagated to kf1's covisible group and its points, the guided
    matches bound at kf1, the loop-side points (kf2 and its covisibles,
    ``fuse_pts_cap`` lowest ids) fused into kf1 and its ``fuse_group_cap``
    - 1 strongest group members (one K2 launch each), then the whole
    covisibility rebuilt.

    Returns (new map, bundle): old poses, corrected poses, group mask,
    covisibility before and after, keyframe validity, parents, loop
    edges, the number of group members left unfused, and the live point
    count, on the device."""
    K, M = m.K, m.M
    dev = m.device
    ar = torch.arange(K, device=dev)
    covis_before = m.covis
    old_poses = m.kf_pose
    group = scatter_set((m.covis[kf1] > 0) & m.kf_valid, kf1, True)
    S_cw_corr = S_12 @ old_poses[kf2]
    corrected_all = (old_poses @ inv_T(old_poses[kf1])) @ S_cw_corr
    member = _member_points(m, group)
    # Each point moves with its reference keyframe's correction when the
    # reference is in the group, else with kf1's (loopClosing.cpp:263-287).
    ref = m.mp_ref_kf
    refc = torch.clamp(_i64(ref), 0, K - 1)
    use_kf = torch.where((ref >= 0) & group[refc], refc, kf1)
    p_corr = _transform(inv_T(corrected_all[use_kf]), _transform(old_poses[use_kf], m.mp_pos))
    new_m = m._replace(
        mp_pos=torch.where(member[:, None], p_corr, m.mp_pos),
        kf_pose=torch.where(group[:, None, None], sim3_to_se3(corrected_all), old_poses),
        loop_edge=scatter_set(m.loop_edge, kf1, kf2),
    )
    new_m = _bind_points_into_kf(new_m, kf1, matched_mp, scale_factor, n_levels)

    # Loop-side points: kf2 and all its covisibles (m_v_loopMapPoints).
    lsel = scatter_set((covis_before[kf2] > 0) & new_m.kf_valid, kf2, True)
    pts = _lowest_ids(_member_points(new_m, lsel), fuse_pts_cap)
    pvalid = pts < M
    pts = torch.where(pvalid, pts, -1)
    # Fusion targets: kf1 and its strongest group members.
    others_w = torch.where(group & (ar != kf1), covis_before[kf1], -1)
    gvals, gids = stable_topk(others_w, min(fuse_group_cap - 1, K - 1))
    g_list = torch.cat([torch.full((1,), kf1, dtype=torch.int64, device=dev), gids])
    g_ok = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev), gvals > 0])
    n_group_skipped = torch.clamp(torch.sum(group) - fuse_group_cap, min=0)
    for i in range(g_list.shape[0]):
        g = g_list[i:i + 1]
        assign = _fuse_match_into_kf(new_m, g, pts, pvalid, cam, scale_factor, n_levels)
        q = torch.where((assign >= 0) & g_ok[i:i + 1],
                        pts[torch.clamp(_i64(assign), 0, pts.shape[0] - 1)], -1)
        new_m = _bind_points_into_kf(new_m, g, q, scale_factor, n_levels)
    new_m = recompute_covis_all(new_m)
    bundle = (
        old_poses, corrected_all, group, covis_before, new_m.covis, new_m.kf_valid,
        new_m.parent, new_m.loop_edge, n_group_skipped, torch.sum(new_m.mp_valid),
    )
    return new_m, bundle


def _pack_bundle(bundle) -> torch.Tensor:
    """The correction bundle as one float32 vector (every integer in it
    is below 2^24, so exact), read with one copy."""
    return torch.cat([x.reshape(-1).to(torch.float32) for x in bundle])


def _unpack_bundle(v: np.ndarray, K: int):
    """Host arrays of ``_pack_bundle``'s vector, in the bundle's order."""
    sizes = [K * 16, K * 16, K, K * K, K * K, K, K, K, 1, 1]
    parts, o = [], 0
    for n in sizes:
        parts.append(v[o:o + n])
        o += n
    return (
        parts[0].reshape(K, 4, 4), parts[1].reshape(K, 4, 4), parts[2] > 0.5,
        parts[3].reshape(K, K).astype(np.int32), parts[4].reshape(K, K).astype(np.int32),
        parts[5] > 0.5, parts[6].astype(np.int64), parts[7].astype(np.int64),
        int(parts[8][0]), int(parts[9][0]),
    )


# ----------------------------------------------------------------------
# The closer
# ----------------------------------------------------------------------

class LoopCloserImpl:
    """Detection on every keyframe, verification one keyframe late, the
    correction, the essential graph and the chunked global BA of one
    ``SlamSystem``."""

    def __init__(self, system, closer):
        self.system = system
        self.closer = closer
        # RANSAC draws (the JAX package's PRNGKey(0) chain).
        self.generator = torch.Generator("cpu").manual_seed(0)
        self._gba = None  # the global BA in flight (see _start_global_ba)
        self._pending = None  # (kf_id, frame id at dispatch, packed detection)
        # Keyframe-sharded detection when several ranks run the system.
        self._kf_group = multihost.device_mesh("kf",
                                               length_divisor=system.cfg.capacity.max_keyframes)
        self.used_sharded_detect = False

    def process(self, kf_id: int) -> bool:
        """Advance any global BA by one chunk, verify the previous
        keyframe's detection, and dispatch this keyframe's detection."""
        sys = self.system
        self.tick()
        closed = self._poll_pending()
        if sys.n_keyframes - self.closer.last_loop_kf_count >= sys.cfg.loop.min_kfs_between_loops:
            self._dispatch_detect(kf_id)
        return closed

    def flush(self) -> bool:
        """Verify a detection still pending and run any global BA to its
        end (sequence end)."""
        closed = self._poll_pending()
        while self._gba is not None:
            self.tick()
        return closed

    def _dispatch_detect(self, kf_id: int) -> None:
        """Candidate scoring and the consistency update on the device; the
        packed result is read at the next keyframe."""
        sys = self.system
        m = sys.map
        cfg = sys.cfg
        C = cfg.capacity.loop_candidates
        if not isinstance(self.closer.consistent_groups, tuple):
            self.closer.consistent_groups = (
                torch.zeros((C, m.K), dtype=torch.bool, device=m.device),
                torch.full((C,), -1, dtype=torch.int32, device=m.device),
            )
        prev_masks, prev_counts = self.closer.consistent_groups
        ids, consistent, masks, counts = _detect(
            m, sys.retrieval, kf_id, prev_masks, prev_counts, C,
            cfg.loop.covisibility_consistency_th, n_banks=cfg.loop.retrieval_banks,
            bank_bits=cfg.loop.retrieval_bank_bits, min_frame_gap=cfg.loop.min_frame_gap,
            group=self._kf_group,
        )
        self.used_sharded_detect |= self._kf_group is not None
        self.closer.consistent_groups = (masks, counts.to(torch.int32))
        packed = torch.cat([ids.to(torch.float32), consistent.to(torch.float32)])
        sys._snapshot()
        self._pending = (kf_id, int(sys._host_kf_frame_id[kf_id]), packed)

    def _poll_pending(self) -> bool:
        """Verify the pending detection's consistent candidates in order;
        the first that passes every gate is corrected."""
        if self._pending is None:
            return False
        kf_id, frame_id_at_dispatch, packed = self._pending
        self._pending = None
        sys = self.system
        closer = self.closer
        # Staleness guard: mapping may have culled the pending keyframe, or
        # reused its slot for another frame, since the dispatch.
        sys._snapshot()
        if (not sys._host_kf_valid[kf_id]
                or int(sys._host_kf_frame_id[kf_id]) != frame_id_at_dispatch):
            return False
        v = _fetch(packed)
        C = v.shape[0] // 2
        cands = [int(i) for i, c in zip(v[:C], v[C:]) if i >= 0 and c > 0.5]
        if cands:
            sys.stats.loop_candidates += 1
        for cand in cands:
            hit = self._compute_sim3(kf_id, cand)
            if hit is not None:
                S_12, _, matched_mp, t_norm = hit
                sys.stats.loop_events.append((
                    int(sys._host_kf_frame_id[kf_id]), int(sys._host_kf_frame_id[cand]), t_norm,
                ))
                self._correct(kf_id, cand, S_12, matched_mp)
                closer.last_loop_kf_count = sys.n_keyframes
                closer.n_loops_closed += 1
                closer.consistent_groups = []  # re-initialised at the next dispatch
                return True
        return False

    def _compute_sim3(self, kf1: int, kf2: int):
        """Verification with one packed read; the reference's sequential
        early exits become gate checks on it in the reference's order:
        appearance matches, RANSAC, Sim3 inliers, guided total.  Returns
        (S_12 on the device, total matches, matched_mp, |t| of S_12) or
        None."""
        sys = self.system
        cfg = sys.cfg
        pack_dev, matched_mp = _verify_pack(
            sys.map, kf1, kf2, sys.cam,
            th_low=cfg.matcher.th_low, ratio=cfg.matcher.ratio_reloc,
            n_hypotheses=cfg.loop.ransac_max_iters, min_inliers=cfg.loop.ransac_min_inliers,
            sim3_iters=cfg.optim.sim3_iters, scale_factor=cfg.orb.scale_factor,
            n_levels=cfg.orb.n_levels, guided_cap=cfg.capacity.tracking_points,
            generator=self.generator,
        )
        pack = _fetch(pack_dev)
        n_matches, ransac_ok, n_in, total = int(pack[0]), bool(pack[1] > 0.5), int(pack[2]), int(pack[3])
        fails = sys.stats.loop_verify_fails
        if n_matches < cfg.loop.min_bow_matches:
            fails["bow"] = fails.get("bow", 0) + 1
            fails.setdefault("bow_diag", []).append(
                (kf1, kf2, n_matches, int(pack[4]), int(pack[5]))
            )
            return None
        if not ransac_ok:
            fails["ransac"] = fails.get("ransac", 0) + 1
            return None
        if n_in < cfg.loop.min_sim3_inliers:
            fails["sim3"] = fails.get("sim3", 0) + 1
            return None
        if total < cfg.loop.min_total_matches:
            fails["guided"] = fails.get("guided", 0) + 1
            return None
        S_host = pack[6:PACK].reshape(4, 4)
        return pack_dev[6:PACK].reshape(4, 4), total, matched_mp, float(np.linalg.norm(S_host[:3, 3]))

    def _correct(self, kf1: int, kf2: int, S_12, matched_mp) -> None:
        """The correction with one packed read of its bundle, the
        essential graph from that bundle, and global BA armed."""
        sys = self.system
        cfg = sys.cfg
        new_m, bundle = _correct_on_device(
            sys.map, kf1, kf2, S_12, matched_mp, sys.cam,
            scale_factor=cfg.orb.scale_factor, n_levels=cfg.orb.n_levels,
            fuse_pts_cap=cfg.capacity.loop_fuse_points,
            fuse_group_cap=cfg.capacity.loop_fuse_group,
        )
        sys.map = new_m
        (old_np, corrected_np, group_np, covis_before_np, covis_after_np, kf_valid_np,
         parent_np, loop_edge_np, n_group_skipped, n_valid_pts) = _unpack_bundle(
            _fetch(_pack_bundle(bundle)), new_m.K)
        if n_group_skipped > 0:
            print(
                f"[loop] searchAndFuse: corrected group exceeds capacity.loop_fuse_group by "
                f"{n_group_skipped} keyframes; weakest-covisibility members not fused"
            )
        sys.map = self._essential_graph(
            sys.map, kf1, kf2, old_np, corrected_np, group_np, covis_before_np,
            covis_after_np, kf_valid_np, parent_np, loop_edge_np,
        )
        self._start_global_ba(sys.map, n_valid_pts)

    def _essential_graph(self, m: MapState, kf1, kf2, old_np, corrected_np, group_np,
                         covis_before_np, covis_after_np, kf_valid_np, parent_np,
                         loop_edge_np) -> MapState:
        """Essential-graph optimisation (optimizer.cpp:502-661).  The edge
        set is assembled on the host from the fetched bundle, in
        insertion order, the first insertion of a pair winning: the new
        cross-loop covisibility links (loopConnections, measured with the
        corrected poses), the spanning tree and earlier loop edges, then
        strong covisibility (weight >= essential_min_covis_weight after
        fusion); the Sim3 solve runs on the device."""
        cfg = self.system.cfg
        K = m.K
        dev = m.device
        ei, ej, meas = [], [], []
        inserted = set()

        def add_edge(i, j, use_corrected=False):
            if i < 0 or j < 0 or i == j or not (kf_valid_np[i] and kf_valid_np[j]):
                return
            key = (min(i, j), max(i, j))
            if key in inserted:
                return
            inserted.add(key)
            if use_corrected:
                Si = corrected_np[i] if group_np[i] else old_np[i]
                Sj = corrected_np[j] if group_np[j] else old_np[j]
            else:
                Si, Sj = old_np[i], old_np[j]
            ei.append(i)
            ej.append(j)
            meas.append(Si @ np.linalg.inv(Sj))

        wmin = cfg.optim.essential_min_covis_weight
        new_link = np.argwhere(
            (covis_after_np >= wmin) & (covis_before_np < 15)
            & group_np[:, None] & ~group_np[None, :]
        )
        for i, j in new_link:
            add_edge(int(i), int(j), use_corrected=True)
        self.system.stats.loop_conn_edges.append(int(len(new_link)))
        for i in range(K):
            if not kf_valid_np[i]:
                continue
            add_edge(i, int(parent_np[i]))
            if loop_edge_np[i] >= 0:
                add_edge(i, int(loop_edge_np[i]), use_corrected=(i == kf1))
        for i, j in np.argwhere(np.triu(covis_after_np, 1) >= wmin):
            add_edge(int(i), int(j))
        if not ei:
            return m
        E = len(ei)
        prob = PoseGraphProblem(
            S_iw=m.kf_pose,
            fixed=scatter_set(torch.zeros((K,), dtype=torch.bool, device=dev), kf2, True),
            vertex_valid=m.kf_valid,
            edge_i=_upload(np.asarray(ei, np.int64), dev),
            edge_j=_upload(np.asarray(ej, np.int64), dev),
            edge_meas=_upload(np.stack(meas).astype(np.float32), dev),
            edge_valid=torch.ones((E,), dtype=torch.bool, device=dev),
            edge_weight=torch.ones((E,), dtype=torch.float32, device=dev),
        )
        S_opt = optimize_pose_graph(prob, iters=cfg.optim.essential_graph_iters, fix_scale=True)
        # Points follow their reference keyframe's correction
        # (optimizer.cpp:630-661); fix_scale keeps the poses rigid.
        ref = torch.clamp(_i64(m.mp_ref_kf), 0, K - 1)
        p_new = _transform(inv_T(S_opt[ref]), _transform(m.kf_pose[ref], m.mp_pos))
        mp_pos = torch.where((m.mp_valid & (m.mp_ref_kf >= 0))[:, None], p_new, m.mp_pos)
        kf_pose = torch.where(m.kf_valid[:, None, None], sim3_to_se3(S_opt), m.kf_pose)
        return m._replace(kf_pose=kf_pose, mp_pos=mp_pos)

    def _start_global_ba(self, m: MapState, n_valid: int) -> None:
        """Arm the full-map BA (optimizer.cpp:353-357) without running it:
        every valid keyframe in the window, the ``global_ba_max_points``
        best-observed points (ties to the lower id), ``global_ba_obs``
        observations each; ``tick`` advances it.  A new loop replaces a
        BA in flight (loopClosing.cpp:234-242)."""
        sys = self.system
        sys.stats.global_ba_runs += 1
        cfg = sys.cfg
        K = m.K
        dev = m.device
        win = torch.where(m.kf_valid, torch.arange(K, dtype=torch.int32, device=dev), -1)
        fixed = torch.full((1,), -1, dtype=torch.int32, device=dev)
        pts_cap = min(cfg.capacity.global_ba_max_points, m.M)
        if n_valid > pts_cap:
            print(
                f"[loop] global BA: map has {n_valid} points, optimizing the {pts_cap} "
                f"best-observed (capacity.global_ba_max_points); the rest follow their "
                f"reference keyframes' correction"
            )
        rank = torch.where(m.mp_valid, torch.sum(m.mp_obs_kf >= 0, dim=-1), -1)
        vals, pts = stable_topk(rank, pts_cap)
        pts = torch.where(vals >= 0, pts, -1).to(torch.int32)
        prob, _ = build_local_ba(m, win, fixed, pts, sys.inv_sigma2_tab,
                                 obs_cap=cfg.capacity.global_ba_obs)
        self._gba = dict(
            prob=prob, pts=pts, T=prob.T_cw, p=prob.p_w,
            lam=torch.full((), 1e-4, dtype=torch.float32, device=dev),
            done=0, iters=cfg.optim.global_ba_iters, chunk=5,
            valid0=m.kf_valid.clone(), fid0=m.kf_frame_id.clone(), kf_count0=sys.n_keyframes,
            # Point-sharded chunks when several ranks run the system.
            group=multihost.device_mesh("pts", length_divisor=prob.P),
        )

    def tick(self) -> None:
        """Advance the global BA in flight by one LM chunk (point-sharded
        over the ranks when there are several; the points come back
        whole), and merge it when its ``global_ba_iters`` are done."""
        g = self._gba
        if g is None:
            return
        if g["group"] is not None:
            g["T"], g["p"], g["lam"] = _sharded_lm_chunk(
                g["group"], self.system.cam, g["prob"], g["T"], g["p"], g["lam"], g["chunk"]
            )
        else:
            g["T"], g["p"], g["lam"] = _lm_chunk(
                self.system.cam, g["prob"], g["T"], g["p"], g["lam"], chunk=g["chunk"]
            )
        g["done"] += g["chunk"]
        if g["done"] >= g["iters"]:
            self._finish_gba()

    def _finish_gba(self) -> None:
        """Merge the finished global BA into the live map."""
        g = self._gba
        self._gba = None
        sys = self.system
        sys.map = _merge_gba(sys.map, g["T"], g["p"], g["pts"], g["valid0"], g["fid0"],
                             g["kf_count0"])
