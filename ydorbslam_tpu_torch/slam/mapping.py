"""Local mapping: point culling, local BA windowing, keyframe culling and
the per-keyframe pipeline ``mapping_step``, with its two halves for the
pipelined path: ``mapping_prep`` (per keyframe) and ``mapping_finish``
(local BA and keyframe culling, once per drain).

Port of ``ydorbslam_tpu/slam/mapping.py`` (the reference LocalMapping
thread, src/localMapping.cpp, run synchronously after each keyframe
insertion):

  * ``cull_map_points`` (localMapping.cpp:90-108): found-ratio < 0.25, or
    too few observations two keyframes after creation;
  * local BA (optimizer.cpp:138-352): covisibility window around the new
    keyframe, fixed observer cameras, the two-phase Schur LM of
    ``optim/schur.py`` (K4), outlier observation erasure;
  * ``cull_keyframes`` (localMapping.cpp:371-405): 90 % of close points
    seen >= 3 times elsewhere at the same or a finer scale.

Triangulation and fusion (K3) live in ``slam/triangulate.py``.  Every
``top_k`` of the JAX module ranks integer weights with many ties, so it
goes through ``ops.select.stable_topk`` (ties in ascending index order,
as ``jax.lax.top_k``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import trace
from ..geometry.camera import CameraIntrinsics
from ..geometry.se3 import inv_T
from ..ops.scatter import scatter_max, scatter_set
from ..ops.select import stable_topk
from ..optim.schur import BAProblem, bundle_adjust
from .map_state import (
    MapState, argmax_first, recount_obs, recount_obs_weighted, refresh_points,
)
from .triangulate import fuse_neighbors_batch, triangulate_neighbors_batch

# Default local BA capacity split: optimized window + fixed observers.
LBA_WIN = 64
LBA_FIX = 32
LBA_PTS = 4096
CULL_CAP = 1024  # culled points cleared per call; the rest wait a call
NCAND = 16  # keyframe-culling candidates per call


def _pad(x: torch.Tensor, n: int) -> torch.Tensor:
    if x.shape[0] >= n:
        return x
    return torch.cat([x, torch.full((n - x.shape[0],), -1, dtype=x.dtype, device=x.device)])


def cull_map_points(
    m: MapState, current_kf_count, found_ratio: float = 0.25, min_obs: int = 3,
) -> MapState:
    """Recent-map-point culling (localMapping.cpp:90-108): found/visible
    < ``found_ratio`` while recent, <= ``min_obs`` weighted observations
    at age 2, or no observation at all.  Bindings are cleared through the
    culled points' observation lists, at most ``CULL_CAP`` per call."""
    ratio = m.mp_found.to(torch.float32) / torch.clamp(m.mp_visible, min=1).to(torch.float32)
    n_obs = recount_obs_weighted(m)
    n_obs_raw = recount_obs(m)
    age = current_kf_count - m.mp_first_kf
    bad = m.mp_valid & (
        ((ratio < found_ratio) & (age <= 3))
        | ((age == 2) & (n_obs <= min_obs))
        | (n_obs_raw == 0)
    )
    bvals, bids = stable_topk(bad.to(torch.int32), min(CULL_CAP, m.M))
    bok = bvals > 0
    bidc = torch.clamp(bids, 0, m.M - 1)
    row_w = torch.where(bok, bidc, m.M)  # M -> dropped
    okf = m.mp_obs_kf[bidc]  # (CAP,O)
    okp = m.mp_obs_kp[bidc]
    kill = bok[:, None] & (okf >= 0)
    kfw = torch.where(kill, okf.to(torch.int64), m.K)
    kf_mp = scatter_set(
        m.kf_mp, (kfw.reshape(-1), torch.clamp(okp.to(torch.int64), 0, m.N - 1).reshape(-1)), -1
    )
    return m._replace(
        mp_valid=scatter_set(m.mp_valid, row_w, False),
        kf_mp=kf_mp,
        mp_obs_kf=scatter_set(m.mp_obs_kf, row_w, -1),
        mp_obs_kp=scatter_set(m.mp_obs_kp, row_w, -1),
    )


def select_local_window(
    m: MapState, kf_id, win_cap: int = LBA_WIN, fix_cap: int = LBA_FIX,
    pts_cap: int = LBA_PTS,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(window kfs (win_cap,), fixed kfs (fix_cap,), points
    (min(pts_cap, M),)), -1 padded: the keyframe and its covisible
    neighbours by weight (optimizer.cpp:142-173), the points they observe
    (lowest ids first), and the other keyframes observing those points,
    by covisibility."""
    dev = m.device
    w = m.covis[kf_id] * m.kf_valid.to(torch.int32)
    w = scatter_set(w, kf_id, 1 << 20)  # self first
    vals, win = stable_topk(w, min(win_cap, m.K))
    win = _pad(torch.where(vals > 0, win, -1), win_cap)

    winc = torch.clamp(win, 0, m.K - 1)
    win_mp = m.kf_mp[winc]  # (win_cap, N)
    win_sel = (win >= 0)[:, None] & (win_mp >= 0)
    in_win = scatter_set(
        torch.zeros((m.K + 1,), dtype=torch.bool, device=dev),
        torch.where(win >= 0, win, m.K), win >= 0,
    )[: m.K]
    member = scatter_max(
        torch.zeros((m.M,), dtype=torch.bool, device=dev),
        torch.clamp(win_mp.to(torch.int64), 0, m.M - 1), win_sel,
    )
    member = member & m.mp_valid
    order = torch.where(member, torch.arange(m.M, device=dev), m.M)
    pts = torch.sort(order).values[:pts_cap]
    pts = torch.where(pts < m.M, pts, -1)

    ptc = torch.clamp(pts, 0, m.M - 1)
    obs_k = m.mp_obs_kf[ptc]  # (pts_cap, O)
    obs_ok = (pts[:, None] >= 0) & (obs_k >= 0)
    observer = scatter_max(
        torch.zeros((m.K,), dtype=torch.bool, device=dev),
        torch.clamp(obs_k.to(torch.int64), 0, m.K - 1), obs_ok,
    )
    fixed_mask = observer & m.kf_valid & ~in_win
    fw = torch.where(fixed_mask, m.covis[kf_id] + 1, -1)
    fvals, fixed = stable_topk(fw, min(fix_cap, m.K))
    fixed = _pad(torch.where(fvals > 0, fixed, -1), fix_cap)
    return win, fixed, pts


def build_local_ba(
    m: MapState, win: torch.Tensor, fixed: torch.Tensor, pts: torch.Tensor,
    inv_sigma2_tab: torch.Tensor, obs_cap: int = 0,
) -> Tuple[BAProblem, torch.Tensor]:
    """Gather the capacity-bounded BAProblem of the local window.
    ``obs_cap`` > 0 keeps each point's first ``obs_cap`` in-window
    observations (stable order).  Returns (problem, obs_sel (P, obs_cap)
    the original O-slot of each kept observation)."""
    dev = m.device
    C = win.shape[0] + fixed.shape[0]
    cams = torch.cat([win, fixed])
    cam_ok = cams >= 0
    camc = torch.clamp(cams, 0, m.K - 1)
    T = m.kf_pose[camc]
    cam_fixed = torch.arange(C, device=dev) >= win.shape[0]
    # KF id 0 (the map origin) is always fixed (optimizer.cpp:27,176).
    # (The origin's index as a (1,) tensor: indexing with a 0-dim one reads it on the host.)
    origin = argmax_first(m.kf_valid).reshape(1)
    cam_fixed = cam_fixed | (m.kf_frame_id[camc] == m.kf_frame_id[origin])
    # LUT keyframe id -> local cam index.  Padded cameras write -1 to
    # slot 0 after any real camera there; the last update wins, as in
    # the JAX package (a behaviour of the reference, ROADMAP Queue 3).
    lut = scatter_set(
        torch.full((m.K,), -1, dtype=torch.int32, device=dev),
        torch.where(cam_ok, camc, 0),
        torch.where(cam_ok, torch.arange(C, dtype=torch.int32, device=dev), -1),
    )

    ptc = torch.clamp(pts, 0, m.M - 1)
    pt_ok = (pts >= 0) & m.mp_valid[ptc]
    obs_kf = m.mp_obs_kf[ptc]  # (P,O)
    obs_kp = m.mp_obs_kp[ptc]
    obs_cam = torch.where(obs_kf >= 0, lut[torch.clamp(obs_kf.to(torch.int64), 0, m.K - 1)], -1)
    obs_sel = torch.arange(obs_cam.shape[1], device=dev)[None, :].expand(obs_cam.shape)
    if obs_cap and obs_cap < obs_cam.shape[1]:
        order = torch.argsort(-(obs_cam >= 0).to(torch.int32), dim=1, stable=True)[:, :obs_cap]
        obs_kf = torch.gather(obs_kf, 1, order)
        obs_kp = torch.gather(obs_kp, 1, order)
        obs_cam = torch.gather(obs_cam, 1, order)
        obs_sel = order
    kfc = torch.clamp(obs_kf.to(torch.int64), 0, m.K - 1)
    kpc = torch.clamp(obs_kp.to(torch.int64), 0, m.N - 1)
    uv = m.kf_uv[kfc, kpc]
    ur = m.kf_right_u[kfc, kpc]
    octv = m.kf_octave[kfc, kpc]
    obs_valid = pt_ok[:, None] & (obs_cam >= 0) & m.kf_kp_valid[kfc, kpc]
    return BAProblem(
        T_cw=T,
        cam_fixed=cam_fixed,
        cam_valid=cam_ok,
        p_w=m.mp_pos[ptc],
        pt_valid=pt_ok,
        obs_cam=obs_cam,
        obs_uvr=torch.cat([uv, ur[..., None]], dim=-1),
        obs_inv_sigma2=inv_sigma2_tab[octv.to(torch.int64)],
        obs_stereo=ur >= 0,
        obs_valid=obs_valid,
    ), obs_sel.to(torch.int64)


def apply_local_ba(
    m: MapState, win, pts, T_new, p_new, outlier, obs_sel,
) -> MapState:
    """Write back the optimised poses and points and erase the outlier
    observations (optimizer.cpp:336-352).  ``outlier`` is indexed by the
    compacted observation slots; ``obs_sel`` maps them back.  Padded
    window and point rows write slot 0 back with its own value after any
    real update there (last update wins, as in the JAX package)."""
    win_ok = win >= 0
    winc = torch.where(win_ok, win, 0)
    kf_pose = scatter_set(
        m.kf_pose, winc, torch.where(win_ok[:, None, None], T_new[: win.shape[0]], m.kf_pose[winc])
    )
    pt_ok = pts >= 0
    ptc = torch.where(pt_ok, pts, 0)
    mp_pos = scatter_set(m.mp_pos, ptc, torch.where(pt_ok[:, None], p_new, m.mp_pos[ptc]))
    m = m._replace(kf_pose=kf_pose, mp_pos=mp_pos)

    rows = m.mp_obs_kf[ptc]
    obs_kf = torch.gather(rows, 1, obs_sel)
    obs_kp = torch.gather(m.mp_obs_kp[ptc], 1, obs_sel)
    kill = outlier & pt_ok[:, None] & (obs_kf >= 0)
    pt_w = torch.where(kill, ptc[:, None], m.M)  # dropped when not killed
    kf_w = torch.where(kill, obs_kf.to(torch.int64), 0).reshape(-1)
    kp_w = torch.where(kill, obs_kp.to(torch.int64), 0).reshape(-1)
    kf_mp = scatter_set(
        m.kf_mp, (kf_w, kp_w), torch.where(kill.reshape(-1), -1, m.kf_mp[kf_w, kp_w])
    )
    return m._replace(
        mp_obs_kf=scatter_set(m.mp_obs_kf, (pt_w, obs_sel), -1),
        mp_obs_kp=scatter_set(m.mp_obs_kp, (pt_w, obs_sel), -1),
        kf_mp=kf_mp,
    )


def cull_keyframes(
    m: MapState, kf_id, depth_threshold: torch.Tensor, redundancy: float = 0.9,
) -> MapState:
    """Redundant-keyframe culling (localMapping.cpp:371-405) over the
    ``NCAND`` strongest covisible neighbours of ``kf_id``; children of a
    culled keyframe re-parent to their strongest older live keyframe, or
    to the culled node's parent (keyFrame.cpp:256-327).  The first
    keyframe and tree roots are never culled."""
    dev = m.device
    w = m.covis[kf_id] * m.kf_valid.to(torch.int32)
    first_kf = argmax_first(m.kf_valid)
    w = scatter_set(scatter_set(w, first_kf, 0), kf_id, 0)
    wvals, cand_ids = stable_topk(w, min(NCAND, m.K))
    cand_ok = wvals > 0
    candc = torch.clamp(cand_ids, 0, m.K - 1)

    ids = torch.clamp(m.kf_mp[candc].to(torch.int64), 0, m.M - 1)  # (NC,N)
    pt_live = (m.kf_mp[candc] >= 0) & m.mp_valid[ids] & m.kf_kp_valid[candc]
    close = pt_live & (m.kf_depth[candc] > 0) & (m.kf_depth[candc] <= depth_threshold)
    oct_here = m.kf_octave[candc]
    obs_live_all = m.mp_obs_kf >= 0
    hist = torch.zeros((m.M, 9), dtype=torch.int32, device=dev)
    hist.scatter_add_(
        1, torch.clamp(m.mp_obs_oct.to(torch.int64), 0, 8), obs_live_all.to(torch.int32)
    )
    cnt_le = torch.cumsum(hist, dim=-1)  # (M,9)
    t = torch.clamp(oct_here.to(torch.int64) + 1, 0, 8)
    n_finer = torch.gather(cnt_le[ids], 2, t[..., None])[..., 0] - 1
    redundant_pt = close & (n_finer >= 3)
    n_close = torch.sum(close, dim=-1)
    n_red = torch.sum(redundant_pt, dim=-1)
    cull_cand = cand_ok & (n_close > 10) & (
        n_red.to(torch.float32) > redundancy * n_close.to(torch.float32)
    )
    cull_cand = cull_cand & (m.parent[candc] >= 0)
    cull = scatter_max(torch.zeros((m.K,), dtype=torch.bool, device=dev), candc, cull_cand)

    kf_valid = m.kf_valid & ~cull
    par = torch.clamp(m.parent.to(torch.int64), 0, m.K - 1)
    T_c2p = m.kf_pose @ inv_T(m.kf_pose[par])
    kf_T_c2p = torch.where(cull[:, None, None], T_c2p, m.kf_T_c2p)
    # Erase the observations made by culled keyframes through their own
    # bindings; a point bound by two culled candidates resolves
    # last-writer-wins, as in the JAX package.
    obs_rows = m.mp_obs_kf[ids.reshape(-1)]  # (NC*N, O)
    owner = candc.repeat_interleave(m.N)
    live_row = (pt_live & cull_cand[:, None]).reshape(-1)
    hit = (obs_rows == owner[:, None]) & live_row[:, None]
    row_w = torch.where(live_row, ids.reshape(-1), m.M)
    mp_obs_kf = scatter_set(m.mp_obs_kf, row_w, torch.where(hit, -1, obs_rows))
    mp_obs_kp = scatter_set(
        m.mp_obs_kp, row_w, torch.where(hit, -1, m.mp_obs_kp[ids.reshape(-1)])
    )
    kf_mp = torch.where(cull[:, None], -1, m.kf_mp)
    parent_culled = cull[par] & (m.parent >= 0)
    older = kf_valid[None, :] & (m.kf_frame_id[None, :] < m.kf_frame_id[:, None])
    w_child = torch.where(older, m.covis, -1)
    best_w = torch.amax(w_child, dim=1)
    best_cand = torch.argmax(w_child, dim=1).to(m.parent.dtype)
    grand = m.parent[par]
    new_parent = torch.where(
        parent_culled & kf_valid, torch.where(best_w > 0, best_cand, grand), m.parent
    )
    covis = torch.where(cull[:, None] | cull[None, :], 0, m.covis)
    return m._replace(
        kf_valid=kf_valid, kf_mp=kf_mp, mp_obs_kf=mp_obs_kf, mp_obs_kp=mp_obs_kp,
        parent=new_parent, covis=covis, kf_T_c2p=kf_T_c2p,
    )


# ----------------------------------------------------------------------
# The per-keyframe mapping program
# ----------------------------------------------------------------------

# Packed snapshot: one float32 vector that carries everything the host's
# bookkeeping reads after a keyframe, so it is read with one copy.
SNAP_CULL_CAP = 16  # >= keyframe-culling NCAND


def snapshot_layout(K: int):
    """(offsets dict, total length) of the packed mapping snapshot."""
    off, o = {}, 0
    for name, ln in (
        ("kf_valid", K),
        ("valid_before", K),
        ("parent", K),
        ("kf_frame_id", K),
        ("ref_pose", 16),
        ("culled_ids", SNAP_CULL_CAP),
        ("culled_c2p", SNAP_CULL_CAP * 16),
        ("culled_parent", SNAP_CULL_CAP),
    ):
        off[name] = (o, o + ln)
        o += ln
    return off, o


def mapping_prep(
    m: MapState, kf_id: int, kf_count: int, cam: CameraIntrinsics,
    scale_factor: float = 1.2, n_levels: int = 8, n_neighbors: int = 10,
    cull_found_ratio: float = 0.25, cull_min_obs: int = 3, tri_ratio: float = 0.6,
) -> MapState:
    """The per-keyframe half of the mapping pipeline: cull recent points,
    pick the covisible neighbours on the device, triangulate against the
    first-order neighbours (K3), refresh, fuse with the first- and
    second-order neighbourhood (K3), refresh (localMapping.cpp:63-294
    without the BA/cull tail).  As in the JAX package, the covisibility is
    not refreshed after fusion.  The pipelined path runs it for every
    keyframe of a drain."""
    with trace.span("mapping.prep"):
        dev = m.device
        with trace.span("mapping.cull_points"):
            m = cull_map_points(m, kf_count, found_ratio=cull_found_ratio, min_obs=cull_min_obs)
        with trace.span("mapping.triangulate"):
            w = m.covis[kf_id] * m.kf_valid.to(torch.int32)
            nvals, nids = stable_topk(w, min(n_neighbors, m.K))
            nok = nvals > 0
            m = triangulate_neighbors_batch(
                m, kf_id, nids, nok, kf_count, cam, scale_factor, n_levels, ratio=tri_ratio,
            )
        m = _refresh_own_points(m, kf_id, scale_factor, n_levels)
        with trace.span("mapping.fuse"):
            K = m.K
            first_mask = scatter_set(
                torch.zeros((K,), dtype=torch.bool, device=dev), torch.where(nok, nids, K), True
            )
            w2 = torch.amax(
                torch.where(nok[:, None], m.covis[torch.clamp(nids, 0, K - 1)], 0), dim=0
            )
            w2 = torch.where(
                first_mask | (torch.arange(K, device=dev) == kf_id) | ~m.kf_valid, 0, w2
            )
            n2vals, n2ids = stable_topk(w2, min(n_neighbors, K))
            fuse_ids = torch.cat([nids, n2ids])
            fuse_ok = torch.cat([nok, n2vals > 0])
            m = fuse_neighbors_batch(m, kf_id, fuse_ids, fuse_ok, cam, scale_factor, n_levels)
        return _refresh_own_points(m, kf_id, scale_factor, n_levels)


def _refresh_own_points(m: MapState, kf_id: int, scale_factor: float, n_levels: int):
    """``refresh_points`` on the points the keyframe ``kf_id`` observes."""
    with trace.span("mapping.refresh"):
        return refresh_points(
            m, torch.where(m.kf_mp[kf_id] >= 0, m.kf_mp[kf_id], -1), scale_factor, n_levels
        )


def mapping_finish(
    m: MapState, kf_id: int, cam: CameraIntrinsics, inv_sigma2_tab: torch.Tensor,
    depth_threshold: torch.Tensor, iters1: int = 5, iters2: int = 10, win_cap: int = LBA_WIN,
    fix_cap: int = LBA_FIX, pts_cap: int = LBA_PTS, obs_cap: int = 0,
    kf_cull_redundancy: float = 0.9,
):
    """The per-drain half: local BA (K4), redundant-keyframe culling and
    the packed snapshot (localMapping.cpp:29,371-405;
    optimizer.cpp:138-352).  The pipelined path runs it once per drain on
    its newest keyframe: a queued keyframe stops the reference's running
    local BA (``interruptBA``, localMapping.cpp:54-58), so only the last
    keyframe of a burst gets one.  Returns (map, snapshot)."""
    with trace.span("mapping.ba"):
        with trace.span("mapping.ba_build"):
            win, fixed, pts = select_local_window(m, kf_id, win_cap, fix_cap, pts_cap)
            prob, obs_sel = build_local_ba(m, win, fixed, pts, inv_sigma2_tab, obs_cap=obs_cap)
        with trace.span("mapping.ba_solve"):
            T_new, p_new, outlier = bundle_adjust(cam, prob, iters1=iters1, iters2=iters2)
        with trace.span("mapping.ba_apply"):
            m = apply_local_ba(m, win, pts, T_new[:win_cap], p_new, outlier, obs_sel)
    with trace.span("mapping.cull_kf"):
        valid_before = m.kf_valid
        m = cull_keyframes(m, kf_id, depth_threshold, redundancy=kf_cull_redundancy)
        return m, _pack_snapshot(m, kf_id, valid_before)


def _pack_snapshot(m: MapState, kf_id: int, valid_before: torch.Tensor) -> torch.Tensor:
    """The packed snapshot (``snapshot_layout``) after keyframe culling."""
    culled = valid_before & ~m.kf_valid
    kcap = min(SNAP_CULL_CAP, m.K)
    cvals, cids = stable_topk(culled.to(torch.int32), kcap)
    cids = _pad(torch.where(cvals > 0, cids, -1), SNAP_CULL_CAP)
    cidc = torch.clamp(cids, 0, m.K - 1)
    f = torch.float32
    return torch.cat([
        m.kf_valid.to(f),
        valid_before.to(f),
        m.parent.to(f),
        m.kf_frame_id.to(f),
        m.kf_pose[kf_id].reshape(16),
        cids.to(f),
        m.kf_T_c2p[cidc].reshape(-1),
        m.parent[cidc].to(f),
    ])


def mapping_step(
    m: MapState,
    kf_id: int,
    kf_count: int,
    cam: CameraIntrinsics,
    inv_sigma2_tab: torch.Tensor,
    depth_threshold: torch.Tensor,
    scale_factor: float = 1.2,
    n_levels: int = 8,
    iters1: int = 5,
    iters2: int = 10,
    win_cap: int = LBA_WIN,
    fix_cap: int = LBA_FIX,
    pts_cap: int = LBA_PTS,
    obs_cap: int = 0,
    n_neighbors: int = 10,
    cull_found_ratio: float = 0.25,
    cull_min_obs: int = 3,
    tri_ratio: float = 0.6,
    kf_cull_redundancy: float = 0.9,
):
    """The whole per-keyframe LocalMapping pipeline (localMapping.cpp:8-53):
    ``mapping_prep`` (cull, triangulate, fuse, refresh) then
    ``mapping_finish`` (local BA, keyframe culling, packed snapshot).  It reads nothing back
    to the host.  Returns (map, snapshot (snapshot_layout length,) f32)."""
    m = mapping_prep(
        m, kf_id, kf_count, cam, scale_factor, n_levels, n_neighbors,
        cull_found_ratio, cull_min_obs, tri_ratio,
    )
    return mapping_finish(
        m, kf_id, cam, inv_sigma2_tab, depth_threshold, iters1, iters2,
        win_cap, fix_cap, pts_cap, obs_cap, kf_cull_redundancy,
    )
