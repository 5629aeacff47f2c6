"""New-point triangulation and neighbour fusion for local mapping.

Port of the keyframe pipeline's part of ``ydorbslam_tpu/slam/
triangulate.py``: ``triangulate_neighbors_batch``
(LocalMapping::createNewMapPoints, localMapping.cpp:109-252) and
``fuse_neighbors_batch`` (searchInNeighbors + fuseByProjection,
localMapping.cpp:253-294, orbMatcher.cpp:682-745).

The JAX package vmaps each per-pair step over the neighbours; here the
pair axis B is a batch dimension written out.  Every search is ONE K3
launch (``ops.hamming.pair_best2``): the per-pair gates travel as
(B, N, 8) attribute packs and the kernel (or its plain version) returns
per-row (idx, best, second).  The JAX package takes this route on the
TPU; its CPU route builds the dense masked matrices, and both give the
same map.

Fusion merges duplicates: when a projected point lands on a keypoint
already bound to another point, the one with fewer observations dies
into the other through ``map_state.replace_points``.  The merge set is
compacted to ``FUSE_MERGE_BUDGET`` rows in stable-argsort order, as in
the JAX package; merges past the budget wait for the next keyframe.
"""
from __future__ import annotations

import torch

from ..geometry.camera import CameraIntrinsics
from ..geometry.se3 import inv_T
from ..ops.hamming import INVALID_DIST, pair_best2
from ..ops.scatter import scatter_min, scatter_set
from .map_state import (
    MapState, add_observations, add_observations_multi, alloc_slots, f32,
    obs_has_free, replace_points,
)
from .matchers import predict_scale_level, project_sources

FUSE_MERGE_BUDGET = 512
CHI2_MONO = 5.991
_BIG_KEY = INVALID_DIST * 16384


def _level_scales(scale_factor: float, n_levels: int, device) -> torch.Tensor:
    """scale_factor ** arange(n_levels) in float32, as the JAX package
    takes it (``sf ** jnp.arange(n, dtype=float32)``)."""
    return torch.pow(
        f32(scale_factor, device),
        torch.arange(n_levels, dtype=torch.float32, device=device),
    )


def _intrinsic_matrix(cam: CameraIntrinsics) -> torch.Tensor:
    z = torch.zeros_like(cam.fx)
    o = torch.ones_like(cam.fx)
    return torch.stack([
        torch.stack([cam.fx, z, cam.cx]),
        torch.stack([z, cam.fy, cam.cy]),
        torch.stack([z, z, o]),
    ])


def _camera_center(T_cw: torch.Tensor) -> torch.Tensor:
    """Camera centre(s) -R^T t of (..., 4, 4) poses."""
    R, t = T_cw[..., :3, :3], T_cw[..., :3, 3]
    return -(R.transpose(-1, -2) @ t[..., None])[..., 0]


def _fundamental_matrix(cam: CameraIntrinsics, T1_cw, T2_cw) -> torch.Tensor:
    """F21 with x2^T F21 x1 = 0 (pixels) from the relative pose 1 -> 2,
    batched over (..., 4, 4) poses (localMapping.cpp:295-306)."""
    T21 = T2_cw @ inv_T(T1_cw)
    R, t = T21[..., :3, :3], T21[..., :3, 3]
    z = torch.zeros_like(t[..., 0])
    tx = torch.stack([
        torch.stack([z, -t[..., 2], t[..., 1]], -1),
        torch.stack([t[..., 2], z, -t[..., 0]], -1),
        torch.stack([-t[..., 1], t[..., 0], z], -1),
    ], -2)
    Kinv = torch.linalg.inv_ex(_intrinsic_matrix(cam))[0]
    return Kinv.T @ tx @ R @ Kinv


def _triangulate_pairs(cam, T1, T2, uv1, uv2):
    """Linear two-view triangulation in closed form: the inhomogeneous
    least squares A[:, :3] X = -A[:, 3] of the DLT rows through 3x3
    normal equations (the JAX package's form).  T1 (4,4), T2 (B,4,4),
    uv1 (N,2), uv2 (B,N,2) -> (B,N,3)."""
    from ..optim.schur import inv3x3

    B, N = uv2.shape[0], uv2.shape[1]
    K = _intrinsic_matrix(cam)
    P1 = K @ T1[:3, :4]  # (3,4)
    P2 = (K @ T2[:, :3, :4])[:, None]  # (B,1,3,4)
    u1 = uv1[:, :, None]  # (N,2,1)
    u2 = uv2[..., None]  # (B,N,2,1)
    A = torch.stack([
        (u1[:, 0] * P1[2] - P1[0]).expand(B, N, 4),
        (u1[:, 1] * P1[2] - P1[1]).expand(B, N, 4),
        u2[:, :, 0] * P2[..., 2, :] - P2[..., 0, :],
        u2[:, :, 1] * P2[..., 2, :] - P2[..., 1, :],
    ], -2)  # (B,N,4,4)
    A3 = A[..., :3]
    b = -A[..., 3]
    G = A3.transpose(-1, -2) @ A3
    rhs = A3.transpose(-1, -2) @ b[..., None]
    eye = torch.eye(3, device=uv1.device)
    return (inv3x3(G + 1e-9 * eye) @ rhs)[..., 0]


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, ...) gathered along N by idx (B, N)."""
    idx = idx.to(torch.int64)
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


# ----------------------------------------------------------------------
# Triangulation
# ----------------------------------------------------------------------

def _tri_pair_setup(m: MapState, kf1, kf2, cam, n_levels: int, scale_factor: float):
    """Per-pair epipolar-gate inputs for B pairs (kf1, kf2[b]): the
    epipolar lines of kf1's keypoints in each kf2 image, the squared
    threshold row scale and the free-keypoint masks
    (localMapping.cpp:128)."""
    sf = _level_scales(scale_factor, n_levels, m.device)
    T1, T2 = m.kf_pose[kf1], m.kf_pose[kf2]
    free1 = m.kf_kp_valid[kf1] & (m.kf_mp[kf1] < 0)
    free2 = m.kf_kp_valid[kf2] & (m.kf_mp[kf2] < 0)
    uv1 = m.kf_uv[kf1]
    F21 = _fundamental_matrix(cam, T1, T2)  # (B,3,3)
    x1h = torch.cat([uv1, torch.ones((m.N, 1), device=m.device)], -1)
    lines = x1h @ F21.transpose(-1, -2)  # (B,N,3)
    den2 = lines[..., 0] ** 2 + lines[..., 1] ** 2
    thr = 3.84 * torch.clamp(den2, min=1e-18)
    return dict(
        sigma2=sf * sf, free1=free1, free2=free2, uv2=m.kf_uv[kf2], lines=lines,
        thr=thr,
    )


def _tri_attrs(m: MapState, kf1, kf2, active, cam, n_levels: int, scale_factor: float):
    """The epipolar gates as K3 "epi" attribute packs, (B, N, 8) each."""
    s = _tri_pair_setup(m, kf1, kf2, cam, n_levels, scale_factor)
    B = kf2.shape[0]
    z = torch.zeros((B, m.N), device=m.device)
    lines = s["lines"]
    a_attr = torch.stack([
        lines[..., 0], lines[..., 1], lines[..., 2], s["thr"],
        m.kf_octave[kf1].to(torch.float32).expand(B, m.N),
        (s["free1"][None] & active[:, None]).to(torch.float32), z, z,
    ], -1)
    oct2 = m.kf_octave[kf2]
    b_attr = torch.stack([
        s["uv2"][..., 0], s["uv2"][..., 1], s["sigma2"][oct2.to(torch.int64)],
        oct2.to(torch.float32), s["free2"].to(torch.float32), z, z, z,
    ], -1)
    return a_attr, b_attr


def _tri_select(b1, b2, idx, ratio: float, N: int):
    """TH_LOW + best/second ratio + the kf2-side collision resolve, per
    pair: if two kf1 keypoints claim one kf2 keypoint only the closer
    pair stays (ties to the lower kf1 row)."""
    B = idx.shape[0]
    dev = idx.device
    b2c = torch.clamp(b2, max=256)
    matched = (
        (idx >= 0) & (b1 <= 50)
        & (b1.to(torch.float32) < ratio * b2c.to(torch.float32))
    )
    rows = torch.arange(N, device=dev)
    key = torch.where(matched, b1.to(torch.int64) * N + rows, _BIG_KEY)
    col = torch.where(matched, idx.to(torch.int64), N)
    colmin = scatter_min(
        torch.full((B, N), _BIG_KEY, dtype=torch.int64, device=dev),
        (torch.arange(B, device=dev)[:, None], col), key,
    )
    idxc = torch.clamp(idx.to(torch.int64), 0, N - 1)
    matched = matched & (torch.gather(colmin, 1, idxc) == key)
    return matched, idxc


def _tri_geom(m: MapState, kf1, kf2, active, matched, best2, cam,
              scale_factor: float, n_levels: int):
    """Triangulation and the acceptance checks for the selected pairs:
    parallax decision with stereo fallbacks, two-view chi2 and scale
    gates (localMapping.cpp:176-244).  Returns (good (B,N), best2 (B,N),
    X (B,N,3))."""
    dev = m.device
    sf = _level_scales(scale_factor, n_levels, dev)
    sigma2 = sf * sf
    T1, T2 = m.kf_pose[kf1], m.kf_pose[kf2]
    c1, c2 = _camera_center(T1), _camera_center(T2)
    baseline = torch.linalg.norm(c1 - c2, dim=-1)  # (B,)
    uv1 = m.kf_uv[kf1]
    uv2m = _gather_rows(m.kf_uv[kf2], best2)  # (B,N,2)
    X_tri = _triangulate_pairs(cam, T1, T2, uv1, uv2m)

    R1w, t1 = T1[:3, :3], T1[:3, 3]
    R2w, t2 = T2[:, :3, :3], T2[:, :3, 3]
    one1 = torch.ones((m.N,), device=dev)
    ray1 = torch.stack(
        [(uv1[:, 0] - cam.cx) / cam.fx, (uv1[:, 1] - cam.cy) / cam.fy, one1], -1
    ) @ R1w
    ray2 = torch.stack(
        [(uv2m[..., 0] - cam.cx) / cam.fx, (uv2m[..., 1] - cam.cy) / cam.fy,
         torch.ones_like(uv2m[..., 0])], -1
    ) @ R2w
    # The JAX package divides by ``jnp.linalg.norm(ray, -1)``, whose -1 is
    # ``ord``: the matrix norm of ord -1 over all N rays of the pair (the
    # least column sum of |ray|), not each ray's length.  The quotient is
    # then far below 1, so the parallax test passes whenever the rays
    # point the same way.  The port keeps that behaviour of the
    # reference (ROADMAP Queue 3).
    n1 = torch.abs(ray1).sum(dim=-2).amin(dim=-1)  # ()
    n2 = torch.abs(ray2).sum(dim=-2).amin(dim=-1)  # (B,)
    cos_rays = torch.sum(ray1 * ray2, -1) / torch.clamp(n1 * n2, min=1e-9)[:, None]
    d1s = m.kf_depth[kf1]
    d2s = _gather_rows(m.kf_depth[kf2], best2)
    b_half = 0.5 * cam.bf / cam.fx
    cos_st1 = torch.cos(2.0 * torch.atan2(b_half, torch.clamp(d1s, min=1e-3)))
    cos_st2 = torch.cos(2.0 * torch.atan2(b_half, torch.clamp(d2s, min=1e-3)))
    cos_st1 = torch.where(d1s > 0, cos_st1, 2.0)
    cos_st2 = torch.where(d2s > 0, cos_st2, 2.0)
    cos_stereo = torch.minimum(cos_st1, cos_st2)
    good_parallax = (cos_rays > 0) & (cos_rays < 0.9998) & (cos_rays < cos_stereo)
    X_st1 = (
        torch.stack([(uv1[:, 0] - cam.cx) / cam.fx * d1s,
                     (uv1[:, 1] - cam.cy) / cam.fy * d1s, d1s], -1)
        - t1
    ) @ R1w
    X_st2 = (
        torch.stack([(uv2m[..., 0] - cam.cx) / cam.fx * d2s,
                     (uv2m[..., 1] - cam.cy) / cam.fy * d2s, d2s], -1)
        - t2[:, None]
    ) @ R2w
    use_st1 = ~good_parallax & (d1s > 0)
    use_st2 = ~good_parallax & ~use_st1 & (d2s > 0)
    X = torch.where(
        good_parallax[..., None], X_tri,
        torch.where(use_st1[..., None], X_st1.expand_as(X_tri), X_st2),
    )
    has_source = good_parallax | use_st1 | use_st2

    pc1 = X @ T1[:3, :3].T + T1[:3, 3]
    pc2 = X @ T2[:, :3, :3].transpose(-1, -2) + T2[:, None, :3, 3]
    z1, z2 = pc1[..., 2], pc2[..., 2]
    z1s, z2s = torch.clamp(z1, min=1e-6), torch.clamp(z2, min=1e-6)
    u1p = cam.fx * pc1[..., 0] / z1s + cam.cx
    v1p = cam.fy * pc1[..., 1] / z1s + cam.cy
    u2p = cam.fx * pc2[..., 0] / z2s + cam.cx
    v2p = cam.fy * pc2[..., 1] / z2s + cam.cy
    e1 = (u1p - uv1[:, 0]) ** 2 + (v1p - uv1[:, 1]) ** 2
    e2 = (u2p - uv2m[..., 0]) ** 2 + (v2p - uv2m[..., 1]) ** 2
    ok = (z1 > 0) & (z2 > 0)
    r1 = m.kf_right_u[kf1]
    r2 = _gather_rows(m.kf_right_u[kf2], best2)
    e1r = e1 + (u1p - cam.bf / z1s - r1) ** 2
    e2r = e2 + (u2p - cam.bf / z2s - r2) ** 2
    oct1 = m.kf_octave[kf1].to(torch.int64)
    oct2 = _gather_rows(m.kf_octave[kf2], best2).to(torch.int64)
    s2_1, s2_2 = sigma2[oct1], sigma2[oct2]
    ok = ok & torch.where(r1 >= 0, e1r <= 7.8 * s2_1, e1 <= CHI2_MONO * s2_1)
    ok = ok & torch.where(r2 >= 0, e2r <= 7.8 * s2_2, e2 <= CHI2_MONO * s2_2)
    d1 = torch.linalg.norm(X - c1, dim=-1)
    d2 = torch.linalg.norm(X - c2[:, None], dim=-1)
    ratio_d = d2 / torch.clamp(d1, min=1e-6)
    ratio_o = sf[oct1] / sf[oct2]
    factor = 1.5 * scale_factor
    ok = ok & (d1 > 1e-6) & (d2 > 1e-6)
    ok = ok & (ratio_d * factor >= ratio_o) & (ratio_d <= ratio_o * factor)

    good = (
        matched & has_source & ok
        & (baseline > cam.bf / cam.fx)[:, None] & active[:, None]
    )
    return good, best2, X


def triangulate_neighbors_batch(
    m: MapState,
    kf1: int,
    nids: torch.Tensor,  # (B,) neighbour keyframe ids (-1 padded)
    nok: torch.Tensor,  # (B,) bool
    kf_count,
    cam: CameraIntrinsics,
    scale_factor: float,
    n_levels: int,
    ratio: float = 0.6,
) -> MapState:
    """Triangulate kf1 against all covisible neighbours in one batch: one
    K3 "epi" launch for the B searches, then each kf1 keypoint takes its
    first (covisibility-ordered) accepting neighbour and the new points
    get both observations written into their empty rows."""
    dev = m.device
    B = nids.shape[0]
    kf2c = torch.clamp(nids.to(torch.int64), 0, m.K - 1)
    a_attr, b_attr = _tri_attrs(m, kf1, kf2c, nok, cam, n_levels, scale_factor)
    desc_a = m.kf_desc[kf1].expand(B, m.N, 8).contiguous()
    idx, b1, b2 = pair_best2(desc_a, a_attr, m.kf_desc[kf2c], b_attr, mode="epi")
    matched, best2 = _tri_select(b1, b2, idx, ratio, m.N)
    good, best2, X = _tri_geom(
        m, kf1, kf2c, nok, matched, best2, cam, scale_factor, n_levels
    )

    cols = torch.arange(m.N, device=dev)
    pick = torch.argmax(good.to(torch.uint8), dim=0)  # first accepting neighbour
    any_good = torch.any(good, dim=0)
    sel_kf2 = kf2c[pick]
    sel_best2 = best2[pick, cols]
    sel_X = X[pick, cols]

    ranks = torch.where(any_good, torch.cumsum(any_good.to(torch.int64), 0) - 1, -1)
    slots = alloc_slots(m.mp_valid, ranks)
    created = slots >= 0
    slot_w = torch.where(created, slots.to(torch.int64), m.M)  # M -> dropped
    oct1 = m.kf_octave[kf1]
    oct2 = m.kf_octave[sel_kf2, sel_best2]
    i32 = torch.int32

    def two_cols(fill, c0, c1, dtype):
        rows = torch.full((m.N, m.O), fill, dtype=dtype, device=dev)
        rows[:, 0] = c0
        rows[:, 1] = c1
        return rows

    obs_kf_rows = two_cols(-1, kf1, sel_kf2.to(i32), i32)
    obs_kp_rows = two_cols(-1, cols.to(i32), sel_best2.to(i32), i32)
    obs_oct_rows = two_cols(0, oct1, oct2, i32)
    obs_st_rows = two_cols(
        False, m.kf_right_u[kf1] >= 0, m.kf_right_u[sel_kf2, sel_best2] >= 0, torch.bool
    )
    kf_mp = m.kf_mp.clone()
    kf_mp[kf1] = torch.where(created, slots, m.kf_mp[kf1])
    kf_mp = scatter_set(kf_mp, (torch.where(created, sel_kf2, m.K), sel_best2), slots)
    return m._replace(
        mp_pos=scatter_set(m.mp_pos, slot_w, sel_X),
        mp_valid=scatter_set(m.mp_valid, slot_w, True),
        mp_first_kf=scatter_set(m.mp_first_kf, slot_w, int(kf_count)),
        mp_found=scatter_set(m.mp_found, slot_w, 1),
        mp_visible=scatter_set(m.mp_visible, slot_w, 1),
        mp_obs_kf=scatter_set(m.mp_obs_kf, slot_w, obs_kf_rows),
        mp_obs_kp=scatter_set(m.mp_obs_kp, slot_w, obs_kp_rows),
        mp_obs_oct=scatter_set(m.mp_obs_oct, slot_w, obs_oct_rows),
        mp_obs_stereo=scatter_set(m.mp_obs_stereo, slot_w, obs_st_rows),
        kf_mp=kf_mp,
    )


# ----------------------------------------------------------------------
# Fusion
# ----------------------------------------------------------------------

def _fuse_pair_setup(m: MapState, src_kf, dst_kf, cam, scale_factor: float, n_levels: int):
    """Fuse-by-projection gate inputs for B pairs (src_kf[b], dst_kf[b]):
    src's bound points projected into dst, the scale-predicted radius and
    octave range, and the composite source validity (frustum, distance
    band, view angle, not already observed by dst)."""
    sf = _level_scales(scale_factor, n_levels, m.device)
    ids = m.kf_mp[src_kf]  # (B,N)
    idc = torch.clamp(ids.to(torch.int64), 0, m.M - 1)
    pt_ok = (ids >= 0) & m.mp_valid[idc]
    pos = m.mp_pos[idc]  # (B,N,3)
    T = m.kf_pose[dst_kf]  # (B,4,4)
    proj = project_sources(cam, T, pos, pt_ok, border=5.0)
    po = pos - _camera_center(T)[:, None]
    dist = torch.linalg.norm(po, dim=-1)
    band_ok = (dist >= 0.8 * m.mp_min_dist[idc]) & (dist <= 1.2 * m.mp_max_dist[idc])
    normal = m.mp_normal[idc]
    view_cos = torch.sum(po * normal, dim=-1) / torch.clamp(
        dist * torch.linalg.norm(normal, dim=-1), min=1e-6
    )
    pred = predict_scale_level(dist, 1.2 * m.mp_max_dist[idc], n_levels, scale_factor)
    radius = 3.0 * sf[pred.to(torch.int64)]
    already = torch.any(m.mp_obs_kf[idc] == dst_kf[:, None, None], dim=-1)
    valid_src = pt_ok & proj.valid & band_ok & (view_cos >= 0.5) & ~already
    return dict(ids=ids, idc=idc, uv=proj.uv, ur=proj.ur, radius=radius, pred=pred,
                valid_src=valid_src)


def _fuse_attrs(m: MapState, src_kf, dst_kf, cam, scale_factor: float, n_levels: int):
    """The fuse gates as K3 "proj" attribute packs, (B, N, 8) each; b-lane
    5 carries 1/sf^2(octave), the fuse chi2 weight (orbMatcher.cpp:714-721)."""
    s = _fuse_pair_setup(m, src_kf, dst_kf, cam, scale_factor, n_levels)
    f = torch.float32
    rad = s["radius"]
    z = torch.zeros_like(rad)
    a_attr = torch.stack([
        s["uv"][..., 0], s["uv"][..., 1], s["ur"], rad, rad,
        (s["pred"] - 1).to(f), s["pred"].to(f), s["valid_src"].to(f),
    ], -1)
    oct_d = m.kf_octave[dst_kf]
    sfo = torch.pow(f32(scale_factor, m.device), oct_d.to(f))
    isf2 = 1.0 / (sfo * sfo)
    b_attr = torch.stack([
        m.kf_uv[dst_kf][..., 0], m.kf_uv[dst_kf][..., 1], m.kf_right_u[dst_kf],
        oct_d.to(f), m.kf_kp_valid[dst_kf].to(f), isf2, z, z,
    ], -1)
    return a_attr, b_attr, s["ids"]


def _fuse_select(idx, b1, active, ids, N: int):
    """TH_LOW gate (orbMatcher.cpp:737), then one source point per dst
    keypoint (min distance, ties to the lower src row), per pair.
    Returns (bound (B,N), cand_mp (B,N), who_d (B,N)) over dst keypoints."""
    B = idx.shape[0]
    dev = idx.device
    hit = (idx >= 0) & (b1 <= 50)
    rows = torch.arange(N, device=dev)
    key = torch.where(hit, b1.to(torch.int64) * N + rows, _BIG_KEY)
    col = torch.where(hit, idx.to(torch.int64), N)
    colmin = scatter_min(
        torch.full((B, N), _BIG_KEY, dtype=torch.int64, device=dev),
        (torch.arange(B, device=dev)[:, None], col), key,
    )
    bound = (colmin < _BIG_KEY) & active[:, None]
    who = torch.where(bound, colmin % N, 0)
    who_d = torch.where(bound, colmin // N, INVALID_DIST)
    return bound, torch.gather(ids, 1, who), who_d


def _merge_rows(merge, old, new):
    """The first FUSE_MERGE_BUDGET merge rows, in stable-argsort order."""
    mf = merge.reshape(-1)
    sel = torch.argsort((~mf).to(torch.uint8), stable=True)[:FUSE_MERGE_BUDGET]
    ok = mf[sel]
    return torch.where(ok, old.reshape(-1)[sel], -1), new.reshape(-1)[sel], ok


def fuse_neighbors_batch(
    m: MapState,
    kf1: int,
    nids: torch.Tensor,  # (B,) neighbour ids (-1 padded)
    nok: torch.Tensor,  # (B,) bool
    cam: CameraIntrinsics,
    scale_factor: float,
    n_levels: int,
) -> MapState:
    """Two-way neighbour fusion in two batched passes (one K3 "proj"
    launch each).  OUT: kf1's points project into every neighbour and
    each neighbour's keypoint row binds or merges on its own.  IN: every
    neighbour's points project into kf1, the per-keypoint winner resolves
    across neighbours by Hamming distance, then kf1's row binds or
    merges."""
    dev = m.device
    B = nids.shape[0]
    kf2c = torch.clamp(nids.to(torch.int64), 0, m.K - 1)
    kf1v = torch.full((B,), kf1, dtype=torch.int64, device=dev)
    cols = torch.arange(m.N, device=dev)
    n_obs_tab = torch.sum(m.mp_obs_kf >= 0, dim=-1)

    # ---------------- OUT: kf1 -> each neighbour ----------------
    a_attr, b_attr, ids1 = _fuse_attrs(m, kf1v, kf2c, cam, scale_factor, n_levels)
    desc_a = m.mp_desc[torch.clamp(ids1.to(torch.int64), 0, m.M - 1)].contiguous()
    idx_o, b1_o, _ = pair_best2(desc_a, a_attr, m.kf_desc[kf2c], b_attr, mode="proj")
    bound, cand, _ = _fuse_select(idx_o, b1_o, nok, ids1, m.N)
    existing = m.kf_mp[kf2c]  # (B,N)
    empty_slot = existing < 0
    bind = bound & empty_slot
    flat_pt = torch.where(bind, cand, -1).reshape(-1)
    m, okw = add_observations_multi(
        m, flat_pt, kf2c[:, None].expand(B, m.N).reshape(-1),
        cols[None].expand(B, m.N).reshape(-1), flat_pt >= 0,
    )
    bind = bind & okw.reshape(B, m.N)
    new_rows = torch.where(bind, cand, existing)
    m = m._replace(kf_mp=scatter_set(m.kf_mp, torch.where(nok, kf2c, m.K), new_rows))
    cand_obs = n_obs_tab[torch.clamp(cand.to(torch.int64), 0, m.M - 1)]
    exist_obs = n_obs_tab[torch.clamp(existing.to(torch.int64), 0, m.M - 1)]
    merge = bound & ~empty_slot & (cand != existing)
    old = torch.where(exist_obs > cand_obs, cand, existing)
    new = torch.where(exist_obs > cand_obs, existing, cand)
    m = replace_points(m, *_merge_rows(merge, old, new), scale_factor, n_levels)

    # ---------------- IN: each neighbour -> kf1 ----------------
    a_attr, b_attr, idsB = _fuse_attrs(m, kf2c, kf1v, cam, scale_factor, n_levels)
    desc_a = m.mp_desc[torch.clamp(idsB.to(torch.int64), 0, m.M - 1)]
    desc_b = m.kf_desc[kf1].expand(B, m.N, 8).contiguous()
    idx_i, b1_i, _ = pair_best2(desc_a, a_attr, desc_b, b_attr, mode="proj")
    bound_i, cand_i, dist_i = _fuse_select(idx_i, b1_i, nok, idsB, m.N)
    dmat = torch.where(bound_i, dist_i, INVALID_DIST)
    win = torch.argmin(dmat, dim=0)  # first neighbour with the least distance
    win_d = dmat[win, cols]
    j_bound = win_d < INVALID_DIST
    j_cand = cand_i[win, cols]
    jc = torch.clamp(j_cand.to(torch.int64), 0, m.M - 1)
    first_j = scatter_min(
        torch.full((m.M + 1,), m.N, dtype=torch.int64, device=dev),
        torch.where(j_bound, jc, m.M), cols,
    )
    j_bound = j_bound & (first_j[jc] == cols)

    existing1 = m.kf_mp[kf1]
    empty1 = existing1 < 0
    bind1 = j_bound & empty1 & obs_has_free(m, j_cand)
    kf_mp = m.kf_mp.clone()
    kf_mp[kf1] = torch.where(bind1, j_cand, existing1)
    m = m._replace(kf_mp=kf_mp)
    m = add_observations(m, torch.where(bind1, j_cand, -1), kf1, cols, bind1)
    n_obs2 = torch.sum(m.mp_obs_kf >= 0, dim=-1)
    c_obs = n_obs2[jc]
    e_obs = n_obs2[torch.clamp(existing1.to(torch.int64), 0, m.M - 1)]
    merge1 = j_bound & ~empty1 & (j_cand != existing1)
    old1 = torch.where(e_obs > c_obs, j_cand, existing1)
    new1 = torch.where(e_obs > c_obs, existing1, j_cand)
    return replace_points(m, *_merge_rows(merge1, old1, new1), scale_factor, n_levels)
