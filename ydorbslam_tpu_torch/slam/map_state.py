"""The map as a struct of fixed-capacity tensors: keyframes, points, graphs.

Port of ``ydorbslam_tpu/slam/map_state.py``.  The capacities and
conventions are the JAX package's: K keyframe slots, N keypoint slots
per keyframe, M map-point slots, O observation slots per point; an
empty slot is ``valid == False`` or index ``-1``.  Every mutation is a
function ``MapState -> MapState`` that builds new tensors (the inputs
are not modified), so a test can step the same map through both
packages.

Descriptors are int32 tensors that hold the uint32 bits (the port's
rule T2).  Every ``.at[...].set`` of the JAX module goes through
``ops.scatter.scatter_set``, which drops out-of-range indices and lets
the last update win among duplicates, as XLA does on the CPU; sorts
that JAX does stably pass ``stable=True``.

Keyframe ids that the host chose (``kf_id``) are Python ints.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..geometry.camera import CameraIntrinsics, backproject
from ..ops.extractor import FrameFeatures
from ..ops.hamming import popcount32
from ..ops.scatter import scatter_add, scatter_min, scatter_set


class MapState(NamedTuple):
    # --- keyframes (K, ...) ---
    kf_pose: torch.Tensor  # (K,4,4) T_cw
    kf_valid: torch.Tensor  # (K,) bool
    kf_timestamp: torch.Tensor  # (K,) f32
    kf_frame_id: torch.Tensor  # (K,) i32 source frame index
    kf_uv: torch.Tensor  # (K,N,2) undistorted
    kf_right_u: torch.Tensor  # (K,N)
    kf_depth: torch.Tensor  # (K,N)
    kf_octave: torch.Tensor  # (K,N) i32
    kf_angle: torch.Tensor  # (K,N)
    kf_desc: torch.Tensor  # (K,N,8) i32 (uint32 bits)
    kf_kp_valid: torch.Tensor  # (K,N) bool
    kf_mp: torch.Tensor  # (K,N) i32 map-point id per keypoint slot (-1)
    # --- map points (M, ...) ---
    mp_pos: torch.Tensor  # (M,3)
    mp_valid: torch.Tensor  # (M,) bool
    mp_desc: torch.Tensor  # (M,8) i32 (uint32 bits) distinctive descriptor
    mp_normal: torch.Tensor  # (M,3) viewing normal
    mp_min_dist: torch.Tensor  # (M,)
    mp_max_dist: torch.Tensor  # (M,)
    mp_ref_kf: torch.Tensor  # (M,) i32
    mp_first_kf: torch.Tensor  # (M,) i32 keyframe count at creation
    mp_found: torch.Tensor  # (M,) i32
    mp_visible: torch.Tensor  # (M,) i32
    mp_obs_kf: torch.Tensor  # (M,O) i32 observing keyframe (-1 empty)
    mp_obs_kp: torch.Tensor  # (M,O) i32 keypoint slot in that keyframe
    mp_obs_oct: torch.Tensor  # (M,O) i32 octave of that keypoint
    mp_obs_stereo: torch.Tensor  # (M,O) bool observation has a right-x
    # --- graph (K, ...) ---
    covis: torch.Tensor  # (K,K) i32 shared-point weights
    parent: torch.Tensor  # (K,) i32 spanning-tree parent (-1 root)
    loop_edge: torch.Tensor  # (K,) i32 loop edge partner (-1)
    kf_T_c2p: torch.Tensor  # (K,4,4) pose relative to parent, frozen at cull

    @property
    def K(self) -> int:
        return self.kf_pose.shape[0]

    @property
    def N(self) -> int:
        return self.kf_uv.shape[1]

    @property
    def M(self) -> int:
        return self.mp_pos.shape[0]

    @property
    def O(self) -> int:
        return self.mp_obs_kf.shape[1]

    @property
    def device(self) -> torch.device:
        return self.kf_pose.device


def empty_map(K: int, N: int, M: int, O: int, device="cuda") -> MapState:
    f32, i32 = torch.float32, torch.int32

    def full(shape, v, dtype):
        return torch.full(shape, v, dtype=dtype, device=device)

    eye = torch.eye(4, device=device)
    return MapState(
        kf_pose=eye.repeat(K, 1, 1),
        kf_valid=full((K,), False, torch.bool),
        kf_timestamp=full((K,), 0.0, f32),
        kf_frame_id=full((K,), -1, i32),
        kf_uv=full((K, N, 2), 0.0, f32),
        kf_right_u=full((K, N), -1.0, f32),
        kf_depth=full((K, N), -1.0, f32),
        kf_octave=full((K, N), 0, i32),
        kf_angle=full((K, N), 0.0, f32),
        kf_desc=full((K, N, 8), 0, i32),
        kf_kp_valid=full((K, N), False, torch.bool),
        kf_mp=full((K, N), -1, i32),
        mp_pos=full((M, 3), 0.0, f32),
        mp_valid=full((M,), False, torch.bool),
        mp_desc=full((M, 8), 0, i32),
        mp_normal=full((M, 3), 0.0, f32),
        mp_min_dist=full((M,), 0.0, f32),
        mp_max_dist=full((M,), 0.0, f32),
        mp_ref_kf=full((M,), -1, i32),
        mp_first_kf=full((M,), -1, i32),
        mp_found=full((M,), 1, i32),
        mp_visible=full((M,), 1, i32),
        mp_obs_kf=full((M, O), -1, i32),
        mp_obs_kp=full((M, O), -1, i32),
        mp_obs_oct=full((M, O), 0, i32),
        mp_obs_stereo=full((M, O), False, torch.bool),
        covis=full((K, K), 0, i32),
        parent=full((K,), -1, i32),
        loop_edge=full((K,), -1, i32),
        kf_T_c2p=eye.repeat(K, 1, 1),
    )


def _i64(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64)


def _clip(x: torch.Tensor, hi: int) -> torch.Tensor:
    return torch.clamp(_i64(x), 0, hi - 1)


def f32(x, device) -> torch.Tensor:
    """A float32 0-dim tensor: dividing by a tensor (not a Python float)
    keeps a true float32 division on every device (CUDA turns division
    by a Python scalar into multiplication by its reciprocal).  Made by a
    fill, not a host-to-device copy, which would wait for the stream."""
    return torch.full((), x, dtype=torch.float32, device=device)



def argmax_first(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Index of the first maximum (``jnp.argmax``), also for bools."""
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    return torch.argmax(x, dim=dim)


# ----------------------------------------------------------------------
# Functional slot allocation
# ----------------------------------------------------------------------

def rank_free_slots(valid: torch.Tensor) -> torch.Tensor:
    """rank[i] = how many free slots precede free slot i (for allocation)."""
    free = ~valid
    return torch.where(free, torch.cumsum(free.to(torch.int64), 0) - 1, -1)


def alloc_slots(valid: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Map each requested rank r in ``want`` (-1 = no request) to the
    r-th free slot index, or -1 if out of capacity."""
    rank = rank_free_slots(valid)
    n = valid.shape[0]
    dev = valid.device
    slot_of_rank = torch.full((n,), -1, dtype=torch.int32, device=dev)
    slot_of_rank = scatter_set(
        slot_of_rank, torch.where(rank >= 0, rank, n),
        torch.arange(n, dtype=torch.int32, device=dev),
    )
    n_free = torch.sum(~valid)
    slot_of_rank = torch.where(
        torch.arange(n, device=dev) < n_free, slot_of_rank, -1
    )
    want = _i64(want)
    return torch.where(
        (want >= 0) & (want < n), slot_of_rank[torch.clamp(want, 0, n - 1)], -1
    ).to(torch.int32)


# ----------------------------------------------------------------------
# Observation management
# ----------------------------------------------------------------------

def obs_has_free(m: MapState, mp_ids: torch.Tensor) -> torch.Tensor:
    """(B,) whether each point has a free observation slot."""
    return torch.any(m.mp_obs_kf[_clip(mp_ids, m.M)] < 0, dim=-1)


def add_observations(
    m: MapState, mp_ids: torch.Tensor, kf_id: int, kp_idx: torch.Tensor, valid: torch.Tensor
) -> MapState:
    """Append (kf_id, kp) observations to points ``mp_ids`` (one obs per
    point at most): each lands in its point's first free O-slot; a point
    at capacity drops it (MapPoint::addObservation)."""
    mp = _clip(mp_ids, m.M)
    slots_free = m.mp_obs_kf[mp] < 0  # (B,O)
    first_free = argmax_first(slots_free, -1)
    has_free = torch.any(slots_free, dim=-1)
    ok = valid & (mp_ids >= 0) & has_free
    mp_w = torch.where(ok, mp, m.M - 1)  # writes to the dummy row keep its value
    kpc = _clip(kp_idx, m.N)
    obs_kf = scatter_set(
        m.mp_obs_kf, (mp_w, first_free),
        torch.where(ok, kf_id, m.mp_obs_kf[mp_w, first_free]),
    )
    obs_kp = scatter_set(
        m.mp_obs_kp, (mp_w, first_free),
        torch.where(ok, kp_idx.to(torch.int32), m.mp_obs_kp[mp_w, first_free]),
    )
    oct_new = m.kf_octave[kf_id][kpc]
    obs_oct = scatter_set(
        m.mp_obs_oct, (mp_w, first_free),
        torch.where(ok, oct_new, m.mp_obs_oct[mp_w, first_free]),
    )
    st_new = m.kf_right_u[kf_id][kpc] >= 0
    obs_st = scatter_set(
        m.mp_obs_stereo, (mp_w, first_free),
        torch.where(ok, st_new, m.mp_obs_stereo[mp_w, first_free]),
    )
    return m._replace(
        mp_obs_kf=obs_kf, mp_obs_kp=obs_kp, mp_obs_oct=obs_oct, mp_obs_stereo=obs_st,
    )


def add_observations_multi(
    m: MapState,
    mp_ids: torch.Tensor,
    kf_ids: torch.Tensor,
    kp_idx: torch.Tensor,
    valid: torch.Tensor,
) -> Tuple[MapState, torch.Tensor]:
    """Append observations where the same point may appear several times
    in one batch: each point's new observations are ranked (stable sort
    by point id) and the r-th one lands in the r-th free slot of that
    point's row.  Returns (map, written (F,) bool)."""
    F = mp_ids.shape[0]
    dev = m.device
    ok = valid & (mp_ids >= 0)
    mp = _clip(mp_ids, m.M)
    key = torch.where(ok, mp, m.M)
    order = torch.argsort(key, stable=True)
    sorted_mp = key[order]
    newgrp = torch.cat(
        [torch.ones((1,), dtype=torch.bool, device=dev), sorted_mp[1:] != sorted_mp[:-1]]
    )
    pos = torch.arange(F, device=dev)
    grp_start = torch.cummax(torch.where(newgrp, pos, 0), 0).values
    rank_sorted = pos - grp_start
    rank = scatter_set(
        torch.zeros((F,), dtype=torch.int64, device=dev), order, rank_sorted
    )
    free = m.mp_obs_kf[mp] < 0  # (F,O)
    cum = torch.cumsum(free.to(torch.int64), dim=-1)
    slot_hit = free & (cum == (rank[:, None] + 1))
    slot = argmax_first(slot_hit, -1)
    has_slot = torch.any(slot_hit, dim=-1)
    okw = ok & has_slot
    mp_w = torch.where(okw, mp, m.M)  # dropped when invalid
    kfc, kpc = _clip(kf_ids, m.K), _clip(kp_idx, m.N)
    return (
        m._replace(
            mp_obs_kf=scatter_set(m.mp_obs_kf, (mp_w, slot), kf_ids.to(torch.int32)),
            mp_obs_kp=scatter_set(m.mp_obs_kp, (mp_w, slot), kp_idx.to(torch.int32)),
            mp_obs_oct=scatter_set(m.mp_obs_oct, (mp_w, slot), m.kf_octave[kfc, kpc]),
            mp_obs_stereo=scatter_set(
                m.mp_obs_stereo, (mp_w, slot), m.kf_right_u[kfc, kpc] >= 0
            ),
        ),
        okw,
    )


def erase_observations(m: MapState, mp_ids: torch.Tensor, kf_ids: torch.Tensor) -> MapState:
    """Remove observation (kf, *) from each point in mp_ids (batched), and
    clear the keyframe's keypoint binding (MapPoint::eraseObservation)."""
    mp = _clip(mp_ids, m.M)
    ok = (mp_ids >= 0)[:, None]
    hit = (m.mp_obs_kf[mp] == kf_ids[:, None]) & ok  # (B,O)
    kp_slots = m.mp_obs_kp[mp]
    cols = torch.arange(m.O, device=m.device)[None, :]
    obs_kf = scatter_set(m.mp_obs_kf, (mp[:, None], cols), torch.where(hit, -1, m.mp_obs_kf[mp]))
    obs_kp = scatter_set(m.mp_obs_kp, (mp[:, None], cols), torch.where(hit, -1, kp_slots))
    kf_w = torch.where(mp_ids >= 0, _i64(kf_ids), 0)
    kp_any = torch.where(hit, kp_slots, -1).amax(dim=-1)
    kpc = _clip(kp_any, m.N)
    kf_mp = scatter_set(
        m.kf_mp, (kf_w, kpc),
        torch.where((kp_any >= 0) & (mp_ids >= 0), -1, m.kf_mp[kf_w, kpc]),
    )
    return m._replace(mp_obs_kf=obs_kf, mp_obs_kp=obs_kp, kf_mp=kf_mp)


def recount_obs(m: MapState) -> torch.Tensor:
    """(M,) number of live observations per point."""
    return torch.sum(m.mp_obs_kf >= 0, dim=-1)


def recount_obs_weighted(m: MapState) -> torch.Tensor:
    """(M,) reference observationsNum: stereo/RGB-D observations count
    double (mapPoint.cpp:96-99)."""
    live = m.mp_obs_kf >= 0
    return torch.sum(
        torch.where(live, 1 + m.mp_obs_stereo.to(torch.int64), 0), dim=-1
    )


# ----------------------------------------------------------------------
# Derived point attributes
# ----------------------------------------------------------------------

def camera_centers(kf_pose: torch.Tensor) -> torch.Tensor:
    """(K,3) camera centres -R^T t of every keyframe slot."""
    R, t = kf_pose[..., :3, :3], kf_pose[..., :3, 3]
    return -torch.einsum("kji,kj->ki", R, t)


def refresh_points(
    m: MapState, mp_ids: torch.Tensor, scale_factor: float, n_levels: int
) -> MapState:
    """Recompute the distinctive descriptor, normal and scale band of a
    batch of points (-1 padded): min-median-Hamming descriptor over the
    observations (mapPoint.cpp:169-218) and the mean viewing ray with the
    band from the first live observation's octave (:219-250)."""
    B = mp_ids.shape[0]
    dev = m.device
    mp = _clip(mp_ids, m.M)
    ok = (mp_ids >= 0) & m.mp_valid[mp]
    obs_kf = m.mp_obs_kf[mp]  # (B,O)
    obs_kp = m.mp_obs_kp[mp]
    has = obs_kf >= 0
    kfc = _clip(obs_kf, m.K)
    kpc = _clip(obs_kp, m.N)
    descs = m.kf_desc[kfc, kpc]  # (B,O,8)

    # Min-median-distance descriptor.
    d = torch.zeros((B, m.O, m.O), dtype=torch.int64, device=dev)
    for w in range(8):
        d += popcount32(torch.bitwise_xor(descs[:, :, None, w], descs[:, None, :, w]))
    big = 10_000
    d = torch.where(has[:, None, :] & has[:, :, None], d, big)
    d_sorted = torch.sort(d, dim=-1).values
    n_obs = torch.sum(has, dim=-1)  # (B,)
    med_idx = torch.clamp(n_obs // 2, 0, m.O - 1)
    median = torch.gather(
        d_sorted, 2, med_idx[:, None, None].expand(B, m.O, 1)
    )[..., 0]  # (B,O)
    median = torch.where(has, median, big)
    best = torch.argmin(median, dim=-1)  # first minimum
    new_desc = torch.gather(descs, 1, best[:, None, None].expand(B, 1, 8))[:, 0]

    # Normal: mean unit vector from the observing camera centres.
    centers_all = camera_centers(m.kf_pose)  # (K,3)
    centers = centers_all[kfc]  # (B,O,3)
    pos = m.mp_pos[mp][:, None, :]
    rays = pos - centers
    ray_norm = torch.linalg.norm(rays, dim=-1, keepdim=True)
    unit = torch.where(has[..., None], rays / torch.clamp(ray_norm, min=1e-6), 0.0)
    normal = torch.sum(unit, dim=1) / torch.clamp(n_obs[:, None], min=1).to(torch.float32)

    # Scale band from the first live observation.
    first = argmax_first(has, -1)
    ref_kf = torch.gather(kfc, 1, first[:, None])[:, 0]
    ref_kp = torch.gather(kpc, 1, first[:, None])[:, 0]
    ref_center = centers_all[ref_kf]
    dist_ref = torch.linalg.norm(m.mp_pos[mp] - ref_center, dim=-1)
    octv = m.kf_octave[ref_kf, ref_kp]
    level_scale = torch.pow(f32(scale_factor, dev), octv.to(torch.float32))
    max_dist = dist_ref * level_scale
    min_dist = max_dist / f32(scale_factor ** (n_levels - 1), dev)

    okb = ok & (n_obs > 0)
    mp_w = torch.where(okb, mp, m.M - 1)

    def put(arr, new):
        cur = arr[mp_w]
        sel = okb.reshape((B,) + (1,) * (new.dim() - 1))
        return scatter_set(arr, mp_w, torch.where(sel, new.to(arr.dtype), cur))

    return m._replace(
        mp_desc=put(m.mp_desc, new_desc),
        mp_normal=put(m.mp_normal, normal),
        mp_max_dist=put(m.mp_max_dist, max_dist),
        mp_min_dist=put(m.mp_min_dist, min_dist),
        mp_ref_kf=put(m.mp_ref_kf, ref_kf),
    )


def replace_points(
    m: MapState,
    old_ids: torch.Tensor,
    new_ids: torch.Tensor,
    ok: torch.Tensor,
    scale_factor: float,
    n_levels: int,
) -> MapState:
    """Batched ``MapPoint::beReplacedBy`` (mapPoint.cpp:128-157): each
    surviving ``new`` absorbs the observations of its dying ``old`` (a
    keyframe slot bound to ``old`` rebinds to ``new``, or is erased when
    ``new`` is already observed there or has no free slot), counters
    fold in, ``old`` is invalidated and the survivors refresh.  Duplicate
    ``old`` entries keep the first row; rows whose ``old`` is a ``new``
    elsewhere (or vice versa) are dropped."""
    R = old_ids.shape[0]
    dev = m.device
    oldc = _clip(old_ids, m.M)
    newc = _clip(new_ids, m.M)
    ok = (
        ok & (old_ids >= 0) & (new_ids >= 0) & (old_ids != new_ids)
        & m.mp_valid[oldc] & m.mp_valid[newc]
    )
    rows = torch.arange(R, dtype=torch.int32, device=dev)
    first = scatter_min(
        torch.full((m.M + 1,), R, dtype=torch.int32, device=dev),
        torch.where(ok, oldc, m.M), rows,
    )
    ok = ok & (first[oldc] == rows)
    used_new = scatter_set(
        torch.zeros((m.M,), dtype=torch.bool, device=dev), torch.where(ok, newc, m.M), True
    )
    used_old = scatter_set(
        torch.zeros((m.M,), dtype=torch.bool, device=dev), torch.where(ok, oldc, m.M), True
    )
    ok = ok & ~used_new[oldc] & ~used_old[newc]

    okf = m.mp_obs_kf[oldc]  # (R,O)
    okp = m.mp_obs_kp[oldc]
    live = (okf >= 0) & ok[:, None]
    in_new = torch.any(okf[:, :, None] == m.mp_obs_kf[newc][:, None, :], dim=-1)
    transfer = live & ~in_new
    m, okw = add_observations_multi(
        m,
        torch.where(transfer, newc[:, None], -1).reshape(-1),
        okf.reshape(-1),
        okp.reshape(-1),
        transfer.reshape(-1),
    )
    okw = okw.reshape(R, m.O)
    tgt = torch.where(transfer & okw, newc[:, None], -1)
    kf_w = torch.where(live, _i64(okf), m.K)
    kf_mp = scatter_set(
        m.kf_mp, (kf_w.reshape(-1), _clip(okp, m.N).reshape(-1)), tgt.reshape(-1)
    )
    new_w = torch.where(ok, newc, m.M)
    mp_found = scatter_add(m.mp_found, new_w, torch.where(ok, m.mp_found[oldc], 0))
    mp_visible = scatter_add(m.mp_visible, new_w, torch.where(ok, m.mp_visible[oldc], 0))
    old_w = torch.where(ok, oldc, m.M)
    m = m._replace(
        kf_mp=kf_mp,
        mp_found=mp_found,
        mp_visible=mp_visible,
        mp_valid=scatter_set(m.mp_valid, old_w, False),
        mp_obs_kf=scatter_set(m.mp_obs_kf, old_w, -1),
        mp_obs_kp=scatter_set(m.mp_obs_kp, old_w, -1),
    )
    return refresh_points(m, torch.where(ok, new_ids, -1), scale_factor, n_levels)


# ----------------------------------------------------------------------
# Covisibility + spanning tree
# ----------------------------------------------------------------------

def update_covisibility(m: MapState, kf_id: int) -> MapState:
    """Recompute the covisibility row/col of one keyframe from the
    observation lists of its bound points (KeyFrame::updateConnections,
    keyFrame.cpp:37-96); a new keyframe's spanning-tree parent is its
    strongest earlier neighbour, else the most recent earlier one."""
    dev = m.device
    ids = m.kf_mp[kf_id]  # (N,)
    rows = m.mp_obs_kf[_clip(ids, m.M)]  # (N,O)
    live = (ids >= 0)[:, None] & (rows >= 0)
    # The JAX package counts votes with a dense (N, O, K) compare; a
    # scatter-add of the same votes gives the same integers.
    votes = torch.where(live, _i64(rows), m.K).reshape(-1)
    w = torch.zeros((m.K + 1,), dtype=torch.int32, device=dev)
    w = w.index_add_(0, votes, torch.ones_like(votes, dtype=torch.int32))[: m.K]
    w = torch.where(m.kf_valid, w, 0)
    w = scatter_set(w, kf_id, 0)
    covis = m.covis.clone()
    covis[kf_id, :] = w
    covis[:, kf_id] = w
    earlier = m.kf_valid & (m.kf_frame_id >= 0) & (m.kf_frame_id < m.kf_frame_id[kf_id])
    w_earlier = torch.where(earlier, w, -1)
    best = torch.argmax(w_earlier)
    recent = torch.argmax(torch.where(earlier, m.kf_frame_id, -1))
    fallback = torch.where(torch.any(earlier), recent, -1)
    # The argmax's own weight is the maximum: no 0-dim index, so no read.
    chosen = torch.where(torch.amax(w_earlier) > 0, best, fallback)
    parent = torch.where(m.parent[kf_id] < 0, chosen, m.parent[kf_id]).to(torch.int32)
    return m._replace(covis=covis, parent=scatter_set(m.parent, kf_id, parent))


def recompute_covis_all(m: MapState) -> MapState:
    """Rebuild the whole covisibility matrix from the observation lists
    (the loop correction's updateConnections sweep, loopClosing.cpp:
    311-317): weight(i, j) = the number of valid points observed by both
    i and j, with a zero diagonal and no weight to or from a keyframe
    that is not valid.  The JAX package sums (B, K) one-hot blocks of
    4096 points; here one (M, K) 0/1 incidence product gives the same
    integers (exact in float32 below 2^24 points), with the spanning
    tree and parents untouched."""
    K, M = m.K, m.M
    dev = m.device
    obs = m.mp_obs_kf.to(torch.int64)
    col = torch.where((obs >= 0) & m.mp_valid[:, None], obs, K)
    inc = torch.zeros((M, K + 1), dtype=torch.float32, device=dev)
    inc.scatter_(1, col, 1.0)
    A = inc[:, :K]
    covis = (A.T @ A).to(torch.int32)
    ok = m.kf_valid[:, None] & m.kf_valid[None, :] & ~torch.eye(K, dtype=torch.bool, device=dev)
    return m._replace(covis=torch.where(ok, covis, 0))


# ----------------------------------------------------------------------
# Keyframe insertion
# ----------------------------------------------------------------------

def insert_keyframe(
    m: MapState,
    kf_id: int,
    frame_id: int,
    timestamp: float,
    feats: FrameFeatures,
    T_cw: torch.Tensor,
    matched_mp: torch.Tensor,
    cam: CameraIntrinsics,
    depth_threshold: torch.Tensor,
    kf_count: int,
    scale_factor: float = 1.2,
    n_levels: int = 8,
    min_close_seed: int = 100,
) -> Tuple[MapState, torch.Tensor]:
    """Insert a frame as keyframe ``kf_id`` (a free slot chosen by the
    host): store its arrays, bind its map-point matches, seed new close
    points for unmatched keypoints with depth (at least the nearest
    ``min_close_seed``), refresh the touched points and update the
    covisibility row and spanning tree (tracking.cpp:797-844,
    localMapping.cpp:63-89).  Returns (map, number of new points)."""
    N = m.N
    dev = m.device
    idx = torch.arange(N, device=dev)

    # 0. slot-reuse hygiene: clear stale observations of this slot id.
    stale = m.mp_obs_kf == kf_id
    m = m._replace(
        mp_obs_kf=torch.where(stale, -1, m.mp_obs_kf),
        mp_obs_kp=torch.where(stale, -1, m.mp_obs_kp),
    )

    # 1. bindings: valid matches with a free obs slot, one keypoint per point.
    mclip = _clip(matched_mp, m.M)
    matched_ok = (matched_mp >= 0) & feats.valid & m.mp_valid[mclip]
    had_match = matched_ok
    matched_ok = matched_ok & obs_has_free(m, matched_mp)
    first_kp = scatter_min(
        torch.full((m.M + 1,), N, dtype=torch.int32, device=dev),
        torch.where(matched_ok, mclip, m.M), idx.to(torch.int32),
    )
    matched_ok = matched_ok & (first_kp[mclip] == idx)

    # 2. new close points (and the nearest min_close_seed with depth).
    has_depth = feats.valid & (feats.depth > 0) & ~had_match
    close = has_depth & (feats.depth <= depth_threshold)
    depth_rank = torch.argsort(
        torch.argsort(torch.where(has_depth, feats.depth, float("inf")), stable=True),
        stable=True,
    )
    near_enough = has_depth & (depth_rank < min_close_seed)
    want_new = close | near_enough
    ranks = torch.where(want_new, torch.cumsum(want_new.to(torch.int64), 0) - 1, -1)
    new_slots = alloc_slots(m.mp_valid, ranks)  # (N,) mp slot or -1
    created = new_slots >= 0

    p_c = backproject(cam, feats.uv, torch.clamp(feats.depth, min=1e-3))
    R, t = T_cw[:3, :3], T_cw[:3, 3]
    p_w = (p_c - t) @ R

    slot_w = torch.where(created, _i64(new_slots), m.M - 1)
    def seed(arr, v):
        sel = created.reshape((N,) + (1,) * (arr.dim() - 1))
        if not isinstance(v, torch.Tensor):
            v = torch.full((), v, dtype=arr.dtype, device=dev)
        return scatter_set(arr, slot_w, torch.where(sel, v.to(arr.dtype), arr[slot_w]))

    m = m._replace(
        mp_pos=seed(m.mp_pos, p_w),
        mp_valid=seed(m.mp_valid, True),
        mp_first_kf=seed(m.mp_first_kf, int(kf_count)),
        mp_found=seed(m.mp_found, 1),
        mp_visible=seed(m.mp_visible, 1),
        mp_obs_kf=seed(m.mp_obs_kf, -1),
        mp_obs_kp=seed(m.mp_obs_kp, -1),
    )

    kf_mp_row = torch.where(
        matched_ok, matched_mp, torch.where(created, new_slots, -1)
    ).to(torch.int32)

    def row(arr, v):
        out = arr.clone()
        if not isinstance(v, torch.Tensor):  # a fill: a Python number set in place is an upload
            v = torch.full((), v, dtype=arr.dtype, device=dev)
        out[kf_id] = v
        return out

    m = m._replace(
        kf_pose=row(m.kf_pose, T_cw),
        kf_valid=row(m.kf_valid, True),
        kf_timestamp=row(m.kf_timestamp, float(timestamp)),
        kf_frame_id=row(m.kf_frame_id, frame_id),
        kf_uv=row(m.kf_uv, feats.uv),
        kf_right_u=row(m.kf_right_u, feats.right_u),
        kf_depth=row(m.kf_depth, feats.depth),
        kf_octave=row(m.kf_octave, feats.octave),
        kf_angle=row(m.kf_angle, feats.angle),
        kf_desc=row(m.kf_desc, feats.desc),
        kf_kp_valid=row(m.kf_kp_valid, feats.valid),
        kf_mp=row(m.kf_mp, kf_mp_row),
    )

    # 3. observations for both matched and created points
    m = add_observations(m, kf_mp_row, kf_id, idx, kf_mp_row >= 0)
    # 4. refresh all touched points
    m = refresh_points(m, torch.where(kf_mp_row >= 0, kf_mp_row, -1), scale_factor, n_levels)
    # 5. graph updates
    m = update_covisibility(m, kf_id)
    return m, torch.sum(created)
