"""TUM-format trajectory export — the evaluation output contract.

Reproduces the exact file format of the reference writers
``System::saveTrajectoryTUM`` and ``System::saveKeyFrameTrajectoryTUM``
(src/system.cpp:193-261): one line per localized frame,

    ``timestamp tx ty tz qx qy qz qw``

with the pose expressed as camera-in-world relative to the *first
keyframe* (camera center ``-R^T t`` and rotation ``R^T`` of ``T_cw``),
timestamps at 6 decimals, translations/quaternions at 9 (full
trajectory) or 7 (keyframe trajectory) significant digits.  Frames lost
during tracking are skipped, and frames whose reference keyframe was
culled walk up the spanning tree accumulating the stored
relative-to-parent transforms (src/system.cpp:209-232).

Also includes ATE RMSE evaluation (the TUM tooling metric) so accuracy
regression tests are self-contained — the reference delegates this to
external tools (SURVEY.md §4).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def _rot_to_quat_np(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> (qx, qy, qz, qw), numpy host-side version."""
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    q = np.array([x, y, z, w])
    return q / np.linalg.norm(q)


def write_tum_trajectory(
    path: str,
    timestamps: Sequence[float],
    poses_T_cw: Sequence[np.ndarray],
    lost: Sequence[bool] | None = None,
    precision: int = 9,
) -> None:
    """Write camera-in-world poses in TUM format.

    ``poses_T_cw`` are world-to-camera 4x4 matrices (already composed
    relative to the first keyframe by the caller); the writer inverts to
    camera-in-world as the reference does (src/system.cpp:225-228).
    """
    with open(path, "w") as f:
        for i, (t, T) in enumerate(zip(timestamps, poses_T_cw)):
            if lost is not None and lost[i]:
                continue
            T = np.asarray(T, dtype=np.float64)
            R_wc = T[:3, :3].T
            center = -R_wc @ T[:3, 3]
            q = _rot_to_quat_np(R_wc)
            p = precision
            f.write(
                f"{t:.6f} {center[0]:.{p}f} {center[1]:.{p}f} {center[2]:.{p}f} "
                f"{q[0]:.{p}f} {q[1]:.{p}f} {q[2]:.{p}f} {q[3]:.{p}f}\n"
            )


def read_tum_trajectory(path: str):
    """Read a TUM trajectory file -> (timestamps (N,), positions (N,3),
    quaternions (N,4) in xyzw)."""
    data = np.loadtxt(path, comments="#", ndmin=2)
    return data[:, 0], data[:, 1:4], data[:, 4:8]


def associate_by_time(t_a: np.ndarray, t_b: np.ndarray, max_dt: float = 0.02):
    """Greedy nearest-timestamp association (TUM associate.py semantics).

    Returns index pairs (ia, ib) with |t_a[ia] - t_b[ib]| <= max_dt.
    """
    ia, ib = [], []
    j = 0
    used = np.zeros(len(t_b), dtype=bool)
    for i, t in enumerate(t_a):
        j = int(np.searchsorted(t_b, t))
        best, best_dt = -1, max_dt
        for k in (j - 1, j):
            if 0 <= k < len(t_b) and not used[k]:
                dt = abs(t_b[k] - t)
                if dt <= best_dt:
                    best, best_dt = k, dt
        if best >= 0:
            used[best] = True
            ia.append(i)
            ib.append(best)
    return np.asarray(ia, dtype=np.int64), np.asarray(ib, dtype=np.int64)


def ate_rmse(
    positions_est: np.ndarray, positions_gt: np.ndarray, with_scale: bool = False
) -> float:
    """Absolute trajectory error RMSE after Horn/Umeyama alignment.

    The standard TUM evaluation: rigidly align estimated to ground-truth
    positions (SE3; optionally Sim3 with ``with_scale``), then RMSE of
    the residual translations.
    """
    est = np.asarray(positions_est, dtype=np.float64)
    gt = np.asarray(positions_gt, dtype=np.float64)
    assert est.shape == gt.shape and est.shape[0] >= 3
    mu_e, mu_g = est.mean(0), gt.mean(0)
    E, G = est - mu_e, gt - mu_g
    H = E.T @ G
    U, S, Vt = np.linalg.svd(H)
    D = np.eye(3)
    if np.linalg.det(Vt.T @ U.T) < 0:
        D[2, 2] = -1.0
    R = Vt.T @ D @ U.T
    s = 1.0
    if with_scale:
        var_e = (E * E).sum() / len(E)
        s = (S * np.diag(D)).sum() / var_e
    t = mu_g - s * R @ mu_e
    aligned = (s * (R @ est.T)).T + t
    err = aligned - gt
    return float(np.sqrt((err * err).sum(axis=1).mean()))


def ate_against_groundtruth(traj_path: str, gt_path: str):
    """The runners' ATE of a TUM trajectory file against a TUM
    groundtruth file (``t tx ty tz qx qy qz qw`` rows), poses associated
    by time: (ATE RMSE in metres, or None below 3 associations; the
    number of associated poses)."""
    gt = np.loadtxt(gt_path, comments="#", ndmin=2)
    t_est, p_est, _ = read_tum_trajectory(traj_path)
    ia, ib = associate_by_time(t_est, gt[:, 0])
    if len(ia) < 3:
        return None, len(ia)
    return float(ate_rmse(p_est[ia], gt[ib][:, 1:4])), len(ia)


def ate_against_kitti_poses(traj_path: str, poses_path: str, n_frames: int):
    """The KITTI runners' ATE of a TUM trajectory file against a KITTI
    ``poses.txt`` (camera-to-world 3x4 rows): the i-th written position
    against the i-th ground-truth position of the first ``n_frames``, as
    both packages' ``run_kitti_stereo`` pair them.  (ATE RMSE in metres,
    or None below 3 pairs; the number of pairs.)"""
    gt = np.loadtxt(poses_path).reshape(-1, 3, 4)[:n_frames, :, 3]
    _, p_est, _ = read_tum_trajectory(traj_path)
    k = min(len(p_est), len(gt))
    if k < 3:
        return None, k
    return float(ate_rmse(p_est[:k], gt[:k])), k
