"""Point- and observation-sharded optimization over a ``ShardGroup``.

Port of ``ydorbslam_tpu/parallel/ba_sharded.py``.  Every rank holds the
whole problem, replicated, and works on its contiguous block of the
sharded axis (``multihost.shard_rows``): the observations of the pose
step, the points of the BA.  The camera system is summed over the ranks
(``multihost.all_reduce``, where the JAX package calls ``psum``) and
solved by every rank alike; the points' back-substitution stays on their
rank, and the blocks come back whole by an ``all_gather`` in rank order.
Communication per LM step is the (C, 42) camera blocks, the (6C, 6C)
Schur coupling, the (C, 6) rhs term and two scalars, whatever the number
of points.

The LM accept/reject test reads the reduced cost on the device, so every
rank takes the same branch and no rank waits on the host inside a chunk.
Between chunks ``sharded_bundle_adjust`` asks ``should_abort()`` on the
host and acts on rank 0's answer, so all ranks stop after the same chunk.
"""
from __future__ import annotations

import torch

from ..geometry.camera import CameraIntrinsics
from ..geometry.se3 import se3_exp
from ..optim.residuals import batched_residual_and_jacobians, observation_weights
from ..optim.schur import (
    BAProblem, _delta2, _flat_chi2, _flat_project, _flat_weights, _flatten_obs, _lm_iteration,
    _po_flat, _po_unflat, lm_solve,
)
from .multihost import ShardGroup, all_gather_rows, all_reduce, broadcast_flag, shard_rows

_POINT_FIELDS = ("p_w", "pt_valid", "obs_cam", "obs_uvr", "obs_inv_sigma2", "obs_stereo",
                 "obs_valid")


def _local_problem(prob: BAProblem, g: ShardGroup) -> BAProblem:
    """This rank's point block of ``prob``; the cameras stay whole."""
    return prob._replace(**{k: shard_rows(getattr(prob, k), g) for k in _POINT_FIELDS})


def sharded_pose_step(g: ShardGroup, cam: CameraIntrinsics, T_cw, p_w, obs_uvr, inv_sigma2,
                      valid) -> torch.Tensor:
    """One Gauss-Newton pose step with the N observations sharded: each
    rank sums H = J^T W J and b = J^T W r over its block, the sums are
    reduced over the group, and every rank solves the same 6x6 system.
    Returns the new T_cw (4, 4)."""
    p, o, s2, v = (shard_rows(x, g) for x in (p_w, obs_uvr, inv_sigma2, valid))
    r, J, _, depth = batched_residual_and_jacobians(cam, T_cw, p, o)
    w = observation_weights(o[:, 2] > -1e8, s2)  # every row stereo-capable
    wm = w * (v & (depth > 1e-3)).to(torch.float32)[:, None]
    H = all_reduce(torch.einsum("nci,nc,ncj->ij", J, wm, J), g)
    b = all_reduce(torch.einsum("nci,nc,nc->i", J, wm, r), g)
    dx = -torch.linalg.solve(H + 1e-6 * torch.eye(6, device=H.device), b)
    return se3_exp(dx) @ T_cw


def sharded_ba_step(g: ShardGroup, cam: CameraIntrinsics, prob: BAProblem, lam=1e-4):
    """One robust Schur-complement Gauss-Newton step with the points
    sharded (``schur._lm_iteration`` on this rank's block, its camera sums
    reduced over the group).  Returns (T_new (C,4,4), p_new (P,3)), the
    points gathered whole."""
    local = _local_problem(prob, g)
    lam_t = torch.as_tensor(lam, dtype=torch.float32, device=prob.p_w.device)
    T_new, p_new = _lm_iteration(cam, prob.T_cw, local.p_w, local, local.obs_valid, lam_t, True,
                                 group=g)
    return T_new, all_gather_rows(p_new, g)


def _sharded_lm_chunk(g: ShardGroup, cam: CameraIntrinsics, prob: BAProblem, T, p, lam,
                      chunk: int = 5, use_huber: bool = True):
    """``chunk`` LM iterations from (T, p) carrying the damping ``lam``
    (a 0-dim tensor), the points sharded over ``g`` (``lm_solve(...,
    group=g)``): ``schur._lm_chunk``'s sharded form.  Returns (T, p, lam),
    the points gathered whole."""
    local = _local_problem(prob._replace(T_cw=T, p_w=p), g)
    T_new, p_new, _, lam_new = lm_solve(cam, local, chunk, use_huber, local.obs_valid, lam0=lam,
                                        group=g)
    return T_new, all_gather_rows(p_new, g), lam_new


def _sharded_classify(g: ShardGroup, cam: CameraIntrinsics, prob: BAProblem, T, p):
    """Chi-squared outliers (P, O) with the points sharded, gathered whole."""
    local = _local_problem(prob._replace(p_w=p), g)
    f = _flatten_obs(local)
    pr = _flat_project(cam, T, local.p_w, f)
    wu, wv, wr, mask = _flat_weights(f, pr["zr"], _po_flat(local.obs_valid))
    chi2 = _flat_chi2(pr, wu, wv, wr)
    Pl, O = local.obs_cam.shape
    out = _po_unflat(mask, Pl, O) & (_po_unflat(chi2, Pl, O) > _delta2(local.obs_stereo))
    return all_gather_rows(out, g)


def sharded_bundle_adjust(g: ShardGroup, cam: CameraIntrinsics, prob: BAProblem, iters: int,
                          chunk: int = 5, should_abort=None):
    """Point-sharded global BA: the reference's single robust phase
    (optimizer.cpp:7-137) in chunks of ``chunk`` LM iterations, the
    damping carried across chunks; between chunks rank 0's answer to
    ``should_abort()`` stops every rank (g2o's force-stop flag,
    optimizer.cpp:17-19).  ``prob.P`` must split over the group.
    Returns (T, p, obs_outlier) like ``schur.bundle_adjust``."""
    if prob.P % g.size:
        raise ValueError(f"{prob.P} points do not split over {g.size} ranks")
    dev = prob.p_w.device
    T, p = prob.T_cw, prob.p_w
    lam = torch.full((), 1e-4, dtype=torch.float32, device=dev)
    done = 0
    while done < iters:
        T, p, lam = _sharded_lm_chunk(g, cam, prob, T, p, lam, chunk, True)
        done += chunk
        if should_abort is not None and done < iters and \
                broadcast_flag(should_abort() if g.rank == 0 else False, g, dev):
            break
    return T, p, _sharded_classify(g, cam, prob, T, p)
