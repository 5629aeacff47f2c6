"""The reduced camera system of one damped Gauss-Newton step of a
bundle-adjustment problem, plain.

The benchmark's reference for the first step of the port's local BA
(``optim/schur.lm_solve``: the observation pass of K4, the camera
reduction and the Schur complement, the camera solve and the points'
back-substitution) and for its cost.  It follows the equations of the
dense form of that step in ``ydorbslam_tpu_torch/optim/schur.py``
(``_lm_iteration`` with ``_camera_step``), written here anew on the
(P, O) observation grid, in the dtype of its inputs (float64 for the
reference).
"""
from __future__ import annotations

import torch

from .residuals import huber_cost, huber_scale, residual_and_jacobians

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


def _observations(cam, T, p, obs_cam, obs_uvr, obs_inv_sigma2, obs_stereo, obs_valid, pt_valid,
                  active):
    """Residuals, Jacobians and masked weights on the (P, O) grid:
    (r, Jc, Jp, w3 (P, O, 3), camc (P, O), mask (P, O))."""
    C = T.shape[0]
    dt = p.dtype
    camc = torch.clamp(obs_cam.to(torch.int64), 0, C - 1)
    r, Jc, Jp, z = residual_and_jacobians(cam, T[camc], p[:, None, :], obs_uvr)
    keep = torch.stack([torch.ones_like(obs_stereo)] * 2 + [obs_stereo], dim=-1)
    mask = active & obs_valid & (obs_cam >= 0) & pt_valid[:, None] & (z > 1e-3)
    w3 = torch.where(keep, obs_inv_sigma2[..., None], 0.0) * mask[..., None].to(dt)
    return r, Jc, Jp, w3, camc, mask


def _delta2(obs_stereo, like):
    return torch.where(obs_stereo, torch.full_like(like, CHI2_STEREO),
                       torch.full_like(like, CHI2_MONO))


def cost(cam, T, p, obs_cam, obs_uvr, obs_inv_sigma2, obs_stereo, obs_valid, pt_valid, active,
         use_huber: bool):
    """The robustified (or raw) total cost of a state, as the step's
    accept test weighs it."""
    r, _, _, w3, _, mask = _observations(cam, T, p, obs_cam, obs_uvr, obs_inv_sigma2, obs_stereo,
                                         obs_valid, pt_valid, active)
    chi2 = torch.sum(r * r * w3, dim=-1)
    c = huber_cost(chi2, _delta2(obs_stereo, chi2)) if use_huber else chi2
    return torch.sum(c * mask.to(c.dtype))


def normal_equations(cam, T, p, obs_cam, obs_uvr, obs_inv_sigma2, obs_stereo, obs_valid,
                     pt_valid, active, use_huber: bool):
    """The Gauss-Newton pieces of one state: a dict of Hcc (C, 6, 6),
    bc (C, 6), Hpp (P, 3, 3), bp (P, 3), B (P, O, 6, 3), the one-hot
    incidence E (P, O, C), and the sums over the terms' absolute values
    bc_abs, bp_abs (the scales against which a cancelling gradient is
    judged)."""
    C = T.shape[0]
    r, Jc, Jp, w3, camc, _ = _observations(cam, T, p, obs_cam, obs_uvr, obs_inv_sigma2,
                                           obs_stereo, obs_valid, pt_valid, active)
    if use_huber:
        chi2 = torch.sum(r * r * w3, dim=-1)
        w3 = w3 * huber_scale(chi2, _delta2(obs_stereo, chi2))[..., None]
    E = ((camc[..., None] == torch.arange(C, device=p.device))
         & (obs_cam >= 0)[..., None]).to(p.dtype)
    return dict(
        Hpp=torch.einsum("poki,pok,pokj->pij", Jp, w3, Jp),
        bp=torch.einsum("poki,pok,pok->pi", Jp, w3, r),
        bp_abs=torch.einsum("poki,pok,pok->pi", Jp.abs(), w3, r.abs()),
        Hcc=torch.einsum("poc,poij->cij", E, torch.einsum("poki,pok,pokj->poij", Jc, w3, Jc)),
        bc=torch.einsum("poc,poi->ci", E, torch.einsum("poki,pok,pok->poi", Jc, w3, r)),
        bc_abs=torch.einsum("poc,poi->ci", E, torch.einsum("poki,pok,pok->poi", Jc.abs(), w3,
                                                            r.abs())),
        B=torch.einsum("poki,pok,pokj->poij", Jc, w3, Jp),
        E=E)


def damped_points(Hpp, lam: float, pt_valid):
    """The points' damped blocks, as the step damps them."""
    eye3 = torch.eye(3, dtype=Hpp.dtype, device=Hpp.device)
    tr3 = torch.diagonal(Hpp, dim1=-2, dim2=-1).sum(-1)
    return Hpp + lam * eye3 * torch.clamp(tr3 / 3.0, min=1e-6)[:, None, None]


def reduced_system(cam, T, p, obs_cam, obs_uvr, obs_inv_sigma2, obs_stereo, obs_valid, pt_valid,
                   active, use_huber: bool, lam: float):
    """The normal equations of one step at damping ``lam``, reduced to the
    cameras: (Hcc (C, 6, 6), S_off (C, C, 6, 6), bs (C, 6), bs_abs (C, 6)),
    the Schur complement of the damped point blocks taken out of the
    camera system: S_off[c, d] couples cameras c and d through their
    shared points.  The right-hand side bs sums terms that cancel near a
    minimum (a gradient); bs_abs is the same sum over their absolute
    values, the scale against which an error of bs is judged."""
    C, P = T.shape[0], p.shape[0]
    dt = p.dtype
    ne = normal_equations(cam, T, p, obs_cam, obs_uvr, obs_inv_sigma2, obs_stereo, obs_valid,
                          pt_valid, active, use_huber)
    eye3 = torch.eye(3, dtype=dt, device=p.device)
    Hpp_inv = torch.linalg.inv(damped_points(ne["Hpp"], lam, pt_valid)
                               + (~pt_valid).to(dt)[:, None, None] * eye3)
    Hpp_inv = torch.where(pt_valid[:, None, None], Hpp_inv, 0.0)
    E, B, bp = ne["E"], ne["B"], ne["bp"]
    U = torch.einsum("poc,poik->pcik", E, B @ Hpp_inv[:, None])  # (P, C, 6, 3)
    V = torch.einsum("poc,pojk->pcjk", E, B)
    S_off = (U.permute(1, 2, 0, 3).reshape(C * 6, P * 3)
             @ V.permute(1, 2, 0, 3).reshape(C * 6, P * 3).T)
    bs = ne["bc"] - torch.einsum("pcik,pk->ci", U, bp)
    bs_abs = ne["bc_abs"] + torch.einsum("pcik,pk->ci", U.abs(), ne["bp_abs"])
    return ne["Hcc"], S_off.reshape(C, 6, C, 6).permute(0, 2, 1, 3), bs, bs_abs


def point_residual(ne: dict, lam: float, pt_valid, camc_of, dxc, dxp):
    """The points' rows of the damped step equations, Hpp_d dxp + bp +
    sum_o B^T dxc[cam(o)] = 0, at a given camera step ``dxc`` (C, 6) and
    point step ``dxp`` (P, 3): (the residual's norm over the valid
    points, the norm of the sum of the terms' sizes)."""
    Hd = damped_points(ne["Hpp"], lam, pt_valid)
    dg = dxc[camc_of]  # (P, O, 6)
    cpl = torch.einsum("poij,poi->pj", ne["B"], dg)
    cpl_abs = torch.einsum("poij,poi->pj", ne["B"].abs(), dg.abs())
    r = torch.einsum("pij,pj->pi", Hd, dxp) + ne["bp"] + cpl
    scale = torch.einsum("pij,pj->pi", Hd.abs(), dxp.abs()) + ne["bp_abs"] + cpl_abs
    m = pt_valid[:, None].to(r.dtype)
    return torch.linalg.norm(r * m), torch.linalg.norm(scale * m)


def camera_system(Hcc, S_off, bs, lam: float, free):
    """The damped reduced camera system as one (6C, 6C) matrix and its
    right-hand side, the cameras that do not move (fixed or invalid) held
    by identity rows: the system whose solution x gives the camera step
    dx = -x."""
    C = Hcc.shape[0]
    dt, dev = Hcc.dtype, Hcc.device
    eye6 = torch.eye(6, dtype=dt, device=dev)
    tr6 = torch.diagonal(Hcc, dim1=-2, dim2=-1).sum(-1)
    S = -S_off.clone()
    ar = torch.arange(C, device=dev)
    S[ar, ar] += Hcc + lam * eye6 * torch.clamp(tr6 / 6.0, min=1e-6)[:, None, None]
    fm = free.to(dt)
    S = S * fm[:, None, None, None] * fm[None, :, None, None]
    S[ar, ar] += (1.0 - fm)[:, None, None] * eye6
    return S.permute(0, 2, 1, 3).reshape(C * 6, C * 6), (bs * fm[:, None]).reshape(-1)
