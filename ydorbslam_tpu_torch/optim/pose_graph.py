"""Sim3 pose-graph optimization (the essential graph), torch.

Port of ``ydorbslam_tpu/optim/pose_graph.py``, the replacement of
``Optimizer::optimizeEssentialGraph`` (src/optimizer.cpp:502-661):
vertices are per-keyframe Sim3 poses, edges are spanning-tree links,
loop edges and strong covisibility pairs, and the residual of edge
(i, j) with measurement S_ij is

    e = log_sim3( S_meas @ S_j @ S_i^-1 )    (7-vector)

under left-multiplied tangent perturbations of S_i and S_j.  The
per-edge Jacobians come from the residual of every edge at all 14
central-difference perturbations, in one float64 batch each for i and j
(``geometry.sim3.tangent_jacobian``); the JAX package takes them with
``jax.jacfwd``.  The normal equations are summed per vertex
and per vertex pair with ``index_add_`` into a dense (7V, 7V) system
solved by ``solve_ex``; fixed and invalid vertices get identity rows.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.sim3 import inv_S, sim3_exp, sim3_log, tangent_jacobian


class PoseGraphProblem(NamedTuple):
    S_iw: torch.Tensor  # (V,4,4) current Sim3 keyframe poses (world->kf)
    fixed: torch.Tensor  # (V,) bool
    vertex_valid: torch.Tensor  # (V,) bool
    edge_i: torch.Tensor  # (E,) int
    edge_j: torch.Tensor  # (E,) int
    edge_meas: torch.Tensor  # (E,4,4) S_i_meas @ S_j_meas^-1
    edge_valid: torch.Tensor  # (E,) bool
    edge_weight: torch.Tensor  # (E,) f32 information scale


def _edge_residual(S_meas, S_i, S_j, eps_i, eps_j, fix_scale: bool):
    """(..., E, 7) residuals of edges perturbed by tangents eps_i, eps_j
    (..., E, 7)."""
    if fix_scale:
        keep = (torch.arange(7, device=eps_i.device) < 6).to(eps_i.dtype)
        eps_i, eps_j = eps_i * keep, eps_j * keep
    Si = sim3_exp(eps_i) @ S_i
    Sj = sim3_exp(eps_j) @ S_j
    return sim3_log(S_meas @ Sj @ inv_S(Si))


def _edge_jacobians(S_meas, S_i, S_j, fix_scale: bool):
    """Residuals (E,7) and Jacobians (E,7,7) in eps_i and eps_j at 0."""
    E = S_meas.shape[0]
    dev = S_meas.device
    zeros = torch.zeros((E, 7), device=dev)
    r = _edge_residual(S_meas, S_i, S_j, zeros, zeros, fix_scale)
    m64, i64, j64 = (x.to(torch.float64) for x in (S_meas, S_i, S_j))
    z64 = zeros.to(torch.float64)
    Ji = tangent_jacobian(lambda e: _edge_residual(m64, i64, j64, e, z64, fix_scale), (E,), dev)
    Jj = tangent_jacobian(lambda e: _edge_residual(m64, i64, j64, z64, e, fix_scale), (E,), dev)
    return r, Ji, Jj


def optimize_pose_graph(
    prob: PoseGraphProblem, iters: int = 20, fix_scale: bool = False
) -> torch.Tensor:
    """-> optimized (V,4,4) Sim3 poses after ``iters`` Gauss-Newton steps.
    ``fix_scale`` pins sigma = 0 (stereo/RGB-D, loopClosing.cpp:318)."""
    V = prob.S_iw.shape[0]
    dev = prob.S_iw.device
    ic = torch.clamp(prob.edge_i.to(torch.int64), 0, V - 1)
    jc = torch.clamp(prob.edge_j.to(torch.int64), 0, V - 1)
    w = (prob.edge_valid.to(torch.float32) * prob.edge_weight)[:, None, None]
    free = prob.vertex_valid & ~prob.fixed
    fm = free.to(torch.float32)
    ar = torch.arange(V, device=dev)
    eye7 = torch.eye(7, device=dev)
    S_all = prob.S_iw
    for _ in range(iters):
        r, Ji, Jj = _edge_jacobians(prob.edge_meas, S_all[ic], S_all[jc], fix_scale)
        Hij = w * torch.einsum("eci,ecj->eij", Ji, Jj)
        H_off = torch.zeros((V * V, 7, 7), device=dev)
        H_off.index_add_(0, ic * V + jc, Hij)
        H_off.index_add_(0, jc * V + ic, Hij.transpose(-1, -2))
        H_diag = torch.zeros((V, 7, 7), device=dev)
        H_diag.index_add_(0, ic, w * torch.einsum("eci,ecj->eij", Ji, Ji))
        H_diag.index_add_(0, jc, w * torch.einsum("eci,ecj->eij", Jj, Jj))
        b = torch.zeros((V, 7), device=dev)
        b.index_add_(0, ic, w[:, :, 0] * torch.einsum("eci,ec->ei", Ji, r))
        b.index_add_(0, jc, w[:, :, 0] * torch.einsum("eci,ec->ei", Jj, r))
        H = H_off.reshape(V, V, 7, 7)
        H[ar, ar] += H_diag
        H = H * fm[:, None, None, None] * fm[None, :, None, None]
        H[ar, ar] += torch.where(free, 1e-6, 1.0)[:, None, None] * eye7
        b = b * fm[:, None]
        Hd = H.permute(0, 2, 1, 3).reshape(V * 7, V * 7)
        dx = -torch.linalg.solve_ex(Hd, b.reshape(-1))[0].reshape(V, 7)
        if fix_scale:
            dx = torch.cat([dx[:, :6], torch.zeros_like(dx[:, 6:])], dim=-1)
        S_new = sim3_exp(dx) @ S_all
        S_all = torch.where(free[:, None, None], S_new, S_all)
    return S_all
