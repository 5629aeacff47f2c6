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
``jax.jacfwd``.  The normal equations are summed per vertex pair
into a dense (7V, 7V) system solved by ``solve_ex``; fixed and invalid
vertices get identity rows.

The sums go in a fixed order (``edge_segments``, ``assemble``): the
edges' blocks are sorted once by their (row, column) vertex pair with a
stable sort, and each pair's blocks are added by a segmented tree scan
over the sorted rows, so a vertex pair's sum has the same bits on every
run and every device.  A float ``index_add_`` on CUDA accumulates with
atomics in an order that changes from run to run, and a loop closure's
every later pose depends on this graph.  The JAX package sums with
``jax.ops.segment_sum``, one result per input.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

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


class EdgeSegments(NamedTuple):
    """The fixed summation order of an edge list (``edge_segments``).

    Row e of the stacked blocks [H_ij; H_ij^T; H_ii; H_jj] (4E rows)
    goes to vertex pair ``key[e]`` = row * V + column; ``order`` is the
    stable sort of the keys, ``same[t]`` marks the sorted rows whose key
    equals the key 2^t rows earlier, and ``dst`` is the pair each sorted
    row writes: its key at the last row of its pair, else V * V (a
    spare row that is dropped)."""

    order: torch.Tensor  # (4E,) int64
    same: Tuple[torch.Tensor, ...]  # (4E - 2^t,) bool per step t
    dst: torch.Tensor  # (4E,) int64


def edge_segments(ic: torch.Tensor, jc: torch.Tensor, V: int) -> EdgeSegments:
    """The summation order of the edges (ic, jc), made once per graph:
    the edge list does not change between iterations.  No host
    synchronisation."""
    key = torch.cat([ic * V + jc, jc * V + ic, ic * (V + 1), jc * (V + 1)])
    order = torch.argsort(key, stable=True)
    k = key[order]
    n = k.shape[0]
    same, s = [], 1
    while s < n:
        same.append(k[s:] == k[:-s])
        s *= 2
    last = torch.ones_like(k, dtype=torch.bool)
    last[:-1] = k[1:] != k[:-1]
    return EdgeSegments(order, tuple(same), torch.where(last, k, V * V))


def assemble(seg: EdgeSegments, Ji, Jj, r, w, V: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """H (V, V, 7, 7) and b (V, 7) of the normal equations, summed per
    vertex pair in ``seg``'s fixed order.  Ji, Jj (E, 7, 7) are the
    residuals' Jacobians in the tangents of vertices i and j, r (E, 7)
    the residuals and w (E,) the edge weights.  b rides in the diagonal
    pairs' rows, so one scan sums both."""
    E = r.shape[0]
    w = w[:, None, None]
    Hij = w * torch.einsum("eci,ecj->eij", Ji, Jj)
    blocks = torch.cat([
        Hij, Hij.transpose(-1, -2),
        w * torch.einsum("eci,ecj->eij", Ji, Ji), w * torch.einsum("eci,ecj->eij", Jj, Jj),
    ]).reshape(4 * E, 49)
    bi = w[:, :, 0] * torch.einsum("eci,ec->ei", Ji, r)
    bj = w[:, :, 0] * torch.einsum("eci,ec->ei", Jj, r)
    rhs = torch.cat([torch.zeros((2 * E, 7), dtype=r.dtype, device=r.device), bi, bj])
    x = torch.cat([blocks, rhs], dim=1)[seg.order]
    s = 1
    for same in seg.same:
        # Inclusive scan within each pair: the rows 2^t back add in only
        # where they carry the same pair (the keys are sorted).
        x[s:] += torch.where(same[:, None], x[:-s], 0.0)
        s *= 2
    out = torch.zeros((V * V + 1, 56), dtype=x.dtype, device=x.device)
    out.index_copy_(0, seg.dst, x)
    out = out[:-1].reshape(V, V, 56)
    ar = torch.arange(V, device=x.device)
    return out[..., :49].reshape(V, V, 7, 7), out[ar, ar, 49:]


def optimize_pose_graph(
    prob: PoseGraphProblem, iters: int = 20, fix_scale: bool = False
) -> torch.Tensor:
    """-> optimized (V,4,4) Sim3 poses after ``iters`` Gauss-Newton steps.
    ``fix_scale`` pins sigma = 0 (stereo/RGB-D, loopClosing.cpp:318)."""
    V = prob.S_iw.shape[0]
    dev = prob.S_iw.device
    ic = torch.clamp(prob.edge_i.to(torch.int64), 0, V - 1)
    jc = torch.clamp(prob.edge_j.to(torch.int64), 0, V - 1)
    seg = edge_segments(ic, jc, V)
    w = prob.edge_valid.to(torch.float32) * prob.edge_weight
    free = prob.vertex_valid & ~prob.fixed
    fm = free.to(torch.float32)
    ar = torch.arange(V, device=dev)
    eye7 = torch.eye(7, device=dev)
    S_all = prob.S_iw
    for _ in range(iters):
        r, Ji, Jj = _edge_jacobians(prob.edge_meas, S_all[ic], S_all[jc], fix_scale)
        H, b = assemble(seg, Ji, Jj, r, w, V)
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
