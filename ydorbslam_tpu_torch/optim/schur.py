"""Bundle adjustment by Levenberg-Marquardt with a Schur complement.

Port of the local-BA path of ``ydorbslam_tpu/optim/schur.py``
(``bundle_adjust`` -> ``lm_solve`` -> ``_flat_system`` / ``_flat_step``)
and of global BA's chunk (``_lm_chunk``, loop closing's step):
observations are grouped by point into fixed (P, O) slots and flattened
o-major (q = o * P + p); each LM iteration makes one observation pass
(K4, ``optim.lm_kernel.lm_obs``, on every device), marginalises the
points with closed-form 3x3 inverses, and solves the (6C, 6C) reduced
camera system by Cholesky.

The camera reductions use the one-hot observation -> camera incidence
as matrix products, as the JAX package does.  A float ``index_add_`` on
CUDA accumulates with atomics in an order that changes from run to run;
the products keep every run of the port reproducible.  The accept /
reject decision, the damping and the step sanitising stay on the device:
the whole solve makes no host synchronisation.

A Cholesky factorisation that fails (``info != 0``, the matrix is not
positive definite) gives a zero camera step, as the NaN factor of
``jax.lax.linalg.cholesky`` does through the JAX package's
``isfinite`` guard; the input is symmetrised first, as JAX does.

With ``group`` (a ``parallel.multihost.ShardGroup``) the point axis of
the problem is this rank's block of it (``parallel/ba_sharded.py``): the
camera reductions (``red``, the cost, ``S_off`` and the reduced rhs's
point term) are summed over the group's ranks where the JAX package
calls ``psum``, and every rank solves the same camera system.  With
``group=None`` nothing is reduced and the dense results are unchanged.

The vmapped-style reference of one damped step (``_per_obs``,
``_weights``, ``_lm_iteration``, solved by block-Jacobi PCG
``_pcg_solve_blocks``) and ``ba_cost_and_chi2`` are ported too: the
point-sharded BA step runs on them, as the JAX package's does.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import torch

from ..geometry.camera import CameraIntrinsics
from ..geometry.se3 import se3_exp
from ..parallel.multihost import all_reduce
from .lm_kernel import NIN, lm_obs
from .residuals import chi2_per_obs, huber_cost, huber_scale, residual_and_jacobians

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class BAProblem(NamedTuple):
    """Point-grouped BA problem with static capacities C cameras,
    P points, O observations per point."""

    T_cw: torch.Tensor  # (C,4,4)
    cam_fixed: torch.Tensor  # (C,) bool, gauge/observer cameras
    cam_valid: torch.Tensor  # (C,) bool
    p_w: torch.Tensor  # (P,3)
    pt_valid: torch.Tensor  # (P,) bool
    obs_cam: torch.Tensor  # (P,O) i32 camera index or -1
    obs_uvr: torch.Tensor  # (P,O,3)
    obs_inv_sigma2: torch.Tensor  # (P,O)
    obs_stereo: torch.Tensor  # (P,O) bool
    obs_valid: torch.Tensor  # (P,O) bool

    @property
    def C(self) -> int:
        return self.T_cw.shape[0]

    @property
    def P(self) -> int:
        return self.p_w.shape[0]

    @property
    def O(self) -> int:
        return self.obs_cam.shape[1]


def inv3x3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate / det), the JAX
    package's formula."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-12, det, torch.full_like(det, 1e-12))
    adj = torch.stack(
        [
            torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1),
            torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1),
            torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1),
        ],
        dim=-2,
    )
    return adj * inv_det[..., None, None]


def inv6x6_blocked(M: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 6x6 inverse by 2x2 block elimination of 3x3
    blocks, each inverted with ``inv3x3``:

        M = [[A, B], [C, D]],  S = D - C A^-1 B
        M^-1 = [[A^-1 + A^-1 B S^-1 C A^-1, -A^-1 B S^-1],
                [-S^-1 C A^-1,               S^-1]]
    """
    A = M[..., :3, :3]
    B = M[..., :3, 3:]
    Cb = M[..., 3:, :3]
    D = M[..., 3:, 3:]
    Ainv = inv3x3(A)
    AinvB = Ainv @ B
    Sinv = inv3x3(D - Cb @ AinvB)
    CAinv = Cb @ Ainv
    top = torch.cat([Ainv + AinvB @ Sinv @ CAinv, -AinvB @ Sinv], dim=-1)
    bot = torch.cat([-Sinv @ CAinv, Sinv], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _pcg_solve_blocks(S: torch.Tensor, b: torch.Tensor, iters: int = 128) -> torch.Tensor:
    """Solve S x = b for block-structured S (C,C,6,6), b (C,6) by
    block-Jacobi preconditioned conjugate gradients: ``iters`` fixed
    iterations, the 6x6 diagonal blocks as the preconditioner, each
    division guarded on the device (no host read)."""
    C = S.shape[0]
    ar = torch.arange(C, device=S.device)
    eye6 = torch.eye(6, dtype=S.dtype, device=S.device)
    Minv = inv6x6_blocked(S[ar, ar] + 1e-5 * eye6)

    def matvec(x):
        return torch.einsum("cdij,dj->ci", S, x)

    def precond(r):
        return torch.einsum("cij,cj->ci", Minv, r)

    def guard(d):
        return torch.where(torch.abs(d) > 1e-20, d, torch.full_like(d, 1e-20))

    x = torch.zeros_like(b)
    r = b - matvec(x)
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    for _ in range(iters):
        Ap = matvec(p)
        alpha = rz / guard(torch.sum(p * Ap))
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = torch.sum(r * z)
        p = z + rz_new / guard(rz) * p
        rz = rz_new
    return x


def _cholesky_solve_blocks(S: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve S x = b for block-structured S (C,C,6,6), b (C,6) by dense
    Cholesky of the symmetrised (6C, 6C) system; a failed factorisation
    gives x = 0 (decided on the device)."""
    C = S.shape[0]
    D = C * 6
    M = S.permute(0, 2, 1, 3).reshape(D, D)
    M = 0.5 * (M + M.T)
    L, info = torch.linalg.cholesky_ex(M)
    y = torch.linalg.solve_triangular(L, b.reshape(D, 1), upper=False)
    x = torch.linalg.solve_triangular(L.T, y, upper=True)
    return torch.where(info == 0, x, torch.zeros_like(x)).reshape(C, 6)


def _sanitize(d: torch.Tensor) -> torch.Tensor:
    """Zero the rows of a step that are not finite or longer than 1e3
    (a breakdown of the solve, a near-singular point block): the LM's
    accept/reject compares costs and cannot veto a NaN."""
    d = torch.where(torch.isfinite(d), d, 0.0)
    return torch.where(torch.linalg.norm(d, dim=-1, keepdim=True) < 1e3, d, 0.0)


def _camera_step(prob: BAProblem, Hcc, S_off, bs, lam, solve):
    """The damped reduced camera system S = diag(Hcc + damping) - S_off
    with the gauge (fixed and invalid cameras) masked to identity rows,
    solved by ``solve(S, bs)``: returns (dxc (C,6) sanitised, free (C,))."""
    C = prob.C
    dev = Hcc.device
    eye6 = torch.eye(6, device=dev)
    tr6 = torch.diagonal(Hcc, dim1=-2, dim2=-1).sum(-1)
    Hcc_d = Hcc + lam * eye6 * torch.clamp(tr6[:, None, None] / 6.0, min=1e-6)
    ar = torch.arange(C, device=dev)
    S = -S_off
    S[ar, ar] = S[ar, ar] + Hcc_d
    free = prob.cam_valid & ~prob.cam_fixed
    fmask = free.to(torch.float32)
    S = S * fmask[:, None, None, None] * fmask[None, :, None, None]
    S[ar, ar] = S[ar, ar] + (1.0 - fmask)[:, None, None] * eye6
    return _sanitize(-solve(S, bs * fmask[:, None])), free


def _per_obs(cam: CameraIntrinsics, T_all, p_w, prob: BAProblem):
    """Residuals and Jacobians over the (P, O) observation grid:
    (r (P,O,3), J_cam (P,O,3,6), J_pt (P,O,3,3), z (P,O))."""
    camc = torch.clamp(prob.obs_cam.to(torch.int64), 0, prob.C - 1)
    return residual_and_jacobians(cam, T_all[camc], p_w[:, None, :], prob.obs_uvr)


def _weights(prob: BAProblem, z, active):
    """Per-component weights (P,O,3), masked, and the observation mask."""
    keep = torch.stack([torch.ones_like(prob.obs_stereo)] * 2 + [prob.obs_stereo], dim=-1)
    w3 = torch.where(keep, prob.obs_inv_sigma2[..., None], 0.0)
    mask = active & prob.obs_valid & (prob.obs_cam >= 0) & prob.pt_valid[:, None] & (z > 1e-3)
    return w3 * mask[..., None].to(torch.float32), mask


def ba_cost_and_chi2(cam, T_all, p_w, prob: BAProblem, active, use_huber: bool):
    """(total robustified or raw cost, chi2 (P,O), mask (P,O))."""
    r, _, _, z = _per_obs(cam, T_all, p_w, prob)
    w3, mask = _weights(prob, z, active)
    chi2 = chi2_per_obs(r, w3)
    cost = huber_cost(chi2, _delta2(prob.obs_stereo)) if use_huber else chi2
    return torch.sum(cost * mask.to(torch.float32)), chi2, mask


def _lm_iteration(cam, T_all, p_w, prob: BAProblem, active, lam, use_huber: bool, group=None):
    """One damped step on the (P, O) grid, solved by ``_pcg_solve_blocks``:
    returns (T_new, p_new).  The camera sums are one-hot incidence
    products (``E``), the Schur coupling one ``Um @ Vm.T`` product; with
    ``group`` they are summed over its ranks (``parallel.ba_sharded.
    sharded_ba_step``)."""
    C, P, O = prob.C, prob.P, prob.O
    dev = p_w.device
    r, Jc, Jp, z = _per_obs(cam, T_all, p_w, prob)
    w3, mask = _weights(prob, z, active)
    chi2 = chi2_per_obs(r, w3)
    if use_huber:
        w3 = w3 * huber_scale(chi2, _delta2(prob.obs_stereo))[..., None]
    Hpp = torch.einsum("poci,poc,pocj->pij", Jp, w3, Jp)
    bp = torch.einsum("poci,poc,poc->pi", Jp, w3, r)
    tr3 = torch.diagonal(Hpp, dim1=-2, dim2=-1).sum(-1)
    Hpp_inv = inv3x3(Hpp + lam * torch.eye(3, device=dev)
                     * torch.clamp(tr3[:, None, None] / 3.0, min=1e-6))
    Hpp_inv = torch.where(~prob.pt_valid[:, None, None], 0.0, Hpp_inv)

    camc = torch.clamp(prob.obs_cam.to(torch.int64), 0, C - 1)
    E = ((camc[..., None] == torch.arange(C, device=dev)) & (prob.obs_cam >= 0)[..., None]).to(
        torch.float32)  # (P,O,C)
    Hcc = all_reduce(torch.einsum("poc,poij->cij", E,
                                  torch.einsum("poci,poc,pocj->poij", Jc, w3, Jc)), group)
    bc = all_reduce(torch.einsum("poc,poi->ci", E,
                                 torch.einsum("poci,poc,poc->poi", Jc, w3, r)), group)
    B = torch.einsum("poci,poc,pocj->poij", Jc, w3, Jp)  # (P,O,6,3)
    U = torch.einsum("poc,poik->pcik", E, B @ Hpp_inv[:, None])  # (P,C,6,3)
    V = torch.einsum("poc,pojk->pcjk", E, B)
    Um = U.permute(1, 2, 0, 3).reshape(C * 6, P * 3)
    Vm = V.permute(1, 2, 0, 3).reshape(C * 6, P * 3)
    S_off = all_reduce(Um @ Vm.T, group).reshape(C, 6, C, 6).permute(0, 2, 1, 3)
    bs = bc - all_reduce(torch.einsum("pcik,pk->ci", U, bp), group)

    dxc, free = _camera_step(prob, Hcc, S_off, bs, lam, _pcg_solve_blocks)
    corr = torch.einsum("poij,poi->pj", B, dxc[camc])
    dxp = _sanitize(-torch.einsum("pij,pj->pi", Hpp_inv, bp + corr))
    T_new = torch.where(free[:, None, None], se3_exp(dxc) @ T_all, T_all)
    p_new = torch.where(prob.pt_valid[:, None], p_w + dxp, p_w)
    return T_new, p_new


def _po_flat(a: torch.Tensor) -> torch.Tensor:
    """(P, O, ...) -> (Q, ...) in o-major order (q = o * P + p)."""
    return a.transpose(0, 1).reshape((-1,) + tuple(a.shape[2:]))


def _po_unflat(q: torch.Tensor, P: int, O: int) -> torch.Tensor:
    """(Q, ...) o-major -> (P, O, ...)."""
    return q.reshape((O, P) + tuple(q.shape[1:])).transpose(0, 1)


class _FlatObs(NamedTuple):
    """Loop-invariant flattened observation data (Q = P*O, o-major)."""

    cam_idx: torch.Tensor  # (Q,) clipped camera index
    p_idx: torch.Tensor  # (Q,) point index
    obs_u: torch.Tensor  # (Q,)
    obs_v: torch.Tensor  # (Q,)
    obs_r: torch.Tensor  # (Q,)
    inv_s2: torch.Tensor  # (Q,)
    stereo: torch.Tensor  # (Q,) bool
    base_ok: torch.Tensor  # (Q,) bool: obs_valid & cam>=0 & pt_valid
    E: torch.Tensor  # (Q, C) one-hot obs -> camera incidence (f32)


def _flatten_obs(prob: BAProblem) -> _FlatObs:
    C, P, O = prob.C, prob.P, prob.O
    dev = prob.p_w.device
    cam_f = _po_flat(prob.obs_cam)
    camc = torch.clamp(cam_f.to(torch.int64), 0, C - 1)
    ok = (cam_f >= 0) & _po_flat(prob.obs_valid) & prob.pt_valid.repeat(O)
    E = (
        (camc[:, None] == torch.arange(C, device=dev)[None, :]) & ok[:, None]
    ).to(torch.float32)
    uvr = _po_flat(prob.obs_uvr)
    return _FlatObs(
        cam_idx=camc,
        p_idx=torch.arange(P, device=dev).repeat(O),
        obs_u=uvr[:, 0],
        obs_v=uvr[:, 1],
        obs_r=uvr[:, 2],
        inv_s2=_po_flat(prob.obs_inv_sigma2),
        stereo=_po_flat(prob.obs_stereo),
        base_ok=ok,
        E=E,
    )


def _flat_project(cam: CameraIntrinsics, T_all, p_w, f: _FlatObs):
    """Componentwise projection at every observation: (Q,) tensors."""
    Tf = T_all.reshape(T_all.shape[0], 16)[f.cam_idx]
    R00, R01, R02, t0 = Tf[:, 0], Tf[:, 1], Tf[:, 2], Tf[:, 3]
    R10, R11, R12, t1 = Tf[:, 4], Tf[:, 5], Tf[:, 6], Tf[:, 7]
    R20, R21, R22, t2 = Tf[:, 8], Tf[:, 9], Tf[:, 10], Tf[:, 11]
    pw = p_w[f.p_idx]
    X, Y, Z = pw[:, 0], pw[:, 1], pw[:, 2]
    x = R00 * X + R01 * Y + R02 * Z + t0
    y = R10 * X + R11 * Y + R12 * Z + t1
    zr = R20 * X + R21 * Y + R22 * Z + t2
    z = torch.clamp(zr, min=1e-6)
    iz = 1.0 / z
    u = cam.fx * x * iz + cam.cx
    v = cam.fy * y * iz + cam.cy
    ur = u - cam.bf * iz
    return dict(
        x=x, y=y, z=z, zr=zr, iz=iz,
        ru=f.obs_u - u, rv=f.obs_v - v, rr=f.obs_r - ur,
    )


def _flat_weights(f: _FlatObs, zr, active_flat):
    """Per-component weights (wu, wv, wr) and the scalar obs mask."""
    mask = f.base_ok & active_flat & (zr > 1e-3)
    mf = mask.to(torch.float32)
    wu = f.inv_s2 * mf
    wr = wu * f.stereo.to(torch.float32)
    return wu, wu, wr, mask


def _flat_chi2(pr, wu, wv, wr):
    return pr["ru"] ** 2 * wu + pr["rv"] ** 2 * wv + pr["rr"] ** 2 * wr


def _delta2(stereo: torch.Tensor) -> torch.Tensor:
    one = torch.ones(stereo.shape, dtype=torch.float32, device=stereo.device)
    return torch.where(stereo, CHI2_STEREO * one, CHI2_MONO * one)


def _flat_cost(cam, T_all, p_w, f: _FlatObs, active_flat, use_huber: bool, group=None):
    """Total robustified cost (residual-only pass), summed over
    ``group``'s ranks when the points are sharded."""
    pr = _flat_project(cam, T_all, p_w, f)
    wu, wv, wr, mask = _flat_weights(f, pr["zr"], active_flat)
    chi2 = _flat_chi2(pr, wu, wv, wr)
    cost = huber_cost(chi2, _delta2(f.stereo)) if use_huber else chi2
    return all_reduce(torch.sum(cost * mask.to(torch.float32)), group)


class _FlatSystem(NamedTuple):
    """Normal-equation pieces of one state, carried across LM iterations
    (a rejected step re-solves from the cached system)."""

    red: torch.Tensor  # (C,42) camera blocks [Hcc 36 | bc 6]
    Hpp: torch.Tensor  # (P,3,3)
    bp: torch.Tensor  # (P,3)
    Bq: torch.Tensor  # (18,Q) coupling columns B[i][k] at row i*3+k
    cost: torch.Tensor  # () robustified total


def _flat_system(
    cam: CameraIntrinsics, T_all, p_w, prob: BAProblem, f: _FlatObs, active_flat,
    use_huber: bool, group=None,
) -> _FlatSystem:
    """One observation pass at (T_all, p_w) through K4: camera and point
    normal equations, coupling columns and robustified cost; ``red`` and
    the cost summed over ``group``'s ranks when the points are sharded."""
    C, P, O = prob.C, prob.P, prob.O
    Q = O * P
    dev = p_w.device
    one = torch.ones((Q,), dtype=torch.float32, device=dev)
    inp = torch.cat(
        [
            T_all[:, :3, :3].reshape(C, 9)[f.cam_idx].T,  # R row-major
            T_all[:, :3, 3][f.cam_idx].T,
            p_w[f.p_idx].T,
            torch.stack([
                f.obs_u, f.obs_v, f.obs_r, f.inv_s2,
                f.stereo.to(torch.float32),
                (f.base_ok & active_flat).to(torch.float32),
                (1.0 if use_huber else 0.0) * one,
                cam.fx * one, cam.fy * one, cam.cx * one, cam.cy * one, cam.bf * one,
            ]),
            torch.zeros((NIN - 27, Q), dtype=torch.float32, device=dev),
        ],
        0,
    ).reshape(NIN, O, P)
    outq, outp = lm_obs(inp)
    red = all_reduce(outq[:42].reshape(42, Q) @ f.E, group)  # (42, C)
    return _FlatSystem(
        red=red.T,
        Hpp=outp[:9].T.reshape(P, 3, 3),
        bp=outp[9:12].T,
        Bq=outq[42:60].reshape(18, Q),
        cost=all_reduce(torch.sum(outp[12]), group),
    )


def _flat_step(cam, prob: BAProblem, f: _FlatObs, sys: _FlatSystem, T_all, p_w, lam,
               group=None):
    """Solve one damped step from a cached normal-equation system; the
    Schur off-diagonal and the reduced rhs's point term are summed over
    ``group``'s ranks when the points are sharded."""
    C, P, O = prob.C, prob.P, prob.O
    dev = p_w.device

    def osum(q):
        return torch.sum(q.reshape(O, P), dim=0)

    eye3 = torch.eye(3, device=dev)
    Hcc = sys.red[:, :36].reshape(C, 6, 6)
    bc = sys.red[:, 36:42]
    bp = sys.bp
    tr3 = torch.diagonal(sys.Hpp, dim1=-2, dim2=-1).sum(-1)
    Hpp_d = sys.Hpp + lam * eye3 * torch.clamp(tr3[:, None, None] / 3.0, min=1e-6)
    Hpp_inv = inv3x3(Hpp_d)
    Hpp_inv = torch.where(~prob.pt_valid[:, None, None], 0.0, Hpp_inv)

    Bc = [[sys.Bq[i * 3 + k] for k in range(3)] for i in range(6)]
    Hgf = Hpp_inv.reshape(P, 9)[f.p_idx]  # (Q,9)
    Hg = [[Hgf[:, 3 * j + k] for k in range(3)] for j in range(3)]
    BH = [
        [Bc[i][0] * Hg[0][k] + Bc[i][1] * Hg[1][k] + Bc[i][2] * Hg[2][k] for k in range(3)]
        for i in range(6)
    ]
    B_stack = torch.stack([torch.stack(Bc[i], -1) for i in range(6)], -2).reshape(O, P, 6, 3)
    BH_stack = torch.stack([torch.stack(BH[i], -1) for i in range(6)], -2).reshape(O, P, 6, 3)
    E_po = f.E.reshape(O, P, C)
    U = torch.einsum("opc,opik->pcik", E_po, BH_stack)  # (P,C,6,3)
    V = torch.einsum("opc,opjk->pcjk", E_po, B_stack)
    Um = U.permute(1, 2, 0, 3).reshape(C * 6, P * 3)
    Vm = V.permute(1, 2, 0, 3).reshape(C * 6, P * 3)
    S_off = all_reduce(Um @ Vm.T, group).reshape(C, 6, C, 6).permute(0, 2, 1, 3)
    corr_cam = all_reduce(torch.einsum("pcik,pk->ci", U, bp), group)
    dxc, free = _camera_step(prob, Hcc, S_off, bc - corr_cam, lam, _cholesky_solve_blocks)

    dg = dxc[f.cam_idx]  # (Q,6)
    corr = torch.stack(
        [osum(sum(Bc[i][k] * dg[:, i] for i in range(6))) for k in range(3)], -1
    )
    dxp = _sanitize(-torch.einsum("pij,pj->pi", Hpp_inv, bp + corr))

    T_new = se3_exp(dxc) @ T_all
    T_new = torch.where(free[:, None, None], T_new, T_all)
    p_new = torch.where(prob.pt_valid[:, None], p_w + dxp, p_w)
    return T_new, p_new


def lm_solve(
    cam: CameraIntrinsics,
    prob: BAProblem,
    iters: int,
    use_huber: bool,
    active: torch.Tensor,
    lam0: Union[float, torch.Tensor] = 1e-4,
    group=None,
):
    """Fixed-iteration LM with accept/reject damping: one observation
    pass per iteration (the candidate's system pass carries its cost,
    which is the accept/reject test).  ``lam0`` is the starting damping:
    a float, or a 0-dim tensor that carries the damping of an earlier
    chunk.  With ``group`` the problem's points are this rank's block
    and the returned ``p`` is that block; the cost that decides each
    step is the group's sum, so every rank takes the same branch.
    Returns (T, p, cost, lam)."""
    dev = prob.p_w.device
    f = _flatten_obs(prob)
    active_flat = _po_flat(active)

    def system(T, p):
        return _flat_system(cam, T, p, prob, f, active_flat, use_huber, group)

    sysc = system(prob.T_cw, prob.p_w)
    T, p, cost = prob.T_cw, prob.p_w, sysc.cost
    lam = lam0 if isinstance(lam0, torch.Tensor) else torch.full(
        (), lam0, dtype=torch.float32, device=dev)
    for _ in range(iters):
        T_new, p_new = _flat_step(cam, prob, f, sysc, T, p, lam, group)
        sys_new = system(T_new, p_new)
        accept = sys_new.cost < cost
        T = torch.where(accept, T_new, T)
        p = torch.where(accept, p_new, p)
        sysc = _FlatSystem(*(torch.where(accept, a, b) for a, b in zip(sys_new, sysc)))
        lam = torch.where(
            accept, torch.clamp(lam * 0.5, min=1e-8), torch.clamp(lam * 5.0, max=1e6)
        )
        cost = torch.where(accept, sys_new.cost, cost)
    return T, p, cost, lam


def bundle_adjust(
    cam: CameraIntrinsics,
    prob: BAProblem,
    iters1: int = 5,
    iters2: int = 10,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference local-BA protocol (optimizer.cpp:287-314): ``iters1``
    robust iterations, demote chi2-outlier observations, ``iters2``
    non-robust iterations, final outlier classification.  ``iters1=0``
    runs one robust phase (the global-BA form).

    Returns (T_cw (C,4,4), p_w (P,3), obs_outlier (P,O) bool)."""
    active0 = prob.obs_valid
    delta2 = _delta2(prob.obs_stereo)
    f = _flatten_obs(prob)
    af0 = _po_flat(active0)

    def flat_chi2_mask(T, p):
        pr = _flat_project(cam, T, p, f)
        wu, wv, wr, mask = _flat_weights(f, pr["zr"], af0)
        chi2 = _flat_chi2(pr, wu, wv, wr)
        return _po_unflat(chi2, prob.P, prob.O), _po_unflat(mask, prob.P, prob.O)

    if iters1 > 0:
        T, p, _, _ = lm_solve(cam, prob, iters1, True, active0)
        chi2, mask = flat_chi2_mask(T, p)
        inlier = mask & (chi2 <= delta2)
        T, p, _, _ = lm_solve(cam, prob._replace(T_cw=T, p_w=p), iters2, False, inlier)
    else:
        T, p, _, _ = lm_solve(cam, prob, iters2, True, active0)
    chi2, mask = flat_chi2_mask(T, p)
    return T, p, mask & (chi2 > delta2)


def _lm_chunk(cam: CameraIntrinsics, prob: BAProblem, T, p, lam, chunk: int = 5):
    """``chunk`` robust LM iterations from (T, p) carrying the damping
    ``lam``: one step of the global BA that loop closing advances per
    keyframe.  Returns (T, p, lam)."""
    T_new, p_new, _, lam_new = lm_solve(
        cam, prob._replace(T_cw=T, p_w=p), chunk, True, prob.obs_valid, lam0=lam
    )
    return T_new, p_new, lam_new
