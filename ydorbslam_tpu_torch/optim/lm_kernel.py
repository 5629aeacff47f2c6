"""K4: the bundle-adjustment observation pass, its plain version and its
dispatcher.

Port of the contract of ``ydorbslam_tpu/optim/lm_kernel.py``
(``lm_obs_pallas``).  One LM iteration's per-observation work —
projection, stereo residuals, Huber weights, the 42 camera
normal-equation columns (36 Hcc + 6 bc), the 18 camera-point coupling
columns and, per point, the 9 Hpp + 3 bp entries and the robustified
cost summed over the point's O observations — from one stacked input:

    inp  (NIN=32, O, P) float32, rows I_* below (rows 27-31 unused)
    outq (NOUT_Q=64, O, P): 36 Hcc (row i*6+j), 6 bc, 18 B (row 42+i*3+k), 4 zero
    outp (NOUT_P=16, P):    9 Hpp (row i*3+j), 3 bp, 1 cost, 3 zero

``lm_obs_plain`` is the XLA body of ``schur._flat_system`` written on
this layout; a CUDA tensor launches ``csrc/lm_obs.cu`` instead
(``ops.kernels.lm_obs_cuda``).  The camera reduction and everything
after it stay in ``optim/schur.py``.
"""
from __future__ import annotations

from typing import Tuple

import torch

CHI2_MONO = 5.991
CHI2_STEREO = 7.815

NIN = 32
(
    I_R00, I_R01, I_R02, I_R10, I_R11, I_R12, I_R20, I_R21, I_R22,
    I_T0, I_T1, I_T2,
    I_X, I_Y, I_Z,
    I_OU, I_OV, I_OR,
    I_IS2, I_STEREO, I_OK, I_HUB,
    I_FX, I_FY, I_CX, I_CY, I_BF,
) = range(27)
NOUT_Q = 64
NOUT_P = 16


def lm_obs_plain(inp: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(32, O, P) -> ((64, O, P), (16, P)); see the module docstring."""
    g = inp
    R = [g[I_R00 + k] for k in range(9)]
    t0, t1, t2 = g[I_T0], g[I_T1], g[I_T2]
    X, Y, Z = g[I_X], g[I_Y], g[I_Z]
    fx, fy, cx, cy, bf = g[I_FX], g[I_FY], g[I_CX], g[I_CY], g[I_BF]

    x = R[0] * X + R[1] * Y + R[2] * Z + t0
    y = R[3] * X + R[4] * Y + R[5] * Z + t1
    zr = R[6] * X + R[7] * Y + R[8] * Z + t2
    z = torch.clamp(zr, min=1e-6)
    iz = 1.0 / z
    u = fx * x * iz + cx
    v = fy * y * iz + cy
    ur = u - bf * iz
    ru = g[I_OU] - u
    rv = g[I_OV] - v
    rr = g[I_OR] - ur

    mask = g[I_OK] * (zr > 1e-3).to(torch.float32)
    wu0 = g[I_IS2] * mask
    stereo = g[I_STEREO]
    wr0 = wu0 * stereo
    chi2 = ru * ru * wu0 + rv * rv * wu0 + rr * rr * wr0
    one = torch.ones_like(chi2)
    delta2 = torch.where(stereo > 0.5, CHI2_STEREO * one, CHI2_MONO * one)
    use_huber = g[I_HUB] > 0.5
    s = torch.sqrt(torch.clamp(chi2, min=1e-12))
    d = torch.sqrt(delta2)
    rho = torch.where(chi2 <= delta2, chi2, 2.0 * d * s - delta2)
    cost_terms = torch.where(use_huber, rho, chi2) * mask
    hub = torch.where(
        use_huber & (chi2 > delta2),
        torch.sqrt(delta2 / torch.clamp(chi2, min=1e-12)),
        one,
    )
    wu = wu0 * hub
    wr = wr0 * hub

    iz2 = iz * iz
    a = fx * iz
    c3 = -fx * x * iz2
    dd = fy * iz
    e = -fy * y * iz2
    cr = c3 + bf * iz2
    zero = torch.zeros_like(a)
    Ju = (-a, zero, -c3, -c3 * y, -(a * z - c3 * x), a * y)
    Jv = (zero, -dd, -e, -(-dd * z + e * y), e * x, -dd * x)
    Jr = (-a, zero, -cr, -cr * y, -(a * z - cr * x), a * y)
    Pu = tuple(-(a * R[j] + c3 * R[6 + j]) for j in range(3))
    Pv = tuple(-(dd * R[3 + j] + e * R[6 + j]) for j in range(3))
    Pr = tuple(-(a * R[j] + cr * R[6 + j]) for j in range(3))
    Jc = tuple(zip(Ju, Jv, Jr))
    Jp = tuple(zip(Pu, Pv, Pr))
    rrow = (ru, rv, rr)

    def rowsum(Ai, Bj):
        return wu * Ai[0] * Bj[0] + wu * Ai[1] * Bj[1] + wr * Ai[2] * Bj[2]

    cols = [rowsum(Jc[i], Jc[j]) for i in range(6) for j in range(6)]
    cols += [rowsum(Jc[i], rrow) for i in range(6)]
    cols += [rowsum(Jc[i], Jp[k]) for i in range(6) for k in range(3)]
    cols += [zero] * (NOUT_Q - len(cols))
    pts = [rowsum(Jp[i], Jp[j]).sum(0) for i in range(3) for j in range(3)]
    pts += [rowsum(Jp[i], rrow).sum(0) for i in range(3)]
    pts.append(cost_terms.sum(0))
    pts += [zero[0]] * (NOUT_P - len(pts))
    return torch.stack(cols, 0), torch.stack(pts, 0)


def lm_obs(inp: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 dispatcher: a CUDA tensor launches the CUDA kernel (or raises),
    a CPU tensor takes ``lm_obs_plain``."""
    if inp.is_cuda:
        from ..ops.kernels import lm_obs_cuda

        return lm_obs_cuda(inp)
    if inp.device.type != "cpu":
        raise ValueError(f"lm_obs: unsupported device {inp.device}")
    return lm_obs_plain(inp)
