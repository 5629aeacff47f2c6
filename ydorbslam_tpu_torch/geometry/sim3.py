"""Sim(3) similarities on torch tensors.

Port of the packing and point-action part of
``ydorbslam_tpu/geometry/sim3.py``: ``make_S``, ``split_S``, ``inv_S`` and
``transform_points_S``, and of its tangent-space maps for loop closing:
``sim3_exp``, ``sim3_log`` (through ``_sim3_W``) and the SE(3)
conversions.  A similarity ``(s, R, t)`` is one (...,4,4) matrix
``S = [[s*R, t], [0, 1]]`` acting on points as ``p' = s R p + t``; a
tangent vector is ``zeta = [rho(3), phi(3), sigma(1)]`` with scale
``s = exp(sigma)``.  Every function broadcasts over leading dimensions
and keeps its input's dtype, so ``tangent_jacobian`` can evaluate a
residual at a whole stack of perturbations in float64 at once.
"""
from __future__ import annotations

import torch

from typing import Callable, Tuple

from .se3 import _EPS, hat, make_T, so3_exp, so3_log

JAC_STEP = 1e-6  # float64 central-difference step of tangent_jacobian


def make_S(s: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Pack scale/rotation/translation into a (...,4,4) similarity matrix."""
    return make_T(s[..., None, None] * R, t)


def split_S(S: torch.Tensor):
    """(...,4,4) -> (s, R, t) with det(R)=+1."""
    sR = S[..., :3, :3]
    d = torch.linalg.det(sR)
    s = torch.sign(d) * torch.abs(d) ** (1.0 / 3.0)  # real cube root
    R = sR / torch.clamp(s[..., None, None], min=_EPS)
    return s, R, S[..., :3, 3]


def inv_S(S: torch.Tensor) -> torch.Tensor:
    """Inverse similarity: (s,R,t)^-1 = (1/s, R^T, -1/s R^T t)."""
    s, R, t = split_S(S)
    s_inv = 1.0 / torch.clamp(s, min=_EPS)
    Rt = R.transpose(-1, -2)
    return make_S(s_inv, Rt, -s_inv[..., None] * (Rt @ t[..., None])[..., 0])


def transform_points_S(S: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a similarity to (...,N,3) points."""
    sR, t = S[..., :3, :3], S[..., :3, 3]
    return pts @ sR.transpose(-1, -2) + t[..., None, :]


def _sim3_W(phi: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """The Sim(3) matrix W with t = W rho for zeta = [rho, phi, sigma]:
    W = A I + B K + C K^2, K = hat(phi), with the JAX package's
    coefficients and its series where sigma or the angle is small."""
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    s = torch.exp(sigma)
    sig_small = torch.abs(sigma) < 1e-5
    th_small = theta2 < 1e-8
    one = torch.ones_like(sigma)
    A = torch.where(sig_small, 1.0 + sigma * 0.5 + sigma * sigma / 6.0,
                    (s - 1.0) / torch.where(sig_small, one, sigma))
    a = s * torch.sin(theta)
    b = s * torch.cos(theta)
    c = theta2 + sigma * sigma
    c_safe = torch.clamp(c, min=_EPS)
    B_gen = (a * sigma + (1.0 - b) * theta) / (torch.clamp(theta, min=_EPS) * c_safe)
    C_gen = (A - ((b - 1.0) * sigma + a * theta) / c_safe) / torch.clamp(theta2, min=_EPS)
    sig2 = sigma * sigma
    B0 = torch.where(sig_small, 0.5 + sigma / 6.0,
                     ((sigma - 1.0) * s + 1.0) / torch.where(sig_small, one, sig2))
    C0 = torch.where(
        sig_small, 1.0 / 6.0 + sigma / 24.0,
        (s * (0.5 * sig2 - sigma + 1.0) - 1.0) / torch.where(sig_small, one, sig2 * sigma),
    )
    B = torch.where(th_small, B0, B_gen)
    C = torch.where(th_small, C0, C_gen)
    K = hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(K.shape)
    return A[..., None, None] * eye + B[..., None, None] * K + C[..., None, None] * (K @ K)


def sim3_exp(zeta: torch.Tensor) -> torch.Tensor:
    """exp: (...,7) [rho, phi, sigma] -> (...,4,4) similarity."""
    rho, phi, sigma = zeta[..., :3], zeta[..., 3:6], zeta[..., 6]
    t = (_sim3_W(phi, sigma) @ rho[..., None])[..., 0]
    return make_S(torch.exp(sigma), so3_exp(phi), t)


def sim3_log(S: torch.Tensor) -> torch.Tensor:
    """log: (...,4,4) similarity -> (...,7) [rho, phi, sigma].  The solve
    with W is ``solve_ex``: no host check of its result."""
    s, R, t = split_S(S)
    sigma = torch.log(torch.clamp(s, min=_EPS))
    phi = so3_log(R)
    rho = torch.linalg.solve_ex(_sim3_W(phi, sigma), t[..., None])[0][..., 0]
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)


def sim3_to_se3(S: torch.Tensor) -> torch.Tensor:
    """Drop the scale: (s, R, t) -> (R, t / s), the essential graph's
    recovery step (optimizer.cpp:630-661)."""
    s, R, t = split_S(S)
    return make_T(R, t / torch.clamp(s[..., None], min=_EPS))


def tangent_jacobian(f: Callable[[torch.Tensor], torch.Tensor], batch: Tuple[int, ...],
                     device, n: int = 7, h: float = JAC_STEP) -> torch.Tensor:
    """Jacobian at a zero tangent of a residual ``f`` that maps float64
    tangents (2n, *batch, n) to float64 residuals (2n, *batch, R), by
    central differences along each of the n directions, all evaluated in
    one batched call.  In float64 with h = 1e-6 the difference is within
    ~1e-10 relative of the derivative (truncation h^2, rounding 1e-16/h),
    under the float32 rounding of the JAX package's ``jax.jacfwd``; g2o,
    the reference's solver, takes its Sim3 edges' Jacobians numerically
    too.  Returns (*batch, R, n) float32."""
    eye = torch.eye(n, dtype=torch.float64, device=device) * h
    steps = torch.cat([eye, -eye]).reshape((2 * n,) + (1,) * len(batch) + (n,))
    out = f(steps.expand((2 * n,) + tuple(batch) + (n,)))
    J = (out[:n] - out[n:]) / (2.0 * h)  # (n, *batch, R)
    return J.movedim(0, -1).to(torch.float32)
