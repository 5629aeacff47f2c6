"""SE(3) tangent-space operations on torch tensors.

Port of ``ydorbslam_tpu/geometry/se3.py``.  Same conventions:

  * A pose is a 4x4 homogeneous matrix ``T = [[R, t], [0, 1]]``.
  * Camera poses are world-to-camera (``T_cw``).
  * A twist is ``xi = [rho, phi]``, translation first;
    ``exp(xi) = [[exp([phi]x), V(phi) rho], [0, 1]]``.

All functions broadcast over leading batch dimensions and keep the
input's dtype and device.
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def hat(phi: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew-symmetric."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def vee(M: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hat`: (..., 3, 3) -> (..., 3)."""
    return torch.stack([M[..., 2, 1], M[..., 0, 2], M[..., 1, 0]], dim=-1)


def _eye_like(K: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula with small-angle Taylor guards. (...,3)->(...,3,3)."""
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    K = hat(phi)
    K2 = K @ K
    return _eye_like(K) + a[..., None, None] * K + b[..., None, None] * K2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Log map of SO(3): (...,3,3) -> (...,3), safe near 0 and pi.  The
    angle comes from atan2(|w|, trace) with w = vee(R - R^T), the
    epsilon inside the square root keeps the derivative finite at the
    identity, and near pi the axis is read off (R + R^T)/2."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    w = vee(R - R.transpose(-1, -2))  # 2 sin(theta) * axis
    sin_t = 0.5 * torch.sqrt(torch.sum(w * w, dim=-1) + _EPS * _EPS)
    theta = torch.atan2(sin_t, cos_t)
    near_zero = theta < 1e-4
    scale = torch.where(
        near_zero, 0.5 + theta * theta / 12.0, theta / (2.0 * torch.clamp(sin_t, min=_EPS))
    )
    phi = scale[..., None] * w
    near_pi = theta > 3.1386  # within ~3e-3 of pi
    sym = 0.5 * (R + R.transpose(-1, -2))
    eye = torch.eye(3, dtype=R.dtype, device=R.device).expand(R.shape)
    outer = (sym - cos_t[..., None, None] * eye) / torch.clamp(
        1.0 - cos_t[..., None, None], min=0.5
    )
    diag = torch.stack([outer[..., 0, 0], outer[..., 1, 1], outer[..., 2, 2]], dim=-1)
    k = torch.argmax(diag, dim=-1)
    col = torch.gather(outer, -1, k[..., None, None].expand(outer.shape[:-1] + (1,)))[..., 0]
    axis = col / torch.clamp(torch.linalg.norm(col, dim=-1, keepdim=True), min=_EPS)
    sign = torch.where(torch.sum(axis * w, dim=-1, keepdim=True) < 0.0, -1.0, 1.0)
    return torch.where(near_pi[..., None], theta[..., None] * axis * sign, phi)


def _left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """SO(3) left Jacobian V(phi) such that exp-se3 t-part = V rho."""
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(
        small, 1.0 / 6.0 - theta2 / 120.0,
        (theta - torch.sin(theta)) / (theta2 * theta),
    )
    K = hat(phi)
    K2 = K @ K
    return _eye_like(K) + b[..., None, None] * K + c[..., None, None] * K2


def _left_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_left_jacobian`, with its Taylor series near 0."""
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    half = theta * 0.5
    cot = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / torch.clamp(torch.sin(half), min=_EPS)) / theta2,
    )
    K = hat(phi)
    K2 = K @ K
    return _eye_like(K) - 0.5 * K + cot[..., None, None] * K2


def make_T(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble (...,4,4) from (...,3,3) rotation and (...,3) translation."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., None]], dim=-1)
    # [0, 0, 0, 1] made on the device: setting a Python number into a
    # single element of a card tensor is an upload that stalls the host.
    bottom = torch.cat([torch.zeros(batch + (1, 3), dtype=R.dtype, device=R.device),
                        torch.ones(batch + (1, 1), dtype=R.dtype, device=R.device)], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """exp: (...,6) twist [rho, phi] -> (...,4,4) homogeneous transform."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    t = (_left_jacobian(phi) @ rho[..., None])[..., 0]
    return make_T(R, t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """log: (...,4,4) -> (...,6) twist [rho, phi]."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    phi = so3_log(R)
    rho = (_left_jacobian_inv(phi) @ t[..., None])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def inv_T(T: torch.Tensor) -> torch.Tensor:
    """Inverse of a rigid transform without a general 4x4 solve."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return make_T(Rt, -(Rt @ t[..., None])[..., 0])


def orthonormalize_T(T: torch.Tensor) -> torch.Tensor:
    """Project the rotation block back onto SO(3) (Gram-Schmidt).

    The tracking state's pose feeds a multiplicative feedback loop
    (velocity = T_new inv(T_last); prediction = velocity T_last) whose
    orthogonality defect roughly doubles every frame in float32; one
    projection per pose solve keeps the chain on the manifold (see the
    JAX module's docstring for the measurement).
    """
    R = T[..., :3, :3]
    c0 = R[..., :, 0]
    c0 = c0 / torch.clamp(torch.linalg.norm(c0, dim=-1, keepdim=True), min=1e-12)
    c1 = R[..., :, 1]
    c1 = c1 - torch.sum(c0 * c1, dim=-1, keepdim=True) * c0
    c1 = c1 / torch.clamp(torch.linalg.norm(c1, dim=-1, keepdim=True), min=1e-12)
    c2 = torch.linalg.cross(c0, c1, dim=-1)
    Rn = torch.stack([c0, c1, c2], dim=-1)
    return make_T(Rn, T[..., :3, 3])


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (...,4,4) to (...,N,3) points -> (...,N,3)."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    return pts @ R.transpose(-1, -2) + t[..., None, :]


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (...,3,3) -> quaternion (x, y, z, w), TUM order.

    Branchless Shepperd's method: all four candidate encodings are
    formed and the one with the largest pivot is kept (the first on a
    tie, as ``jnp.argmax``), so it is safe for any rotation; the sign is
    made canonical with w >= 0."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)
    pivots = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        dim=-1,
    )
    k = torch.argmax(pivots, dim=-1)
    cand = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4 candidates, (w, x, y, z))
    q = torch.gather(cand, -2, k[..., None, None].expand(k.shape + (1, 4)))[..., 0, :]
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=_EPS)
    q = q * torch.where(q[..., :1] < 0.0, -1.0, 1.0)
    return torch.stack([q[..., 1], q[..., 2], q[..., 3], q[..., 0]], dim=-1)


def quat_to_rot(q_xyzw: torch.Tensor) -> torch.Tensor:
    """Quaternion (x, y, z, w) -> rotation matrix (...,3,3)."""
    q = q_xyzw / torch.clamp(torch.linalg.norm(q_xyzw, dim=-1, keepdim=True), min=_EPS)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack(
        [
            torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
            torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
        ],
        dim=-2,
    )
