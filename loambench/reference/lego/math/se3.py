"""SO(3)/SE(3) math on torch tensors (port of `lego_loam_tpu/math/se3.py`).

Every pose is a rotation matrix plus a translation in the lidar frame (x
forward, y left, z up). All functions broadcast over leading batch dims.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-9


def _eye_like(x, shape):
    return torch.eye(3, dtype=x.dtype, device=x.device).expand(shape)


def hat(w):
    """so(3) hat operator: (...,3) -> (...,3,3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def exp_so3(w):
    """Rodrigues: (...,3) axis-angle -> (...,3,3) rotation."""
    theta = torch.linalg.norm(w, dim=-1, keepdim=True)[..., None]  # (...,1,1)
    K = hat(w / torch.clamp(theta[..., 0], min=_EPS))
    I = _eye_like(w, K.shape)
    R = I + torch.sin(theta) * K + (1.0 - torch.cos(theta)) * (K @ K)
    Ks = hat(w)
    Rsmall = I + Ks + 0.5 * (Ks @ Ks)
    return torch.where(theta > 1e-7, R, Rsmall)


def log_so3(R):
    """(...,3,3) rotation -> (...,3) axis-angle."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    v = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    sin_theta_v = torch.clamp(0.5 * torch.linalg.norm(v, dim=-1), 0.0, 1.0)
    # arccos is ill-conditioned at both ends: atan2 away from pi, and
    # pi - arcsin(sin) close to it.
    theta = torch.where(
        cos_theta < -0.7,
        math.pi - torch.arcsin(sin_theta_v),
        torch.atan2(sin_theta_v, cos_theta),
    )
    sin_theta = torch.sin(theta)
    scale = torch.where(
        torch.abs(sin_theta) > 1e-6,
        theta / torch.clamp(2.0 * sin_theta, min=_EPS),
        torch.full_like(theta, 0.5),
    )
    w = v * scale[..., None]
    # Near pi: axis from the diagonal, signs from the off-diagonal sums.
    near_pi = cos_theta < -1.0 + 1e-4
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis_sq = torch.clamp(
        (diag - cos_theta[..., None]) / (1.0 - cos_theta[..., None] + _EPS), min=0.0
    )
    axis = torch.sqrt(axis_sq)
    sgn = torch.sign(v)
    sgn = torch.where(sgn == 0, torch.ones_like(sgn), sgn)
    w_pi = axis * sgn * theta[..., None]
    return torch.where(near_pi[..., None], w_pi, w)


def left_jacobian_so3(w):
    """SO(3) left Jacobian J_l(w): (...,3) -> (...,3,3)."""
    theta = torch.linalg.norm(w, dim=-1, keepdim=True)[..., None]
    K = hat(w / torch.clamp(theta[..., 0], min=_EPS))
    I = _eye_like(w, K.shape)
    A = (1.0 - torch.cos(theta)) / torch.clamp(theta, min=_EPS)
    B = (theta - torch.sin(theta)) / torch.clamp(theta, min=_EPS)
    J = I + A * K + B * (K @ K)
    Jsmall = I + 0.5 * hat(w)
    return torch.where(theta > 1e-7, J, Jsmall)


def exp_se3(xi):
    """se(3) twist (...,6) [w, v] -> (R (...,3,3), t (...,3))."""
    w, v = xi[..., :3], xi[..., 3:]
    R = exp_so3(w)
    t = (left_jacobian_so3(w) @ v[..., None])[..., 0]
    return R, t


def log_se3(R, t):
    """(R, t) -> twist (...,6) [w, v]."""
    w = log_so3(R)
    # inv_ex: no read-back of the info code, so no device synchronisation
    Jinv = torch.linalg.inv_ex(left_jacobian_so3(w)).inverse
    v = (Jinv @ t[..., None])[..., 0]
    return torch.cat([w, v], dim=-1)


def compose(Ra, ta, Rb, tb):
    """T_a * T_b."""
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


def inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def relative(Ra, ta, Rb, tb):
    """T_a^{-1} * T_b."""
    Rinv, tinv = inverse(Ra, ta)
    return compose(Rinv, tinv, Rb, tb)


def orthonormalize(R):
    """Project (...,3,3) near-rotations back onto SO(3): two Newton steps of
    the polar factor, R <- R (3I - R^T R) / 2. The map pose is a long chain
    of f32 products; without re-projection its non-orthogonality feeds back
    through the prior composition."""
    I = _eye_like(R, R.shape)
    for _ in range(2):
        R = R @ (1.5 * I - 0.5 * (R.transpose(-1, -2) @ R))
    return R


def transform(R, t, p):
    """Apply (R, t) to points p (...,3)."""
    return torch.einsum("...ij,...j->...i", R, p) + t


def interp(R, t, s):
    """Fractional pose exp(s * log(T)); s broadcasts over leading dims."""
    xi = log_se3(R, t)
    if not isinstance(s, torch.Tensor):  # a number scales on the device, with no upload
        return exp_se3(xi * s)
    return exp_se3(xi * s.to(xi.dtype)[..., None])


def euler_zyx_to_matrix(roll, pitch, yaw):
    """R = Rz(yaw) Ry(pitch) Rx(roll)."""
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    return torch.stack(
        [
            torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], dim=-1),
            torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], dim=-1),
            torch.stack([-sp, cp * sr, cp * cr], dim=-1),
        ],
        dim=-2,
    )


def matrix_to_euler_zyx(R):
    """Inverse of euler_zyx_to_matrix -> (roll, pitch, yaw)."""
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    pitch = torch.atan2(-R[..., 2, 0], torch.sqrt(R[..., 2, 1] ** 2 + R[..., 2, 2] ** 2))
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return roll, pitch, yaw


def quat_to_matrix(q):
    """Quaternion (w, x, y, z) -> rotation matrix."""
    n = torch.linalg.norm(q, dim=-1, keepdim=True)
    q = q / n
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], dim=-1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1),
        ],
        dim=-2,
    )


def matrix_to_quat(R):
    """Rotation matrix -> quaternion (w, x, y, z), w >= 0."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    qw = torch.sqrt(torch.clamp(1.0 + tr, min=_EPS)) * 0.5
    qx = (R[..., 2, 1] - R[..., 1, 2]) / (4.0 * qw)
    qy = (R[..., 0, 2] - R[..., 2, 0]) / (4.0 * qw)
    qz = (R[..., 1, 0] - R[..., 0, 1]) / (4.0 * qw)
    q = torch.stack([qw, qx, qy, qz], dim=-1)
    # tr <= 0: go through axis-angle
    w = log_so3(R)
    theta = torch.linalg.norm(w, dim=-1, keepdim=True)
    axis = w / torch.clamp(theta, min=_EPS)
    q_aa = torch.cat([torch.cos(theta * 0.5), axis * torch.sin(theta * 0.5)], dim=-1)
    q = torch.where((tr > 0)[..., None], q, q_aa)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_mul(a, b):
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )
