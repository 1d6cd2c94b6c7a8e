"""Ackermann vehicle model: linkage kinematics + measurement covariance
(port of `lego_loam_tpu/ackermann.py`).

Rewrite of the reference's `AckermanStatePropagation` (`myESKF.cpp:639-752`)
and of the MATLAB-Coder measurement-covariance generator
(`MeaCovFromMatlab/MeaCov2C_pkg/MeaCov2C.cpp`). The generated C code is 368
lines of unrolled symbolic Jacobian algebra; here the covariance is
propagated with `torch.func.jacfwd` through the same kinematics function.

float32 throughout, with Python constants entering each operation as the
JAX package's weakly typed scalars do. A constant divided by a tensor goes
through `_rdiv` (a true division), since `c / t` on a tensor is computed as
`t.reciprocal() * c`.
"""

from __future__ import annotations

import math

import torch

# Vehicle linkage parameters, meters (myESKF.h:215-224, given in mm there).
L = 0.176
L1 = 0.112
L2 = 0.04452
L3 = 0.085
L4 = L2
L_REAR = 0.164
L_AX = (L_REAR - L1) / 2.0
R_WHEEL = 0.100

# Encoder scale factors (myESKF.h:107-108)
REAR_WHEEL_COUNT = 60000.0 * 45.0 / 35.0
HEADING_ANGLE_COUNT = 2.0 ** 14


def _rdiv(c: float, t):
    return torch.full_like(t, c) / t


def _cot(x):
    return torch.cos(x) / torch.sin(x)


def _acot(x):
    return torch.atan2(torch.ones_like(x), x)


def ackermann_kinematics(vel_wheel, steer_rel, encoder_pri, heading, pos_xy, dt):
    """One Ackermann propagation step.

    Inputs mirror the reference: `vel_wheel` = rear wheel angular rate
    (rad/s), `steer_rel` = incremental steering encoder angle, `encoder_pri`
    = accumulated previous steering angle, `heading` = current yaw (0-d
    float32 tensors). Returns (new_xy, vel_xy, new_heading, omega_B,
    new_encoder_pri). The straight-line branch (delta_r = 0) computes
    cot(0) before `where` discards it; forward-mode tangents through `where`
    take only the kept branch, so they stay finite there."""
    delta_r = encoder_pri + steer_rel
    a = torch.atan2(torch.full_like(delta_r, L), torch.full_like(delta_r, L1 / 2.0))
    omega_k = vel_wheel

    a_r = delta_r + a
    S = torch.sqrt(L1 * L1 + L4 * L4 - 2 * L1 * L4 * torch.cos(a_r))
    b = torch.arccos(torch.clip((L1 * L1 + S * S - L4 * L4) / (2.0 * L1 * S), -1.0, 1.0))
    c = torch.arccos(torch.clip((L2 * L2 + S * S - L3 * L3) / (2.0 * L2 * S), -1.0, 1.0))
    a_l = b + c
    delta_l = a - a_l
    delta_f = _acot(
        _cot(delta_r)
        - _rdiv((L_REAR / 2.0) - L_AX, _rdiv(L_REAR - 2.0 * L_AX, _cot(delta_r) - _cot(delta_l)))
    )
    sgn = torch.sign(delta_r)
    R_m = sgn * L * _cot(delta_f)

    ratio = (R_m - sgn * (L_REAR / 2.0)) / (R_m + sgn * (L_REAR / 2.0))
    omega_l = (2.0 * omega_k * ratio) / (1.0 + ratio)
    omega_B = omega_l * R_WHEEL / ((R_m - sgn * (L_REAR / 2.0)) * sgn)
    V_r = R_m * sgn * omega_B

    # straight-line limit (delta_r == 0, myESKF.cpp:712-719)
    straight = torch.abs(delta_r) < 1e-9
    V_r = torch.where(straight, omega_k * R_WHEEL, V_r)
    omega_B = torch.where(straight, torch.zeros_like(omega_B), omega_B)

    vel_xy = torch.stack([V_r * torch.cos(heading), V_r * torch.sin(heading)])
    new_xy = pos_xy + vel_xy * dt
    new_heading = heading + omega_B * dt
    return new_xy, vel_xy, new_heading, omega_B, delta_r


def counts_to_inputs(vel_count, steer_count, dt):
    """Encoder counts -> (wheel rad/s, steering angle) (myESKF.cpp:563-564)."""
    vel = (vel_count / REAR_WHEEL_COUNT) * 2.0 * math.pi / dt
    steer = (steer_count / HEADING_ANGLE_COUNT) * 2.0 * math.pi
    return vel, steer


def measurement_and_covariance(
    vel_count, steer_count, encoder_pri, heading, vel_prev_xy, dt, enc_var=(0.5, 0.5), heading_var=0.0
):
    """Ackermann measurement [vx, vy, q(wxyz)] and its covariance R (6,6).

    ≙ MeaCov2C (MeaCov2C.cpp): first-order propagation of the encoder noise
    V2 = diag(0.5, 0.5) (myESKF.cpp:565-566) and the current heading variance
    through the kinematics into measurement space, by `torch.func.jacfwd`."""

    def h(u):
        # (1,) slices, not 0-d tensors: forward-mode AD of a 0-d float32
        # tensor with a Python scalar gives a float64 tangent
        vc, sc, th = u[0:1], u[1:2], u[2:3]
        vel, steer = counts_to_inputs(vc, sc, dt)
        _, vel_xy, new_heading, _, _ = ackermann_kinematics(
            vel, steer, encoder_pri.reshape(1), th, torch.zeros_like(u[:2, None]), dt
        )
        z = torch.zeros_like(new_heading)
        q = torch.cat([torch.cos(new_heading / 2.0), z, z, torch.sin(new_heading / 2.0)])
        return torch.cat([vel_xy[:, 0], q])

    u0 = torch.stack([vel_count, steer_count, heading])
    z = h(u0)
    J = torch.func.jacfwd(h)(u0)  # (6, 3)
    var_u = torch.diag(torch.stack([torch.full_like(u0[0], v) for v in (enc_var[0], enc_var[1], heading_var)]))
    R = J @ var_u @ J.T
    # Keep the reference's diagonal-only use (myESKF.cpp:594-600)
    R = torch.diag(torch.diag(R)) + 1e-12 * torch.eye(6, dtype=u0.dtype, device=u0.device)
    return z, R
