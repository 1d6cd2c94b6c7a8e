"""18-state error-state Kalman filter: IMU / LiDAR / Ackermann fusion (port
of `lego_loam_tpu/eskf.py`).

Rewrite of the reference's standalone ESKF study (`myESKF.{h,cpp}` ≈2.1 kLoC
+ boost-ublas matrix exponentials): the whole 50 s / 5000-tick run is a loop
over IMU samples with LiDAR (10 Hz) and Ackermann (100 Hz) updates, 18x18
covariance algebra on the device. The JAX package runs it as one `lax.scan`
with a `cond` on the LiDAR tick; here it is a Python loop over ticks, and
whether a tick takes the LiDAR update depends only on its index and the
number of LiDAR rows, so the host decides it: no tick reads the device
back (inverses go through `inv_ex`, constants are made on the device).

State (Solà-convention ESKF, matching myESKF.h:61-73):
  nominal: p, v, q (wxyz), acc_bias, gyro_bias, gravity   (19 params)
  error:   [dp, dv, dtheta, dab, dgb, dg]                 (18,)

Key maps to the reference:
  NominalStatePropagation      myESKF.cpp:244-329   -> _propagate_nominal
  ErrorStateTransitionMatrix   myESKF.cpp:332-384   -> _error_transition
  LidarFusionProcess           myESKF.cpp:498-556   -> _lidar_update
  AckermanFusionProcess        myESKF.cpp:558-636   -> _ackermann_update
  Injection + Reset(G)         myESKF.cpp:469-496   -> _inject_and_reset
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .ackermann import ackermann_kinematics, counts_to_inputs, measurement_and_covariance
from .math import se3


class EskfParams(NamedTuple):
    dt_imu: float = 0.01
    lidar_every: int = 10  # lidar tick period in IMU ticks
    acc_std: float = 0.01
    gyro_std: float = 0.0015
    acc_bias_std: float = 0.0005
    gyro_bias_std: float = 0.0005
    trans_std: float = 0.01
    rot_std: float = 1.0
    p0: float = 0.001  # initial covariance diag (myESKF.cpp:78)


class Nominal(NamedTuple):
    p: torch.Tensor
    v: torch.Tensor
    q: torch.Tensor  # (4,) wxyz
    ab: torch.Tensor
    gb: torch.Tensor
    g: torch.Tensor


class EskfState(NamedTuple):
    x: Nominal
    P: torch.Tensor  # (18, 18)
    heading: torch.Tensor  # Ackermann heading estimate
    encoder_pri: torch.Tensor
    ack_v: torch.Tensor  # (3,) previous Ackermann velocity state


def _f32(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device, torch.float32)
    return torch.from_numpy(np.array(x, np.float32)).to(device)


def init_state(p0, v0, rpy0, g=9.81, params: EskfParams = EskfParams(), device="cuda") -> EskfState:
    rpy0 = _f32(rpy0, device)
    q0 = se3.matrix_to_quat(se3.euler_zyx_to_matrix(rpy0[0], rpy0[1], rpy0[2]))
    x = Nominal(
        p=_f32(p0, device), v=_f32(v0, device), q=q0, ab=torch.zeros(3, device=device),
        gb=torch.zeros(3, device=device), g=_f32([0.0, 0.0, -g], device),
    )
    return EskfState(
        x=x, P=torch.eye(18, device=device) * params.p0, heading=rpy0[2].clone(),
        encoder_pri=torch.zeros((), device=device), ack_v=_f32(v0, device),
    )


def _unit_quat(like):
    q = torch.zeros(4, dtype=like.dtype, device=like.device)
    q[0] = 1.0
    return q


def _rotvec_quat(w):
    """Quaternion of rotation vector w (identity at w = 0)."""
    wn = torch.linalg.norm(w)
    dq = torch.cat([torch.cos(wn * 0.5)[None], w / torch.clamp(wn, min=1e-12) * torch.sin(wn * 0.5)])
    return torch.where(wn > 0, dq, _unit_quat(w))


def _propagate_nominal(x: Nominal, acc, omega, dt):
    R = se3.quat_to_matrix(x.q)
    a_world = R @ (acc - x.ab) + x.g
    p = x.p + x.v * dt + 0.5 * a_world * dt * dt
    v = x.v + a_world * dt
    q = se3.quat_mul(x.q, _rotvec_quat((omega - x.gb) * dt))
    q = q / torch.linalg.norm(q)
    return Nominal(p=p, v=v, q=q, ab=x.ab, gb=x.gb, g=x.g)


def _error_transition(x: Nominal, acc, omega, dt, params: EskfParams):
    """Fx (18,18) and the additive process noise Fi Qi Fi^T (18,18)."""
    R = se3.quat_to_matrix(x.q)
    dev = R.device
    I3 = torch.eye(3, device=dev)
    Fx = torch.eye(18, device=dev)
    Fx[0:3, 3:6] = I3 * dt
    Fx[3:6, 15:18] = I3 * dt
    Fx[6:9, 12:15] = -I3 * dt
    Fx[3:6, 9:12] = -R * dt
    Fx[3:6, 6:9] = -R @ se3.hat(acc - x.ab) * dt
    Fx[6:9, 6:9] = se3.exp_so3(-(omega - x.gb) * dt)

    q = torch.zeros(18, device=dev)
    q[3:6] = params.acc_std ** 2 * dt * dt
    q[6:9] = params.gyro_std ** 2 * dt * dt
    q[9:12] = params.acc_bias_std ** 2 * dt
    q[12:15] = params.gyro_bias_std ** 2 * dt
    return Fx, torch.diag(q)


def _q_delta_theta(q):
    """dq/dtheta quaternion chart Jacobian (4,3) (myESKF.cpp:414-419)."""
    w, x, y, z = q[0], q[1], q[2], q[3]
    return 0.5 * torch.stack(
        [torch.stack(r) for r in ([-x, -y, -z], [w, -z, y], [z, w, -x], [-y, x, w])]
    )


def _x_delta_x(q):
    """(19, 18) true-state/error-state chart Jacobian."""
    X = torch.zeros((19, 18), device=q.device)
    X[0:6, 0:6] = torch.eye(6, device=q.device)
    X[6:10, 6:9] = _q_delta_theta(q)
    X[10:19, 9:18] = torch.eye(9, device=q.device)
    return X


def _inject_and_reset(x: Nominal, P, dx):
    """Inject the error estimate and reset covariance (myESKF.cpp:469-496)."""
    dth = dx[6:9]
    x = Nominal(
        p=x.p + dx[0:3], v=x.v + dx[3:6], q=se3.quat_mul(x.q, _rotvec_quat(dth)),
        ab=x.ab + dx[9:12], gb=x.gb + dx[12:15], g=x.g + dx[15:18],
    )
    G = torch.eye(18, device=P.device)
    G[6:9, 6:9] = se3.exp_so3(0.5 * dth)
    return x, G @ P @ G.T


def _kalman_update(x, P, H, V, err):
    S = H @ P @ H.T + V
    K = P @ H.T @ torch.linalg.inv_ex(S).inverse  # no error check: it would wait for the device
    dx = K @ err
    P = (torch.eye(18, device=P.device) - K @ H) @ P
    return _inject_and_reset(x, P, dx)


def _selector(rows, cols, ones, device):
    """A (rows, cols) zero matrix with ones at the (r, c) pairs."""
    H = torch.zeros((rows, cols), device=device)
    for r, c in ones:
        H[r, c] = 1.0
    return H


def _lidar_update(x, P, z_pos, z_rpy, qua_noise, params: EskfParams):
    """7-dim (pos + quaternion) lidar update (myESKF.cpp:498-556)."""
    dev = P.device
    Hx = _selector(7, 19, [(0, 0), (1, 1), (2, 2), (3, 6), (4, 7), (5, 8), (6, 9)], dev)
    H = Hx @ _x_delta_x(x.q)

    V = torch.zeros((7, 7), device=dev)
    V[0:3, 0:3] = torch.eye(3, device=dev) * params.trans_std ** 2
    V[3:7, 3:7] = torch.diag((params.rot_std * qua_noise) ** 2)

    q_meas = se3.matrix_to_quat(se3.euler_zyx_to_matrix(z_rpy[0], z_rpy[1], z_rpy[2]))
    # hemisphere alignment (myESKF.cpp:516-521)
    q_meas = torch.where(torch.dot(q_meas, x.q) < 0, -q_meas, q_meas)
    err = torch.cat([z_pos - x.p, q_meas - x.q])
    return _kalman_update(x, P, H, V, err)


def _ackermann_update(x, P, heading, encoder_pri, vel_count, steer_count, params: EskfParams):
    """6-dim (vx, vy, quaternion) wheel/steer update (myESKF.cpp:558-636)."""
    dt = params.dt_imu
    z, Rm = measurement_and_covariance(vel_count, steer_count, encoder_pri, heading, x.v, dt)
    vel, steer = counts_to_inputs(vel_count, steer_count, dt)
    _, _, _new_heading, _, new_encoder_pri = ackermann_kinematics(
        vel, steer, encoder_pri, heading, torch.zeros(2, device=P.device), dt
    )

    Hx = _selector(6, 19, [(0, 3), (1, 4), (2, 6), (3, 7), (4, 8), (5, 9)], P.device)
    H = Hx @ _x_delta_x(x.q)

    q_meas = z[2:6]
    q_meas = torch.where(torch.dot(q_meas, x.q) < 0, -q_meas, q_meas)
    err = torch.cat([z[0:2] - x.v[0:2], q_meas - x.q])
    x, P = _kalman_update(x, P, H, Rm, err)

    # post-update bookkeeping (myESKF.cpp:627-634): heading tracks the fused
    # attitude, steering accumulator advances
    _, _, yaw = se3.matrix_to_euler_zyx(se3.quat_to_matrix(x.q))
    return x, P, yaw, new_encoder_pri


def run_eskf(
    acc_mea,  # (T, 3)
    omega_mea,  # (T, 3)
    lidar_pos,  # (Tl, 3) at 1/lidar_every rate
    lidar_rpy,  # (Tl, 3)
    vel_count,  # (T,)
    steer_count,  # (T,)
    state0: EskfState,
    qua_noise=None,  # (4,), default 0.01 each
    params: EskfParams = EskfParams(),
):
    """Full fused run on the device of state0 (inputs: tensors or arrays);
    returns the final state and per-tick (pos, vel, rpy, ab, gb) histories.

    ≙ runESKF's main loop (myESKF.cpp:926-980): propagate at 100 Hz, lidar
    update when the tick lands on the 10 Hz grid, Ackermann update at every
    tick."""
    dev = state0.P.device
    acc_mea, omega_mea, lidar_pos, lidar_rpy, vel_count, steer_count = (
        _f32(a, dev) for a in (acc_mea, omega_mea, lidar_pos, lidar_rpy, vel_count, steer_count)
    )
    qua_noise = torch.full((4,), 0.01, device=dev) if qua_noise is None else _f32(qua_noise, dev)
    T, Tl, le = acc_mea.shape[0], lidar_pos.shape[0], params.lidar_every
    dt = params.dt_imu
    s = state0
    hist = {k: [] for k in ("pos", "vel", "rpy", "acc_bias", "gyro_bias")}
    for i in range(T):
        acc, omega = acc_mea[i], omega_mea[i]
        x = _propagate_nominal(s.x, acc, omega, dt)
        Fx, Q = _error_transition(s.x, acc, omega, dt, params)
        P = Fx @ s.P @ Fx.T + Q

        k = (i + 1) // le
        if (i + 1) % le == 0 and k < Tl:
            x, P = _lidar_update(x, P, lidar_pos[k], lidar_rpy[k], qua_noise, params)

        x, P, heading, encoder_pri = _ackermann_update(x, P, s.heading, s.encoder_pri, vel_count[i],
                                                       steer_count[i], params)
        s = EskfState(x=x, P=P, heading=heading, encoder_pri=encoder_pri, ack_v=x.v)
        hist["pos"].append(x.p)
        hist["vel"].append(x.v)
        hist["rpy"].append(torch.stack(se3.matrix_to_euler_zyx(se3.quat_to_matrix(x.q))))
        hist["acc_bias"].append(x.ab)
        hist["gyro_bias"].append(x.gb)
    return s, {k: torch.stack(v) if v else torch.zeros((0, 3), device=dev) for k, v in hist.items()}
