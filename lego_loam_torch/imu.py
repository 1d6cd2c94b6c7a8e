"""IMU integration, scan undistortion and the wheel-odometry motion prior
(port of `lego_loam_tpu/imu.py`).

A scan's IMU samples arrive as a fixed (S,) window, padded and masked.
`integrate_imu` turns them into an orientation, velocity and shift track;
`undistort_to` re-expresses each point captured at relative time s in the
sensor frame at a reference time, interpolating the track piecewise
linearly (the rotation along the geodesic). `odom_prior_motion` is the
lever-arm corrected inter-frame motion from two wheel-odometry poses.

The reference integrates with a `lax.scan`; here the same recurrence is a
closed form over cumulative sums (see `integrate_imu`). Everything is plain
float32 tensor arithmetic on the caller's device; the 3x3 products are
einsums, which run without TF32 (the package turns it off).
"""

from __future__ import annotations

import dataclasses

import torch

from .math import se3
from .types import _Base

GRAVITY = (0.0, 0.0, -9.81)


@dataclasses.dataclass(frozen=True)
class ImuTrack(_Base):
    """Integrated IMU trajectory over one scan period (leading batch dims
    allowed)."""

    t: torch.Tensor  # (S,) sample times relative to scan start (s)
    R: torch.Tensor  # (S, 3, 3) orientation (world frame)
    shift: torch.Tensor  # (S, 3) accumulated position
    velo: torch.Tensor  # (S, 3) velocity
    mask: torch.Tensor  # (S,) valid samples

    def frame(self, c: int) -> "ImuTrack":
        """Frame c of a (C, S, ...) batch of tracks."""
        return ImuTrack(*(getattr(self, f.name)[c] for f in dataclasses.fields(self)))


def _const(values, like):
    """A (3,) constant on `like`'s device, built by fills (no upload, so it
    may be made inside a captured step)."""
    return torch.stack([torch.full((), float(v), dtype=like.dtype, device=like.device) for v in values])


def integrate_imu(t, rpy, acc, v0=None, mask=None) -> ImuTrack:
    """Integrate raw samples: t (..., S) times, rpy (..., S, 3) roll/pitch/
    yaw orientation, acc (..., S, 3) body-frame acceleration with gravity.

    Gravity is removed with the orientation. The reference's recurrence,
    with a masked sample's dt set to 0,

        p_k = p_{k-1} + v_{k-1} dt_k + a_k dt_k^2 / 2,   v_k = v_{k-1} + a_k dt_k,

    is summed in closed form: v_k = v0 + sum_{j<=k} a_j dt_j and p_k =
    sum_{j<=k} (v_{j-1} dt_j + a_j dt_j^2 / 2). The order of the sums
    differs from the scan's, so results agree to float32 rounding."""
    S = t.shape[-1]
    if mask is None:
        mask = torch.ones(t.shape, dtype=torch.bool, device=t.device)
    R = se3.euler_zyx_to_matrix(rpy[..., 0], rpy[..., 1], rpy[..., 2])
    acc_w = torch.einsum("...sij,...sj->...si", R, acc) + _const(GRAVITY, acc)
    # dt_0 = 0; a padded slot's raw dt is negative (its t is 0): zeroed
    dt = torch.diff(t, dim=-1, prepend=t[..., :1])
    dt = torch.where(mask, dt, torch.zeros_like(dt))[..., None]
    if v0 is None:
        v0 = torch.zeros(3, dtype=acc.dtype, device=acc.device)
    dv = acc_w * dt
    velo = v0[..., None, :] + torch.cumsum(dv, dim=-2)
    v_prev = torch.cat([v0.expand(*velo.shape[:-2], 1, 3), velo[..., : S - 1, :]], dim=-2)
    shift = torch.cumsum(v_prev * dt + 0.5 * dv * dt, dim=-2)
    return ImuTrack(t=t, R=R, shift=shift, velo=velo, mask=mask)


def _interp_track(track: ImuTrack, tq):
    """Orientation (Q, 3, 3) and shift (Q, 3) of one (S,) track at query
    times tq (Q,): the segment is found by a left-side search over the
    valid times (masked slots at +inf), clipped to [1, S-1]."""
    S = track.t.shape[0]
    tt = torch.where(track.mask, track.t, torch.full_like(track.t, float("inf"))).contiguous()
    hi = torch.clamp(torch.searchsorted(tt, tq.contiguous()), 1, S - 1)
    lo = hi - 1
    t0, t1 = track.t[lo], track.t[hi]
    w = torch.clamp((tq - t0) / torch.clamp(t1 - t0, min=1e-9), 0.0, 1.0)

    # blend the rotations through the relative log (geodesic interpolation)
    R0, R1 = track.R[lo], track.R[hi]
    dR = torch.einsum("qji,qjk->qik", R0, R1)  # R0^T R1
    wlog = se3.log_so3(dR) * w[:, None]
    Rq = torch.einsum("qij,qjk->qik", R0, se3.exp_so3(wlog))
    shiftq = track.shift[lo] * (1 - w[:, None]) + track.shift[hi] * w[:, None]
    return Rq, shiftq


def undistort_to_start(xyz, rel_time, track: ImuTrack, scan_period: float):
    """Re-express points captured at rel_time in the scan-start frame:
    p_start = R_0^T (R_s p + shift_s - shift_0)."""
    return undistort_to(xyz, rel_time, track, scan_period, ref_time=0.0)


def undistort_to(xyz, rel_time, track: ImuTrack, scan_period: float, ref_time: float = 1.0):
    """Re-express points (..., 3) captured at rel_time (...) in the sensor
    frame at relative time ref_time (1 = scan end, where the rest of the
    pipeline settles a cloud: afterwards rel_time is 1 and no motion warp
    applies)."""
    shape = xyz.shape[:-1]
    flat = xyz.reshape(-1, 3)
    tq = rel_time.reshape(-1) * scan_period
    Rq, shiftq = _interp_track(track, tq)
    Rr, shiftr = _interp_track(track, torch.full_like(tq[:1], ref_time * scan_period))
    p_world = torch.einsum("qij,qj->qi", Rq, flat) + shiftq
    p_ref = torch.einsum("ji,qj->qi", Rr[0], p_world - shiftr[0])
    return p_ref.reshape(*shape, 3)


def odom_prior_motion(R_slam, t_slam, R_odom_prev, t_odom_prev, R_odom_cur, t_odom_cur, lever_arm):
    """Inter-frame motion prior (M_R, M_t) from the wheel-odometry poses at
    the previous and the current scan, corrected for the lever arm between
    the odometry frame and the sensor: the sensor positions t + R la of
    both poses, expressed in the previous pose's frame. R_slam and t_slam
    (the accumulated lidar odometry) are unused, as in the reference."""
    la = _const(lever_arm, t_odom_cur)
    p_prev = t_odom_prev + R_odom_prev @ la
    p_cur = t_odom_cur + R_odom_cur @ la
    return R_odom_prev.T @ R_odom_cur, R_odom_prev.T @ (p_cur - p_prev)
